"""On-card smoke test of tpu_engine_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py            # needs one CUDA card (an H100 here)

Builds every CUDA kernel of the serving path from tpu_engine_torch/csrc,
holds each against its plain PyTorch version at the shapes the serving
path gives it and times it, runs a Llama-2-7B-width Q4_K_M model (depth
cut to 4 layers, random weights from a seed) through the kernels and
through the plain versions at f16, q8_0 and q4_0 KV, then serves it over
the cortex HTTP flow once per KV cache type (/loadmodel -> 8 concurrent
/v1/chat/completions, plus one that context-shifts at q8_0 ->
/unloadmodel) and checks that each cycle launched every kernel of its
path. Any failure raises and exits non-zero. The last lines are the
kernel table as one JSON object, the card's name and power limit from
nvidia-smi, and {"ok": true, "device": {...}}. Per-shape details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np
import torch

from tpu_engine_torch.kernels import _build
from tpu_engine_torch.kernels import dequant_matmul as DM
from tpu_engine_torch.kernels import flash_attention as FA
from tpu_engine_torch.kvcache.cache import (QUANT_KINDS, KVCache, default_layout,
                                            dequant_kv, quantize_kv_rows)
from tpu_engine_torch.model import llama as LL
from tpu_engine_torch.model import weights as W
from tpu_engine_torch.serve import ops as OPS

HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_S = 67e12    # H100 SXM f32 (CUDA cores); the kernels multiply in f32
ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
N_LAYER = 4  # depth cut of the Llama-2-7B widths (32 layers) for the smoke
ITERS = 20   # timed launches per kernel shape
QMM_TOL = 1e-4     # max |kernel - plain| / max |plain|: f32 vs f32, sum order
ATTN_TOL = 2e-4    # max |kernel - plain| (outputs O(1)): f32 sums, sum order
LOGIT_TOL = 2e-3   # max |dlogit| / max |logit| over the model phase


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median device time of fn over iters launches, each after an L2
    flush (a 256 MB write), with a CUDA event pair around the launch."""

    def __init__(self, iters: int):
        self.iters = iters
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(2):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(self.iters)]
        for e0, e1 in ev:
            self.flush.zero_()
            e0.record()
            fn()
            e1.record()
        torch.cuda.synchronize()
        return float(np.median([e0.elapsed_time(e1) for e0, e1 in ev]))


# ---------------------------------------------------------------- kernels
def rand_qtensor(gen, n, k, kind, group, has_bias) -> W.QTensor:
    dev = "cuda"
    if kind == "nib4":
        qs = torch.randint(0, 256, (n, k // 2), generator=gen, device=dev,
                           dtype=torch.uint8)
    else:  # Q6_K values span -32..31
        qs = torch.randint(-32, 32, (n, k), generator=gen, device=dev,
                           dtype=torch.int8)
    ng = k // group
    scale = torch.rand((n, ng), generator=gen, device=dev) * 2e-3 + 1e-4
    bias = (-(torch.rand((n, ng), generator=gen, device=dev) * 2e-2)
            if has_bias else None)
    return W.QTensor(qs=qs, scale=scale, bias=bias, kind=kind, group=group,
                     shape=(n, k))


QMM_SHAPES = [  # (tensor, kind, group, has_bias, N, K) at Llama-2-7B widths
    ("wqkv Q4_K", "nib4", 32, True, 12288, 4096),
    ("wo Q4_K", "nib4", 32, True, 4096, 4096),
    ("w_gateup Q4_K", "nib4", 32, True, 22016, 4096),
    ("w_down Q4_K", "nib4", 32, True, 4096, 11008),
    ("output Q6_K", "i8", 16, False, 32000, 4096),
    ("w_down Q6_K", "i8", 16, False, 4096, 11008),
]


def qmm_phase(timer: Timer, gen) -> list[dict]:
    rows = []
    for name, kind, group, has_bias, n, k in QMM_SHAPES:
        qt = rand_qtensor(gen, n, k, kind, group, has_bias)
        w_f32 = W.dequant(qt)  # the yardstick's pre-dequantized weight
        # one M per tile configuration of qmm.cu: decode (<= 8), a B=1
        # prefill bucket (9..64) and a grouped prefill (> 64)
        for m in (8, 32, 512):
            x = torch.randn((m, k), generator=gen, device="cuda")
            y = DM.qmm_cuda(x, qt)
            ref = DM.qmatmul_plain(x, qt)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            scale = float(ref.abs().max())
            rel = err / scale
            if not (torch.isfinite(y).all() and rel <= QMM_TOL):
                raise AssertionError(f"qmm {name} M={m}: rel err {rel:.3e} "
                                     f"> {QMM_TOL}")
            wbytes = qt.nbytes
            bytes_ = x.numel() * 4 + wbytes + m * n * 4
            flops = 2.0 * m * n * k
            bound = max(bytes_ / HBM_BYTES_S, flops / F32_FLOPS_S) * 1e3
            row = dict(
                kernel="qmm_nib4" if kind == "nib4" else "qmm_i8",
                shape=f"{name} {n}x{k} M={m}", M=m, N=n, K=k,
                max_abs_err=err, max_rel_err=rel, tol_rel=QMM_TOL,
                ms=timer(lambda: DM.qmm_cuda(x, qt)),
                plain_ms=timer(lambda: DM.qmatmul_plain(x, qt)),
                library_ms=timer(lambda: torch.matmul(x, w_f32.t())),
                bound_ms=bound,
                bound_by="bytes" if bytes_ / HBM_BYTES_S >= flops / F32_FLOPS_S
                else "operations")
            log(f"qmm {row['shape']}: max_abs_err {err:.3e} rel {rel:.3e} "
                f"(tol {QMM_TOL}) kernel_ms {row['ms']:.4f} bound_ms "
                f"{bound:.4f} ({row['bound_by']}) library_ms "
                f"{row['library_ms']:.4f} plain_ms {row['plain_ms']:.4f}")
            rows.append(row)
        del w_f32
    return rows


def attn_cfg(D, softcap=0.0):
    return types.SimpleNamespace(
        attention_scale=lambda: 1.0 / math.sqrt(D), attn_logit_softcap=softcap,
        layer_window=lambda li: 0, rope_dim=D)


def attn_case(gen, B, KH, G, D, T, starts, Tc, n_valid, kind="f16",
              layout="td", L=2, li=1):
    """A random cache of `kind` in `layout` (quantized kinds quantize random
    f32 rows with the port's quantize_kv_rows) and one step's operands."""
    dev = "cuda"
    H = KH * G
    S = B
    planes, scales = [], []
    for _ in range(2):
        x = torch.randn((L, S, KH, T, D), generator=gen, device=dev)
        if kind in QUANT_KINDS:
            x, s = quantize_kv_rows(x, kind)
            scales.append(s)
        else:
            x = x.to(torch.float32 if kind == "f32" else torch.bfloat16)
        planes.append(x.transpose(-1, -2).contiguous() if layout == "dt" else x)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    cache = KVCache(planes[0], planes[1], st.clone(), *(scales or (None, None)),
                    kind=kind, layout=layout)
    slot_ids = torch.arange(B, dtype=torch.int32, device=dev).flip(0).contiguous()
    cache.lengths = cache.lengths.flip(0).contiguous()  # slot b holds row B-1-b
    q = torch.randn((B, Tc, H, D), generator=gen, device=dev)
    k_new = torch.randn((B, KH, Tc, D), generator=gen, device=dev)
    v_new = torch.randn((B, KH, Tc, D), generator=gen, device=dev)
    q_pos = st[:, None] + torch.arange(Tc, dtype=torch.int32, device=dev)[None]
    nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    return dict(q=q, cache=cache, li=li, slot_ids=slot_ids, q_pos=q_pos,
                n_valid=nv, k_new=k_new, v_new=v_new, starts=st)


def attn_bytes_flops(c, Tc):
    """Bytes the call must move (q in and out, the in-flight rows, and each
    live cell of K and V once: its Dk stored elements plus, when quantized,
    its 4-byte scale) and the multiply-adds of the attended pairs."""
    q, cache = c["q"], c["cache"]
    B, _, H, D = q.shape
    KH = c["k_new"].shape[1]
    starts = c["starts"].tolist()
    nv = c["n_valid"].tolist()
    Dk = cache.k.shape[3 if cache.layout == "dt" else 4]
    cell = Dk * cache.k.element_size() + (4 if cache.quantized else 0)
    live = sum(starts)
    bytes_ = (q.numel() * 4 * 2 + 2 * c["k_new"].numel() * 4
              + 2 * live * KH * cell)
    keys = 0  # attended keys summed over query rows (data-dependent)
    for b in range(B):
        for t in range(Tc):
            keys += starts[b] + min(t + 1, nv[b])
    flops = 4.0 * keys * H * D
    return bytes_, flops


def sdpa_inputs(c, Tc):
    """Gathered, dequantized, "td"-ordered and GQA-expanded f32 K/V and the
    boolean mask for the yardstick (made outside its timing)."""
    q, cache = c["q"], c["cache"]
    B, _, H, D = q.shape
    KH = c["k_new"].shape[1]
    G = H // KH
    sl = c["slot_ids"].long()
    li = c["li"]
    kv = []
    for cells, sc in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
        x = cells[li, sl]
        if cache.layout == "dt":
            x = x.transpose(-1, -2)
        kv.append(dequant_kv(x, None if sc is None else sc[li, sl],
                             cache.kind))  # [B, KH, T, D] f32
    kc, vc = kv
    T = kc.shape[2]
    kk = torch.cat([kc, c["k_new"]], 2).repeat_interleave(G, 1)
    vv = torch.cat([vc, c["v_new"]], 2).repeat_interleave(G, 1)
    cell = torch.arange(T, device="cuda")
    st = c["starts"].long()
    t = torch.arange(Tc, device="cuda")
    m_cache = (cell[None, None, :] < st[:, None, None]).expand(B, Tc, T)
    m_new = (t[None, None, :] <= t[None, :, None]) & (
        t[None, None, :] < c["n_valid"].long()[:, None, None])
    mask = torch.cat([m_cache, m_new.expand(B, Tc, Tc)], 2)[:, None]
    return q.transpose(1, 2).contiguous(), kk, vv, mask


FILLS = [1, 511, 37, 256, 128, 400, 2, 300]  # decode fills, mixed 1..511


def attn_cases(D=128):
    """(kernel, label, attn_case kwargs, represents the kernel in the
    kernels line) for every timed attention shape of the serving path."""
    cases = []

    def add(kname, label, main=False, **kw):
        kind, layout = kw.get("kind", "f16"), kw.get("layout", "td")
        cases.append((kname, f"{kind} {layout} {label}", kw, main))

    # "td" (f16 at head_dim 128: the f16 server; q8_0/q4_0 in "td" only
    # when a caller asks for that layout)
    for kind in ("f16", "q8_0", "q4_0"):
        for KH, G in ((32, 1), (8, 4)) if kind == "f16" else ((32, 1),):
            add("attn_decode", f"B=8 KH={KH} G={G} D={D} T=512 fills 1..511",
                main=kind == "f16" and KH == 32, B=8, KH=KH, G=G, D=D, T=512,
                starts=FILLS, Tc=1, n_valid=[1] * 8, kind=kind)
        for KH, G in ((32, 1), (8, 4)) if kind == "f16" else ((32, 1),):
            for hist in (0, 256) if kind == "f16" else (256,):
                add("attn_prefill", f"B=1 Tc=512 history {hist} KH={KH} G={G} "
                    f"D={D}", main=kind == "f16" and KH == 32 and hist == 0,
                    B=1, KH=KH, G=G, D=D, T=1024, starts=[hist], Tc=512,
                    n_valid=[512], kind=kind)
    # the engine's grouped prefill: one [n_slots, bucket] step with mixed
    # histories and inactive rows at n_valid=0 (empty or mid-decode slots)
    grouped = dict(B=8, KH=32, G=1, D=D, T=512,
                   starts=[0, 0, 130, 0, 256, 17, 0, 200], Tc=256,
                   n_valid=[256, 24, 0, 0, 150, 0, 256, 0])
    glabel = f"B=8 Tc=256 grouped, mixed histories, 4 rows n_valid=0 KH=32 G=1 D={D}"
    add("attn_prefill", glabel, **grouped)
    # "dt": the quantized servers (512-cell slots), T=320 (where the JAX
    # package falls back from _decode_kernel_dma to _decode_kernel_t), and
    # TinyLlama's geometry (f16 at D=64, G=8)
    for kind in ("q8_0", "q4_0"):
        add("attn_decode_dt", f"B=8 KH=32 G=1 D={D} T=512 fills 1..511",
            main=kind == "q8_0", B=8, KH=32, G=1, D=D, T=512, starts=FILLS,
            Tc=1, n_valid=[1] * 8, kind=kind, layout="dt")
        add("attn_decode_dt", f"B=8 KH=32 G=1 D={D} T=320 fills 1..319",
            B=8, KH=32, G=1, D=D, T=320, starts=[min(f, 319) for f in FILLS],
            Tc=1, n_valid=[1] * 8, kind=kind, layout="dt")
        for hist in (0, 256):
            add("attn_prefill_dt", f"B=1 Tc=512 history {hist} KH=32 G=1 D={D}",
                main=kind == "q8_0" and hist == 0, B=1, KH=32, G=1, D=D,
                T=1024, starts=[hist], Tc=512, n_valid=[512], kind=kind,
                layout="dt")
        add("attn_prefill_dt", glabel, kind=kind, layout="dt", **grouped)
    add("attn_decode_dt", "B=8 KH=4 G=8 D=64 T=512 fills 1..511 (TinyLlama)",
        B=8, KH=4, G=8, D=64, T=512, starts=FILLS, Tc=1, n_valid=[1] * 8,
        kind="f16", layout="dt")
    return cases


def attn_check(gen, kname, kw, win=0, cap=0.0):
    """Run flash_attention on one case: it must launch `kname` once and
    match attention_reference on every row that attends. Returns (case,
    args, cfg, max abs err, rel err)."""
    c = attn_case(gen, **kw)
    cfg = attn_cfg(kw["D"], cap)
    args = (c["q"], c["cache"], c["li"], c["slot_ids"], c["q_pos"],
            c["n_valid"], c["k_new"], c["v_new"], cfg)
    before = dict(FA.LAUNCHES)
    y = FA.flash_attention(*args, rot_cache=True, win=win)
    ref = LL.attention_reference(*args, rot_cache=True, win=win)
    torch.cuda.synchronize()
    went = {k: FA.LAUNCHES[k] - before[k] for k in before}
    if went != {k: int(k == kname) for k in before}:
        raise AssertionError(f"{kname} case launched {went}")
    # a row at n_valid=0 with no history attends to nothing and the
    # engine discards it; every other row is held to the plain version
    live = (c["n_valid"] > 0) | (c["starts"] > 0)
    err = float((y[live] - ref[live]).abs().max())
    rel = err / float(ref[live].abs().max())
    if not (torch.isfinite(y).all() and err <= ATTN_TOL):
        raise AssertionError(f"{kname} {kw}: max abs err {err:.3e} > {ATTN_TOL}")
    return c, args, cfg, err, rel


def attn_phase(timer: Timer, gen) -> list[dict]:
    rows = []
    D = 128
    # window + softcap + ragged n_valid, in both layouts: correctness only,
    # small shapes
    extra = [("attn_decode", 48, 30.0, dict(B=3, KH=4, G=2, D=D, T=256,
                                            starts=[0, 100, 255], Tc=1,
                                            n_valid=[1] * 3)),
             ("attn_prefill", 48, 30.0, dict(B=2, KH=4, G=2, D=D, T=256,
                                             starts=[0, 90], Tc=100,
                                             n_valid=[100, 61])),
             ("attn_decode", 0, 0.0, dict(B=2, KH=4, G=2, D=D, T=256,
                                          starts=[5, 200], Tc=1, n_valid=[1, 1],
                                          kind="f32"))]
    for kind in ("q8_0", "q4_0", "f32"):
        extra += [("attn_decode_dt", 48, 30.0, dict(
                      B=3, KH=4, G=2, D=D, T=256, starts=[0, 100, 255], Tc=1,
                      n_valid=[1] * 3, kind=kind, layout="dt")),
                  ("attn_prefill_dt", 48, 30.0, dict(
                      B=2, KH=4, G=2, D=D, T=320, starts=[0, 90], Tc=100,
                      n_valid=[100, 61], kind=kind, layout="dt"))]
    for kname, win, cap, kw in extra:
        *_, err, rel = attn_check(gen, kname, kw, win, cap)
        log(f"{kname} check window={win} softcap={cap} B={kw['B']} "
            f"{kw.get('kind', 'f16')} {kw.get('layout', 'td')}: max_abs_err "
            f"{err:.3e} rel {rel:.3e} (tol {ATTN_TOL} abs)")
    for kname, shape, kw, main in attn_cases(D):
        c, args, cfg, err, rel = attn_check(gen, kname, kw)
        Tc = kw["Tc"]
        bytes_, flops = attn_bytes_flops(c, Tc)
        bound = max(bytes_ / HBM_BYTES_S, flops / F32_FLOPS_S) * 1e3
        qs, kk, vv, mask = sdpa_inputs(c, Tc)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = timer(lambda: sdpa(qs, kk, vv, attn_mask=mask))
        row = dict(kernel=kname, shape=shape, main=main, max_abs_err=err,
                   max_rel_err=rel, tol_abs=ATTN_TOL,
                   ms=timer(lambda: FA.flash_attention(*args, rot_cache=True)),
                   plain_ms=timer(lambda: LL.attention_reference(
                       *args, rot_cache=True)),
                   library_ms=lib, bound_ms=bound, bytes=bytes_, flops=flops,
                   bound_by="bytes" if bytes_ / HBM_BYTES_S >= flops / F32_FLOPS_S
                   else "operations")
        log(f"{kname} {shape}: max_abs_err {err:.3e} rel {rel:.3e} "
            f"(tol {ATTN_TOL} abs) "
            f"kernel_ms {row['ms']:.4f} bound_ms {bound:.4f} ({row['bound_by']}) "
            f"library_ms {lib:.4f} (sdpa) plain_ms {row['plain_ms']:.4f}")
        rows.append(row)
        del c, args, qs, kk, vv, mask
    return rows


# ------------------------------------------------------------------ model
def model_phase(path: str) -> dict:
    from tpu_engine_torch.kvcache.cache import new_cache
    from tpu_engine_torch.model.loader import load_model

    t0 = time.time()
    lm = load_model(path, device="cuda")
    torch.cuda.synchronize()
    log(f"model: loaded {path} in {time.time() - t0:.1f}s "
        f"(llama2-7b widths, {lm.cfg.n_layer} layers: depth cut from 32)")
    cfg = lm.cfg
    rng = np.random.default_rng(7)
    prompt = rng.integers(300, cfg.n_vocab, 128).tolist()
    dev = "cuda"

    def run(kind, feed=None):
        cache = new_cache(cfg.n_layer, 1, 512, cfg.n_kv_head, cfg.head_dim,
                          kind=kind, layout=default_layout(kind, cfg.head_dim),
                          device=dev)
        one = torch.zeros((1,), dtype=torch.int32, device=dev)
        act = torch.ones((1,), dtype=torch.bool, device=dev)
        logits, cache, _ = LL.forward_step(
            lm.weights, cache, torch.tensor([prompt], dtype=torch.int32,
                                            device=dev), one, act, cfg,
            n_valid=torch.tensor([128], dtype=torch.int32, device=dev),
            rot_cache=True)
        rows, toks = [logits[0]], []
        for i in range(16):
            nxt = int(torch.argmax(logits[0])) if feed is None else feed[i]
            toks.append(nxt)
            logits, cache, _ = LL.forward_step(
                lm.weights, cache, torch.tensor([[nxt]], dtype=torch.int32,
                                                device=dev), one, act, cfg,
                rot_cache=True)
            rows.append(logits[0])
        torch.cuda.synchronize()
        return torch.stack(rows).float(), toks

    out = {}
    # f16 ("td"): every kernel against every plain version. q8_0/q4_0
    # ("dt"): the attention kernels against attention_reference with the
    # qmm kernels in both runs, so both runs quantize the same K/V rows
    # of the first layer
    for kind in ("f16", "q8_0", "q4_0"):
        t0 = time.time()
        k_logits, toks = run(kind)
        t_kernel = time.time() - t0
        if kind == "f16":
            W.set_qmatmul_impl(DM.qmatmul_plain)
        LL.set_attention_impl(LL.attention_reference)
        try:
            t0 = time.time()
            p_logits, _ = run(kind, feed=toks)  # teacher-forced on the kernel's tokens
            t_plain = time.time() - t0
        finally:
            W.set_qmatmul_impl(None)
            LL.set_attention_impl(None)
        if not torch.isfinite(k_logits).all() or k_logits.shape != (17, cfg.n_vocab):
            raise AssertionError(f"model phase {kind}: non-finite or misshapen logits")
        top1 = float((k_logits.argmax(-1) == p_logits.argmax(-1)).float().mean())
        dmax = float((k_logits - p_logits).abs().max())
        rel = dmax / float(p_logits.abs().max())
        log(f"model {kind} ({default_layout(kind, cfg.head_dim)}): prefill 128 + "
            f"16 greedy decode steps; top-1 agreement kernels vs plain "
            f"{top1:.4f} (need 1.0); max |dlogit| {dmax:.3e} = {rel:.3e} of max "
            f"|logit| (bound {LOGIT_TOL}); wall {t_kernel:.2f}s kernels, "
            f"{t_plain:.2f}s plain")
        if top1 < 1.0 or rel > LOGIT_TOL:
            raise AssertionError(f"model phase {kind}: kernels disagree with "
                                 "plain versions")
        out[kind] = dict(top1=top1, max_dlogit=dmax, rel_dlogit=rel,
                         wall_s_kernels=t_kernel, wall_s_plain=t_plain)
    del lm
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- server
def _post(base, path, body, timeout=900.0):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _stream(base, body, timeout=900.0):
    req = urllib.request.Request(base + "/v1/chat/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    t0 = time.time()
    ttft, chunks = None, []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            payload = line[6:]
            if payload == b"[DONE]":
                break
            c = json.loads(payload)
            if ttft is None and c.get("choices") and \
                    c["choices"][0]["delta"].get("content"):
                ttft = time.time() - t0
            chunks.append(c)
    return chunks, ttft


def server_phase(path: str, smi: str) -> dict:
    from tpu_engine_torch.api.server import make_server
    from tpu_engine_torch.gguf.reader import read_gguf
    from tpu_engine_torch.tokenizer import Tokenizer

    g = read_gguf(path)
    tok = Tokenizer.from_gguf_metadata(g.metadata)
    g.close()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    srv = make_server("127.0.0.1", port, device="cuda")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    # count the engine's context shifts (kvcache.shift_compact calls) and
    # the cache they ran on
    shifts = []
    real_shift = OPS.shift_compact

    def counting_shift(cache, *a, **kw):
        shifts.append((cache.kind, cache.layout, cache.k.device.type))
        return real_shift(cache, *a, **kw)

    OPS.shift_compact = counting_shift
    try:
        out = {}
        for cache_type in ("f16", "q8_0", "q4_0"):
            shifts.clear()
            out[cache_type] = server_cycle(srv, base, path, tok, cache_type,
                                           smi)
            out[cache_type]["context_shifts"] = list(shifts)
            if cache_type == "q8_0" and not any(
                    sh == ("q8_0", "dt", "cuda") for sh in shifts):
                raise AssertionError("q8_0 cycle: no context shift of the "
                                     f"quantized dt cache on the card: {shifts}")
            log(f"server {cache_type}: context shifts {shifts}")
    finally:
        OPS.shift_compact = real_shift
        srv.shutdown()
        srv.server_close()
        srv.registry.unload_all()
        th.join(timeout=30)
    return out


def server_cycle(srv, base, path, tok, cache_type, smi) -> dict:
    """/loadmodel at cache_type -> 8 concurrent chats (9 at q8_0: one more
    whose ~480-token prompt plus 64 generated tokens crosses the 512-cell
    slot, so the engine context-shifts it) -> /unloadmodel. Launch counts
    are zeroed just before /loadmodel and read just after /unloadmodel."""
    n_tokens = [20, 60, 110, 160, 210, 270, 330, 400]  # prompt sizes
    if cache_type == "q8_0":
        n_tokens.append(480)
    for k in DM.LAUNCHES:
        DM.LAUNCHES[k] = 0
    for k in FA.LAUNCHES:
        FA.LAUNCHES[k] = 0
    t0 = time.time()
    status, resp = _post(base, "/loadmodel", {
        "llama_model_path": path, "model": "smoke", "n_parallel": 8,
        "ctx_len": 4096, "cache_type": cache_type})
    if status != 200:
        raise AssertionError(f"/loadmodel {cache_type}: {status} {resp}")
    t_load = time.time() - t0
    # the engine's cache follows default_layout: at head_dim 128, "td" for
    # f16 (attn_decode/attn_prefill) and "dt" for q8_0/q4_0
    # (attn_decode_dt/attn_prefill_dt)
    engine = srv.registry.get("smoke").engine
    cache = engine.ops.cache
    layout = default_layout(cache_type, engine.cfg.head_dim)
    if (cache.kind, cache.layout) != (cache_type, layout):
        raise AssertionError(f"{cache_type}: engine cache {cache.kind} "
                             f"{cache.layout}, want {layout}")
    del engine, cache
    log(f"server {cache_type} ({layout}): /loadmodel {t_load:.1f}s (load + "
        "warm-up)")
    after_load = {**DM.LAUNCHES, **FA.LAUNCHES}
    bodies = [_chat_body(tok, i, n) for i, n in enumerate(n_tokens)]
    results = [None] * len(bodies)

    def worker(i):
        t_s = time.time()
        if bodies[i]["stream"]:
            chunks, ttft = _stream(base, bodies[i])
            results[i] = ("stream", chunks, ttft, time.time() - t_s)
        else:
            results[i] = ("json", _post(base, "/v1/chat/completions",
                                        bodies[i]), None, time.time() - t_s)

    t_burst = time.time()
    ths = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    wall = time.time() - t_burst
    total_completion, ttfts = 0, []
    for i, (kind, res, ttft, lat) in enumerate(results):
        if res is None:
            raise AssertionError(f"{cache_type} request {i}: no response")
        want_prompt = _prompt_tokens(tok, bodies[i])
        if kind == "json":
            status, resp = res
            if status != 200 or resp.get("object") != "chat.completion":
                raise AssertionError(f"request {i}: {status} {resp}")
            usage = resp["usage"]
            finish = resp["choices"][0]["finish_reason"]
            text = resp["choices"][0]["message"]["content"]
        else:
            chunks = res
            usage = [c for c in chunks if c.get("usage")][-1]["usage"]
            finish = [c["choices"][0]["finish_reason"] for c in chunks
                      if c.get("choices")][-1]
            text = "".join(c["choices"][0]["delta"].get("content") or ""
                           for c in chunks if c.get("choices"))
            if ttft is None:
                raise AssertionError(f"stream {i}: no content delta")
            ttfts.append(ttft)
        n_c = usage["completion_tokens"]
        ok = (usage["prompt_tokens"] == want_prompt and 1 <= n_c <= 64
              and usage["total_tokens"] == want_prompt + n_c
              and finish in ("stop", "length")
              and (finish != "length" or n_c == 64)
              and isinstance(text, str))
        if not ok:
            raise AssertionError(f"{cache_type} request {i}: usage {usage} "
                                 f"(prompt {want_prompt}) finish {finish}")
        total_completion += n_c
        log(f"server {cache_type}: request {i} ({kind}): prompt "
            f"{usage['prompt_tokens']} completion {n_c} finish {finish} "
            f"latency {lat:.2f}s")
    after_chat = {**DM.LAUNCHES, **FA.LAUNCHES}
    status, resp = _post(base, "/unloadmodel", {"model": "smoke"})
    if status != 200:
        raise AssertionError(f"/unloadmodel {cache_type}: {status} {resp}")
    launches = {**DM.LAUNCHES, **FA.LAUNCHES}
    chat = {k: after_chat[k] - after_load[k] for k in launches}
    log(f"server {cache_type}: launches over the cycle {launches}; during the "
        f"chat burst {chat}")
    dt = "_dt" if layout == "dt" else ""
    need = ("qmm_nib4", "qmm_i8", "attn_decode" + dt, "attn_prefill" + dt)
    if not all(chat[k] > 0 for k in need):
        raise AssertionError(f"{cache_type}: a kernel of the path was not "
                             f"launched by the chat burst: {chat}")
    other = [k for k in FA.LAUNCHES if k not in need and launches[k]]
    if other:
        raise AssertionError(f"{cache_type}: launched another layout's "
                             f"kernels {other}: {launches}")
    tps = total_completion / wall
    log(f"server {cache_type}: {len(bodies)} requests ({len(bodies) - 2} json, "
        f"2 streamed) in {wall:.2f}s: aggregate {tps:.1f} completion tok/s; "
        f"TTFT (streamed) {', '.join(f'{t:.3f}s' for t in ttfts)} [{smi}]")
    torch.cuda.empty_cache()
    return dict(launches=launches, chat_launches=chat, load_s=t_load,
                wall_s=wall, requests=len(bodies),
                completion_tokens=total_completion, tok_s=tps, ttft_s=ttfts)


def _prompt_tokens(tok, body) -> int:
    """Prompt tokens the engine will count for a chat body (the registry's
    default role prompts; BOS added, no system prefix)."""
    from tpu_engine_torch.api.openai import ModelPrompts, parse_chat_request

    params, _ = parse_chat_request(body, ModelPrompts(), True)
    return len(tok.encode(params.prompt, add_special=True, parse_special=True))


def _chat_body(tok, i: int, n_tokens: int) -> dict:
    """Greedy chat request i whose prompt is the shortest run of words that
    reaches n_tokens tokens; requests 6 and 7 stream."""
    words = ["hello", "world", "the", "quick", "brown", "fox", "jumps",
             "over", "lazy", "dog"]

    def body(n):
        text = " ".join(words[(i + j) % len(words)] for j in range(n))
        return {"model": "smoke", "max_tokens": 64, "temperature": 0,
                "stream": i in (6, 7), "stream_options": {"include_usage": True},
                "messages": [{"role": "user", "content": text}]}

    n = 1
    while _prompt_tokens(tok, body(n)) < n_tokens:
        n += 1
    return body(n)


# ------------------------------------------------------------------- main
FA_SRC = "tpu_engine/kernels/flash_attention.py"
SOURCES = {  # kernel -> (source, the TPU kernel(s) it replaces)
    "qmm_nib4": ("tpu_engine_torch/csrc/qmm.cu",
                 "tpu_engine/kernels/dequant_matmul.py:209"),
    "qmm_i8": ("tpu_engine_torch/csrc/qmm.cu",
               "tpu_engine/kernels/dequant_matmul.py:259"),
    "attn_decode": ("tpu_engine_torch/csrc/attn.cu", f"{FA_SRC}:204"),
    "attn_prefill": ("tpu_engine_torch/csrc/attn.cu", f"{FA_SRC}:875"),
    "attn_decode_dt": ("tpu_engine_torch/csrc/attn_dt.cu",
                       f"{FA_SRC}:411, {FA_SRC}:299"),
    "attn_prefill_dt": ("tpu_engine_torch/csrc/attn_dt.cu", f"{FA_SRC}:960"),
}


def summarize(rows: list[dict], launches: dict) -> list[dict]:
    """One line per kernel: the main-path shape set of a decode step for the
    projections (M=8, summed over the layer's tensors of that kernel); for
    attention the row attn_cases marks (B=8 KH=32 decode at fills 1..511
    and the B=1 Tc=512 history-0 prefill: f16 "td", q8_0 "dt")."""
    out = []
    for name, (src, repl) in SOURCES.items():
        if name.startswith("qmm"):
            sel = [r for r in rows if r["kernel"] == name and r["M"] == 8]
        else:
            sel = [r for r in rows if r["kernel"] == name and r["main"]]
        b_bytes = sum(r["bound_ms"] for r in sel if r["bound_by"] == "bytes")
        out.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=int(launches[name]),
            max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            ms=sum(r["ms"] for r in sel), plain_ms=sum(r["plain_ms"] for r in sel),
            bound_ms=sum(r["bound_ms"] for r in sel),
            bound_by="bytes" if b_bytes * 2 >= sum(r["bound_ms"] for r in sel)
            else "operations",
            library_ms=sum(r["library_ms"] for r in sel)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.time()
    bdir = _build.build_all()
    log(f"kernels: built {sorted(os.listdir(bdir))} in {time.time() - t0:.1f}s "
        f"(nvcc {_build.last_build_seconds:.1f}s, parallel)")
    for f in sorted(os.listdir(bdir)):
        if f.endswith(".log"):
            with open(os.path.join(bdir, f)) as fh:
                for line in fh:
                    if "registers" in line or "spill" in line:
                        log(f"  {f}: {line.strip()}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = Timer(ITERS)
    rows = qmm_phase(timer, gen) + attn_phase(timer, gen)
    detail = {"device": smi, "kernel_rows": rows}
    del timer
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_") as tmp:
        from tpu_engine_torch.tools.q4km import build_q4km_gguf

        path = os.path.join(tmp, "llama2-7b-4l-q4_k_m.gguf")
        t0 = time.time()
        build_q4km_gguf(path, "llama2-7b", n_layer=N_LAYER, seed=0)
        log(f"model: wrote {path} ({os.path.getsize(path) / 1e9:.2f} GB, "
            f"Q4_K_M mix) in {time.time() - t0:.1f}s")
        detail["model"] = model_phase(path)
        detail["server"] = server_phase(path, smi)
    # launches of the main path: the three server cycles, each counted
    # from zero at its /loadmodel to its /unloadmodel
    launches = {k: sum(c["launches"][k] for c in detail["server"].values())
                for k in SOURCES}
    detail["launches"] = launches
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(detail, fh, indent=1)
    print(json.dumps({"kernels": summarize(rows, launches)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
