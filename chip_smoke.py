"""On-card smoke test of tpu_engine_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py            # needs one CUDA card (an H100 here)

Builds every CUDA kernel of the serving path from tpu_engine_torch/csrc,
holds each against its plain PyTorch version (qmm_nib4 and qmm_i8 against
their twin, which rounds to bf16 as they do, with equal bits on repeat)
at the shapes the serving path gives it and times it (tools/timing.py),
at every weight layout of the qmm kernels and a ragged tensor of each,
and, for attention, K stored pre-rotated and unrotated (self-extend),
head_dim 64-256 and query groups of 1-72, and
the decode kernels at the edges of their cell splits (also against
decode_split_plain) and twice on the same inputs (equal bits), and the
prefill kernels at the edges of their cell tiles (equal bits too). Then
runs a Llama-2-7B-width Q4_K_M model (depth cut to 4 layers, random
weights from a seed) once through every kernel against each kernel's
twin, and at f16, q8_0 and q4_0 KV and with self-extend at f16 and q4_0
through the attention kernels against attention_reference; then serves
it over the cortex HTTP flow once per KV cache type and twice more with
self-extend (grp_attn_n 4, grp_attn_w 128) at f16 and q8_0
(/loadmodel -> 8 concurrent /v1/chat/completions, plus one that
context-shifts at q8_0 -> /unloadmodel) and checks that each cycle
launched every kernel of its path and no other attention kernel. Then the
embedding phase: qmm_nib4 / qmm_i8 at the encoders' shapes (N, K 768 and
3072, M 8..2048) in the kernel phase; two full-width embedding models
written here from seed 0 (bge-base widths at Q8_0 through
tools/convert.hf_bert_to_gguf, nomic-embed-v1.5 widths at the Q4_K_M mix),
each encoded at 8..n_ctx_train tokens through the kernels against the
twins and the f32 plain run, then served (/loadmodel model_type
"embedding" -> /v1/embeddings in four input forms -> a refused chat ->
/unloadmodel: vectors equal to the direct encode bit for bit, no
attention kernel launched); and the llama model loaded as an embedding
model, its vector against forward_step's pooling. Any failure raises and
exits non-zero. The last lines are the kernel table as
one JSON object, the card's name and power limit from nvidia-smi, and
{"ok": true, "device": {...}}. Per-shape details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
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
from tpu_engine_torch.model.config import ModelConfig
from tpu_engine_torch.serve import ops as OPS
from tpu_engine_torch.tools.timing import Timer

HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_S = 67e12    # H100 SXM f32 (CUDA cores): attention
BF16_FLOPS_S = 989e12  # H100 SXM dense bf16 (tensor cores): qmm_nib4, qmm_i8
ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
N_LAYER = 4  # depth cut of the Llama-2-7B widths (32 layers) for the smoke
ITERS = 20   # timed launches per kernel shape
QMM_TOL = 1e-4     # max |kernel - twin| / max |twin|: the same roundings,
                   # sum order (and the kernels' bf16x3 bias product)
ATTN_TOL = 2e-4    # max |kernel - plain| (outputs O(1)): f32 sums, sum order
LOGIT_TOL = 2e-3   # max |dlogit| / max |logit| over the model phase
TIE_TOL = 1e-5     # self-extend: one row's top-1 may differ where plain's
                   # logits at the two picks lie within this of max |logit|
SE_DIFF = 1e-2     # self-extend logits differ from rotated ones by more
ATTN_GA = (4, 128)  # self-extend (ga_n, ga_w) of the rope kernel cases


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- kernels
# the values of each i8 type's int8 plane (quant/device_format.py)
I8_RANGE = {"Q8_0": (-128, 128), "Q5_0": (-16, 16), "Q5_1": (0, 32),
            "Q5_K": (0, 32), "Q6_K": (-32, 32), "Q3_K": (-4, 4)}


def rand_qtensor(gen, name, n, k, kind, group, has_bias) -> W.QTensor:
    """Random weights of the layout; an i8 plane spans the values of the
    type that ends `name`."""
    dev = "cuda"
    if kind == "nib4":
        qs = torch.randint(0, 256, (n, k // 2), generator=gen, device=dev,
                           dtype=torch.uint8)
    else:
        lo, hi = I8_RANGE[name.split()[-1]]
        qs = torch.randint(lo, hi, (n, k), generator=gen, device=dev,
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
# every other layout of each kernel (quant/device_format.py LAYOUTS), and
# a nib4 tensor without a bias, on wo's shape; and ragged ones (N, K and
# M off every tile and chunk edge): correctness only
# the embedding models' products (bert-base widths, E=768, F=3072): bge's
# Q8_0, and nomic-embed's Q4_K with its Q6_K attn_v / ffn_down; at the
# encoder's prompt buckets
ENC_QMM = [
    ("wq Q8_0", "i8", 32, False, 768, 768),
    ("w_up Q8_0", "i8", 32, False, 3072, 768),
    ("w_down Q8_0", "i8", 32, False, 768, 3072),
    ("wv Q6_K", "i8", 16, False, 768, 768),
    ("w_down Q6_K", "i8", 16, False, 768, 3072),
    ("wq Q4_K", "nib4", 32, True, 768, 768),
    ("w_up Q4_K", "nib4", 32, True, 3072, 768),
    ("w_down Q4_K", "nib4", 32, True, 768, 3072),
]
ENC_MS = (8, 64, 512, 1024, 2048)
QMM_LAYOUTS = [  # (tensor, kind, group, has_bias, N, K, Ms)
    ("wo Q4_0", "nib4", 32, True, 4096, 4096, (8, 32, 512)),
    ("wo Q4_1", "nib4", 32, True, 4096, 4096, (8, 32, 512)),
    ("wo Q2_K", "nib4", 16, True, 4096, 4096, (8, 32, 512)),
    ("wo nib4 no bias", "nib4", 32, False, 4096, 4096, (8, 32, 512)),
    ("ragged Q4_K", "nib4", 32, True, 1000, 4128, (3, 45, 300)),
    ("wo Q8_0", "i8", 32, False, 4096, 4096, (8, 32, 512)),
    ("wo Q5_K", "i8", 32, True, 4096, 4096, (8, 32, 512)),
    ("wo Q3_K", "i8", 16, False, 4096, 4096, (8, 32, 512)),
    ("ragged Q6_K", "i8", 16, False, 1000, 4128, (3, 45, 300)),
    ("ragged Q5_0", "i8", 32, True, 1000, 4128, (3, 45, 300)),
]


def qmm_check(name, qt, x) -> tuple[float, float]:
    """qmm_cuda against the kernel's plain twin on x, and a second launch
    on x to the same bits; (max abs, rel err)."""
    y = DM.qmm_cuda(x, qt)
    again = DM.qmm_cuda(x, qt)
    ref = DM.qmatmul_twin(x, qt)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not (torch.isfinite(y).all() and rel <= QMM_TOL):
        raise AssertionError(f"qmm {name} M={x.shape[0]}: rel err {rel:.3e} "
                             f"> {QMM_TOL}")
    if not torch.equal(y, again):
        raise AssertionError(f"qmm {name} M={x.shape[0]}: bits differ on repeat")
    return err, rel


def qmm_timed_row(timer: Timer, name, qt, x, w_f32, w_bf16) -> dict:
    """qmm_check on x, then the kernel's, its twin's and cuBLAS's times
    (f32 and bf16 on the pre-dequantized weight) beside the bound."""
    m, (n, k) = x.shape[0], qt.shape
    err, rel = qmm_check(name, qt, x)
    # the kernels read x as bf16, with a bias also its f32 group sums (one
    # more product term a group), and multiply on the tensor cores (bf16
    # rate)
    has_bias = qt.bias is not None
    ng = k // qt.group
    bytes_ = (x.numel() * 2 + qt.nbytes + m * n * 4
              + (m * ng * 4 if has_bias else 0))
    flops = 2.0 * m * n * (k + (ng if has_bias else 0))
    t_ops = flops / BF16_FLOPS_S
    bound = max(bytes_ / HBM_BYTES_S, t_ops) * 1e3
    xb = x.to(torch.bfloat16)
    row = dict(
        kernel="qmm_nib4" if qt.kind == "nib4" else "qmm_i8", tensor=name,
        shape=f"{name} {n}x{k} M={m}", M=m, N=n, K=k, timed=True,
        max_abs_err=err, max_rel_err=rel, tol_rel=QMM_TOL,
        ms=timer(lambda: DM.qmm_cuda(x, qt)),
        plain_ms=timer(lambda: DM.qmatmul_twin(x, qt)),
        library_ms=timer(lambda: torch.matmul(x, w_f32.t())),
        library_bf16_ms=timer(lambda: torch.matmul(xb, w_bf16.t())),
        bound_ms=bound,
        bound_by="bytes" if bytes_ / HBM_BYTES_S >= t_ops else "operations")
    log(f"qmm {row['shape']}: max_abs_err {err:.3e} rel {rel:.3e} "
        f"(tol {QMM_TOL}, equal bits on repeat) kernel_ms "
        f"{row['ms']:.4f} bound_ms {bound:.4f} ({row['bound_by']}) "
        f"library_ms {row['library_ms']:.4f} library_bf16_ms "
        f"{row['library_bf16_ms']:.4f} plain_ms {row['plain_ms']:.4f}")
    return row


def qmm_phase(timer: Timer, gen) -> list[dict]:
    rows = []
    for name, kind, group, has_bias, n, k, ms in QMM_LAYOUTS:
        qt = rand_qtensor(gen, name, n, k, kind, group, has_bias)
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda")
            err, rel = qmm_check(name, qt, x)
            log(f"qmm {name} {n}x{k} M={m} check: max_abs_err {err:.3e} rel "
                f"{rel:.3e} (tol {QMM_TOL}), equal bits on repeat")
            rows.append(dict(
                kernel="qmm_nib4" if kind == "nib4" else "qmm_i8",
                shape=f"{name} {n}x{k} M={m}", M=m, N=n, K=k, timed=False,
                max_abs_err=err, max_rel_err=rel, tol_rel=QMM_TOL))
    # one M per tile configuration of qmm.cu: decode (<= 8), a B=1 prefill
    # bucket (9..64) and a grouped prefill (> 64); at the encoders' widths
    # (ENC_QMM) their buckets 8..2048
    for shapes, ms, encoder in ((QMM_SHAPES, (8, 32, 512), False),
                                (ENC_QMM, ENC_MS, True)):
        for name, kind, group, has_bias, n, k in shapes:
            qt = rand_qtensor(gen, name, n, k, kind, group, has_bias)
            w_f32 = W.dequant(qt)  # the yardsticks' pre-dequantized weight
            w_bf16 = w_f32.to(torch.bfloat16)
            for m in ms:
                x = torch.randn((m, k), generator=gen, device="cuda")
                rows.append(dict(qmm_timed_row(timer, name, qt, x, w_f32,
                                               w_bf16), encoder=encoder))
            del w_f32, w_bf16
    return rows


def attn_cfg(D, softcap=0.0, rope_dim=None):
    """Attention's part of a Llama config at head_dim D: 1/sqrt(D) scale,
    split-half rope over rope_dim (default D), theta 10000."""
    return ModelConfig(
        arch="llama", n_layer=2, n_embd=32 * D, n_head=32, n_kv_head=32,
        head_dim=D, n_ff=4 * D, n_vocab=32, n_ctx_train=4096, rms_eps=1e-5,
        rope_theta=10000.0, rope_dim=rope_dim or D, rope_type="neox",
        attn_logit_softcap=softcap)


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


def attn_bytes_flops(c, Tc, rope_dim=0):
    """Bytes the call must move (q in and out, the in-flight rows, and each
    live cell of K and V once: its Dk stored elements plus, when quantized,
    its 4-byte scale) and the multiply-adds of the attended pairs. With
    rope_dim (a rope kernel): also the cos/sin table rows of the cells
    read (each once: rows share them) and the rotation of each live K
    cell (6 operations per rotated pair)."""
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
    if rope_dim:
        bytes_ += 2 * max(starts) * (rope_dim // 2) * 4
        flops += 6.0 * live * KH * (rope_dim // 2)
    return bytes_, flops


def sdpa_inputs(c, Tc, cfg=None, ga=None):
    """Gathered, dequantized, "td"-ordered and GQA-expanded f32 K/V and the
    boolean mask for the yardstick (made outside its timing). With ga (a
    rope kernel's case): cached K rotated by its remapped cell positions
    here, so the rotation is not in the yardstick's time."""
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
    if ga is not None:
        cell = torch.arange(T, dtype=torch.int32, device="cuda")
        kc = LL.apply_rope(kc.transpose(1, 2), LL.self_extend_pos(
            cell, *ga)[None].expand(B, T), cfg).transpose(1, 2)
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
FILLS_2K = [4, 2047, 148, 1024, 512, 1600, 8, 1200]  # mixed 4..2047


def attn_cases(D=128):
    """(kernel, label, attn_case kwargs, represents the kernel in the
    kernels line) for every timed attention shape of the serving path:
    each with K stored pre-rotated, then again with K stored unrotated
    (the *_rope kernels, self-extend at ATTN_GA)."""
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
    # head_dim 256 at G=2 (Gemma 2's heads): one timed shape per kernel
    wide = dict(KH=8, G=2, D=256)
    for layout, kind in (("td", "f16"), ("dt", "q8_0")):
        sfx = "_dt" if layout == "dt" else ""
        add("attn_decode" + sfx, "B=8 KH=8 G=2 D=256 T=512 fills 1..511",
            B=8, T=512, starts=FILLS, Tc=1, n_valid=[1] * 8, kind=kind,
            layout=layout, **wide)
        add("attn_prefill" + sfx, "B=1 Tc=512 history 0 KH=8 G=2 D=256",
            B=1, T=1024, starts=[0], Tc=512, n_valid=[512], kind=kind,
            layout=layout, **wide)
    # BASELINE config 3's long fill (q8_0 KV decode at fills to ~2k): T=2048
    for kname, kind, layout in (("attn_decode", "f16", "td"),
                                ("attn_decode_dt", "q8_0", "dt")):
        add(kname, f"B=8 KH=32 G=1 D={D} T=2048 fills 4..2047", B=8, KH=32,
            G=1, D=D, T=2048, starts=FILLS_2K, Tc=1, n_valid=[1] * 8,
            kind=kind, layout=layout)
    # 16 query heads per kv head: one timed shape for the "td" pair
    g16 = dict(KH=2, G=16, D=D, kind="f16")
    add("attn_decode", f"B=8 KH=2 G=16 D={D} T=512 fills 1..511", B=8, T=512,
        starts=FILLS, Tc=1, n_valid=[1] * 8, **g16)
    add("attn_prefill", f"B=1 Tc=512 history 0 KH=2 G=16 D={D}", B=1,
        T=1024, starts=[0], Tc=512, n_valid=[512], **g16)
    se = f"ga_n={ATTN_GA[0]} ga_w={ATTN_GA[1]}"
    return cases + [(k + "_rope", f"{label} {se}", kw, main)
                    for k, label, kw, main in cases]


# head shapes checked for correctness in every kernel, layout and kind:
# (KH, G, D) at head_dim 256 (Gemma G=1, Gemma 2 G=2), G=16 at D=128, and
# groups past one block's chunk of query heads (decode 8; prefill 64 rows
# at D <= 128, 32 at D = 256)
HEAD_SHAPES = [(4, 1, 256), (2, 2, 256), (2, 16, 128)]
CHUNKED_HEADS = [(1, 72, 128), (1, 40, 256)]


def head_shape_checks():
    """(kernel, attn_case kwargs) of the correctness-only head-shape grid."""
    out = []
    for (KH, G, D), kinds in [(h, ("f32", "f16", "q8_0", "q4_0"))
                              for h in HEAD_SHAPES] + [
                                  (h, ("f16", "q4_0")) for h in CHUNKED_HEADS]:
        for layout in ("td", "dt"):
            for kind in kinds:
                sfx = "_dt" if layout == "dt" else ""
                head = dict(KH=KH, G=G, D=D, T=256, kind=kind, layout=layout)
                for rope in ("", "_rope"):
                    out.append(("attn_decode" + sfx + rope, dict(
                        B=3, starts=[0, 100, 255], Tc=1, n_valid=[1] * 3,
                        **head)))
                    out.append(("attn_prefill" + sfx + rope, dict(
                        B=2, starts=[0, 90], Tc=100, n_valid=[100, 61],
                        **head)))
    return out


def attn_check(gen, kname, kw, win=0, cap=0.0, ga=ATTN_GA, rope_dim=None):
    """Run flash_attention on one case: it must launch `kname` once and
    match attention_reference on every row that attends. A *_rope kernel
    gets K stored unrotated (rot_cache=False) and the self-extend remap
    ga. Returns (case, args, mode, max abs err, rel err): flash_attention
    and attention_reference take (*args, **mode)."""
    c = attn_case(gen, **kw)
    cfg = attn_cfg(kw["D"], cap, rope_dim)
    rope = kname.endswith("_rope")
    args = (c["q"], c["cache"], c["li"], c["slot_ids"], c["q_pos"],
            c["n_valid"], c["k_new"], c["v_new"], cfg,
            *(ga if rope else (1, 0)))
    mode = dict(rot_cache=not rope, win=win)
    before = dict(FA.LAUNCHES)
    y = FA.flash_attention(*args, **mode)
    ref = LL.attention_reference(*args, **mode)
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
    return c, args, mode, err, rel


def split_checks(gen) -> None:
    """The decode kernels at the edges of their splits of FA.DEC_SPLIT
    cells, in every kind and layout, K rotated and not: fills 0, 1, C - 1,
    C, C + 1 and T - 1, a window whose start falls mid-split and one that
    leaves whole splits below it; each held to attention_reference (by
    attn_check) and to decode_split_plain at the kernel's split, within
    ATTN_TOL."""
    C, T = FA.DEC_SPLIT, 256
    for kind in ("f32", "f16", "q8_0", "q4_0"):
        for layout in ("td", "dt"):
            for win, starts in ((0, [0, 1, C - 1, C, C + 1, T - 1]),
                                (30, [150, T - 1, 40, 17])):
                for rope in ("", "_rope"):
                    kname = "attn_decode" + ("_dt" if layout == "dt" else "") + rope
                    kw = dict(B=len(starts), KH=4, G=2, D=128, T=T,
                              starts=starts, Tc=1, n_valid=[1] * len(starts),
                              kind=kind, layout=layout)
                    c, args, mode, err, _ = attn_check(gen, kname, kw, win)
                    y = FA.flash_attention(*args, **mode)
                    cfg, cache = args[8], c["cache"]
                    tables = (FA.cache_rope_tables(cache, cfg, *ATTN_GA)
                              if rope else None)
                    sp = FA.decode_split_plain(
                        c["q"], cache, c["li"], c["slot_ids"], c["starts"],
                        c["k_new"], c["v_new"], win, cfg.attention_scale(),
                        0.0, tables=tables)
                    err_sp = float((y - sp).abs().max())
                    log(f"{kname} split check C={C} window={win} starts="
                        f"{starts} {kind} {layout}: max_abs_err {err:.3e} "
                        f"(attention_reference), {err_sp:.3e} "
                        f"(decode_split_plain) (tol {ATTN_TOL} abs)")
                    if not err_sp <= ATTN_TOL:
                        raise AssertionError(f"{kname} {kw} window={win}: "
                                             f"decode_split_plain {err_sp:.3e}")


def repeat_checks(gen) -> None:
    """Two launches of each decode kernel on the same inputs (the main
    decode shape) give the same bits: the splits merge in a fixed order."""
    for kname, kind, layout in (("attn_decode", "f16", "td"),
                                ("attn_decode_dt", "q8_0", "dt")):
        for rope in ("", "_rope"):
            kw = dict(B=8, KH=32, G=1, D=128, T=512, starts=FILLS, Tc=1,
                      n_valid=[1] * 8, kind=kind, layout=layout)
            *_, args, mode, _, _ = attn_check(gen, kname + rope, kw)
            y0 = FA.flash_attention(*args, **mode)
            y1 = FA.flash_attention(*args, **mode)
            same = bool(torch.equal(y0, y1))
            log(f"{kname + rope} repeat {kind} {layout}: equal bits {same}")
            if not same:
                raise AssertionError(f"{kname + rope}: two launches differ")


PRE_BN = {128: 64, 256: 32}  # cells per prefill tile by head_dim bound
                             # (attn_common.cuh PreGeo)


def prefill_edge_checks(gen) -> None:
    """The four prefill kernels, every kind, at the edges of their cell
    tiles: histories 0, 1, BN - 1, BN, BN + 1 (and an empty row at
    n_valid = 0) with a chunk that is not a multiple of the query block;
    a window whose start falls mid-tile and one that leaves whole tiles
    below it, with softcap; q4_0's 32-byte cells at D = 64 and a "dt"
    row of T = 201 cells (no 16-byte copies); the 32-cell tiles of D =
    256. Each is held to attention_reference by attn_check, and two
    launches of the first case give equal bits."""
    bn, bn2 = PRE_BN[128], PRE_BN[256]
    edges = [0, 1, bn - 1, bn, bn + 1, 0]
    cases = [  # (window, softcap, attn_case kwargs)
        (0, 0.0, dict(B=6, KH=2, G=2, D=128, T=256, starts=edges, Tc=70,
                      n_valid=[70] * 5 + [0])),
        (40, 30.0, dict(B=3, KH=2, G=2, D=128, T=256, starts=[150, 200, 20],
                        Tc=40, n_valid=[40, 40, 33])),
        (0, 0.0, dict(B=2, KH=2, G=4, D=64, T=201, starts=[17, 130], Tc=50,
                      n_valid=[50, 31])),
        (0, 0.0, dict(B=3, KH=1, G=2, D=256, T=128,
                      starts=[bn2 - 1, bn2, bn2 + 1], Tc=40, n_valid=[40] * 3)),
    ]
    for kind in ("f32", "f16", "q8_0", "q4_0"):
        for layout in ("td", "dt"):
            for rope in ("", "_rope"):
                kname = "attn_prefill" + ("_dt" if layout == "dt" else "") + rope
                for i, (win, cap, kw) in enumerate(cases):
                    kw = dict(kw, kind=kind, layout=layout)
                    *_, args, mode, err, _ = attn_check(gen, kname, kw, win, cap)
                    same = ""
                    if i == 0:
                        y0 = FA.flash_attention(*args, **mode)
                        y1 = FA.flash_attention(*args, **mode)
                        if not torch.equal(y0, y1):
                            raise AssertionError(f"{kname} {kind}: two launches differ")
                        same = ", equal bits on repeat"
                    log(f"{kname} tile-edge check {kind} {layout} window={win} "
                        f"softcap={cap} D={kw['D']} T={kw['T']} starts="
                        f"{kw['starts']} Tc={kw['Tc']} n_valid={kw['n_valid']}: "
                        f"max_abs_err {err:.3e} (tol {ATTN_TOL} abs){same}")


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
    # the same with K stored unrotated (the rope kernels at ATTN_GA)
    extra = [(k, w, c, kw, {}) for k, w, c, kw in extra] + [
        (k + "_rope", w, c, kw, {}) for k, w, c, kw in extra]
    # rope_dim = D/2 (the unrotated tail passes through; a q4_0 pair's
    # partner in another byte) and ga_n = 1 (the identity map)
    for kname, layout in (("attn_decode_rope", "td"),
                          ("attn_prefill_rope", "td"),
                          ("attn_decode_dt_rope", "dt"),
                          ("attn_prefill_dt_rope", "dt")):
        Tc = 1 if "decode" in kname else 100
        kw = dict(B=2, KH=4, G=2, D=D, T=256, starts=[150, 200], Tc=Tc,
                  n_valid=[Tc, Tc // 2 + 1], kind="q4_0", layout=layout)
        extra.append((kname, 0, 0.0, kw, dict(rope_dim=D // 2)))
        if layout == "td":
            extra.append((kname, 0, 0.0, dict(kw, kind="f16"), dict(ga=(1, 0))))
    extra += [(k, 0, 0.0, kw, {}) for k, kw in head_shape_checks()]
    for kname, win, cap, kw, opts in extra:
        *_, err, rel = attn_check(gen, kname, kw, win, cap, **opts)
        log(f"{kname} check window={win} softcap={cap} B={kw['B']} "
            f"KH={kw['KH']} G={kw['G']} D={kw['D']} "
            f"{kw.get('kind', 'f16')} {kw.get('layout', 'td')} {opts}: "
            f"max_abs_err {err:.3e} rel {rel:.3e} (tol {ATTN_TOL} abs)")
    split_checks(gen)
    repeat_checks(gen)
    prefill_edge_checks(gen)
    for kname, shape, kw, main in attn_cases(D):
        c, args, mode, err, rel = attn_check(gen, kname, kw)
        Tc = kw["Tc"]
        rope = kname.endswith("_rope")
        cfg = args[8]
        bytes_, flops = attn_bytes_flops(c, Tc, cfg.rope_dim if rope else 0)
        bound = max(bytes_ / HBM_BYTES_S, flops / F32_FLOPS_S) * 1e3
        qs, kk, vv, mask = sdpa_inputs(c, Tc, cfg, ATTN_GA if rope else None)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = timer(lambda: sdpa(qs, kk, vv, attn_mask=mask))
        row = dict(kernel=kname, shape=shape, main=main, max_abs_err=err,
                   max_rel_err=rel, tol_abs=ATTN_TOL,
                   ms=timer(lambda: FA.flash_attention(*args, **mode)),
                   plain_ms=timer(lambda: LL.attention_reference(
                       *args, **mode)),
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
def qt_cols(qt: W.QTensor, k0: int, k1: int) -> W.QTensor:
    """Columns [k0, k1) of a quantized weight (k0, k1 on group edges)."""
    per = 2 if qt.kind == "nib4" else 1
    g0, g1 = k0 // qt.group, k1 // qt.group
    return W.QTensor(
        qs=qt.qs[:, k0 // per:k1 // per].contiguous(),
        scale=qt.scale[:, g0:g1].contiguous(),
        bias=None if qt.bias is None else qt.bias[:, g0:g1].contiguous(),
        kind=qt.kind, group=qt.group, shape=(qt.shape[0], k1 - k0))


def twin_reordered(x, qt):
    """qmatmul_twin's function with its f32 sums over K in another order:
    the second half of K, then the first, added."""
    k = qt.shape[1]
    h = k // 2 // qt.group * qt.group
    return (DM.qmatmul_twin(x[..., h:], qt_cols(qt, h, k))
            + DM.qmatmul_twin(x[..., :h], qt_cols(qt, 0, h)))


def shadowed_qmatmul(shadow: dict):
    """The kernels' qmatmul, each call also computed by the kernel's twin
    on the same input: shadow counts the calls and keeps the largest
    relative error (max |kernel - twin| / max |twin|)."""
    shadow.update(calls=0, max_rel=0.0)

    def shadowed(x, qt):
        y = DM.qmatmul(x, qt)
        ref = DM.qmatmul_twin(x, qt)
        rel = float((y - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        shadow["calls"] += 1
        shadow["max_rel"] = max(shadow["max_rel"], rel)
        return y
    return shadowed


def zero_launches() -> None:
    for counts in (DM.LAUNCHES, FA.LAUNCHES):
        for k in counts:
            counts[k] = 0


def start_server():
    """The port's HTTP server on a free localhost port, in a thread:
    (server, thread, base URL)."""
    from tpu_engine_torch.api.server import make_server

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    srv = make_server("127.0.0.1", port, device="cuda")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th, f"http://127.0.0.1:{port}"


def stop_server(srv, th) -> None:
    srv.shutdown()
    srv.server_close()
    srv.registry.unload_all()
    th.join(timeout=30)


def model_qmm_run(cfg, run) -> dict:
    """f16 through every kernel, against each kernel's plain twin.

    The qmm kernels round x to bf16 as the TPU kernels do, so a difference of
    one f32 rounding upstream flips some bf16 roundings downstream and
    grows layer by layer: two runs of the same bf16 function whose sums
    differ only in order part by far more than LOGIT_TOL at the output.
    So each quantized product of the kernel run is also computed by its
    twin on the same input, and the kernel is held there to QMM_TOL (every
    call of the 128-token prefill and 16 decode steps, all layers). The
    kernel run's logits are held to the twin run's (twins and
    attention_reference, teacher-forced) by top-1 on every row, and their
    max |dlogit| to twice the twin run's own against a run of
    twin_reordered (the same function, its sums in another order), or
    LOGIT_TOL if that is larger."""
    shadow = {}
    shadowed = shadowed_qmatmul(shadow)
    mode = dict(rot_cache=True)
    before = {**DM.LAUNCHES, **FA.LAUNCHES}
    W.set_qmatmul_impl(shadowed)
    try:
        t0 = time.time()
        k_logits, toks = run("f16", mode)
        t_kernel = time.time() - t0
        went = sorted(k for k in before
                      if {**DM.LAUNCHES, **FA.LAUNCHES}[k] > before[k])
        LL.set_attention_impl(LL.attention_reference)
        t0 = time.time()
        logits = {}
        for name, fn in (("twin", DM.qmatmul_twin),
                         ("reordered", twin_reordered)):
            W.set_qmatmul_impl(fn)
            logits[name], _ = run("f16", mode, feed=toks)
        t_plain = time.time() - t0
    finally:
        W.set_qmatmul_impl(None)
        LL.set_attention_impl(None)
    sfx = "_dt" if default_layout("f16", cfg.head_dim) == "dt" else ""
    if went != ["attn_decode" + sfx, "attn_prefill" + sfx, "qmm_i8", "qmm_nib4"]:
        raise AssertionError(f"model phase qmm: launched {went}")
    if not torch.isfinite(k_logits).all() or k_logits.shape != (17, cfg.n_vocab):
        raise AssertionError("model phase qmm: non-finite or misshapen logits")
    p_logits = logits["twin"]
    pmax = float(p_logits.abs().max())
    rel = float((k_logits - p_logits).abs().max()) / pmax
    floor = float((logits["reordered"] - p_logits).abs().max()) / pmax
    bound = max(LOGIT_TOL, 2 * floor)
    differ = (k_logits.argmax(-1) != p_logits.argmax(-1)).nonzero()[:, 0].tolist()
    log(f"model qmm (f16, all kernels {went}): {shadow['calls']} quantized "
        f"products, max rel err against the twin on the same input "
        f"{shadow['max_rel']:.3e} (tol {QMM_TOL}); logits against the twins' "
        f"run: top-1 rows that differ {differ} (need none), max |dlogit| "
        f"{rel:.3e} of max |logit| {pmax:.4f} (bound {bound:.3e}: twice the "
        f"twins' reordered run's {floor:.3e}, or {LOGIT_TOL}); wall "
        f"{t_kernel:.2f}s kernels, {t_plain:.2f}s plain (two runs)")
    if shadow["max_rel"] > QMM_TOL or differ or rel > bound:
        raise AssertionError("model phase qmm: kernels disagree with twins")
    return dict(calls=shadow["calls"], max_rel_per_call=shadow["max_rel"],
                top1_differ=differ, max_logit=pmax, rel_dlogit=rel,
                rel_dlogit_reordered=floor, bound=bound,
                wall_s_kernels=t_kernel, wall_s_plain=t_plain)


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

    def run(kind, mode, feed=None):
        cache = new_cache(cfg.n_layer, 1, 512, cfg.n_kv_head, cfg.head_dim,
                          kind=kind, layout=default_layout(kind, cfg.head_dim),
                          device=dev)
        one = torch.zeros((1,), dtype=torch.int32, device=dev)
        act = torch.ones((1,), dtype=torch.bool, device=dev)
        logits, cache, _ = LL.forward_step(
            lm.weights, cache, torch.tensor([prompt], dtype=torch.int32,
                                            device=dev), one, act, cfg,
            n_valid=torch.tensor([128], dtype=torch.int32, device=dev),
            **mode)
        rows, toks = [logits[0]], []
        for i in range(16):
            nxt = int(torch.argmax(logits[0])) if feed is None else feed[i]
            toks.append(nxt)
            logits, cache, _ = LL.forward_step(
                lm.weights, cache, torch.tensor([[nxt]], dtype=torch.int32,
                                                device=dev), one, act, cfg,
                **mode)
            rows.append(logits[0])
        torch.cuda.synchronize()
        return torch.stack(rows).float(), toks

    out, rotated = {}, {}
    plain_mode = dict(rot_cache=True)
    # self-extend: K stored unrotated; the 128-token prompt crosses ga_w
    se_mode = dict(ga_n=4, ga_w=64, rot_cache=False)
    out["qmm"] = model_qmm_run(cfg, run)
    # the attention kernels against attention_reference, the quantized
    # products f32 (qmatmul_plain) in both runs: without the qmm kernels' bf16
    # roundings nothing amplifies the sum-order differences, so the gate is
    # PR 3's. q8_0/q4_0 ("dt") runs quantize the same K/V rows of the first
    # layer in both runs; "+se": the rope attention kernels
    for label, kind, mode in (("f16", "f16", plain_mode),
                              ("q8_0", "q8_0", plain_mode),
                              ("q4_0", "q4_0", plain_mode),
                              ("f16+se", "f16", se_mode),
                              ("q4_0+se", "q4_0", se_mode)):
        W.set_qmatmul_impl(DM.qmatmul_plain)
        try:
            before = dict(FA.LAUNCHES)
            t0 = time.time()
            k_logits, toks = run(kind, mode)
            t_kernel = time.time() - t0
            went = {k for k in FA.LAUNCHES if FA.LAUNCHES[k] > before[k]}
            rope = {k for k in FA.LAUNCHES if k.endswith("_rope")}
            # the kernels of the mode's K storage, and no other attention kernel
            other = went - rope if mode is se_mode else went & rope
            if not went or other:
                raise AssertionError(f"model phase {label}: launched {went}")
            LL.set_attention_impl(LL.attention_reference)
            t0 = time.time()
            # teacher-forced on the kernel's tokens
            p_logits, _ = run(kind, mode, feed=toks)
            t_plain = time.time() - t0
        finally:
            W.set_qmatmul_impl(None)
            LL.set_attention_impl(None)
        if not torch.isfinite(k_logits).all() or k_logits.shape != (17, cfg.n_vocab):
            raise AssertionError(f"model phase {label}: non-finite or misshapen logits")
        k_arg, p_arg = k_logits.argmax(-1), p_logits.argmax(-1)
        top1 = float((k_arg == p_arg).float().mean())
        pmax = float(p_logits.abs().max())
        dmax = float((k_logits - p_logits).abs().max())
        rel = dmax / pmax
        # top-1 on every row. Under self-extend one row may take the other
        # pick of a tie in the plain run itself: plain's logits at the two
        # picks within TIE_TOL of max |logit|, a bound that does not grow
        # with the kernels' error
        margin = p_logits.max(-1).values - p_logits.gather(-1, k_arg[:, None])[:, 0]
        differ = [(r, float(margin[r]))
                  for r in (k_arg != p_arg).nonzero()[:, 0].tolist()]
        tie = (mode is se_mode and len(differ) == 1
               and differ[0][1] <= TIE_TOL * pmax)
        need = "1.0" if mode is plain_mode else (
            f"1.0, or one row tied within {TIE_TOL} of max |logit|")
        log(f"model {label} ({default_layout(kind, cfg.head_dim)}, {mode}): "
            f"prefill 128 + 16 greedy decode steps through {sorted(went)}; "
            f"top-1 agreement kernels vs plain {top1:.4f} (need {need}; rows "
            f"that differ (row, plain margin) {differ}, max |logit| "
            f"{pmax:.4f}); max |dlogit| {dmax:.3e} = {rel:.3e} of max |logit| "
            f"(bound {LOGIT_TOL}); "
            f"wall {t_kernel:.2f}s kernels, {t_plain:.2f}s plain")
        if (differ and not tie) or rel > LOGIT_TOL:
            raise AssertionError(f"model phase {label}: kernels disagree with "
                                 f"plain versions (rows, plain margins "
                                 f"{differ})")
        out[label] = dict(top1=top1, differ=differ, max_logit=pmax,
                          max_dlogit=dmax, rel_dlogit=rel,
                          wall_s_kernels=t_kernel, wall_s_plain=t_plain)
        if mode is plain_mode:
            rotated[kind] = k_logits
        else:  # the remap must reach the kernels: not the rotated logits
            diff = float((k_logits - rotated[kind]).abs().max())
            rel_diff = diff / float(rotated[kind].abs().max())
            log(f"model {label}: max |dlogit| against the same kind without "
                f"self-extend {rel_diff:.3e} of max |logit| (need > {SE_DIFF})")
            if rel_diff <= SE_DIFF:
                raise AssertionError(f"model phase {label}: self-extend logits "
                                     "equal the rotated path's")
            out[label]["rel_dlogit_vs_rotated"] = rel_diff
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
    from tpu_engine_torch.gguf.reader import read_gguf
    from tpu_engine_torch.tokenizer import Tokenizer

    g = read_gguf(path)
    tok = Tokenizer.from_gguf_metadata(g.metadata)
    g.close()
    srv, th, base = start_server()
    # count the engine's context shifts (kvcache.shift_compact calls), the
    # cache they ran on and whether they re-roped K (rope is None: K
    # stored unrotated, moved as it is)
    shifts = []
    real_shift = OPS.shift_compact

    def counting_shift(cache, *a, rope=None, **kw):
        shifts.append((cache.kind, cache.layout, cache.k.device.type,
                       rope is None))
        return real_shift(cache, *a, rope=rope, **kw)

    OPS.shift_compact = counting_shift
    try:
        out = {}
        # "+se": self-extend (grp_attn_n 4, grp_attn_w 128 inside the
        # 512-cell slot, so the remap fires), K stored unrotated
        for label in ("f16", "q8_0", "q4_0", "f16+se", "q8_0+se"):
            shifts.clear()
            out[label] = server_cycle(srv, base, path, tok, label, smi)
            out[label]["context_shifts"] = list(shifts)
            se = label.endswith("+se")
            if label.startswith("q8_0") and not any(
                    sh == ("q8_0", "dt", "cuda", se) for sh in shifts):
                raise AssertionError(
                    f"{label} cycle: no context shift of the quantized dt "
                    f"cache on the card {'without' if se else 'with'} "
                    f"re-rope: {shifts}")
            log(f"server {label}: context shifts (kind, layout, device, "
                f"no re-rope) {shifts}")
    finally:
        OPS.shift_compact = real_shift
        stop_server(srv, th)
    return out


def server_cycle(srv, base, path, tok, label, smi) -> dict:
    """/loadmodel at cache_type label ("+se": with grp_attn_n 4 and
    grp_attn_w 128) -> 8 concurrent chats (9 at q8_0: one more whose
    ~480-token prompt plus 64 generated tokens crosses the 512-cell slot,
    so the engine context-shifts it) -> /unloadmodel. Launch counts are
    zeroed just before /loadmodel and read just after /unloadmodel."""
    cache_type = label.split("+")[0]
    se = label.endswith("+se")
    n_tokens = [20, 60, 110, 160, 210, 270, 330, 400]  # prompt sizes
    if cache_type == "q8_0":
        n_tokens.append(480)
    zero_launches()
    t0 = time.time()
    status, resp = _post(base, "/loadmodel", {
        "llama_model_path": path, "model": "smoke", "n_parallel": 8,
        "ctx_len": 4096, "cache_type": cache_type,
        **({"grp_attn_n": 4, "grp_attn_w": 128} if se else {})})
    if status != 200:
        raise AssertionError(f"/loadmodel {label}: {status} {resp}")
    t_load = time.time() - t0
    # the engine's cache follows default_layout: at head_dim 128, "td" for
    # f16 (attn_decode/attn_prefill) and "dt" for q8_0/q4_0
    # (attn_decode_dt/attn_prefill_dt); self-extend stores K unrotated
    # (the *_rope kernels of the same layout)
    engine = srv.registry.get("smoke").engine
    cache = engine.ops.cache
    layout = default_layout(cache_type, engine.cfg.head_dim)
    if (cache.kind, cache.layout, engine.ops.rot_cache) != (
            cache_type, layout, not se):
        raise AssertionError(f"{label}: engine cache {cache.kind} "
                             f"{cache.layout} rot_cache "
                             f"{engine.ops.rot_cache}, want {layout}")
    del engine, cache
    log(f"server {label} ({layout}): /loadmodel {t_load:.1f}s (load + "
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
            raise AssertionError(f"{label} request {i}: no response")
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
            raise AssertionError(f"{label} request {i}: usage {usage} "
                                 f"(prompt {want_prompt}) finish {finish}")
        total_completion += n_c
        log(f"server {label}: request {i} ({kind}): prompt "
            f"{usage['prompt_tokens']} completion {n_c} finish {finish} "
            f"latency {lat:.2f}s")
    after_chat = {**DM.LAUNCHES, **FA.LAUNCHES}
    status, resp = _post(base, "/unloadmodel", {"model": "smoke"})
    if status != 200:
        raise AssertionError(f"/unloadmodel {label}: {status} {resp}")
    launches = {**DM.LAUNCHES, **FA.LAUNCHES}
    chat = {k: after_chat[k] - after_load[k] for k in launches}
    log(f"server {label}: launches over the cycle {launches}; during the "
        f"chat burst {chat}")
    sfx = ("_dt" if layout == "dt" else "") + ("_rope" if se else "")
    need = ("qmm_nib4", "qmm_i8", "attn_decode" + sfx, "attn_prefill" + sfx)
    if not all(chat[k] > 0 for k in need):
        raise AssertionError(f"{label}: a kernel of the path was not "
                             f"launched by the chat burst: {chat}")
    # no attention kernel of the other layout or the other K storage
    other = [k for k in FA.LAUNCHES if k not in need and launches[k]]
    if other:
        raise AssertionError(f"{label}: launched attention kernels off its "
                             f"path {other}: {launches}")
    tps = total_completion / wall
    log(f"server {label}: {len(bodies)} requests ({len(bodies) - 2} json, "
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


# ------------------------------------------------------------- embeddings
ENC_COS = 0.999    # cosine of a kernel encode against the f32 plain one
ENC_TOL = 2e-3     # max |dv| / max |v| floor of the kernel-vs-twin bound
NORM_TOL = 1e-4    # | ||v|| - 1 | of a served vector
ENC_MODELS = [  # (label, tools/encoder_gguf.py preset, level, arch)
    ("bge-base Q8_0", "bge-base", "q8_0", "bert"),
    ("nomic-embed-v1.5 Q4_K_M", "nomic-embed-v1.5", "q4_k_m", "nomic-bert"),
]


def enc_products(lm) -> dict:
    """Quantized products an encode launches, by kernel (one a projection
    a layer; the embedding lookup dequantizes rows without a kernel)."""
    out = {"qmm_nib4": 0, "qmm_i8": 0}
    for lw in lm.weights["layers"]:
        for v in lw.values():
            if isinstance(v, W.QTensor) and v.kind != "dense":
                out["qmm_nib4" if v.kind == "nib4" else "qmm_i8"] += 1
    return out


def encode_phase(lm, label: str, timer: Timer) -> dict:
    """Encodes of 8, 128, 512 and n_ctx_train tokens through the kernels,
    each quantized product also computed by its twin on the same input
    (<= QMM_TOL); the vector held to the twins' run within twice the
    twins' own spread under reordered sums (or ENC_TOL of max |v|), to
    the f32 plain run by cosine (>= ENC_COS), finite; an encode launches
    its products on qmm_nib4 / qmm_i8 and no attention kernel. Times: the
    kernel encode and the f32 plain one (tools/timing.py)."""
    from tpu_engine_torch.model.bert import encode

    cfg, dev = lm.cfg, lm.device
    want = enc_products(lm)
    rng = np.random.default_rng(11)
    out = {}
    for n in sorted({min(n, cfg.n_ctx_train) for n in (8, 128, 512)}
                    | {cfg.n_ctx_train}):
        ids = [2] + rng.integers(5, cfg.n_vocab, n - 2).tolist() + [3]
        toks = torch.tensor([ids], dtype=torch.int32, device=dev)
        nv = torch.tensor([n], dtype=torch.int32, device=dev)

        def run():
            return encode(lm.weights, toks, nv, cfg)

        shadow = {}
        shadowed = shadowed_qmatmul(shadow)
        vecs = {}
        before = {**DM.LAUNCHES, **FA.LAUNCHES}
        try:
            for name, fn in (("kernel", shadowed), ("twin", DM.qmatmul_twin),
                             ("reordered", twin_reordered),
                             ("plain", DM.qmatmul_plain)):
                W.set_qmatmul_impl(fn)
                vecs[name] = run()[0].float()
                if name == "kernel":
                    went = {k: v - before[k] for k, v in
                            {**DM.LAUNCHES, **FA.LAUNCHES}.items()}
        finally:
            W.set_qmatmul_impl(None)
        launched = {k: v for k, v in went.items() if v}
        if launched != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"encode {label} n={n}: launched {launched}, "
                                 f"want {want} and no attention kernel")
        k, t = vecs["kernel"], vecs["twin"]
        vmax = float(t.abs().max())
        d = float((k - t).abs().max()) / vmax
        floor = float((vecs["reordered"] - t).abs().max()) / vmax
        bound = max(2 * floor, ENC_TOL)
        p = vecs["plain"]
        cos = float(torch.dot(k, p) / (k.norm() * p.norm()))
        ms = timer(run)
        W.set_qmatmul_impl(DM.qmatmul_plain)
        try:
            plain_ms = timer(run)
        finally:
            W.set_qmatmul_impl(None)
        log(f"encode {label} n={n}: {shadow['calls']} quantized products "
            f"{want}, max rel err against the twin on the same input "
            f"{shadow['max_rel']:.3e} (tol {QMM_TOL}); vector against the "
            f"twins' run max |dv| {d:.3e} of max |v| {vmax:.4f} (bound "
            f"{bound:.3e}: twice the reordered twins' {floor:.3e}, or "
            f"{ENC_TOL}); cosine against f32 plain {cos:.6f} (need >= "
            f"{ENC_COS}); encode_ms {ms:.3f} plain_ms {plain_ms:.3f}")
        if (shadow["max_rel"] > QMM_TOL or d > bound or cos < ENC_COS
                or not all(torch.isfinite(v).all() for v in vecs.values())):
            raise AssertionError(f"encode {label} n={n}: kernels disagree")
        out[n] = dict(products=want, calls=shadow["calls"],
                      max_rel_per_call=shadow["max_rel"], rel_dv=d,
                      rel_dv_reordered=floor, bound=bound, cosine_plain=cos,
                      ms=ms, plain_ms=plain_ms)
    return out


def _post_status(base, path, body):
    """_post that returns an HTTP error's status and body too."""
    try:
        return _post(base, path, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def embed_server_cycle(srv, base, path: str, label: str) -> dict:
    """/loadmodel with model_type "embedding" -> /v1/embeddings in the four
    input forms (one prompt past n_ctx), then eight at once ->
    /v1/chat/completions (refused) -> /unloadmodel, counts zeroed just
    before /loadmodel and read just after /unloadmodel. Then, off the
    counts, each served vector against the engine's direct encode of the
    same ids: equal bits, unit norm. Launches: the warm-up and each
    prompt's products, no attention."""
    from tpu_engine_torch.serve.encoder import EncoderEngine

    zero_launches()
    t0 = time.time()
    status, resp = _post(base, "/loadmodel", {
        "llama_model_path": path, "model": "embed", "model_type": "embedding",
        "ctx_len": 4096})
    if status != 200:
        raise AssertionError(f"/loadmodel {label}: {status} {resp}")
    t_load = time.time() - t0
    engine = srv.registry.get("embed").engine
    if not isinstance(engine, EncoderEngine) or engine.device.type != "cuda":
        raise AssertionError(f"{label}: served by {engine}")
    n_ctx = engine.n_ctx
    rng = np.random.default_rng(13)
    words = "the quick brown fox jumps over the lazy dog hello world"

    def ids(n):
        return [2] + rng.integers(5, engine.cfg.n_vocab, n - 2).tolist() + [3]

    inputs = {"string": words,
              "strings": ["hello world", " ".join([words] * 100)],
              "tokens": ids(100),
              "token_lists": [ids(8), ids(300), ids(n_ctx + 40)]}
    served, t_req = [], {}
    for form, inp in inputs.items():
        t0 = time.time()
        status, resp = _post(base, "/v1/embeddings",
                             {"model": "embed", "input": inp})
        t_req[form] = time.time() - t0
        prompts = inp if form in ("strings", "token_lists") else [inp]
        if status != 200 or len(resp["data"]) != len(prompts):
            raise AssertionError(f"{label} /v1/embeddings {form}: {status}")
        served += [(form, p, d["embedding"]) for p, d in zip(prompts, resp["data"])]
    # eight concurrent requests: they arrive together, one server thread
    # each, and the engine's _encode_lock serialises their encodes
    burst = [ids(n) for n in (8, 16, 40, 64, 100, 200, 300, 500)]
    results = [None] * len(burst)

    def worker(i):
        results[i] = _post(base, "/v1/embeddings",
                           {"model": "embed", "input": burst[i]})

    t0 = time.time()
    ths = [threading.Thread(target=worker, args=(i,)) for i in range(len(burst))]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    t_req["burst of 8"] = time.time() - t0
    for prompt, res in zip(burst, results):
        if res is None or res[0] != 200:
            raise AssertionError(f"{label} concurrent /v1/embeddings: {res}")
        served.append(("concurrent", prompt, res[1]["data"][0]["embedding"]))
    status, resp = _post_status(base, "/v1/chat/completions", {
        "model": "embed", "messages": [{"role": "user", "content": "hi"}]})
    if status != 500 or "embeddings only" not in resp.get("error", ""):
        raise AssertionError(f"{label}: chat on an embedding model gave "
                             f"{status} {resp}")
    status, resp = _post(base, "/unloadmodel", {"model": "embed"})
    if status != 200:
        raise AssertionError(f"/unloadmodel {label}: {status} {resp}")
    launches = {**DM.LAUNCHES, **FA.LAUNCHES}
    per = enc_products(engine.lm)
    want = {k: per.get(k, 0) * (1 + len(served)) for k in launches}
    log(f"server {label}: /loadmodel {t_load:.1f}s (load + warm-up); "
        f"/v1/embeddings {', '.join(f'{f} {t:.3f}s' for f, t in t_req.items())}"
        f"; launches over the cycle {launches} (want {want}: the warm-up and "
        f"{len(served)} encodes)")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    lengths = []
    for form, prompt, vec in served:
        p_ids = engine.prompt_ids(prompt)
        ref = engine.encode_ids(p_ids)
        ref = ref / float(np.linalg.norm(ref))
        got = np.asarray(vec, np.float64).astype(np.float32)
        norm = float(np.linalg.norm(np.asarray(vec, np.float64)))
        lengths.append(len(p_ids))
        if not np.array_equal(got, ref) or abs(norm - 1.0) > NORM_TOL:
            raise AssertionError(
                f"{label} {form} ({len(p_ids)} tokens): served vector differs "
                f"from the direct encode by {np.abs(got - ref).max():.3e}, "
                f"norm {norm:.6f}")
    if max(lengths) != n_ctx:
        raise AssertionError(f"{label}: no prompt reached n_ctx {n_ctx}")
    log(f"server {label}: {len(served)} vectors ({lengths} tokens; the last "
        f"cut to n_ctx {n_ctx}) equal the direct encodes bit for bit, norms "
        f"within {NORM_TOL} of 1; chat refused with 500")
    del engine
    return dict(launches=launches, load_s=t_load, request_s=t_req,
                prompt_tokens=lengths)


def causal_embed_cycle(srv, base, path: str) -> dict:
    """The llama smoke model loaded with model_type "embedding" (served by
    InferenceEngine's embedding path, no warm-up): one /v1/embeddings
    vector against forward_step's pooling of the same ids, padded to the
    engine's prefill bucket, on a fresh cache of the engine's kind."""
    from tpu_engine_torch.kvcache.cache import new_cache

    dev = "cuda"
    zero_launches()
    status, resp = _post(base, "/loadmodel", {
        "llama_model_path": path, "model": "smoke-embed",
        "model_type": "embedding", "ctx_len": 512, "n_parallel": 1})
    if status != 200:
        raise AssertionError(f"/loadmodel llama embedding: {status} {resp}")
    entry = srv.registry.get("smoke-embed")
    engine, lm, cfg = entry.engine, entry.model, entry.model.cfg
    del entry
    ids = np.random.default_rng(17).integers(300, cfg.n_vocab, 100).tolist()
    status, resp = _post(base, "/v1/embeddings",
                         {"model": "smoke-embed", "input": ids})
    if status != 200:
        raise AssertionError(f"llama /v1/embeddings: {status} {resp}")
    status, _ = _post(base, "/unloadmodel", {"model": "smoke-embed"})
    launches = {**DM.LAUNCHES, **FA.LAUNCHES}
    kind = engine.ops.cache.kind
    bucket = next(b for b in engine.prefill_buckets if b >= len(ids))
    cache = new_cache(cfg.n_layer, 1, 512, cfg.n_kv_head, cfg.head_dim,
                      kind=kind, layout=default_layout(kind, cfg.head_dim),
                      device=dev)
    _, _, pooled = LL.forward_step(
        lm.weights, cache,
        torch.tensor([ids + [0] * (bucket - len(ids))], dtype=torch.int32,
                     device=dev),
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.ones((1,), dtype=torch.bool, device=dev), cfg,
        n_valid=torch.tensor([len(ids)], dtype=torch.int32, device=dev),
        collect_hidden=cfg.pooling_type, rot_cache=engine.ops.rot_cache)
    ref = pooled[0].cpu().numpy().astype(np.float64)
    ref = ref / np.linalg.norm(ref)
    got = np.asarray(resp["data"][0]["embedding"])
    d = float(np.abs(got - ref).max())
    log(f"server llama embedding (pooling {cfg.pooling_type}, {kind} cache, "
        f"bucket {bucket}): launches {launches}; served vector against "
        f"forward_step's pooling max |dv| {d:.3e} (tol {QMM_TOL}), equal bits "
        f"{bool(np.array_equal(got, ref))}, norm {np.linalg.norm(got):.6f}")
    if (status != 200 or d > QMM_TOL
            or not all(launches[k] for k in ("qmm_nib4", "qmm_i8"))):
        raise AssertionError("llama embedding cycle failed")
    return dict(launches=launches, max_dv=d, bucket=bucket)


def embedding_phase(tmp: str, smi: str, llama_path: str, timer: Timer) -> dict:
    """For each embedding model (ENC_MODELS, written here at full width from
    seed 0): encode_phase on the card, then embed_server_cycle; then the
    llama smoke model's causal embedding cycle."""
    from tpu_engine_torch.model.loader import load_model
    from tpu_engine_torch.tools import encoder_gguf as EG

    srv, th, base = start_server()
    out = {}
    try:
        for label, preset, level, arch in ENC_MODELS:
            path = os.path.join(tmp, f"{preset}-{level}.gguf")
            t0 = time.time()
            if arch == "bert":  # CLS pooling, as bge
                EG.build_bert_gguf(path, preset, level, seed=0, pooling_type=2)
            else:
                EG.build_nomic_bert_gguf(path, preset, level, seed=0)
            log(f"embedding: wrote {path} ({os.path.getsize(path) / 1e6:.1f} "
                f"MB, {label}, full depth) in {time.time() - t0:.1f}s")
            lm = load_model(path, device="cuda")
            L, E, H, F, V, ctx = EG.PRESETS[preset]
            if (lm.cfg.arch, lm.cfg.n_layer, lm.cfg.n_embd, lm.cfg.n_ff,
                    lm.cfg.n_vocab, lm.cfg.n_ctx_train) != (arch, L, E, F, V, ctx):
                raise AssertionError(f"{label}: loaded {lm.cfg}")
            res = {"pooling": lm.cfg.pooling_type,
                   "products": enc_products(lm),
                   "encode": encode_phase(lm, label, timer)}
            del lm
            res["server"] = embed_server_cycle(srv, base, path, label)
            out[label] = res
        out["llama causal"] = causal_embed_cycle(srv, base, llama_path)
    finally:
        stop_server(srv, th)
    log(f"embedding: per-bucket encode ms (kernels / f32 plain) [{smi}]: " +
        "; ".join(f"{lab} " + ", ".join(
            f"n={n} {r['ms']:.3f}/{r['plain_ms']:.3f}"
            for n, r in out[lab]["encode"].items()) for lab, *_ in ENC_MODELS))
    return out


# ------------------------------------------------------------------- main
FA_SRC = "tpu_engine/kernels/flash_attention.py"
SOURCES = {  # kernel -> (source, the TPU kernel(s) it replaces)
    "qmm_nib4": ("tpu_engine_torch/csrc/qmm.cu",
                 "tpu_engine/kernels/dequant_matmul.py:209, "
                 "scripts/qmm_variants.py:39, scripts/qmm_variants.py:69"),
    "qmm_i8": ("tpu_engine_torch/csrc/qmm.cu",
               "tpu_engine/kernels/dequant_matmul.py:259"),
    "attn_decode": ("tpu_engine_torch/csrc/attn.cu", f"{FA_SRC}:204"),
    "attn_prefill": ("tpu_engine_torch/csrc/attn.cu", f"{FA_SRC}:875"),
    "attn_decode_dt": ("tpu_engine_torch/csrc/attn_dt.cu",
                       f"{FA_SRC}:411, {FA_SRC}:299"),
    "attn_prefill_dt": ("tpu_engine_torch/csrc/attn_dt.cu", f"{FA_SRC}:960"),
    "attn_decode_rope": ("tpu_engine_torch/csrc/attn_rope.cu", f"{FA_SRC}:121"),
    "attn_prefill_rope": ("tpu_engine_torch/csrc/attn_rope.cu", f"{FA_SRC}:875"),
    "attn_decode_dt_rope": ("tpu_engine_torch/csrc/attn_dt_rope.cu",
                            f"{FA_SRC}:299"),
    "attn_prefill_dt_rope": ("tpu_engine_torch/csrc/attn_dt_rope.cu",
                             f"{FA_SRC}:960"),
}


# an encoder layer's products by kernel, as counts of ENC_QMM tensors: bge's
# Q8_0 layer (q, k, v, o; up; down) and nomic-embed's Q6_K pair (v, down
# on its use_more_bits layers) on qmm_i8, nomic-embed's Q4_K layer (q, k,
# v, o; gate, up; down) on qmm_nib4
ENC_LAYERS = {
    "qmm_i8": {"bge Q8_0 layer": {"wq Q8_0": 4, "w_up Q8_0": 1, "w_down Q8_0": 1},
               "nomic Q6_K pair": {"wv Q6_K": 1, "w_down Q6_K": 1}},
    "qmm_nib4": {"nomic Q4_K layer": {"wq Q4_K": 4, "w_up Q4_K": 2,
                                      "w_down Q4_K": 1}},
}


def _sum_rows(sel: list[tuple[dict, int]]) -> dict:
    """Times, bounds and the yardstick summed over (row, multiplicity)."""
    total = sum(r["bound_ms"] * c for r, c in sel)
    b_bytes = sum(r["bound_ms"] * c for r, c in sel if r["bound_by"] == "bytes")
    return dict(ms=sum(r["ms"] * c for r, c in sel),
                plain_ms=sum(r["plain_ms"] * c for r, c in sel),
                bound_ms=total,
                bound_by="bytes" if b_bytes * 2 >= total else "operations",
                library_ms=sum(r["library_ms"] * c for r, c in sel))


def summarize(rows: list[dict], launches: dict) -> list[dict]:
    """One line per kernel: the main-path shape set of a decode step for the
    projections (M=8, summed over the layer's tensors of that kernel); for
    attention the row attn_cases marks (B=8 KH=32 decode at fills 1..511
    and the B=1 Tc=512 history-0 prefill: f16 "td", q8_0 "dt"; the rope
    kernels at the same shapes with self-extend at ATTN_GA). The qmm lines
    carry under "encoder" an encoder layer's products (ENC_LAYERS) at each
    bucket of ENC_MS, with library_ms cuBLAS bf16 on the same shapes."""
    out = []
    for name, (src, repl) in SOURCES.items():
        if name.startswith("qmm"):
            sel = [r for r in rows if r["kernel"] == name and r["M"] == 8
                   and r["timed"] and not r.get("encoder")]
        else:
            sel = [r for r in rows if r["kernel"] == name and r["main"]]
        line = dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=int(launches[name]),
            max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            **_sum_rows([(r, 1) for r in sel]))
        if name in ENC_LAYERS:
            line["encoder"] = []
            for layer, counts in ENC_LAYERS[name].items():
                for m in ENC_MS:
                    enc = [(r, counts[r["tensor"]]) for r in rows
                           if r.get("encoder") and r["M"] == m
                           and r["tensor"] in counts]
                    summ = _sum_rows(enc)
                    summ["library_ms"] = sum(r["library_bf16_ms"] * c
                                             for r, c in enc)
                    line["encoder"].append(dict(layer=layer, M=m, **summ))
        out.append(line)
    return out


def ptxas_usage(text: str) -> list[tuple[str, str, str]]:
    """(kernel, registers, spill line) of each entry function in nvcc's
    -Xptxas -v output; attn:: and qmm kernel names shown with their
    template arguments (attn::prefill_kernel<kind, DT, ROT, DMAX>,
    qmm_kernel<Cfg<format, BN, BM, ...>>)."""
    out, name, spills = [], "?", ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            k = re.match(r"_ZN4attn\d+(\w+?)I(.*)EEvNS_4ArgsE", name)
            if k:
                args = ", ".join(v if t == "i" else ("true" if v == "1" else "false")
                                 for t, v in re.findall(r"L([ib])(\d+)E", k.group(2)))
                name = f"attn::{k.group(1)}<{args}>"
            k = re.search(r"qmm_kernelINS_3CfgINS_\d+(\w+?)E((?:Li\d+E)+)", name)
            if k:
                args = ", ".join(re.findall(r"Li(\d+)E", k.group(2)))
                name = f"qmm_kernel<Cfg<{k.group(1)}, {args}>>"
            spills = ""
        elif "spill stores" in line:
            spills = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((name, m.group(1), spills))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
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
                for name, regs, spills in ptxas_usage(fh.read()):
                    log(f"  {f}: {name}: {regs} registers, {spills}")
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
        detail["embedding"] = embedding_phase(tmp, smi, path, Timer(ITERS))
    # launches of the main path: the five server cycles and the three
    # embedding cycles, each counted from zero at its /loadmodel to its
    # /unloadmodel
    cycles = list(detail["server"].values()) + [
        detail["embedding"][label]["server"] for label, *_ in ENC_MODELS] + [
        detail["embedding"]["llama causal"]]
    launches = {k: sum(c["launches"][k] for c in cycles) for k in SOURCES}
    detail["launches"] = launches
    detail["wall_s"] = time.time() - t_start
    log(f"chip_smoke: every phase in {detail['wall_s']:.1f}s")
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
