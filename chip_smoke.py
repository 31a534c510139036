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
the load phase: the extract kernel (GGUF blocks to the natural layout,
csrc/extract.cu) against extract_plain for the ten quantized formats at
4096x4096 and at 333 rows, bit for bit, timed; the smoke model loaded on
the card by load_model, its quantized tensors against a CPU load's bit
for bit (as each family file's are, right after its load in the family
phase). Then
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
model, its vector against forward_step's pooling. Then
tools/perplexity.py's evaluation of the Llama model (16 windows of 512
tokens of seeded pseudo-text) at f16, q8_0 and q4_0 KV through the
kernels against the twins and attention_reference token by token;
tools/chat.py as a subprocess and in this process (--greedy), its text
against chat.py's loop on the twins; and the multimodal phase: LLaVA
mmproj files at llava-1.5-7b and llava-1.6-vicuna-7b widths and PNGs
written from seeds (decoded back to their arrays), CLIP encodes on the
card against the CPU, the image prefill (unbucketed chunks) on the
kernels against the twins and attention_reference, and two served
cycles (/loadmodel {mmproj} -> a chat with data-URI images ->
/unloadmodel: llava-1.5 at f16, llava-1.6 at q8_0 with two images),
each held to a direct engine run of the same request, plus a refused
[img-1] and a refused projector width. Then the parallel phase: two
ranks as two processes on cuda:0 over gloo, the kernels at a TP=2
rank's shapes (in the kernel phase), TP=2 and DP=2 logits against one
rank, three served grid cycles (tensor_parallel 2 at f16 and q8_0,
data_parallel 2) held to the 1x1 cycles token by token, and a 1x1 mesh
through the TP path. Last, the family phase, with a torch generator and
numpy seeds of its own: the kernels at the shapes of four more families
(tools/family_gguf.py: gemma2, qwen2, phi3, llama3.1 at their published
widths, cut to 2 layers), then each family's file written and loaded on
the card, held as the Llama model is (model_qmm_run, near-ties allowed;
attn_model_run at f16 and q8_0 KV; gemma2 and phi3 past their windows,
and apart from the run with the window off), and gemma2 (f16) and qwen2
(q8_0, with a context shift) served through /loadmodel, each served
token teacher-forced through the twins. Then the grid phase, with seeds
of its own (two ranks on cuda:0 over gloo): qmm_nib4 / qmm_i8 at a TP=2
phi3 rank's shapes; phi3 (written again by the family phase's writer)
at TP=2, its logits against one rank and a served tensor_parallel 2
cycle against a 1x1 cycle token by token; llava-1.5 image chats (the
multimodal phase's mmproj and image) at tensor_parallel 2 and
data_parallel 2 against 1x1; nomic-embed at tensor_parallel 2, served
whole with no process and equal bit for bit; the Llama model as an
embedding model at TP=2 and DP=2 against 1x1. Then the sampling phase,
with seeds of its own: the device sampler's kept candidate sets and
probabilities on the Llama model's prefill rows against the host chain
(with and without penalties over a filled ring), 65536 draws from one
row against the host's probabilities, a served burst of 8 that mixes
the lanes (free requests, a grammar in the device bank, a json_schema,
a recursive grammar, a seed, logprobs), each request's lane checked,
and a data_parallel 2 cycle at temperature 0.8 against 1x1 with the
sampler seed fixed. Any failure raises and exits non-zero. The last lines are the kernel table as
one JSON object, the card's name and power limit from nvidia-smi, and
{"ok": true, "device": {...}}. Per-shape details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import io
import json
import math
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
from tpu_engine_torch.kernels import extract as EX
from tpu_engine_torch.kernels import flash_attention as FA
from tpu_engine_torch.kvcache.cache import (QUANT_KINDS, KVCache, default_layout,
                                            dequant_kv, quantize_kv_rows)
from tpu_engine_torch.model import llama as LL
from tpu_engine_torch.model import weights as W
from tpu_engine_torch.model.config import ModelConfig
from tpu_engine_torch.serve import ops as OPS
from tpu_engine_torch.tools import family_gguf as FG
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


def qmm_timed_row(timer: Timer, name, qt, x, w_f32, w_bf16, smi="") -> dict:
    """qmm_check on x, then the kernel's, its twin's and cuBLAS's times
    (f32 and bf16 on the pre-dequantized weight) beside the bound; smi:
    the card's name and power limit, for the log line."""
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
        f"{row['library_bf16_ms']:.4f} plain_ms {row['plain_ms']:.4f}"
        + (f" [{smi}]" if smi else ""))
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
    # perplexity's output product: a window's 256 hidden rows, cast to bf16
    name, kind, group, has_bias, n, k = QMM_SHAPES[4]  # output Q6_K
    qt = rand_qtensor(gen, name, n, k, kind, group, has_bias)
    w_f32 = W.dequant(qt)
    x = torch.randn((256, k), generator=gen, device="cuda").to(torch.bfloat16)
    rows.append(dict(qmm_timed_row(timer, name, qt, x.float(), w_f32,
                                   w_f32.to(torch.bfloat16)), perplexity=True))
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


def attn_bytes_flops(c, Tc, rope_dim=0, win=0):
    """Bytes the call must move (q in and out, the in-flight rows, and each
    live cell of K and V once: its Dk stored elements plus, when quantized,
    its 4-byte scale) and the multiply-adds of the attended pairs. With
    rope_dim (a rope kernel): also the cos/sin table rows of the cells
    read (each once: rows share them) and the rotation of each live K
    cell (6 operations per rotated pair). With a window: a cell is live
    when some query row of its slot sees it (a row at position p sees
    positions p - win + 1 .. p)."""
    q, cache = c["q"], c["cache"]
    B, _, H, D = q.shape
    KH = c["k_new"].shape[1]
    starts = c["starts"].tolist()
    nv = c["n_valid"].tolist()
    Dk = cache.k.shape[3 if cache.layout == "dt" else 4]
    cell = Dk * cache.k.element_size() + (4 if cache.quantized else 0)
    live = sum(min(s, win - 1) for s in starts) if win else sum(starts)
    bytes_ = (q.numel() * 4 * 2 + 2 * c["k_new"].numel() * 4
              + 2 * live * KH * cell)
    keys = 0  # attended keys summed over query rows (data-dependent)
    for b in range(B):
        for t in range(Tc):
            if win:  # cached cells from position lo, in-flight rows from lo
                lo = starts[b] + t - win + 1
                keys += (starts[b] - min(max(lo, 0), starts[b])
                         + max(0, min(t + 1, nv[b]) - max(lo - starts[b], 0)))
            else:
                keys += starts[b] + min(t + 1, nv[b])
    flops = 4.0 * keys * H * D
    if rope_dim:
        bytes_ += 2 * max(starts) * (rope_dim // 2) * 4
        flops += 6.0 * live * KH * (rope_dim // 2)
    return bytes_, flops


def sdpa_inputs(c, Tc, cfg=None, ga=None, win=0):
    """Gathered, dequantized, "td"-ordered and GQA-expanded f32 K/V and the
    boolean mask (with win: of the window too) for the yardstick (made
    outside its timing). With ga (a rope kernel's case): cached K rotated
    by its remapped cell positions here, so the rotation is not in the
    yardstick's time."""
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
    if win:
        q_pos = st[:, None, None] + t[None, :, None]
        m_cache = m_cache & (cell[None, None, :] > q_pos - win)
        m_new = m_new & (t[None, None, :] > t[None, :, None] - win)
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
    # the multimodal and perplexity paths: an image's remainder chunk after
    # 512 cells (llava-1.5: Tc 64), a llava-1.6 image's ragged remainder in
    # the q8_0 "dt" cache, and perplexity's last 128-token sub-chunk of 8
    # windows over 384 stored cells
    add("attn_prefill", f"B=1 Tc=64 history 520 KH=32 G=1 D={D} (image)",
        B=1, KH=32, G=1, D=D, T=2048, starts=[520], Tc=64, n_valid=[64])
    add("attn_prefill_dt", f"B=1 Tc=216 history 1560 KH=32 G=1 D={D} (image)",
        B=1, KH=32, G=1, D=D, T=4096, starts=[1560], Tc=216, n_valid=[216],
        kind="q8_0", layout="dt")
    for kname, kind, layout in (("attn_prefill", "f16", "td"),
                                ("attn_prefill_dt", "q8_0", "dt")):
        add(kname, f"B=8 Tc=128 history 384 KH=32 G=1 D={D} (perplexity)",
            B=8, KH=32, G=1, D=D, T=512, starts=[384] * 8, Tc=128,
            n_valid=[128] * 8, kind=kind, layout=layout)
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
        rows.append(attn_timed_row(timer, gen, kname, shape, kw, main))
    return rows


def attn_timed_row(timer: Timer, gen, kname, shape, kw, main, win=0,
                   cap=0.0, repeat=False, smi="") -> dict:
    """attn_check on one case (window win, softcap cap), then the kernel's,
    attention_reference's and sdpa's times beside the bound (sdpa takes
    the window in its mask and has no softcap). repeat: a second launch
    must give the same bits. smi: the card's name and power limit, for
    the log line."""
    c, args, mode, err, rel = attn_check(gen, kname, kw, win, cap)
    if repeat and not torch.equal(FA.flash_attention(*args, **mode),
                                  FA.flash_attention(*args, **mode)):
        raise AssertionError(f"{kname} {shape}: two launches differ")
    Tc = kw["Tc"]
    rope = kname.endswith("_rope")
    cfg = args[8]
    bytes_, flops = attn_bytes_flops(c, Tc, cfg.rope_dim if rope else 0, win)
    bound = max(bytes_ / HBM_BYTES_S, flops / F32_FLOPS_S) * 1e3
    qs, kk, vv, mask = sdpa_inputs(c, Tc, cfg, ATTN_GA if rope else None, win)
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
        f"(tol {ATTN_TOL} abs{', equal bits on repeat' if repeat else ''}) "
        f"kernel_ms {row['ms']:.4f} bound_ms {bound:.4f} ({row['bound_by']}) "
        f"library_ms {lib:.4f} (sdpa) plain_ms {row['plain_ms']:.4f}"
        + (f" [{smi}]" if smi else ""))
    return row


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
    from tpu_engine_torch.dist import multihost

    for counts in (DM.LAUNCHES, FA.LAUNCHES, EX.LAUNCHES):
        for k in counts:
            counts[k] = 0
    multihost.FOLLOWER_LAUNCHES.clear()


def grid_launches() -> dict:
    """This process's kernel launches plus those its grids' followers
    reported at /unloadmodel (the load's extract among them)."""
    from tpu_engine_torch.dist import multihost

    return {k: n + multihost.FOLLOWER_LAUNCHES.get(k, 0)
            for k, n in {**DM.LAUNCHES, **FA.LAUNCHES,
                         **EX.LAUNCHES}.items()}


def start_server(devices=None, backend=None):
    """The port's HTTP server on a free localhost port, in a thread:
    (server, thread, base URL). devices / backend: a grid's ranks."""
    from tpu_engine_torch.api.server import make_server

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    srv = make_server("127.0.0.1", port, device="cuda", devices=devices,
                      backend=backend)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th, f"http://127.0.0.1:{port}"


def stop_server(srv, th) -> None:
    srv.shutdown()
    srv.server_close()
    srv.registry.unload_all()
    th.join(timeout=30)


def model_qmm_run(cfg, run, label: str = "model", ties: bool = False) -> dict:
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
    LOGIT_TOL if that is larger. ties: a row's top-1 may differ where the
    twins' logits at the two picks lie within that bound (a near-tie the
    bf16 function flips under any change of sum order)."""
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
        raise AssertionError(f"{label} phase qmm: launched {went}")
    if not torch.isfinite(k_logits).all() or k_logits.shape != (17, cfg.n_vocab):
        raise AssertionError(f"{label} phase qmm: non-finite or misshapen logits")
    p_logits = logits["twin"]
    pmax = float(p_logits.abs().max())
    rel = float((k_logits - p_logits).abs().max()) / pmax
    floor = float((logits["reordered"] - p_logits).abs().max()) / pmax
    bound = max(LOGIT_TOL, 2 * floor)
    k_arg = k_logits.argmax(-1)
    margin = (p_logits.max(-1).values
              - p_logits.gather(-1, k_arg[:, None])[:, 0]) / pmax
    differ = (k_arg != p_logits.argmax(-1)).nonzero()[:, 0].tolist()
    untied = [r for r in differ if not ties or float(margin[r]) > bound]
    need = "each a tie within the bound" if ties else "need none"
    log(f"{label} qmm (f16, all kernels {went}): {shadow['calls']} quantized "
        f"products, max rel err against the twin on the same input "
        f"{shadow['max_rel']:.3e} (tol {QMM_TOL}); logits against the twins' "
        f"run: top-1 rows that differ {differ} (the twins' margins / max "
        f"|logit| {[float(margin[r]) for r in differ]}; {need}), max |dlogit| "
        f"{rel:.3e} of max |logit| {pmax:.4f} (bound {bound:.3e}: twice the "
        f"twins' reordered run's {floor:.3e}, or {LOGIT_TOL}); wall "
        f"{t_kernel:.2f}s kernels, {t_plain:.2f}s plain (two runs)")
    if shadow["max_rel"] > QMM_TOL or untied or rel > bound:
        raise AssertionError(f"{label} phase qmm: kernels disagree with twins")
    return dict(calls=shadow["calls"], max_rel_per_call=shadow["max_rel"],
                top1_differ=differ, max_logit=pmax, rel_dlogit=rel,
                rel_dlogit_reordered=floor, bound=bound,
                wall_s_kernels=t_kernel, wall_s_plain=t_plain)


def prompt_run(lm, segs, max_len: int):
    """run(kind, mode, feed=None, timing=None) over a prompt of segments,
    ("t", token ids) or ("i", image tokens [n, E] on the card), each fed in
    chunks of at most 512 at its exact length (images as embeddings, as
    the engine's _prefill_segment with n_batch 512), then 16 greedy decode
    steps (feed: teacher-forced tokens). Returns (logits [17, V] f32,
    tokens); timing, a list, gets the prefill's wall seconds."""
    from tpu_engine_torch.kvcache.cache import new_cache

    cfg, dev = lm.cfg, "cuda"

    def run(kind, mode, feed=None, timing=None):
        cache = new_cache(cfg.n_layer, 1, max_len, cfg.n_kv_head, cfg.head_dim,
                          kind=kind, layout=default_layout(kind, cfg.head_dim),
                          device=dev)
        one = torch.zeros((1,), dtype=torch.int32, device=dev)
        act = torch.ones((1,), dtype=torch.bool, device=dev)
        torch.cuda.synchronize()
        t0 = time.time()
        for k, d in segs:
            for off in range(0, len(d), 512):
                c = min(512, len(d) - off)
                toks = (torch.tensor([d[off:off + c]], dtype=torch.int32,
                                     device=dev) if k == "t" else
                        torch.zeros((1, c), dtype=torch.int32, device=dev))
                logits, cache, _ = LL.forward_step(
                    lm.weights, cache, toks, one, act, cfg,
                    n_valid=torch.tensor([c], dtype=torch.int32, device=dev),
                    embd=None if k == "t" else d[None, off:off + c], **mode)
        torch.cuda.synchronize()
        if timing is not None:
            timing.append(time.time() - t0)
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
    return run


def attn_model_run(cfg, run, label, kind, mode, se: bool):
    """The attention kernels against attention_reference on run's prompt,
    the quantized products f32 (qmatmul_plain) in both runs: without the
    qmm kernels' bf16 roundings nothing amplifies the sum-order
    differences, so the gate is LOGIT_TOL. q8_0/q4_0 ("dt") runs quantize the
    same K/V rows of the first layer in both runs; se: the rope attention
    kernels. Returns (result, the kernel run's logits)."""
    W.set_qmatmul_impl(DM.qmatmul_plain)
    try:
        before = dict(FA.LAUNCHES)
        t0 = time.time()
        k_logits, toks = run(kind, mode)
        t_kernel = time.time() - t0
        went = {k for k in FA.LAUNCHES if FA.LAUNCHES[k] > before[k]}
        rope = {k for k in FA.LAUNCHES if k.endswith("_rope")}
        # the kernels of the mode's K storage, and no other attention kernel
        other = went - rope if se else went & rope
        if not went or other:
            raise AssertionError(f"{label} phase {kind}: launched {went}")
        LL.set_attention_impl(LL.attention_reference)
        t0 = time.time()
        # teacher-forced on the kernel's tokens
        p_logits, _ = run(kind, mode, feed=toks)
        t_plain = time.time() - t0
    finally:
        W.set_qmatmul_impl(None)
        LL.set_attention_impl(None)
    if not torch.isfinite(k_logits).all() or k_logits.shape != (17, cfg.n_vocab):
        raise AssertionError(f"{label} phase {kind}: non-finite or misshapen logits")
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
    tie = se and len(differ) == 1 and differ[0][1] <= TIE_TOL * pmax
    need = ("1.0, or one row tied within "
            f"{TIE_TOL} of max |logit|") if se else "1.0"
    log(f"{label} {kind} ({default_layout(kind, cfg.head_dim)}, {mode}): "
        f"prefill + 16 greedy decode steps through {sorted(went)}; "
        f"top-1 agreement kernels vs plain {top1:.4f} (need {need}; rows "
        f"that differ (row, plain margin) {differ}, max |logit| "
        f"{pmax:.4f}); max |dlogit| {dmax:.3e} = {rel:.3e} of max |logit| "
        f"(bound {LOGIT_TOL}); "
        f"wall {t_kernel:.2f}s kernels, {t_plain:.2f}s plain")
    if (differ and not tie) or rel > LOGIT_TOL:
        raise AssertionError(f"{label} phase {kind}: kernels disagree with "
                             f"plain versions (rows, plain margins {differ})")
    return dict(top1=top1, differ=differ, max_logit=pmax, max_dlogit=dmax,
                rel_dlogit=rel, wall_s_kernels=t_kernel,
                wall_s_plain=t_plain), k_logits


def model_phase(path: str) -> dict:
    from tpu_engine_torch.model.loader import load_model

    t0 = time.time()
    lm = load_model(path, device="cuda")
    torch.cuda.synchronize()
    log(f"model: loaded {path} in {time.time() - t0:.1f}s "
        f"(llama2-7b widths, {lm.cfg.n_layer} layers: depth cut from 32)")
    cfg = lm.cfg
    rng = np.random.default_rng(7)
    prompt = rng.integers(300, cfg.n_vocab, 128).tolist()
    run = prompt_run(lm, [("t", prompt)], 512)

    out, rotated = {}, {}
    plain_mode = dict(rot_cache=True)
    # self-extend: K stored unrotated; the 128-token prompt crosses ga_w
    se_mode = dict(ga_n=4, ga_w=64, rot_cache=False)
    out["qmm"] = model_qmm_run(cfg, run)
    for label, kind, mode in (("f16", "f16", plain_mode),
                              ("q8_0", "q8_0", plain_mode),
                              ("q4_0", "q4_0", plain_mode),
                              ("f16+se", "f16", se_mode),
                              ("q4_0+se", "q4_0", se_mode)):
        out[label], k_logits = attn_model_run(cfg, run, "model", kind, mode,
                                              mode is se_mode)
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
    shifts = []
    real_shift = OPS.shift_compact
    OPS.shift_compact = counting_shift(shifts)
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


def counting_shift(shifts: list):
    """OPS.shift_compact that also counts the engine's context shifts
    (kvcache.shift_compact calls) in `shifts`: the cache each ran on and
    whether it re-roped K (rope is None: K stored unrotated, moved as it
    is)."""
    real_shift = OPS.shift_compact

    def shift(cache, *a, rope=None, **kw):
        shifts.append((cache.kind, cache.layout, cache.k.device.type,
                       rope is None))
        return real_shift(cache, *a, rope=rope, **kw)
    return shift


SERVED_PROMPTS = [20, 60, 110, 160, 210, 270, 330, 400]  # prompt tokens


def server_cycle(srv, base, path, tok, label, smi, grid=None,
                 extra=None) -> dict:
    """/loadmodel at cache_type label ("+se": with grp_attn_n 4 and
    grp_attn_w 128) -> 8 concurrent chats (9 at q8_0 without a grid: one
    more whose ~480-token prompt plus 64 generated tokens crosses the
    512-cell slot, so the engine context-shifts it) -> /unloadmodel.
    Launch counts are zeroed just before /loadmodel and read just after
    /unloadmodel; a grid's (the /loadmodel fields `grid`, e.g.
    {"tensor_parallel": 2}) include its followers'. With a grid, the
    ranks' state must agree (verify_state) and every follower must have
    exited after /unloadmodel. Each request's generated token ids are
    read from the engine's slots. extra(engine), if given, runs after the
    chats (and verify_state), before /unloadmodel; its result is the
    cycle's "extra"."""
    from tpu_engine_torch.dist import multihost

    cache_type = label.split("+")[0]
    se = label.endswith("+se")
    n_tokens = list(SERVED_PROMPTS)
    if cache_type == "q8_0" and grid is None:
        n_tokens.append(480)
    zero_launches()
    t0 = time.time()
    status, resp = _post(base, "/loadmodel", {
        "llama_model_path": path, "model": "smoke", "n_parallel": 8,
        "ctx_len": 4096, "cache_type": cache_type, **(grid or {}),
        **({"grp_attn_n": 4, "grp_attn_w": 128} if se else {})})
    if status != 200:
        raise AssertionError(f"/loadmodel {label}: {status} {resp}")
    t_load = time.time() - t0
    if not EX.LAUNCHES["extract"]:
        raise AssertionError(f"/loadmodel {label}: no tensor was extracted "
                             "on the card")
    # the engine's cache follows default_layout: at head_dim 128, "td" for
    # f16 (attn_decode/attn_prefill) and "dt" for q8_0/q4_0
    # (attn_decode_dt/attn_prefill_dt); self-extend stores K unrotated
    # (the *_rope kernels of the same layout)
    entry = srv.registry.get("smoke")
    engine = entry.engine
    procs = entry.grid.procs if entry.grid is not None else []
    if bool(procs) != bool(grid) or not all(p.is_alive() for p in procs):
        raise AssertionError(f"{label}: grid {grid} has followers {procs}")
    cache = engine.ops.cache
    layout = default_layout(cache_type, engine.cfg.head_dim)
    if (cache.kind, cache.layout, engine.ops.rot_cache) != (
            cache_type, layout, not se):
        raise AssertionError(f"{label}: engine cache {cache.kind} "
                             f"{cache.layout} rot_cache "
                             f"{engine.ops.rot_cache}, want {layout}")
    del cache
    log(f"server {label} ({layout}): /loadmodel {t_load:.1f}s (load + "
        f"warm-up{', followers spawned' if grid else ''})")
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

    # each request's generated token ids, kept when its slot is released
    from tpu_engine_torch.serve.slot import Slot

    released, real_release = {}, Slot.release

    def release(slot):
        released[tuple(slot.prompt_tokens)] = list(slot.generated_tokens)
        real_release(slot)

    Slot.release = release
    t_burst = time.time()
    try:
        ths = [threading.Thread(target=worker, args=(i,))
               for i in range(len(bodies))]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
    finally:
        Slot.release = real_release
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
    ids = [_prompt_ids(tok, b) for b in bodies]
    generated = [released.get(tuple(i)) for i in ids]
    if any(g is None for g in generated[:len(SERVED_PROMPTS)]):
        raise AssertionError(f"{label}: a request's tokens were not kept")
    state = None
    if grid:
        # every rank sampled the same tokens from the same logits, bit for
        # bit; lengths agree in each group
        if not multihost.verify_engine(engine):
            raise AssertionError(f"{label}: the ranks' state diverged: "
                                 f"{engine.ops.last_state}")
        state = engine.ops.last_state
        log(f"server {label}: verify_state ok: every rank sampled the same "
            f"{state['tokens']} tokens and computed the same logits bit for "
            f"bit at every step")
    extra_out = None if extra is None else extra(engine)
    del engine, entry
    status, resp = _post(base, "/unloadmodel", {"model": "smoke"})
    if status != 200:
        raise AssertionError(f"/unloadmodel {label}: {status} {resp}")
    import multiprocessing

    if any(p.is_alive() for p in procs) or multiprocessing.active_children():
        raise AssertionError(f"{label}: a process outlived /unloadmodel")
    launches = grid_launches()
    chat = {k: after_chat[k] - after_load[k] for k in after_chat}
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
                completion_tokens=total_completion, tok_s=tps, ttft_s=ttfts,
                prompt_ids=ids, generated=generated, state=state,
                extra=extra_out)


def _prompt_ids(tok, body) -> list[int]:
    """The prompt token ids the engine will feed for a chat body (the
    registry's default role prompts; BOS added, no system prefix)."""
    from tpu_engine_torch.api.openai import ModelPrompts, parse_chat_request

    params, _ = parse_chat_request(body, ModelPrompts(), True)
    return tok.encode(params.prompt, add_special=True, parse_special=True)


def _prompt_tokens(tok, body) -> int:
    return len(_prompt_ids(tok, body))


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


# ------------------------------------------------------------- perplexity
PPL_CTX = 512      # perplexity windows: 16 of 512 tokens, 8 a forward
PPL_WINDOWS = 16
NLL_TOL = 2e-2     # floor of the max |dNLL| bound (nats): twice the
                   # reordered twins' own max |dNLL|, or this
TOP1_FLOOR = 4     # floor of the bound on tokens whose top-1 differs from
                   # the twins': twice the reordered twins' count, or this


def ppl_ids(tok) -> list[int]:
    """PPL_WINDOWS windows of tokens of pseudo-text made from seed 0 out of
    the port's _WORDS, as scripts/ppl_gate.py makes its text."""
    import random

    from tpu_engine_torch.tools.synthetic import _WORDS

    rng = random.Random(0)
    n = PPL_WINDOWS * PPL_CTX
    text = " ".join(rng.choice(_WORDS) for _ in range(2 * n))
    ids = tok.encode(text, add_special=True, parse_special=False)
    if len(ids) < n:
        raise AssertionError(f"perplexity text has {len(ids)} < {n} tokens")
    return ids[:n]


def _scored(lm, ids, kind):
    """(per-token NLL, top-1, logits [n, V] on the card) over every scored
    token of tools/perplexity's score_windows on ids."""
    from tpu_engine_torch.tools import perplexity as PPL

    real, kept = PPL.window_logits, []

    def keep(*a):
        kept.append(real(*a))
        return kept[-1]

    nll, top = [], []
    PPL.window_logits = keep
    try:
        for *_, scored in PPL.score_windows(lm, ids, PPL_CTX, kind):
            nll += [a for a, _ in scored]
            top += [b for _, b in scored]
    finally:
        PPL.window_logits = real
    return (np.concatenate(nll).astype(np.float64), np.concatenate(top),
            torch.cat(kept))


def perplexity_phase(lm, smi: str) -> dict:
    """tools/perplexity's evaluation (128-token sub-chunks over the stored
    cache, 8 windows a forward, bf16 hidden rows into the output product)
    at f16, q8_0 and q4_0 KV through the kernels, counts zeroed before
    and read after each, against the same evaluation on the twins and
    attention_reference, token by token. Perplexity on random weights is
    noise, so the gate is token by token, each bound twice the reordered
    twins' own (the twins' function, its sums in another order) or a
    floor: max |dNLL| (NLL_TOL), max |dlogit| / max |logit| (LOGIT_TOL)
    and the tokens whose top-1 differs (TOP1_FLOOR). The logits are
    bf16, so one sum-order difference flips exact ties: top-1 cannot
    agree on every token."""
    ids = ppl_ids(lm.tokenizer)

    def reordered(x, qt):  # the twin's function, its f32 sums reordered
        return twin_reordered(x.float(), qt).to(x.dtype)

    out, launches = {}, {k: 0 for k in SOURCES}
    for kind in ("f16", "q8_0", "q4_0"):
        zero_launches()
        t0 = time.time()
        k_nll, k_top, k_lg = _scored(lm, ids, kind)  # NLL pulled: synced
        wall = time.time() - t0
        got = {**DM.LAUNCHES, **FA.LAUNCHES}
        for k in launches:
            launches[k] += got[k]
        went = sorted(k for k in got if got[k])
        sfx = "_dt" if default_layout(kind, lm.cfg.head_dim) == "dt" else ""
        # forward_step's default: K stored unrotated, the rope kernels
        need = sorted(["qmm_nib4", "qmm_i8", f"attn_prefill{sfx}_rope"])
        if went != need:
            raise AssertionError(f"perplexity {kind}: launched {went}, "
                                 f"want {need}")
        plain = {}
        LL.set_attention_impl(LL.attention_reference)
        try:
            for name, fn in (("twin", DM.qmatmul_twin), ("reordered", reordered)):
                W.set_qmatmul_impl(fn)
                plain[name] = _scored(lm, ids, kind)
        finally:
            W.set_qmatmul_impl(None)
            LL.set_attention_impl(None)
        (t_nll, t_top, t_lg), (r_nll, r_top, r_lg) = (plain["twin"],
                                                       plain["reordered"])
        d_k = float(np.abs(k_nll - t_nll).max())
        d_r = float(np.abs(r_nll - t_nll).max())
        bound = max(NLL_TOL, 2 * d_r)
        pmax = float(t_lg.abs().max())
        l_k = float((k_lg - t_lg).abs().max()) / pmax
        l_r = float((r_lg - t_lg).abs().max()) / pmax
        lbound = max(LOGIT_TOL, 2 * l_r)
        n_k, n_r = int((k_top != t_top).sum()), int((r_top != t_top).sum())
        nbound = max(TOP1_FLOOR, 2 * n_r)
        del k_lg, t_lg, r_lg, plain
        res = dict(tokens=int(k_nll.size), ppl=math.exp(k_nll.mean()),
                   ppl_plain=math.exp(t_nll.mean()), max_dnll=d_k,
                   max_dnll_reordered=d_r, bound=bound, rel_dlogit=l_k,
                   rel_dlogit_reordered=l_r, logit_bound=lbound,
                   top1_differ=n_k, top1_differ_reordered=n_r,
                   top1_bound=nbound, top1=1 - n_k / k_nll.size,
                   wall_s=wall, tok_s=PPL_WINDOWS * PPL_CTX / wall,
                   launches={k: got[k] for k in went})
        log(f"perplexity {kind} ({PPL_WINDOWS} windows of {PPL_CTX}, "
            f"{res['tokens']} scored, kernels {went} x "
            f"{[got[k] for k in went]}): ppl {res['ppl']:.4f} (plain "
            f"{res['ppl_plain']:.4f}); max |dNLL| {d_k:.3e} (bound {bound:.3e}:"
            f" twice the reordered twins' {d_r:.3e}, or {NLL_TOL}); max "
            f"|dlogit| {l_k:.3e} of max |logit| {pmax:.3f} (bound "
            f"{lbound:.3e}: twice the reordered twins' {l_r:.3e}, or "
            f"{LOGIT_TOL}); top-1 differs on {n_k} tokens (agreement "
            f"{res['top1']:.4f}; bound {nbound}: twice the reordered "
            f"twins' {n_r}, or {TOP1_FLOOR}); eval {wall:.2f}s, "
            f"{res['tok_s']:.0f} tok/s [{smi}]")
        if not np.isfinite(k_nll).all() or d_k > bound or l_k > lbound \
                or n_k > nbound:
            raise AssertionError(f"perplexity {kind}: kernels disagree with "
                                 "the plain path")
        out[kind] = res
    out["launches"] = launches
    return out


# ------------------------------------------------------------------- chat
CHAT_PROMPT = "the quick brown fox jumps over the lazy dog and"
CHAT_N = 32


def chat_loop(lm, ids, feed=None):
    """tools/chat.py's loop on lm (cache f32 "td" of 1024 cells, the prompt
    in one forward_step, then one B=1 step a token, greedy on the host):
    (logits rows [n, V] f32, tokens, the text chat.py prints). feed:
    teacher-forced tokens."""
    from tpu_engine_torch.kvcache.cache import new_cache
    from tpu_engine_torch.sampling import Sampler, SamplingParams
    from tpu_engine_torch.tokenizer import StreamDetokenizer

    cfg, tok, dev = lm.cfg, lm.tokenizer, "cuda"
    cache = new_cache(cfg.n_layer, 1, 1024, cfg.n_kv_head, cfg.head_dim,
                      device=dev)
    sampler = Sampler(SamplingParams(temperature=0.0), cfg.n_vocab,
                      eos_id=tok.eos_id)
    for t in ids:
        sampler.accept(t, apply_grammar=False)
    one = torch.zeros((1,), dtype=torch.int32, device=dev)
    act = torch.ones((1,), dtype=torch.bool, device=dev)
    logits, cache, _ = LL.forward_step(
        lm.weights, cache, torch.tensor([ids], dtype=torch.int32, device=dev),
        one, act, cfg)
    rows, toks, text = [], [], ""
    detok = StreamDetokenizer(tok)
    for i in range(CHAT_N if feed is None else len(feed)):
        rows.append(logits[0].float())
        token = (sampler.sample(logits[0].cpu().numpy()) if feed is None
                 else feed[i])
        sampler.accept(token)
        toks.append(token)
        if tok.is_eog(token):
            break
        text += detok.push(token)
        logits, cache, _ = LL.forward_step(
            lm.weights, cache,
            torch.tensor([[token]], dtype=torch.int32, device=dev), one, act,
            cfg)
    return torch.stack(rows), toks, text + detok.flush() + "\n"


def chat_phase(path: str, lm) -> dict:
    """`python -m tpu_engine_torch.tools.chat <gguf> -p ... -n 32 --greedy`
    as a subprocess on the card (exit 0); the same main() in this process
    with the counts zeroed before and read after (the same text; the
    kernels of its path, f32 "td" cache with K unrotated: the rope
    kernels); then chat.py's loop on the kernels (the same text again) and
    on the twins and attention_reference teacher-forced on its tokens, as
    the model phase holds its qmm run: max |dlogit| within twice the
    reordered twins' own spread (or LOGIT_TOL), and a row's top-1 may
    differ only where the twins' two picks lie within that bound (the
    bf16 function flips such near-ties under any change of sum order)."""
    from tpu_engine_torch.tools import chat as CHAT

    args = [path, "-p", CHAT_PROMPT, "-n", str(CHAT_N), "--greedy"]
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "tpu_engine_torch.tools.chat",
                        *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    t_sub = time.time() - t0
    if r.returncode != 0:
        raise AssertionError(f"chat CLI exited {r.returncode}: {r.stderr[-3000:]}")
    summary = [ln for ln in r.stderr.splitlines() if ln.startswith("[")]
    log(f"chat CLI (subprocess, {t_sub:.1f}s): {r.stdout!r}; " + " ".join(summary))
    zero_launches()
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = CHAT.main(args)
    launches = {**DM.LAUNCHES, **FA.LAUNCHES}
    went = sorted(k for k in launches if launches[k])
    need = sorted(["qmm_nib4", "qmm_i8", "attn_prefill_rope", "attn_decode_rope"])
    if rc != 0 or buf.getvalue() != r.stdout or went != need:
        raise AssertionError(f"chat main() in process: rc {rc}, text "
                             f"{buf.getvalue()!r}, launched {went} (want {need})")
    ids = lm.tokenizer.encode(CHAT_PROMPT)
    k_rows, toks, text = chat_loop(lm, ids)
    if text != r.stdout:
        raise AssertionError(f"chat.py's loop gives {text!r}, the CLI {r.stdout!r}")
    rows = {}
    LL.set_attention_impl(LL.attention_reference)
    try:
        for name, fn in (("twin", DM.qmatmul_twin), ("reordered", twin_reordered)):
            W.set_qmatmul_impl(fn)
            rows[name], _, _ = chat_loop(lm, ids, feed=toks)
    finally:
        W.set_qmatmul_impl(None)
        LL.set_attention_impl(None)
    p_rows = rows["twin"]
    pmax = float(p_rows.abs().max())
    rel = float((k_rows - p_rows).abs().max()) / pmax
    floor = float((rows["reordered"] - p_rows).abs().max()) / pmax
    bound = max(LOGIT_TOL, 2 * floor)
    k_arg, p_arg = k_rows.argmax(-1), p_rows.argmax(-1)
    margin = p_rows.max(-1).values - p_rows.gather(-1, k_arg[:, None])[:, 0]
    differ = [(i, float(margin[i]) / pmax)
              for i in (k_arg != p_arg).nonzero()[:, 0].tolist()]
    log(f"chat: {len(toks)} tokens through {went} x "
        f"{[launches[k] for k in went]}; against the twins teacher-forced: "
        f"max |dlogit| {rel:.3e} of max |logit| {pmax:.4f} (bound "
        f"{bound:.3e}: twice the reordered twins' {floor:.3e}, or "
        f"{LOGIT_TOL}); rows whose top-1 differs (row, the twins' margin / "
        f"max |logit|) {differ} (each within the bound)")
    if rel > bound or any(m > bound for _, m in differ):
        raise AssertionError("chat: the CLI's tokens disagree with the twins'")
    return dict(text=r.stdout, tokens=len(toks), summary=summary,
                subprocess_s=t_sub, differ=differ, rel_dlogit=rel,
                rel_dlogit_reordered=floor, bound=bound, launches=launches)


# ------------------------------------------------------------- multimodal
ENC_REL = 1e-4  # max |card encode - CPU f32 encode| / max |CPU encode|:
                # f32 sums in another order over 23 layers
MM_IMAGES = [  # (label, mmproj preset, height, width, seed)
    # 336 square resize: 576 tokens, prefilled as 512 + 64
    ("llava-1.5 500x375", "llava-1.5-7b", 375, 500, 1),
    # grid 1x2 (672x336), an exact fit: 576 + 24 x (48 + 1) = 1752 tokens
    ("llava-1.6 800x400", "llava-1.6-7b", 400, 800, 2),
    # grid 3x1 (336x1008), 8 padding patch rows cropped each side:
    # 576 + 56 x (24 + 1) = 1976 tokens
    ("llava-1.6 300x700", "llava-1.6-7b", 700, 300, 3),
]


def mm_image(seed: int, h: int, w: int) -> np.ndarray:
    """A seeded RGB image: gradients plus noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 3 % 256], -1)
    return np.clip(base + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)


def _median_s(fn, n: int = 3) -> float:
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        ts.append(time.time() - t0)
    return sorted(ts)[n // 2]


def encode_checks(mm_paths: dict, pngs: dict) -> dict:
    """Each image encoded on the card (host clock around a synchronised
    encode_image: PNG decode, resize and normalise on the host, then the
    tiles' batch on the card; the median of 3 after a warm-up, and of the
    host part alone) against the port's f32 CPU encode of the same bytes.
    Returns {label: {"tokens": the card's [n, E], ...}}."""
    from tpu_engine_torch.clipvit.model import (encode_image, load_clip,
                                                preprocess_anyres,
                                                preprocess_image)

    out = {}
    for preset, path in mm_paths.items():
        t0 = time.time()
        gpu = load_clip(path, device="cuda")
        t_load = time.time() - t0
        cpu = load_clip(path, device="cpu")
        for label, pre, *_ in MM_IMAGES:
            if pre != preset:
                continue
            tok = encode_image(gpu, pngs[label])
            ms = _median_s(lambda: encode_image(gpu, pngs[label])) * 1e3
            prep = preprocess_anyres if gpu.cfg.is_anyres else preprocess_image
            host_ms = _median_s(lambda: prep(pngs[label], gpu.cfg)) * 1e3
            t0 = time.time()
            ref = encode_image(cpu, pngs[label])
            t_cpu = time.time() - t0
            rel = float((tok.cpu() - ref).abs().max()) / float(ref.abs().max())
            log(f"multimodal: encode {label} ({preset}, mmproj on the card "
                f"in {t_load:.1f}s): {tuple(tok.shape)} image tokens, max "
                f"|card - CPU f32| {rel:.3e} of max |token| (bound {ENC_REL});"
                f" encode {ms:.1f} ms with the card ({host_ms:.1f} of them "
                f"decode + resize on the host), {t_cpu * 1e3:.0f} ms on the "
                f"CPU")
            if tok.shape != ref.shape or not torch.isfinite(tok).all() \
                    or rel > ENC_REL:
                raise AssertionError(f"encode {label}: card disagrees with CPU")
            out[label] = dict(tokens=tok, n=int(tok.shape[0]), rel_err=rel,
                              encode_ms=ms, host_ms=host_ms,
                              cpu_ms=t_cpu * 1e3)
        del gpu, cpu
    return out


def _split_cells(tok, prompt: str, images: list) -> int:
    """Cells the engine's _launch_multimodal gives a prompt: its text
    pieces' tokens plus each image's tokens."""
    pieces = re.split(r"\[img-(\d+)\]", prompt)
    n = 0
    for j, part in enumerate(pieces):
        if j % 2 == 0:
            n += len(tok.encode(part, add_special=(j == 0), parse_special=True)) \
                if part else 0
        else:
            n += images[int(part)]
    return n


def mm_server_cycle(srv, base, path, lm, mm_path, clip, label, cache_type,
                    parts, n_parallel, ctx_len, stream, bad_ref=False) -> dict:
    """/loadmodel {mmproj, cache_type} -> one greedy /v1/chat/completions
    whose user content interleaves text and data-URI PNG images (parts:
    str or PNG bytes) [-> one that names [img-1] with one image: refused]
    -> /unloadmodel, counts zeroed just before /loadmodel and read just
    after /unloadmodel. Then, off the counts: the completion equals a
    direct InferenceEngine run of the same request, and usage counts the
    image tokens."""
    from tpu_engine_torch.api.openai import ModelPrompts, parse_chat_request
    from tpu_engine_torch.clipvit.model import encode_image
    from tpu_engine_torch.serve.engine import InferenceEngine

    content = [{"type": "text", "text": p} if isinstance(p, str) else
               {"type": "image_url", "image_url": {
                   "url": "data:image/png;base64," + base64.b64encode(p).decode()}}
               for p in parts]
    body = {"model": "llava", "max_tokens": 32, "temperature": 0,
            "stream": stream, "stream_options": {"include_usage": True},
            "messages": [{"role": "user", "content": content}]}
    load = {"llama_model_path": path, "model": "llava", "mmproj": mm_path,
            "cache_type": cache_type, "n_parallel": n_parallel,
            "ctx_len": ctx_len, "n_batch": 512}
    zero_launches()
    t0 = time.time()
    status, resp = _post(base, "/loadmodel", load)
    if status != 200:
        raise AssertionError(f"/loadmodel {label}: {status} {resp}")
    t_load = time.time() - t0
    engine = srv.registry.get("llava").engine
    n_ctx = engine.slot_ctx * n_parallel
    if engine.clip is None or engine.clip.device.type != "cuda" or (
            engine.cache.kind, engine.cache.layout) != (
            cache_type, default_layout(cache_type, engine.cfg.head_dim)):
        raise AssertionError(f"{label}: engine clip / cache not as loaded")
    del engine
    t0 = time.time()
    if stream:
        chunks, ttft = _stream(base, body)
        usage = [c for c in chunks if c.get("usage")][-1]["usage"]
        text = "".join(c["choices"][0]["delta"].get("content") or ""
                       for c in chunks if c.get("choices"))
        timings = {}
    else:
        status, resp = _post(base, "/v1/chat/completions", body)
        if status != 200:
            raise AssertionError(f"{label}: chat {status} {resp}")
        usage, ttft = resp["usage"], None
        text = resp["choices"][0]["message"]["content"]
        timings = resp.get("timings", {})
    latency = time.time() - t0
    refused = None
    if bad_ref:
        img = next(c for c in content if c["type"] == "image_url")
        bad = dict(body, stream=False, messages=[{"role": "user", "content": [
            {"type": "text", "text": "compare [img-1] with"}, img]}])
        status, r = _post_status(base, "/v1/chat/completions", bad)
        want = "prompt references [img-1] but only 1 image(s) were provided"
        if status == 200 or r.get("error") != want:
            raise AssertionError(f"{label}: [img-1] with one image: {status} {r}")
        refused = r["error"]
        log(f"multimodal {label}: [img-1] with one image refused: {status} "
            f"{refused!r}")
    status, resp = _post(base, "/unloadmodel", {"model": "llava"})
    if status != 200:
        raise AssertionError(f"/unloadmodel {label}: {status} {resp}")
    launches = {**DM.LAUNCHES, **FA.LAUNCHES}
    sfx = "_dt" if default_layout(cache_type, lm.cfg.head_dim) == "dt" else ""
    need = ("qmm_nib4", "qmm_i8", "attn_decode" + sfx, "attn_prefill" + sfx)
    other = [k for k in FA.LAUNCHES if k not in need and launches[k]]
    if not all(launches[k] > 0 for k in need) or other:
        raise AssertionError(f"{label}: launches {launches}: want every one "
                             f"of {need} and no other attention kernel")
    # the same request straight into an engine built as the registry built it
    params, _ = parse_chat_request(body, ModelPrompts(), True)
    eng = InferenceEngine(lm, n_ctx=n_ctx, n_parallel=n_parallel, n_batch=512,
                          cache_type=cache_type, clip=clip)
    try:
        tid = eng.request_completion(params)
        direct, final = "", None
        while final is None:
            r = eng.next_result(tid, timeout=600.0)
            if r.error:
                raise AssertionError(f"{label}: direct run: {r.error_message}")
            direct += r.text if stream or r.stop else ""
            final = r if r.stop else None
    finally:
        eng.shutdown()
    cells = _split_cells(lm.tokenizer, params.prompt,
                         [int(encode_image(clip, im).shape[0]) for im in params.images])
    log(f"multimodal {label} ({cache_type}, {n_parallel} slots of "
        f"{n_ctx // n_parallel} cells): /loadmodel {t_load:.1f}s; prompt "
        f"{usage['prompt_tokens']} tokens (text + image tokens: {cells}), "
        f"completion {usage['completion_tokens']}; {text!r}; latency "
        f"{latency:.2f}s" + (f", TTFT {ttft:.3f}s" if ttft is not None else "")
        + (f", served prompt_ms {timings.get('prompt_ms')}" if timings else "")
        + f"; launches {launches}")
    if text != direct or usage["prompt_tokens"] != final.tokens_evaluated \
            or usage["prompt_tokens"] != cells \
            or usage["completion_tokens"] != final.tokens_predicted \
            or final.tokens_predicted < 1:
        raise AssertionError(f"{label}: served {text!r} / {usage}, direct "
                             f"{direct!r} / {final.tokens_evaluated} + "
                             f"{final.tokens_predicted}, cells {cells}")
    torch.cuda.empty_cache()
    return dict(launches=launches, load_s=t_load, latency_s=latency,
                ttft_s=ttft, prompt_tokens=usage["prompt_tokens"],
                image_cells=cells, completion_tokens=usage["completion_tokens"],
                text=text, refused=refused, timings=timings)


def multimodal_phase(tmp: str, path: str, lm, smi: str) -> dict:
    """mmprojs at llava-1.5-7b and llava-1.6-vicuna-7b widths and PNGs,
    written here from seeds; encodes on the card against the CPU; the
    image prefill through the kernels against the twins (qmm) and
    attention_reference (f16 "td" at Tc 512 + 64; q8_0 "dt" with a ragged
    remainder); then the two served cycles and the refused mmproj."""
    from tpu_engine_torch.clipvit.image import decode_rgb
    from tpu_engine_torch.clipvit.model import load_clip
    from tpu_engine_torch.tools import mmproj_gguf as MG

    out = {}
    mm_paths = {}
    for preset in ("llava-1.5-7b", "llava-1.6-7b"):
        mm_paths[preset] = os.path.join(tmp, f"mmproj-{preset}-f16.gguf")
        t0 = time.time()
        MG.build_mmproj_gguf(mm_paths[preset], preset, seed=0)
        log(f"multimodal: wrote {mm_paths[preset]} "
            f"({os.path.getsize(mm_paths[preset]) / 1e9:.2f} GB, {preset} "
            f"widths {MG.PRESETS[preset]}) in {time.time() - t0:.1f}s")
    pngs = {}
    for label, _, h, w, seed in MM_IMAGES:
        arr = mm_image(seed, h, w)
        pngs[label] = MG.write_png(arr)
        if not np.array_equal(decode_rgb(pngs[label]), arr):
            raise AssertionError(f"{label}: the PNG decoder does not give back "
                                 "the array it was written from")
    log(f"multimodal: {len(pngs)} PNGs decoded back to their arrays")
    enc = encode_checks(mm_paths, pngs)
    out["encode"] = {k: {kk: v for kk, v in e.items() if kk != "tokens"}
                     for k, e in enc.items()}

    # the image prefill on the kernels: against the twins (qmm, f16 "td")
    # and attention_reference at f16 (llava-1.5: Tc 512 then 64) and q8_0
    # (llava-1.6: 512 x 3, then a ragged 216)
    tok = lm.tokenizer
    head = tok.encode("USER: look at this", add_special=True, parse_special=True)
    tail = tok.encode(" and describe it. ASSISTANT:", add_special=False,
                      parse_special=True)
    cfg = lm.cfg
    for label, kind in (("llava-1.5 500x375", "f16"), ("llava-1.6 800x400", "q8_0")):
        img = enc[label]["tokens"]
        segs = [("t", head), ("i", img), ("t", tail)]
        T = (len(head) + len(img) + len(tail) + 16 + 63) // 64 * 64
        run = prompt_run(lm, segs, T)
        timing = []
        run(kind, dict(rot_cache=True))  # warm
        run(kind, dict(rot_cache=True), timing=timing)
        res = {"prefill_ms": timing[0] * 1e3,
               "chunks": [min(512, len(img) - o) for o in range(0, len(img), 512)]}
        log(f"multimodal: image prefill {label} ({kind}): "
            f"{len(head)} + {len(img)} (chunks {res['chunks']}) + {len(tail)} "
            f"cells in {res['prefill_ms']:.1f} ms on the kernels [{smi}]")
        if kind == "f16":
            res["qmm"] = model_qmm_run(cfg, run, label=f"image prefill {label}",
                                       ties=True)
        res["attention"], _ = attn_model_run(cfg, run, f"image prefill {label}",
                                             kind, dict(rot_cache=True), False)
        out[f"prefill {label}"] = res

    srv, th, base = start_server()
    try:
        # a projector whose width is not the LLM's: refused at /loadmodel
        bad = os.path.join(tmp, "mmproj-narrow.gguf")
        MG.build_mmproj_gguf(bad, widths=(32, 8, 32, 64, 4, 2, 48))
        status, r = _post_status(base, "/loadmodel", {
            "llama_model_path": path, "model": "llava", "mmproj": bad})
        want = ("embedding dim of the multimodal projector (48) is not equal "
                f"to that of the LLM ({cfg.n_embd}); use the matching mmproj file")
        if status != 400 or r.get("error") != want:
            raise AssertionError(f"narrow mmproj: {status} {r}")
        log(f"multimodal: narrow projector refused: {status} {r['error']!r}")
        out["refused_mmproj"] = r["error"]
        for preset, label, cache_type, parts, n_par, ctx, stream in (
                ("llava-1.5-7b", "llava-1.5 f16", "f16",
                 ["what is in ", pngs["llava-1.5 500x375"], " this picture?"],
                 2, 4096, True),
                ("llava-1.6-7b", "llava-1.6 q8_0", "q8_0",
                 ["compare ", pngs["llava-1.6 800x400"], " with ",
                  pngs["llava-1.6 300x700"], " please"], 2, 8192, False)):
            clip = load_clip(mm_paths[preset], device="cuda")
            out[label] = mm_server_cycle(
                srv, base, path, lm, mm_paths[preset], clip, label, cache_type,
                parts, n_par, ctx, stream, bad_ref=cache_type == "f16")
            del clip
    finally:
        stop_server(srv, th)
    log("multimodal: encode ms (host part) " + ", ".join(
        f"{k} {v['encode_ms']:.1f} ({v['host_ms']:.1f})"
        for k, v in out["encode"].items())
        + "; image prefill ms " + ", ".join(
            f"{k[8:]} {out[k]['prefill_ms']:.1f}" for k in out
            if k.startswith("prefill ")) + f"; TTFT llava-1.5 f16 "
        f"{out['llava-1.5 f16']['ttft_s']:.3f}s [{smi}]")
    return out


# ------------------------------------------------------------------- main
# --------------------------------------------------------------- parallel
PAR_DEVICES = ["cuda:0", "cuda:0"]  # two ranks share the one card (gloo)
TP_PROMPT, TP_STEPS = 512, 64  # TP=2 check: teacher-forced prompt + steps
DP_PROMPT, DP_STEPS = 64, 16   # DP=2 check: 8 slots, 4 a rank
AR_ITERS = 50                  # timed all_reduce calls a shape
# one TP=2 rank's products at Llama-2-7B widths (M=8, a decode step):
# q|k|v, gate|up and the output head at half their rows, wo and w_down at
# half their columns (w_down: K 5504, whole groups of 32, not of 256)
PAR_QMM = [
    ("wqkv Q4_K", "nib4", 32, True, 6144, 4096),
    ("wo Q4_K", "nib4", 32, True, 4096, 2048),
    ("w_gateup Q4_K", "nib4", 32, True, 11008, 4096),
    ("w_down Q4_K", "nib4", 32, True, 4096, 5504),
    ("output Q6_K", "i8", 16, False, 16000, 4096),
    ("w_down Q6_K", "i8", 16, False, 4096, 5504),
]
# and its attention: 16 of the 32 kv heads, at the main path's shapes
_TP_DEC = dict(B=8, KH=16, G=1, D=128, T=512, starts=FILLS, Tc=1,
               n_valid=[1] * 8)
_TP_PRE = dict(B=1, KH=16, G=1, D=128, T=1024, starts=[0], Tc=512,
               n_valid=[512])
PAR_ATTN = [
    ("attn_decode", "f16 td B=8 KH=16 G=1 D=128 T=512 fills 1..511", _TP_DEC),
    ("attn_prefill", "f16 td B=1 Tc=512 history 0 KH=16 G=1 D=128", _TP_PRE),
    ("attn_decode_dt", "q8_0 dt B=8 KH=16 G=1 D=128 T=512 fills 1..511",
     dict(_TP_DEC, kind="q8_0", layout="dt")),
    ("attn_prefill_dt", "q8_0 dt B=1 Tc=512 history 0 KH=16 G=1 D=128",
     dict(_TP_PRE, kind="q8_0", layout="dt")),
]


def par_kernel_rows(timer: Timer, gen) -> list[dict]:
    """Every kernel of a TP=2 rank at the rank's shapes, held against its
    plain version and timed (rows marked tp=2)."""
    rows = []
    for name, kind, group, has_bias, n, k in PAR_QMM:
        qt = rand_qtensor(gen, name, n, k, kind, group, has_bias)
        w_f32 = W.dequant(qt)
        x = torch.randn((8, k), generator=gen, device="cuda")
        rows.append(dict(qmm_timed_row(timer, name + " (TP=2 rank)", qt, x,
                                       w_f32, w_f32.to(torch.bfloat16)), tp=2))
        del w_f32
    for kname, shape, kw in PAR_ATTN:
        rows.append(dict(attn_timed_row(timer, gen, kname,
                                        shape + " (TP=2 rank)", kw, False),
                         tp=2))
    return rows


def tf_logits(fwd, weights, cfg, cache, prompts, steps, feed=None,
              chunk: int = 512):
    """prompts [B][P] prefilled as one row each (chunks of `chunk`), then
    `steps` decode steps of the B slots feeding feed[i] ([B] tokens) or
    each row's greedy pick; K stored rotated. fwd: forward_step or a
    rank's make_tp_functions step. Returns (logits [steps + 1, B, V] f32,
    tokens fed [steps][B])."""
    dev = cache.k.device
    B, P = len(prompts), len(prompts[0])
    sl = torch.arange(B, dtype=torch.int32, device=dev)
    act = torch.ones((B,), dtype=torch.bool, device=dev)
    for off in range(0, P, chunk):
        c = min(chunk, P - off)
        toks = torch.tensor([p[off:off + c] for p in prompts],
                            dtype=torch.int32, device=dev)
        logits, cache, _ = fwd(weights, cache, toks, sl, act, cfg,
                               n_valid=torch.full((B,), c, dtype=torch.int32,
                                                  device=dev), rot_cache=True)
    rows, fed = [logits], []
    for i in range(steps):
        nxt = (logits.argmax(-1).to(torch.int32) if feed is None else
               torch.tensor(feed[i], dtype=torch.int32, device=dev))
        fed.append(nxt.tolist())
        logits, cache, _ = fwd(weights, cache, nxt[:, None], sl, act, cfg,
                               rot_cache=True)
        rows.append(logits)
    _sync(dev)
    return torch.stack(rows).float(), fed


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _kv_cache(cfg, n_slots: int, n_cells: int, device, kind: str = "f16"):
    """A cache of `kind` in the engine's layout for it."""
    from tpu_engine_torch.kvcache.cache import new_cache

    return new_cache(cfg.n_layer, n_slots, n_cells, cfg.n_kv_head,
                     cfg.head_dim, kind=kind,
                     layout=default_layout(kind, cfg.head_dim), device=device)


def _par_rank(rank: int, devices, store: str, path: str, tp_prompt, tp_feed,
              dp_prompts, dp_feed) -> dict:
    """One rank of the model checks, two processes on `devices` (cuda:0
    twice) over gloo:
    TP=2 (the rank's heads, ffn rows and vocab rows; teacher-forced on
    tp_feed over an f16 and a q8_0 KV cache), the all_reduce of tp_sum timed at a decode step's and a
    prefill chunk's width, then DP=2 (the whole model, 4 of the 8 slots;
    teacher-forced on dp_feed). Returns the gathered logits and this
    rank's kernel launches."""
    import statistics

    import torch.distributed as dist

    from tpu_engine_torch.dist import multihost, tp
    from tpu_engine_torch.model.loader import load_model

    multihost.initialize("file://" + store, 2, rank, "gloo", devices,
                         timeout_s=600.0)
    try:
        before = {**DM.LAUNCHES, **FA.LAUNCHES}
        res = {}
        mesh = tp.tp_mesh(2, devices=devices)
        lm = load_model(path, device=mesh.device, sharder=tp.TPSharder(mesh))
        cfg = lm.cfg
        fwd, _ = tp.make_tp_functions(mesh, lm.weights, cfg)
        cache = tp.shard_cache_tp(_kv_cache(cfg, 1, 1024, "meta"), mesh)
        lw = lm.weights["layers"][0]
        res["tp_shapes"] = {k: list(v.shape) for k, v in lw.items()
                            if isinstance(v, W.QTensor)}
        res["tp_shapes"]["output"] = list(lm.weights["output"].shape)
        res["tp_kv_heads"] = int(cache.k.shape[2])
        t0 = time.time()
        res["tp"], _ = tf_logits(fwd, lm.weights, cfg, cache, [tp_prompt],
                                 len(tp_feed), feed=tp_feed)
        res["tp_wall_s"] = time.time() - t0
        cache = tp.shard_cache_tp(_kv_cache(cfg, 1, 1024, "meta", "q8_0"),
                                  mesh)
        res["tp_q8_0"], _ = tf_logits(fwd, lm.weights, cfg, cache,
                                      [tp_prompt], len(tp_feed), feed=tp_feed)
        res["tp_launches"] = {k: n - before[k] for k, n in
                              {**DM.LAUNCHES, **FA.LAUNCHES}.items()}
        for label, shape in (("decode", (8, 1, cfg.n_embd)),
                             ("prefill", (1, 512, cfg.n_embd))):
            x = torch.randn(shape, device=mesh.device)
            ev, wall = [], []
            cuda = x.device.type == "cuda"
            for _ in range(AR_ITERS):
                if cuda:
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                _sync(x.device)
                t0 = time.perf_counter()
                if cuda:
                    s.record()
                LL.tp_sum(x, mesh.model_group)
                if cuda:
                    e.record()
                    e.synchronize()
                    ev.append(s.elapsed_time(e))
                wall.append((time.perf_counter() - t0) * 1e3)
            res[f"allreduce_{label}_ms"] = statistics.median(ev or wall)
            res[f"allreduce_{label}_wall_ms"] = statistics.median(wall)
        del lm, cache, fwd
        mesh = tp.tp_mesh(1, devices=devices, n_data=2)
        lm = load_model(path, device=mesh.device)
        fwd, _ = tp.make_tp_functions(mesh, lm.weights, cfg)
        cache = tp.shard_cache_tp(_kv_cache(cfg, 8, 256, "meta"), mesh)
        res["dp_slots"] = int(cache.n_slots)
        mid = {**DM.LAUNCHES, **FA.LAUNCHES}
        t0 = time.time()
        res["dp"], _ = tf_logits(fwd, lm.weights, cfg, cache, dp_prompts,
                                 len(dp_feed), feed=dp_feed)
        res["dp_wall_s"] = time.time() - t0
        res["dp_launches"] = {k: n - mid[k] for k, n in
                              {**DM.LAUNCHES, **FA.LAUNCHES}.items()}
        return res
    finally:
        dist.destroy_process_group()


def _par_follower(out: str, *args) -> None:
    """Rank 1 of the model checks (a spawned process): its launches and
    shapes go to `out` for rank 0."""
    res = _par_rank(1, *args)
    torch.save({k: v for k, v in res.items()
                if k not in ("tp", "tp_q8_0", "dp")}, out)


def grid_bounds(lm, prompt, feed, kind: str, label: str = "parallel"):
    """The one-rank logits of prompt then feed (teacher-forced) over a
    `kind` KV cache on the kernels ([steps + 1, V]), and two bounds of
    max |dlogit| / max |logit| against them: a grid's (twice the twins'
    spread under reordered sums, or LOGIT_TOL) and a served run's (also
    twice the spread of the engine's schedule)."""
    cfg, dev = lm.cfg, PAR_DEVICES[0]

    def run(chunk=512):
        return tf_logits(LL.forward_step, lm.weights, cfg,
                         _kv_cache(cfg, 1, 1024, dev, kind), [prompt],
                         len(feed), feed=feed, chunk=chunk)[0]

    # a served prompt's logits also follow the engine's schedule: a
    # chunk's own rows are attended in flight (f32), earlier chunks'
    # as stored (bf16, or q8_0). Spread of that: the prompt in one
    # chunk against chunks of 16, on the kernels
    one, c16 = run(), run(chunk=16)
    chunked = float((c16 - one).abs().max()) / float(one.abs().max())
    twins = {}
    try:
        LL.set_attention_impl(LL.attention_reference)
        for name, fn in (("twin", DM.qmatmul_twin),
                         ("reordered", twin_reordered)):
            W.set_qmatmul_impl(fn)
            twins[name] = run()
    finally:
        W.set_qmatmul_impl(None)
        LL.set_attention_impl(None)
    floor = float((twins["reordered"] - twins["twin"]).abs().max()) / \
        float(twins["twin"].abs().max())
    bound = max(LOGIT_TOL, 2 * floor)
    served = max(bound, 2 * chunked)
    log(f"{label}: at {kind} KV the twins' reordered floor {floor:.3e} "
        f"(bound {bound:.3e}); chunks of 16 against one chunk "
        f"{chunked:.3e} (served bound {served:.3e})")
    return one[:, 0], bound, served


def held(label: str, got, ref, bound: float) -> dict:
    """got against ref (logits [..., V]): max |dlogit| / max |logit| within
    bound, and top-1 equal on every row except where ref's logits at the
    two picks lie within bound of max |logit| (a near-tie)."""
    got, ref = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    pmax = float(ref.abs().max())
    rel = float((got - ref).abs().max()) / pmax
    g_arg = got.argmax(-1)
    margin = (ref.max(-1).values - ref.gather(-1, g_arg[:, None])[:, 0]) / pmax
    differ = (g_arg != ref.argmax(-1)).nonzero()[:, 0].tolist()
    untied = [r for r in differ if float(margin[r]) > bound]
    exact = torch.equal(got, ref)
    log(f"parallel {label}: {got.shape[0]} rows of logits; equal bits: "
        f"{exact}; max |dlogit| {rel:.3e} of max |logit| {pmax:.4f} (bound "
        f"{bound:.3e}); top-1 rows that differ {differ} (margins / max "
        f"|logit| {[float(margin[r]) for r in differ]}, each a tie within "
        f"the bound)")
    if not torch.isfinite(got).all() or rel > bound or untied:
        raise AssertionError(f"parallel {label}: disagrees with one rank")
    return dict(rows=got.shape[0], exact=exact, rel_dlogit=rel,
                max_logit=pmax, bound=bound, top1_differ=differ)


def served_sampler(lm, tok, i: int):
    """The host Sampler of served request i (_chat_body's parameters: its
    repeat penalties), with no token accepted yet."""
    from tpu_engine_torch.api.openai import ModelPrompts, parse_chat_request
    from tpu_engine_torch.sampling import Sampler

    params, _ = parse_chat_request(_chat_body(tok, i, SERVED_PROMPTS[i]),
                                   ModelPrompts(), True)
    return Sampler(params.sampling, lm.cfg.n_vocab, eos_id=lm.tokenizer.eos_id)


def trace_served(lm, tok, label: str, kind: str, ref: dict, got: dict,
                 bound: float) -> list:
    """Each request's generated tokens in a grid cycle against the 1x1
    cycle's: equal, or the first differing token is a near-tie. Both runs
    fed the same tokens up to it. `bound` (of max |logit|) is twice the
    larger of the spreads that move a run's logits away from the one-rank
    kernels' logits after that prefix (a `kind` KV cache): the engine's
    prompt chunks, and TP's order of sums. The one run picked a and the
    other b only if the one-rank logits at a and b, after the request's
    repeat penalties over its last tokens (as the samplers apply them),
    lie within that bound."""
    eos = lm.tokenizer.eos_id
    ties = []
    for i, (a, b) in enumerate(zip(ref["generated"], got["generated"])):
        if a == b:
            continue
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        prefix = ref["prompt_ids"][i] + a[:j]
        logits, _ = tf_logits(LL.forward_step, lm.weights, lm.cfg,
                              _kv_cache(lm.cfg, 1, 1024, PAR_DEVICES[0], kind),
                              [prefix], 0)
        row = logits[0, 0].cpu().numpy().copy()
        sampler = served_sampler(lm, tok, i)
        for t in prefix:
            sampler.accept(t, apply_grammar=False)
        m = float(np.abs(row).max())
        sampler._apply_penalties(row)
        ta = a[j] if j < len(a) else eos
        tb = b[j] if j < len(b) else eos
        gap = float(abs(row[ta] - row[tb])) / m
        log(f"parallel {label}: request {i} first differs at generated token "
            f"{j}: {ta} (1x1) vs {tb}; one-rank penalized logits' gap "
            f"{gap:.3e} of max |logit| (bound {bound:.3e}), one rank "
            f"picks {int(row.argmax())}")
        if gap > bound:
            raise AssertionError(f"parallel {label}: request {i} differs from "
                                 "the 1x1 cycle beyond a near-tie")
        ties.append((i, j, gap))
    return ties


def one_by_one_cycle(lm, tok, smi: str) -> dict:
    """The served prompts through an engine on an explicit 1x1 mesh
    (make_tp_functions, no group) and through the plain engine: the same
    generated tokens. Launches are counted over the mesh engine's run."""
    from tpu_engine_torch.api.openai import ModelPrompts, parse_chat_request
    from tpu_engine_torch.dist import tp
    from tpu_engine_torch.serve import InferenceEngine

    params = [parse_chat_request(_chat_body(tok, i, n), ModelPrompts(),
                                 True)[0] for i, n in enumerate(SERVED_PROMPTS)]
    out = {}
    for label, mesh in (("plain", None),
                        ("1x1 mesh", tp.tp_mesh(1, devices=PAR_DEVICES[:1]))):
        zero_launches()
        eng = InferenceEngine(lm, n_ctx=4096, n_parallel=8, cache_type="f16",
                              mesh=mesh)
        try:
            t0 = time.time()
            tids = eng._call_on_loop(
                lambda: [eng.request_completion(p) for p in params])
            for tid in tids:
                while True:
                    r = eng.next_result(tid, timeout=600.0)
                    if r.error:
                        raise AssertionError(f"{label}: {r.error_message}")
                    if r.stop:
                        break
            wall = time.time() - t0
            gen = {tuple(s.prompt_tokens): list(s.generated_tokens)
                   for s in eng.slots}
        finally:
            eng.shutdown()
        out[label] = dict(generated=list(gen.values()), wall_s=wall,
                          launches={**DM.LAUNCHES, **FA.LAUNCHES})
        log(f"parallel {label} engine: {len(params)} requests in {wall:.2f}s "
            f"[{smi}]")
    if sorted(out["plain"]["generated"]) != sorted(out["1x1 mesh"]["generated"]):
        raise AssertionError("the 1x1 mesh engine's tokens differ from plain")
    log("parallel 1x1 mesh: make_tp_functions served the plain engine's "
        "tokens")
    return out["1x1 mesh"]


@contextlib.contextmanager
def decode_chunk(n: int):
    """The engines' decode chunk (TPU_ENGINE_DECODE_CHUNK) set to n: a
    grid's warm-up decodes a chunk a prompt bucket, each step waiting on
    2 * n_layer + 1 all_reduces over gloo."""
    old = os.environ.get("TPU_ENGINE_DECODE_CHUNK")
    os.environ["TPU_ENGINE_DECODE_CHUNK"] = str(n)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("TPU_ENGINE_DECODE_CHUNK", None)
        else:
            os.environ["TPU_ENGINE_DECODE_CHUNK"] = old


def parallel_phase(path: str, tmp: str, smi: str, ref_cycles: dict) -> dict:
    """Tensor and data parallelism on the one card: two ranks (processes)
    on cuda:0 over gloo. The model checks (TP=2 and DP=2 against one
    rank), three served grid cycles held to the 1x1 cycles (ref_cycles:
    server_phase's f16 and q8_0), and the 1x1 mesh through the TP path."""
    import multiprocessing as mp

    from tpu_engine_torch.gguf.reader import read_gguf
    from tpu_engine_torch.model.loader import load_model
    from tpu_engine_torch.tokenizer import Tokenizer

    out = {}
    t_phase = time.time()
    dev = PAR_DEVICES[0]
    lm = load_model(path, device=dev)
    cfg = lm.cfg
    rng = np.random.default_rng(11)
    tp_prompt = rng.integers(300, cfg.n_vocab, TP_PROMPT).tolist()
    dp_prompts = rng.integers(300, cfg.n_vocab, (8, DP_PROMPT)).tolist()
    t0 = time.time()
    ref_tp, tp_feed = tf_logits(LL.forward_step, lm.weights, cfg,
                                _kv_cache(cfg, 1, 1024, dev), [tp_prompt],
                                TP_STEPS)
    ref_dp, dp_feed = tf_logits(LL.forward_step, lm.weights, cfg,
                                _kv_cache(cfg, 8, 256, dev), dp_prompts,
                                DP_STEPS)
    # the bound of each KV kind: twice the twins' spread under reordered
    # sums (the split of wo / w_down's sums is TP's only change of order;
    # at q8_0 a changed sum can also move a K/V element across a rounding
    # edge of its row's quantization), or LOGIT_TOL
    bounds, served, refs = {}, {}, {}
    for kind in ("f16", "q8_0"):
        refs[kind], bounds[kind], served[kind] = grid_bounds(
            lm, tp_prompt, tp_feed, kind)
    bound = bounds["f16"]
    out["bounds"], out["served_bounds"] = bounds, served
    log(f"parallel: one-rank references ({TP_PROMPT} + {TP_STEPS} tokens; 8 "
        f"slots of {DP_PROMPT} + {DP_STEPS}) and the floors in "
        f"{time.time() - t0:.1f}s")
    store = os.path.join(tmp, "par_store")
    fout = os.path.join(tmp, "par_follower.pt")
    args = (PAR_DEVICES, store, path, tp_prompt, tp_feed, dp_prompts, dp_feed)
    proc = mp.get_context("spawn").Process(target=_par_follower,
                                           args=(fout, *args))
    t0 = time.time()
    proc.start()
    try:
        zero_launches()
        res = _par_rank(0, *args)
        proc.join(600)
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    if proc.exitcode != 0:
        raise AssertionError(f"parallel: rank 1 exited {proc.exitcode}")
    fol = torch.load(fout)
    log(f"parallel: two ranks on cuda:0 over gloo, TP=2 then DP=2, in "
        f"{time.time() - t0:.1f}s; rank shapes {res['tp_shapes']}, "
        f"{res['tp_kv_heads']} kv heads a rank; DP: {res['dp_slots']} of 8 "
        "slots a rank")
    if res["tp_kv_heads"] != cfg.n_kv_head // 2 or res["dp_slots"] != 4:
        raise AssertionError("parallel: a rank's shapes are not its part")
    out["tp2"] = held("TP=2 (teacher-forced, 512 + 64 tokens)", res["tp"],
                      ref_tp[:, 0], bound)
    out["tp2 q8_0 KV"] = held("TP=2 at q8_0 KV (teacher-forced, 512 + 64 "
                              "tokens)", res["tp_q8_0"], refs["q8_0"],
                              bounds["q8_0"])
    out["dp2"] = held("DP=2 (8 slots, 64 + 16 tokens)", res["dp"], ref_dp,
                      bound)
    # the fed tokens are one rank's greedy picks: DP=2 picks the same
    out["dp2"]["greedy_equal"] = bool(
        (res["dp"].argmax(-1)[:-1] == torch.tensor(dp_feed,
                                                   device=dev)).all())
    log(f"parallel DP=2: greedy tokens of the 8 slots equal one rank's: "
        f"{out['dp2']['greedy_equal']} (a rank runs 4 rows where one rank "
        "runs 8; the logits differ where a kernel's sums follow M)")
    for key in ("tp", "dp"):
        out[f"{key}_model"] = dict(
            launches={k: n + fol[f"{key}_launches"][k]
                      for k, n in res[f"{key}_launches"].items()},
            follower_launches=fol[f"{key}_launches"],
            wall_s=res[f"{key}_wall_s"])
    out["allreduce"] = {k: res[k] for k in res if k.startswith("allreduce")}
    log(f"parallel: tp_sum (all_reduce over gloo, ranks sharing cuda:0) "
        f"median of {AR_ITERS}: decode [8, 1, {cfg.n_embd}] f32 "
        f"{res['allreduce_decode_ms']:.3f} ms (CUDA events; "
        f"{res['allreduce_decode_wall_ms']:.3f} ms host clock), prefill "
        f"[1, 512, {cfg.n_embd}] {res['allreduce_prefill_ms']:.3f} ms "
        f"({res['allreduce_prefill_wall_ms']:.3f} ms); a decode step makes "
        f"{2 * cfg.n_layer} plus the logits' gather [{smi}]")
    g = read_gguf(path)
    tok = Tokenizer.from_gguf_metadata(g.metadata)
    g.close()
    srv, th, base = start_server(devices=PAR_DEVICES, backend="gloo")
    try:
        with decode_chunk(16):  # the 1x1 cycles ran 128
            for label, kind, grid in (
                    ("tp2 f16", "f16", {"tensor_parallel": 2}),
                    ("tp2 q8_0", "q8_0", {"tensor_parallel": 2}),
                    ("dp2 f16", "f16", {"data_parallel": 2})):
                cyc = server_cycle(srv, base, path, tok, kind, smi, grid=grid)
                cyc["ties"] = trace_served(lm, tok, label, kind,
                                           ref_cycles[kind], cyc, served[kind])
                log(f"parallel {label}: texts of the 1x1 {kind} cycle, "
                    f"{len(cyc['ties'])} requests traced to a near-tie")
                out[label] = cyc
    finally:
        stop_server(srv, th)
    out["1x1 mesh"] = one_by_one_cycle(lm, tok, smi)
    del lm
    torch.cuda.empty_cache()
    out["wall_s"] = time.time() - t_phase
    log(f"parallel: the phase in {out['wall_s']:.1f}s [{smi}]")
    return out


# --------------------------------------------------------------- families
FAM_SEED = 15      # the family phase's own torch and numpy seeds: no other
                   # phase draws from them
FAM_LAYERS = 2     # depth cut of each family (published widths otherwise)
FAM_ORDER = ("gemma2", "qwen2", "phi3", "llama3.1")
FAM_SERVED = {"gemma2": "f16", "qwen2": "q8_0"}  # served cycles' cache type
FAM_WINDOW_PROMPT = {"gemma2": 4608, "phi3": 2560}  # tokens, past the window
WINDOW_DIFF = 1e-2  # windowed logits differ from window-off ones by more
# the families' products (M=8, a decode step): gemma2's tied Q6_K head,
# phi3's fused Q5_K q|k|v, and a qwen2 layer's Q4_K tensors
FAM_QMM = [
    ("gemma2 output Q6_K", "i8", 16, False, 256000, 3584),
    ("phi3 wqkv Q5_K", "i8", 32, True, 9216, 3072),
    ("qwen2 wqkv Q4_K", "nib4", 32, True, 4608, 3584),
    ("qwen2 wo Q4_K", "nib4", 32, True, 3584, 3584),
    ("qwen2 w_gateup Q4_K", "nib4", 32, True, 37888, 3584),
    ("qwen2 w_down Q4_K", "nib4", 32, True, 3584, 18944),
]
FILLS_8K = [4097, 8191, 4133, 6144, 5120, 7600, 4098, 7300]  # 4097..8191
_DEC = dict(B=8, T=512, starts=FILLS, Tc=1, n_valid=[1] * 8)
_PRE = dict(B=1, T=1024, starts=[0], Tc=512, n_valid=[512])
_QWEN = dict(KH=4, G=7, D=128)
_GEMMA = dict(KH=8, G=2, D=256, T=8192)
_PHI = dict(KH=32, G=1, D=96, layout="dt")
FAM_ATTN = [  # (kernel, label, attn_case kwargs, window, softcap)
    ("attn_decode", "f16 td B=8 KH=4 G=7 D=128 T=512 fills 1..511 (Qwen2)",
     dict(_DEC, **_QWEN), 0, 0.0),
    ("attn_prefill", "f16 td B=1 Tc=512 history 0 KH=4 G=7 D=128 (Qwen2)",
     dict(_PRE, **_QWEN), 0, 0.0),
    ("attn_decode", "f16 td B=8 KH=8 G=2 D=256 T=8192 fills 4097..8191 "
     "window 4096 softcap 50 (Gemma-2)",
     dict(B=8, starts=FILLS_8K, Tc=1, n_valid=[1] * 8, **_GEMMA), 4096, 50.0),
    ("attn_prefill", "f16 td B=1 Tc=512 history 4096 KH=8 G=2 D=256 T=8192 "
     "window 4096 softcap 50 (Gemma-2)",
     dict(B=1, starts=[4096], Tc=512, n_valid=[512], **_GEMMA), 4096, 50.0),
    ("attn_decode_dt", "q8_0 dt B=8 KH=4 G=7 D=128 T=512 fills 1..511 (Qwen2)",
     dict(_DEC, kind="q8_0", layout="dt", **_QWEN), 0, 0.0),
    ("attn_prefill_dt", "q8_0 dt B=1 Tc=512 history 0 KH=4 G=7 D=128 (Qwen2)",
     dict(_PRE, kind="q8_0", layout="dt", **_QWEN), 0, 0.0),
    ("attn_decode_dt", "f16 dt B=8 KH=32 G=1 D=96 T=512 fills 1..511 (Phi-3)",
     dict(_DEC, **_PHI), 0, 0.0),
    ("attn_prefill_dt", "f16 dt B=1 Tc=512 history 0 KH=32 G=1 D=96 (Phi-3)",
     dict(_PRE, **_PHI), 0, 0.0),
]


def family_kernel_rows(timer: Timer, smi: str) -> list[dict]:
    """Each kernel at the families' shapes (FAM_QMM, FAM_ATTN) against its
    plain version, with equal bits on repeat, and timed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(FAM_SEED)
    rows = []
    for name, kind, group, has_bias, n, k in FAM_QMM:
        qt = rand_qtensor(gen, name, n, k, kind, group, has_bias)
        w_f32 = W.dequant(qt)
        x = torch.randn((8, k), generator=gen, device="cuda")
        rows.append(dict(qmm_timed_row(timer, name, qt, x, w_f32,
                                       w_f32.to(torch.bfloat16), smi),
                         family=True))
        del qt, w_f32
    for kname, shape, kw, win, cap in FAM_ATTN:
        rows.append(dict(attn_timed_row(timer, gen, kname, shape, kw, False,
                                        win, cap, repeat=True, smi=smi),
                         family=True))
    torch.cuda.empty_cache()
    return rows


def family_config(family: str, lm) -> dict:
    """What the loaded model must hold for its family: the published
    widths at FAM_LAYERS layers, the window, the Q6_K head and what only
    the family has."""
    cfg, fam = lm.cfg, FG.FAMILIES[family]
    lw = lm.weights["layers"]
    head = lm.weights["output"]
    own = {
        "gemma2": lambda: (cfg.post_norms and cfg.tie_embeddings
                           and cfg.swa_alternate
                           and (cfg.attn_logit_softcap,
                                cfg.final_logit_softcap) == (50.0, 30.0)
                           and cfg.attention_scale() == 256 ** -0.5
                           and head is lm.weights["token_embd"]),
        "qwen2": lambda: all("bqkv" in w or {"bq", "bk", "bv"} <= set(w)
                             for w in lw),
        "phi3": lambda: all((w["wqkv"].kind, w["wqkv"].group,
                             w["wqkv"].bias is not None) == ("i8", 32, True)
                            and w["w_gateup"].shape[0] == 2 * cfg.n_ff
                            for w in lw),
        "llama3.1": lambda: (len(cfg.rope_freqs) == cfg.head_dim // 2
                             and max(cfg.rope_freqs) == 8.0),
    }[family]
    return {
        "widths": FG.Widths(cfg.n_layer, cfg.n_embd, cfg.n_head,
                            cfg.n_kv_head, cfg.head_dim, cfg.n_ff,
                            cfg.n_vocab)
        == dataclasses.replace(fam.widths, n_layer=FAM_LAYERS),
        "window": cfg.sliding_window == dict(fam.extra).get(
            "attention.sliding_window", 0),
        "Q6_K head": (head.kind, head.group, head.bias is None, head.shape)
        == ("i8", 16, True, (cfg.n_vocab, cfg.n_embd)),
        "family's own": bool(own()),
    }


def family_model_checks(family: str, lm) -> dict:
    """One family's model on the card, as the main model is held: its
    config (family_config); model_qmm_run (a near-tie may flip a top-1
    within its bound); attn_model_run at f16 and q8_0 KV; and, with a
    window, a prompt past it held by attn_model_run and apart from the
    same run with the window off by more than WINDOW_DIFF."""
    cfg = lm.cfg
    feats = family_config(family, lm)
    log(f"family {family}: {feats}")
    if not all(feats.values()):
        raise AssertionError(f"family {family}: loaded {cfg}")
    label = f"family {family}"
    rng = np.random.default_rng([FAM_SEED, FAM_ORDER.index(family)])
    run = prompt_run(lm, [("t", rng.integers(300, cfg.n_vocab, 128).tolist())],
                     512)
    plain = dict(rot_cache=True)
    out = {"config": feats,
           "qmm": model_qmm_run(cfg, run, label=label, ties=True)}
    for kind in ("f16", "q8_0"):
        out[kind], _ = attn_model_run(cfg, run, label, kind, plain, False)
    n = FAM_WINDOW_PROMPT.get(family)
    if n:
        win = cfg.sliding_window
        run = prompt_run(lm, [("t", rng.integers(300, cfg.n_vocab, n).tolist())],
                         n + 256)
        wlabel = f"{label} window {win}, {n}-token prompt"
        out["window"], on = attn_model_run(cfg, run, wlabel, "f16", plain, False)
        cfg.sliding_window = 0
        try:
            out["window off"], off = attn_model_run(
                cfg, run, wlabel + ", window off", "f16", plain, False)
        finally:
            cfg.sliding_window = win
        rel = float((on - off).abs().max()) / float(off.abs().max())
        log(f"{wlabel}: max |dlogit| against the same run with the window "
            f"off {rel:.3e} of max |logit| (need > {WINDOW_DIFF})")
        if rel <= WINDOW_DIFF:
            raise AssertionError(f"{wlabel}: the window left the logits as "
                                 "they were")
        out["window"]["rel_dlogit_vs_window_off"] = rel
    return out


def served_through_twins(lm, tok, label: str, kind: str, cyc: dict,
                         bound: float) -> dict:
    """Every token a served cycle generated for its SERVED_PROMPTS requests,
    teacher-forced through the twins and attention_reference over a `kind`
    KV cache: each prompt prefilled into its own slot, then the generated
    tokens fed to all slots a step at a time. At each position the plain
    run's pick after the request's repeat penalties (as the samplers
    apply them) is the served token, or the two lie within `bound` of max
    |logit| (trace_served's near-tie rule). A request that stopped before
    max_tokens picked eos after its last token."""
    cfg, dev, n = lm.cfg, "cuda", len(SERVED_PROMPTS)
    prompts = cyc["prompt_ids"][:n]
    eos = lm.tokenizer.eos_id
    picks = [g + ([eos] if len(g) < 64 else []) for g in cyc["generated"][:n]]
    cache = _kv_cache(cfg, n, 512, dev, kind)
    sl = torch.arange(n, dtype=torch.int32, device=dev)
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    rows = []  # [position][n, V] on the host: the logits before each pick
    W.set_qmatmul_impl(DM.qmatmul_twin)
    LL.set_attention_impl(LL.attention_reference)
    try:
        first = []
        for i, p in enumerate(prompts):
            logits, cache, _ = LL.forward_step(
                lm.weights, cache, torch.tensor([p], dtype=torch.int32,
                                                device=dev),
                sl[i:i + 1], one, cfg, rot_cache=True)
            first.append(logits[0])
        rows.append(torch.stack(first).cpu())
        for j in range(max(len(p) for p in picks) - 1):
            act = torch.tensor([j + 1 < len(p) for p in picks], device=dev)
            feed = torch.tensor([[p[j] if j + 1 < len(p) else 0] for p in picks],
                                dtype=torch.int32, device=dev)
            logits, cache, _ = LL.forward_step(lm.weights, cache, feed, sl, act,
                                               cfg, rot_cache=True)
            rows.append(logits.cpu())
    finally:
        W.set_qmatmul_impl(None)
        LL.set_attention_impl(None)
    ties, n_picks = [], 0
    for i, p in enumerate(picks):
        sampler = served_sampler(lm, tok, i)
        for t in prompts[i]:
            sampler.accept(t, apply_grammar=False)
        for j, served in enumerate(p):
            row = rows[j][i].numpy().copy()
            m = float(np.abs(row).max())
            sampler._apply_penalties(row)
            top = int(row.argmax())
            if top != served:
                gap = float(abs(row[top] - row[served])) / m
                log(f"{label}: request {i} served {served} at generated token "
                    f"{j}, the plain run picks {top}: penalized logits' gap "
                    f"{gap:.3e} of max |logit| (bound {bound:.3e})")
                if gap > bound:
                    raise AssertionError(f"{label}: request {i} differs from "
                                         "the twins beyond a near-tie")
                ties.append((i, j, gap))
            sampler.accept(served, apply_grammar=False)
            n_picks += 1
    log(f"{label}: {n_picks} served picks of {n} requests teacher-forced "
        f"through the twins and attention_reference ({kind} KV): the plain "
        f"run picks each, {len(ties)} near-ties aside")
    return dict(picks=n_picks, ties=ties, bound=bound)


def family_phase(tmp: str, smi: str, timer: Timer) -> tuple[dict, list, dict]:
    """The four families of tools/family_gguf.py at their published widths,
    cut to FAM_LAYERS layers: the kernels at their shapes
    (family_kernel_rows); then for each family its file, written from seed
    0 and loaded on the card, family_model_checks, and (FAM_SERVED) a
    served cycle whose tokens are held to the twins (served_through_twins
    at the family's model_qmm_run bound); the q8_0 cycle must shift a
    quantized "dt" context on the card. Returns (result, kernel rows,
    launches of the family models' runs and served cycles: each counted
    from zero)."""
    from tpu_engine_torch.model.loader import load_model

    t_phase = time.time()
    rows = family_kernel_rows(timer, smi)
    out, launches = {}, dict.fromkeys(SOURCES, 0)
    srv, th, base = start_server()
    try:
        for family in FAM_ORDER:
            fam = FG.FAMILIES[family]
            path = os.path.join(tmp, f"{family}-{FAM_LAYERS}l-q4_k_m.gguf")
            t0 = time.time()
            FG.build_family_gguf(path, family, n_layer=FAM_LAYERS, seed=0)
            t1 = time.time()
            lm = load_model(path, device="cuda")
            torch.cuda.synchronize()
            card_s = time.time() - t1
            log(f"family {family}: wrote {path} ({os.path.getsize(path) / 1e9:.2f}"
                f" GB, Q4_K_M mix, {fam.source} widths, {FAM_LAYERS} layers: "
                f"depth cut from {fam.widths.n_layer}) in {t1 - t0:.1f}s, "
                f"loaded on the card in {card_s:.2f}s (numpy "
                f"to_device_format on the host took 11.3-12.9s a 1 GB "
                f"file on an H100 host), split "
                f"{ {k: round(v, 3) for k, v in lm.load_split.items()} }")
            load = dict(card_s=card_s, split=lm.load_split,
                        **load_against_cpu(path, lm, f"family {family}"))
            zero_launches()
            res = family_model_checks(family, lm)
            res["load"] = load
            res["launches"] = {**DM.LAUNCHES, **FA.LAUNCHES}
            log(f"family {family}: launches over its model checks "
                f"{res['launches']}")
            counted = [res]
            kind = FAM_SERVED.get(family)
            if kind:
                log(f"family {family}: served cycle at {kind} (the server "
                    f"{kind} lines that follow)")
                shifts, real_shift = [], OPS.shift_compact
                OPS.shift_compact = counting_shift(shifts)
                try:
                    cyc = server_cycle(srv, base, path, lm.tokenizer, kind, smi)
                finally:
                    OPS.shift_compact = real_shift
                cyc["context_shifts"] = shifts
                log(f"family {family} {kind} served: context shifts (kind, "
                    f"layout, device, no re-rope) {shifts}")
                if kind == "q8_0" and ("q8_0", "dt", "cuda", False) not in shifts:
                    raise AssertionError(f"family {family}: no context shift "
                                         "of the quantized dt cache on the card")
                cyc["twins"] = served_through_twins(
                    lm, lm.tokenizer, f"family {family} {kind} served", kind,
                    cyc, res["qmm"]["bound"])
                res["served"] = cyc
                counted.append(cyc)
            for c in counted:
                for k in launches:
                    launches[k] += c["launches"][k]
            out[family] = res
            del lm
            os.remove(path)
            torch.cuda.empty_cache()
    finally:
        stop_server(srv, th)
    idle = sorted({r["kernel"] for r in rows if not launches[r["kernel"]]})
    if idle:
        raise AssertionError(f"families: kernels not launched by the family "
                             f"runs: {idle}")
    out["launches"] = launches
    out["wall_s"] = time.time() - t_phase
    log(f"families: launches of the model checks and served cycles "
        f"{launches}; the phase in {out['wall_s']:.1f}s [{smi}]")
    return out, rows, launches


# ---------------------------------------------------------- grids, more
GRID_SEED = 16     # the grid additions' own torch and numpy seeds
PHI_PROMPT, PHI_STEPS = 256, 32  # phi3 TP=2 check: teacher-forced
# a TP=2 phi3 rank's products (M=8, a decode step; Phi-3-mini widths): the
# Q5_K q, k and v slices fused again (3 x 1536 rows), gate|up (2 x 4096
# rows), wo and w_down at half their columns, the head at half its rows
PHI_TP_QMM = [
    ("phi3 wqkv Q5_K", "i8", 32, True, 4608, 3072),
    ("phi3 wo Q4_K", "nib4", 32, True, 3072, 1536),
    ("phi3 w_gateup Q4_K", "nib4", 32, True, 8192, 3072),
    ("phi3 w_down Q4_K", "nib4", 32, True, 3072, 4096),
    ("phi3 w_down Q6_K", "i8", 16, False, 3072, 4096),
    ("phi3 output Q6_K", "i8", 16, False, 16032, 3072),
]
MM_CHAT_TOKENS = 16  # generated tokens of the grids' image chats
MM_N_BATCH = 100     # the grids' image chats: 576 image rows prefill in
                     # chunks of 100 and 76 (no bucket), text in buckets
                     # up to 64 (a grid's warm-up runs each bucket)


def phi3_tp_kernel_rows(timer: Timer, gen, smi: str) -> list[dict]:
    """qmm_nib4 and qmm_i8 at a TP=2 phi3 rank's shapes (PHI_TP_QMM)
    against their twins, equal bits on repeat, timed (rows marked
    phi3_tp)."""
    rows = []
    for name, kind, group, has_bias, n, k in PHI_TP_QMM:
        qt = rand_qtensor(gen, name, n, k, kind, group, has_bias)
        w_f32 = W.dequant(qt)
        x = torch.randn((8, k), generator=gen, device="cuda")
        rows.append(dict(qmm_timed_row(timer, name + " (TP=2 rank)", qt, x,
                                       w_f32, w_f32.to(torch.bfloat16), smi),
                         phi3_tp=True))
        del qt, w_f32
    torch.cuda.empty_cache()
    return rows


def engine_logits(engine, prompt, feed) -> dict:
    """prompt then feed (teacher-forced) through a served engine's own
    ops (a grid's leader: every op replays on the followers) in slot 0,
    emptied before and after, on the engine's loop: logits [steps + 1, V]
    as tf_logits gives them, and rank 0's layer-0 weight shapes, kv heads
    and cache layout."""
    ops = engine.ops

    def run():
        ops.trim(0, 0)
        for off in range(0, len(prompt), 512):
            c = prompt[off:off + 512]
            logits, _ = ops.step([c], [0], [True], n_valid=[len(c)])
        rows = [logits[0]]
        for t in feed:
            logits, _ = ops.step([t], [0], [True])
            rows.append(logits[0])
        ops.trim(0, 0)
        return torch.stack(rows).float()

    logits = engine._call_on_loop(run)
    torch.cuda.synchronize()
    lw = engine.model.weights["layers"][0]
    return dict(logits=logits, layout=ops.cache.layout,
                kv_heads=int(ops.cache.k.shape[2]),
                shapes={k: list(v.shape) for k, v in lw.items()
                        if isinstance(v, W.QTensor)})


def no_process_left(label: str) -> None:
    import multiprocessing

    if multiprocessing.active_children():
        raise AssertionError(f"{label}: a process outlived /unloadmodel: "
                             f"{multiprocessing.active_children()}")


@contextlib.contextmanager
def kept_tokens():
    """{n_predict: generated token ids} of each request, kept as its slot is
    released (the requests of one cycle differ in max_tokens)."""
    from tpu_engine_torch.serve.slot import Slot

    kept, release = {}, Slot.release

    def keep(slot):
        kept[slot.params.n_predict] = list(slot.generated_tokens)
        release(slot)

    Slot.release = keep
    try:
        yield kept
    finally:
        Slot.release = release


def phi3_grid(tmp: str, smi: str, srv, base) -> dict:
    """phi3 at its published widths (tools/family_gguf.py, the family
    phase's writer and seed, 2 layers) served at tensor_parallel 2 (f16,
    "dt" KV at D=96): the cycle held token by token to a 1x1 cycle
    (near-ties traced as trace_served does), then, in the same grid, the
    ranks' logits of a teacher-forced prompt against one rank's by the
    parallel phase's rule (engine_logits)."""
    from tpu_engine_torch.model.loader import load_model

    path = os.path.join(tmp, f"phi3-{FAM_LAYERS}l-q4_k_m.gguf")
    t0 = time.time()
    FG.build_family_gguf(path, "phi3", n_layer=FAM_LAYERS, seed=0)
    lm = load_model(path, device=PAR_DEVICES[0])
    cfg, tok = lm.cfg, lm.tokenizer
    log(f"grids: wrote and loaded {path} in {time.time() - t0:.1f}s")
    rng = np.random.default_rng([GRID_SEED, 0])
    prompt = rng.integers(300, cfg.n_vocab, PHI_PROMPT).tolist()
    feed = rng.integers(300, cfg.n_vocab, (PHI_STEPS, 1)).tolist()
    ref, bound, served = grid_bounds(lm, prompt, feed, "f16", "grids phi3")
    with decode_chunk(16):
        one = server_cycle(srv, base, path, tok, "f16", smi)
        cyc = server_cycle(srv, base, path, tok, "f16", smi,
                           grid={"tensor_parallel": 2},
                           extra=lambda eng: engine_logits(eng, prompt, feed))
    cyc["ties"] = trace_served(lm, tok, "phi3 tp2 f16", "f16", one, cyc,
                               served)
    res = cyc.pop("extra")
    log(f"grids phi3 TP=2: rank 0 shapes {res['shapes']}, "
        f"{res['kv_heads']} kv heads a rank ({res['layout']})")
    lw = res["shapes"]
    H, KH, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    if (res["kv_heads"], res["layout"], lw["wqkv"][0], lw["w_gateup"][0]) != (
            KH // 2, "dt", (H + 2 * KH) * D // 2, cfg.n_ff):
        raise AssertionError("grids phi3: a rank's shapes are not its part")
    out = {"tp2": held(f"phi3 TP=2 (teacher-forced in the served grid, "
                       f"{PHI_PROMPT} + {PHI_STEPS} tokens)", res["logits"],
                       ref, bound),
           "bound": bound, "served_bound": served}
    log(f"grids phi3 tp2 f16 served: the 1x1 cycle's tokens, "
        f"{len(cyc['ties'])} requests traced to a near-tie")
    out["1x1 f16"], out["tp2 f16"] = one, cyc
    del lm
    os.remove(path)
    torch.cuda.empty_cache()
    return out


def mm_chat_body(png: bytes) -> dict:
    """A greedy image chat without repeat penalties (so a near-tie is read
    from the plain logits), MM_CHAT_TOKENS tokens."""
    return {"model": "llava", "max_tokens": MM_CHAT_TOKENS, "temperature": 0,
            "repeat_penalty": 1.0, "messages": [{"role": "user", "content": [
                {"type": "text", "text": "what is in "},
                {"type": "image_url", "image_url": {
                    "url": "data:image/png;base64,"
                           + base64.b64encode(png).decode()}},
                {"type": "text", "text": " this picture?"}]}]}


def mm_trace(lm, clip, body: dict, ref: list, got: list, bound: float,
             label: str):
    """ref (the 1x1 image chat's tokens) against got (a grid's): equal, or
    at the first token where they part the one-rank kernels' logits after
    the shared prefix (prompt_run over the engine's segments) at the two
    picks lie within bound of max |logit|. Returns the tie or None."""
    from tpu_engine_torch.api.openai import ModelPrompts, parse_chat_request
    from tpu_engine_torch.clipvit.model import encode_image

    if ref == got:
        return None
    j = next((n for n, (x, y) in enumerate(zip(ref, got)) if x != y),
             min(len(ref), len(got)))
    params, _ = parse_chat_request(body, ModelPrompts(), True)
    tok, segs = lm.tokenizer, []
    for n, part in enumerate(re.split(r"\[img-(\d+)\]", params.prompt)):
        if n % 2:
            segs.append(("i", encode_image(clip, params.images[int(part)])))
        elif part:
            segs.append(("t", tok.encode(part, add_special=n == 0,
                                         parse_special=True)))
    n_cells = sum(len(d) for _, d in segs)
    feed = (ref + [0] * 16)[:16]
    rows, _ = prompt_run(lm, segs, n_cells + 32)("f16", dict(rot_cache=True),
                                                 feed=feed)
    row = rows[j].cpu().numpy()
    eos = tok.eos_id
    ta, tb = (ref[j] if j < len(ref) else eos), (got[j] if j < len(got) else eos)
    gap = float(abs(row[ta] - row[tb])) / float(np.abs(row).max())
    log(f"grids {label}: first differs at generated token {j}: {ta} (1x1) vs "
        f"{tb}; one-rank logits' gap {gap:.3e} of max |logit| (bound "
        f"{bound:.3e})")
    if gap > bound:
        raise AssertionError(f"grids {label}: differs from the 1x1 chat "
                             "beyond a near-tie")
    return (j, gap)


def mm_grids(tmp: str, path: str, lm, srv, base, bound: float) -> dict:
    """The llava-1.5 mmproj and 500x375 PNG of the multimodal phase (the
    file it wrote; the image drawn again from its seed) served at 1x1, at
    tensor_parallel 2 and at data_parallel 2: each grid's image chat held
    to the 1x1 chat's tokens (mm_trace), the image's 576 rows prefilled
    on every rank in chunks of MM_N_BATCH and the rest, no bucket
    size."""
    from tpu_engine_torch.clipvit.model import load_clip
    from tpu_engine_torch.tools import mmproj_gguf as MG

    mm_path = os.path.join(tmp, "mmproj-llava-1.5-7b-f16.gguf")
    _, _, h, w, seed = MM_IMAGES[0]
    png = MG.write_png(mm_image(seed, h, w))
    body = mm_chat_body(png)
    out = {}
    for name, grid in (("1x1", {}), ("tp2", {"tensor_parallel": 2}),
                       ("dp2", {"data_parallel": 2})):
        zero_launches()
        t0 = time.time()
        status, resp = _post(base, "/loadmodel", {
            "llama_model_path": path, "model": "llava", "mmproj": mm_path,
            "cache_type": "f16", "n_parallel": 2, "ctx_len": 4096,
            "n_batch": MM_N_BATCH, **grid})
        if status != 200:
            raise AssertionError(f"/loadmodel llava {name}: {status} {resp}")
        t_load = time.time() - t0
        entry = srv.registry.get("llava")
        if entry.engine.clip is None or bool(entry.grid) != bool(grid):
            raise AssertionError(f"llava {name}: clip {entry.engine.clip}, "
                                 f"grid {entry.grid}")
        del entry
        with kept_tokens() as kept:
            t0 = time.time()
            status, resp = _post(base, "/v1/chat/completions", body)
            latency = time.time() - t0
        if status != 200:
            raise AssertionError(f"llava {name}: chat {status} {resp}")
        status, _ = _post(base, "/unloadmodel", {"model": "llava"})
        no_process_left(f"llava {name}")
        out[name] = dict(launches=grid_launches(), load_s=t_load,
                         latency_s=latency, usage=resp["usage"],
                         text=resp["choices"][0]["message"]["content"],
                         generated=kept[MM_CHAT_TOKENS])
        log(f"grids llava-1.5 {name}: /loadmodel {t_load:.1f}s, usage "
            f"{resp['usage']}, latency {latency:.2f}s; "
            f"{out[name]['text']!r}; launches {out[name]['launches']}")
    clip = load_clip(mm_path, device="cuda")
    for name in ("tp2", "dp2"):
        if out[name]["usage"]["prompt_tokens"] != out["1x1"]["usage"][
                "prompt_tokens"]:
            raise AssertionError(f"llava {name}: usage {out[name]['usage']}")
        out[name]["tie"] = mm_trace(lm, clip, body, out["1x1"]["generated"],
                                    out[name]["generated"], bound,
                                    f"llava-1.5 {name}")
    del clip
    torch.cuda.empty_cache()
    return out


def embedding_grids(tmp: str, path: str, srv, base, bound: float) -> dict:
    """nomic-embed (the embedding phase's file) at tensor_parallel 2:
    served whole, no process spawned, vectors equal to 1x1's bit for bit.
    The Llama smoke model as model_type "embedding" at TP=2 (max |dv| /
    max |v| within the TP logit bound) and DP=2 (equal to 1x1)."""
    import multiprocessing

    from tpu_engine_torch.serve.encoder import EncoderEngine

    _, preset, level, _ = ENC_MODELS[1]
    nomic = os.path.join(tmp, f"{preset}-{level}.gguf")
    rng = np.random.default_rng([GRID_SEED, 1])
    words = "the quick brown fox jumps over the lazy dog hello world".split()
    out = {}
    for label, model_path, grids, extra in (
            ("nomic", nomic, ({}, {"tensor_parallel": 2}), {}),
            ("llama", path, ({}, {"tensor_parallel": 2},
                             {"data_parallel": 2}), {"n_parallel": 2})):
        inputs = [" ".join(rng.choice(words, n)) for n in (8, 60, 150)]
        vecs = {}
        for grid in grids:
            name = f"{label} {json.dumps(grid)}"
            zero_launches()
            status, resp = _post(base, "/loadmodel", {
                "llama_model_path": model_path, "model": "e",
                "model_type": "embedding", "ctx_len": 1024, **extra, **grid})
            if status != 200:
                raise AssertionError(f"/loadmodel {name}: {status} {resp}")
            entry = srv.registry.get("e")
            if label == "nomic" and (
                    entry.grid is not None or multiprocessing.active_children()
                    or not isinstance(entry.engine, EncoderEngine)
                    or entry.engine.device.type != "cuda"):
                raise AssertionError(f"{name}: not served whole on the card")
            if label == "llama" and bool(entry.grid) != bool(grid):
                raise AssertionError(f"{name}: grid {entry.grid}")
            del entry
            status, resp = _post(base, "/v1/embeddings",
                                 {"model": "e", "input": inputs})
            if status != 200:
                raise AssertionError(f"{name} /v1/embeddings: {status} {resp}")
            _post(base, "/unloadmodel", {"model": "e"})
            no_process_left(name)
            vecs[json.dumps(grid)] = np.asarray(
                [d["embedding"] for d in resp["data"]], np.float64)
            out[name] = dict(launches=grid_launches())
        one = vecs["{}"]
        for key, v in vecs.items():
            if key == "{}":
                continue
            rel = float(np.abs(v - one).max() / np.abs(one).max())
            exact = bool(np.array_equal(v, one))
            tp = "tensor_parallel" in key
            log(f"grids {label} embedding {key}: max |dv| / max |v| against "
                f"1x1 {rel:.3e}, equal bits {exact} (need "
                f"{'<= %.3e' % bound if tp and label == 'llama' else 'equal'})")
            if not (rel <= bound if tp and label == "llama" else exact):
                raise AssertionError(f"grids {label} embedding {key}: "
                                     "vectors differ from 1x1")
            out[f"{label} {key}"].update(rel_dv=rel, exact=exact)
    return out


def grid_phase(tmp: str, path: str, lm, smi: str, par: dict,
               timer: Timer) -> tuple[dict, list, dict]:
    """What grids serve beside the smoke model's text (C1, C2), on two ranks
    sharing cuda:0 over gloo, with a torch generator and numpy seeds of
    its own: qmm at a TP=2 phi3 rank's shapes; phi3 at TP=2 (phi3_grid);
    llava-1.5 image chats at TP=2 and DP=2 (mm_grids); nomic-embed at
    TP=2 and the smoke model as an embedding model at TP=2 and DP=2
    (embedding_grids). Returns (result, kernel rows, launches of the phi3
    TP=2 runs)."""
    t_phase = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(GRID_SEED)
    rows = phi3_tp_kernel_rows(timer, gen, smi)
    out = {}
    srv, th, base = start_server(devices=PAR_DEVICES, backend="gloo")
    try:
        out["phi3"] = phi3_grid(tmp, smi, srv, base)
        with decode_chunk(16):
            out["llava"] = mm_grids(tmp, path, lm, srv, base,
                                    par["served_bounds"]["f16"])
            out["embeddings"] = embedding_grids(tmp, path, srv, base,
                                                par["bounds"]["f16"])
    finally:
        stop_server(srv, th)
    phi = out["phi3"]
    tp_launches = {k: phi["tp2 f16"]["launches"][k] for k in SOURCES}
    idle = sorted({r["kernel"] for r in rows if not tp_launches[r["kernel"]]})
    if idle:
        raise AssertionError(f"grids: kernels not launched by phi3 at TP=2: "
                             f"{idle}")
    out["wall_s"] = time.time() - t_phase
    log(f"grids: phi3 TP=2 launches {tp_launches}; the phase in "
        f"{out['wall_s']:.1f}s [{smi}]")
    return out, rows, tp_launches


# -------------------------------------------------------------- sampling
SAMP_SEED = 17     # the sampling phase's own torch and numpy seeds
SAMP_TEMP = 0.8
KEEP_TOL = 1e-6    # kept probabilities, card against the host chain
N_DRAWS = 65536    # draws from one row, in batches of DRAW_ROWS
DRAW_ROWS = 4096
TV_TOL = 0.02      # total-variation distance of the draws (about 0.007
                   # expected at N_DRAWS)
LOGPROB_TOL = 1e-3  # nats: served logprobs against a direct run's
GRAMMAR_DFA = 'root ::= "answer: " ("yes" | "no" | "maybe") "."\n'
GRAMMAR_REC = 'root ::= item\nitem ::= "(" item ")" | [a-z]+\n'
SCHEMA = {"type": "object", "properties": {
    "answer": {"enum": ["yes", "no", "maybe"]}, "count": {"type": "integer"},
    "sure": {"type": "boolean"}}, "required": ["answer", "count", "sure"]}


def host_kept(row: np.ndarray, sp, ring: list) -> np.ndarray:
    """The host chain's (sampling/chain.py Sampler) tempered probabilities
    of one logits row after its penalties over ring, top_k, top_p, min_p:
    zero outside the kept set."""
    from tpu_engine_torch.sampling import Sampler
    from tpu_engine_torch.sampling.chain import _softmax

    s = Sampler(sp, row.size)
    for t in ring:
        s.accept(int(t), apply_grammar=False)
    x = row.astype(np.float32).copy()
    s._apply_penalties(x)
    x = s._top_k(x, sp.top_k)
    x = s._typical(x, sp.typical_p, sp.min_keep)
    x = s._top_p(x, sp.top_p, sp.min_keep)
    x = s._min_p(x, sp.min_p, sp.min_keep)
    return _softmax(s._temp(x))


def kept_sets(rows: torch.Tensor, sp, rings: list) -> dict:
    """sample_step's candidate set on the card (filtered_logits, then
    candidates: penalties over each row's ring, top_k, top_p, min_p)
    against the host chain's on the same rows: the same tokens kept, and
    their tempered probabilities within KEEP_TOL."""
    from tpu_engine_torch.sampling import device as SD

    S = rows.shape[0]
    params = SD.params_from_host([sp] * S, device="cuda")
    state = SD.DeviceSamplerState(
        ring=SD.ring_from_tokens(rings, S, device="cuda"),
        gen=SD.new_generator(SAMP_SEED, "cuda"),
        gstate=torch.zeros((S,), dtype=torch.int32, device="cuda"))
    v, idx = SD.candidates(SD.filtered_logits(rows, params, state), params)
    pr = torch.softmax(v / sp.temperature, dim=-1).cpu().numpy()
    v, idx = v.cpu().numpy(), idx.cpu().numpy()
    host = rows.cpu().numpy()
    worst, sizes = 0.0, []
    for b in range(S):
        want = host_kept(host[b], sp, rings[b])
        keep = np.isfinite(v[b])
        got = dict(zip(idx[b][keep].tolist(), pr[b][keep].tolist()))
        if set(got) != set(np.nonzero(want)[0].tolist()):
            raise AssertionError(f"sampling: row {b} keeps {sorted(got)} on "
                                 f"the card, {np.nonzero(want)[0].tolist()} "
                                 "on the host")
        worst = max(worst, max(abs(p - want[t]) for t, p in got.items()))
        sizes.append(len(got))
    if worst > KEEP_TOL:
        raise AssertionError(f"sampling: kept probabilities differ by "
                             f"{worst:.3e} > {KEEP_TOL}")
    return dict(kept=sizes, max_dp=float(worst))


def draws_check(row: torch.Tensor, sp, want: np.ndarray) -> dict:
    """N_DRAWS tokens from one row through sample_step on a CUDA generator
    (batches of DRAW_ROWS copies of the row): none outside the host's kept
    set, and the total-variation distance from its tempered probabilities
    (want) within TV_TOL."""
    from tpu_engine_torch.sampling import device as SD

    V = row.shape[-1]
    big = row[None, :].expand(DRAW_ROWS, V).contiguous()
    params = SD.params_from_host([sp] * DRAW_ROWS, device="cuda")
    gen = SD.new_generator(SAMP_SEED, "cuda")
    counts = torch.zeros((V,), dtype=torch.int64, device="cuda")
    for _ in range(N_DRAWS // DRAW_ROWS):
        state = SD.new_state(DRAW_ROWS, device="cuda")
        state.gen = gen
        toks, _ = SD.sample_step(big, params, state)
        counts += torch.bincount(toks.long(), minlength=V)
    counts = counts.cpu().numpy()
    outside = int(counts[want == 0].sum())
    tv = 0.5 * float(np.abs(counts / N_DRAWS - want).sum())
    log(f"sampling: {N_DRAWS} draws at temperature {sp.temperature} from one "
        f"row ({int((want > 0).sum())} kept tokens): {outside} outside the "
        f"host's kept set, total-variation distance {tv:.4f} (tol {TV_TOL})")
    if outside or tv > TV_TOL:
        raise AssertionError("sampling: the card's draws do not follow the "
                             "host chain's probabilities")
    return dict(outside=outside, tv=tv, kept=int((want > 0).sum()))


def grammar_verdict(grammar: str, text: str):
    """"full" when text is a whole sentence of the grammar, "prefix" when
    it can still be extended into one, None when it cannot."""
    from tpu_engine_torch.grammar.gbnf import GrammarMatcher, parse_gbnf

    m = GrammarMatcher.__new__(GrammarMatcher)
    m.bodies, m.root_id = parse_gbnf(grammar)
    stacks = m._expand((("ref", m.root_id),))
    for ch in text:
        stacks = m._advance(stacks, ord(ch))
        if not stacks:
            return None
    return "full" if any(not st for st in stacks) else "prefix"


def schema_holds(obj) -> bool:
    return (isinstance(obj, dict) and set(obj) == {"answer", "count", "sure"}
            and obj["answer"] in ("yes", "no", "maybe")
            and isinstance(obj["count"], int)
            and isinstance(obj["sure"], bool))


def lane_burst():
    """The mixed burst: (expected lane, grammar to hold the text to, body)
    for eight requests, each with its own max_tokens."""
    from tpu_engine_torch.grammar import json_schema_to_grammar
    from tpu_engine_torch.grammar.dfa import compile_byte_dfa

    schema_g = json_schema_to_grammar(SCHEMA)
    schema_lane = ("bank" if compile_byte_dfa(schema_g, 126) is not None
                   else "host")
    words = ["alpha", "beta", "gamma", "delta", "kappa", "sigma", "omega",
             "theta"]

    def chat(i, **kw):
        return {"model": "samp", "max_tokens": 40 + i, "messages": [
            {"role": "user", "content": f"{words[i]} {words[i]} tell me about "
                                        f"{words[i]}"}], **kw}

    return [
        ("device", None, chat(0, temperature=SAMP_TEMP)),
        ("device", None, chat(1, temperature=SAMP_TEMP, top_k=20,
                              presence_penalty=0.5)),
        ("device", None, chat(2, temperature=SAMP_TEMP,
                              frequency_penalty=0.3, repeat_penalty=1.3)),
        ("bank", GRAMMAR_DFA, chat(3, temperature=SAMP_TEMP,
                                   grammar=GRAMMAR_DFA)),
        (schema_lane, schema_g, chat(4, temperature=SAMP_TEMP,
                                     response_format={
                                         "type": "json_schema",
                                         "json_schema": {"schema": SCHEMA}})),
        ("host", GRAMMAR_REC, chat(5, temperature=SAMP_TEMP,
                                   grammar=GRAMMAR_REC)),
        ("host", None, chat(6, temperature=SAMP_TEMP, seed=1234)),
        ("host", None, chat(7, temperature=0, repeat_penalty=1.0,
                            logprobs=True, top_logprobs=5)),
    ]


def lane_burst_cycle(srv, base, path: str, lm, smi: str) -> dict:
    """/loadmodel (8 slots, f16 KV, no prompt cache) -> the mixed burst at
    once (lane_burst) -> the seeded request twice more, one after the
    other, and the logprobs request alone -> /unloadmodel.
    Each request's lane from its slot at launch (gstate: a bank row;
    _on_device), grammar text its grammar accepts (whole at "stop", a
    prefix at "length"), the json_schema object valid when whole, the
    seeded repeats equal, and the logprobs request held to a direct
    engine run (logprobs_check)."""
    from tpu_engine_torch.serve.engine import InferenceEngine

    burst = lane_burst()
    lanes, launch = {}, InferenceEngine._launch_slot

    def record(self, slot, task):
        launch(self, slot, task)
        lanes[task.params.n_predict] = (
            "host" if not self._on_device(slot) else
            "device" if slot.gstate is None else "bank")

    zero_launches()
    status, resp = _post(base, "/loadmodel", {
        "llama_model_path": path, "model": "samp", "n_parallel": 8,
        "ctx_len": 4096, "cache_type": "f16", "caching_enabled": False})
    if status != 200:
        raise AssertionError(f"/loadmodel sampling: {status} {resp}")
    engine = srv.registry.get("samp").engine
    chunks0, host0 = engine.n_chunks_dispatched, engine.n_host_steps
    results = [None] * len(burst)

    def worker(i):
        results[i] = _post(base, "/v1/chat/completions", burst[i][2])

    InferenceEngine._launch_slot = record
    t0 = time.time()
    try:
        with kept_tokens() as kept:
            ths = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(burst))]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
            wall = time.time() - t0
            seeded = [_post(base, "/v1/chat/completions", burst[6][2])
                      for _ in range(2)]
            lone = _post(base, "/v1/chat/completions", burst[7][2])[1]
    finally:
        InferenceEngine._launch_slot = launch
    chunks = engine.n_chunks_dispatched - chunks0
    host_steps = engine.n_host_steps - host0
    del engine
    _post(base, "/unloadmodel", {"model": "samp"})
    launches = {**DM.LAUNCHES, **FA.LAUNCHES}
    out = dict(launches=launches, wall_s=wall, chunks=chunks,
               host_steps=host_steps, requests=[])
    for (lane, grammar, body), res in zip(burst, results):
        if res is None or res[0] != 200:
            raise AssertionError(f"sampling burst: {body} -> {res}")
        choice = res[1]["choices"][0]
        text, finish = choice["message"]["content"], choice["finish_reason"]
        got = lanes[body["max_tokens"]]
        verdict = None if grammar is None else grammar_verdict(grammar, text)
        ok = got == lane and (grammar is None or verdict == "full" or (
            verdict == "prefix" and finish == "length"))
        if ok and grammar is not None and "response_format" in body \
                and verdict == "full":
            ok = schema_holds(json.loads(text))
        out["requests"].append(dict(lane=got, want=lane, finish=finish,
                                    verdict=verdict, text=text,
                                    tokens=res[1]["usage"]["completion_tokens"]))
        log(f"sampling burst: max_tokens {body['max_tokens']}: lane {got} "
            f"(want {lane}), finish {finish}, grammar {verdict}; {text!r}")
        if not ok:
            raise AssertionError(f"sampling burst: request {body} on lane "
                                 f"{got}, text {text!r} ({verdict})")
    texts = [r[1]["choices"][0]["message"]["content"] for r in seeded]
    if texts[0] != texts[1]:
        raise AssertionError(f"sampling: seeded repeats differ: {texts}")
    out["seeded_repeat_equal"] = True
    out["logprobs"] = logprobs_check(lm, burst[7][2], results[7][1], lone,
                                     kept[burst[7][2]["max_tokens"]])
    if not (chunks and host_steps):
        raise AssertionError("sampling burst: not both lanes ran")
    log(f"sampling burst: 8 requests in {wall:.2f}s, {chunks} device decode "
        f"chunks and {host_steps} host-lane steps; seeded request twice: "
        f"equal text; launches {launches} [{smi}]")
    return out


def logprobs_check(lm, body: dict, burst: dict, lone: dict,
                   generated: list) -> dict:
    """The greedy logprobs request: each served token is its top entry (in
    the burst and alone), and alone its top logprobs lie within
    LOGPROB_TOL of a direct InferenceEngine run of the same request (8
    slots, f16, alone: the same schedule), which takes them from the
    log-softmax of its logits. Also logged, not gated: the burst's top
    logprobs against the log-softmax of a one-row teacher-forced run of
    its tokens (another schedule: the qmm kernels' bf16 roundings carry
    a changed sum order onwards)."""
    from tpu_engine_torch.api.openai import ModelPrompts, parse_chat_request
    from tpu_engine_torch.serve.engine import InferenceEngine

    tok = lm.tokenizer
    for resp in (burst, lone):
        for j, e in enumerate(resp["choices"][0]["logprobs"]["content"]):
            if e["token"] != e["top_logprobs"][0]["token"]:
                raise AssertionError(f"sampling logprobs: token {j} "
                                     f"{e['token']!r} is not its top entry")
    params, _ = parse_chat_request(body, ModelPrompts(), False)
    eng = InferenceEngine(lm, n_ctx=4096, n_parallel=8, cache_type="f16")
    try:
        tid = eng.request_completion(params)
        while True:
            r = eng.next_result(tid, timeout=600.0)
            if r.error:
                raise AssertionError(f"sampling logprobs: {r.error_message}")
            if r.stop:
                break
    finally:
        eng.shutdown()
    served = lone["choices"][0]["logprobs"]["content"]
    if len(served) != len(r.probs) or not served:
        raise AssertionError(f"sampling logprobs: {len(served)} served "
                             f"entries, {len(r.probs)} direct")
    worst = 0.0
    for e, d in zip(served, r.probs):
        if [t["token"] for t in e["top_logprobs"]] != \
                [t["piece"] for t in d["top"]]:
            raise AssertionError(f"sampling logprobs: served {e} direct {d}")
        worst = max(worst, max(abs(a["logprob"] - b["logprob"]) for a, b in
                               zip(e["top_logprobs"], d["top"])))
    # the burst's entries against a one-row teacher-forced run (logged)
    content = burst["choices"][0]["logprobs"]["content"]
    n = min(len(content), len(generated))
    logits, _ = tf_logits(LL.forward_step, lm.weights, lm.cfg,
                          _kv_cache(lm.cfg, 1, 1024, "cuda"),
                          [_prompt_ids(tok, body)], n - 1,
                          feed=[[t] for t in generated[:n - 1]])
    logp = torch.log_softmax(logits[:, 0].double(), dim=-1).cpu().numpy()
    tf_worst = max(float(np.abs(np.asarray(
        [t["logprob"] for t in e["top_logprobs"]])
        - np.sort(logp[j])[::-1][:len(e["top_logprobs"])]).max())
        for j, e in enumerate(content[:n]))
    log(f"sampling logprobs: {len(served)} tokens, each its top entry; alone "
        f"within {worst:.3e} nats of a direct engine run (tol {LOGPROB_TOL}); "
        f"in the burst {tf_worst:.3e} nats from a one-row teacher-forced run "
        "(logged)")
    if worst > LOGPROB_TOL:
        raise AssertionError("sampling: served logprobs differ from the "
                             "direct engine run's")
    return dict(tokens=len(served), max_dlogprob=worst,
                burst_vs_teacher_forced=tf_worst)


class DrawRecorder:
    """Wraps sample_step (decode_loop's and sample_first's) to keep, for
    every call, its inputs (logits, per-slot params, penalty ring, grammar
    rows) and its Gumbel draws (read by also wrapping gumbel_noise), with
    the rows the engine had active (EngineOps.dloop's mask;
    sample_first's sampled slots), so that a draw can be replayed on
    changed logits (replay)."""

    def __init__(self):
        from tpu_engine_torch.sampling import device as SD

        self.SD, self.calls, self.active = SD, [], None
        self.real = (SD.sample_step, OPS.sample_step, SD.gumbel_noise,
                     OPS.EngineOps.dloop, OPS.EngineOps.sample_first)

    def __enter__(self):
        SD = self.SD
        step, _, noise_fn, dloop, first = self.real
        noise = {}

        def gumbel(*a, **kw):
            noise["last"] = noise_fn(*a, **kw)
            return noise["last"]

        def sample_step(logits, params, state, gbank=None):
            toks, st = step(logits, params, state, gbank=gbank)
            n = noise["last"]  # a draw per (slot, token id)
            if state.row_span is not None:
                lo, _ = state.row_span
                n = n[lo:lo + logits.shape[0]]
            self.calls.append(dict(
                tokens=toks.cpu().numpy(), active=self.active,
                logits=logits.clone(), params=params, ring=state.ring,
                gstate=state.gstate, gbank=gbank, noise=n))
            return toks, st

        def dloop_(ops, n_inner, active, reset=None):
            self.active = np.asarray(active, bool)
            return dloop(ops, n_inner, active, reset=reset)

        def first_(ops, logits, by_slot, prevs, seed, gstate=None):
            self.active = np.asarray([p is not None for p in by_slot])
            return first(ops, logits, by_slot, prevs, seed, gstate=gstate)

        SD.sample_step, OPS.sample_step, SD.gumbel_noise = (
            sample_step, sample_step, gumbel)
        OPS.EngineOps.dloop, OPS.EngineOps.sample_first = dloop_, first_
        return self

    def __exit__(self, *exc):
        (self.SD.sample_step, OPS.sample_step, self.SD.gumbel_noise,
         OPS.EngineOps.dloop, OPS.EngineOps.sample_first) = self.real

    def slot_calls(self, slot: int) -> list:
        """The calls that drew for slot `slot` while it was active, in
        order: call n drew its n-th generated token."""
        return [c for c in self.calls
                if c["active"] is not None and c["active"][slot]]

    def replay(self, call: dict, slot: int, change=None) -> tuple:
        """Slot `slot`'s draw of `call` again, on its logits plus `change`
        ([V], or none), with the call's own Gumbel draws: (token, gap of
        the two best scores, the kept candidates)."""
        SD = self.SD
        x = call["logits"][slot:slot + 1]
        if change is not None:
            x = x + change[None, :]
        params = SD.param_rows(call["params"], slot, slot + 1)
        state = SD.DeviceSamplerState(ring=call["ring"][slot:slot + 1],
                                      gen=None,
                                      gstate=call["gstate"][slot:slot + 1])
        v, idx = SD.candidates(SD.filtered_logits(x, params, state,
                                                  call["gbank"]), params)
        score = (v / torch.clamp(params.temp, min=1e-6)[:, None]
                 + call["noise"][slot:slot + 1].gather(1, idx))[0]
        top2 = score.topk(2)
        return (int(idx[0, top2.indices[0]]),
                float(top2.values[0] - top2.values[1]),
                set(idx[0][torch.isfinite(v[0])].tolist()))


# prompt tokens of the DP=2 cycle: two a prefill bucket (32, 64, 128, 256),
# so every first token is drawn on the device from the engine's seeded
# generator (a prompt alone in its bucket takes its first token from the
# host chain, seeded afresh: serve/engine.py, as in the JAX package)
SAMP_PROMPTS = [18, 24, 40, 50, 80, 100, 140, 180]


def sampled_bodies(tok) -> list:
    """Chat bodies (_chat_body) of SAMP_PROMPTS tokens at temperature
    SAMP_TEMP, not streamed."""
    return [dict(_chat_body(tok, i, n), temperature=SAMP_TEMP, stream=False)
            for i, n in enumerate(SAMP_PROMPTS)]


def engine_run(eng, bodies) -> dict:
    """The bodies queued on the engine's loop at once (the schedule, and
    with it the draws, does not follow thread timing); {prompt ids:
    (slot, generated ids)}."""
    from tpu_engine_torch.api.openai import ModelPrompts, parse_chat_request

    params = [parse_chat_request(b, ModelPrompts(), True)[0] for b in bodies]
    tids = eng._call_on_loop(lambda: [eng.request_completion(p)
                                      for p in params])
    for tid in tids:
        while True:
            r = eng.next_result(tid, timeout=600.0)
            if r.error:
                raise AssertionError(r.error_message)
            if r.stop:
                break
    return {tuple(s.prompt_tokens): (s.id, list(s.generated_tokens))
            for s in eng.slots}


def dp_sampled_cycle(path: str, lm, bound: float, smi: str) -> dict:
    """The chat bodies of SAMP_PROMPTS at temperature SAMP_TEMP through a
    1x1 engine and a data_parallel 2 grid (start_leader, two ranks on
    cuda:0 over gloo), the sampler seeded with SAMP_SEED on both: each
    request's tokens equal, or the first differing one at a near-tie of
    the 1x1 run's draw (every rank draws every slot's noise and keeps its
    rows, sampling/device.py; a DP rank's logits round apart from one
    rank's): replayed with its own Gumbel draws on its logits moved by at
    most bound * max |logit| each, the 1x1 draw gives the DP run's token.
    A near-tie of the two best scores (within the bound over the
    temperature) is one such case; a token at a top_k, top_p or min_p
    cut within the bound is another. The grid's ranks agree bit for bit
    (verify_state)."""
    from tpu_engine_torch.dist.multihost import start_leader, verify_engine
    from tpu_engine_torch.serve.engine import InferenceEngine
    from tpu_engine_torch.serve.registry import Grid

    bodies = sampled_bodies(lm.tokenizer)
    kw = dict(n_ctx=4096, n_parallel=8, cache_type="f16")
    out = {}
    with decode_chunk(16):
        zero_launches()
        eng = InferenceEngine(lm, **kw)
        eng._dev_seed = SAMP_SEED
        t0 = time.time()
        try:
            with DrawRecorder() as rec:
                one = engine_run(eng, bodies)
        finally:
            eng.shutdown()
        out["1x1"] = dict(launches={**DM.LAUNCHES, **FA.LAUNCHES},
                          wall_s=time.time() - t0)
        zero_launches()
        grid = Grid(2, PAR_DEVICES, "gloo")
        try:
            eng = start_leader(path, 1, channel=grid.channel, data_parallel=2,
                               devices=PAR_DEVICES, seed=SAMP_SEED, **kw)
            t0 = time.time()
            try:
                dp = engine_run(eng, bodies)
                if not verify_engine(eng):
                    raise AssertionError(f"sampling DP=2: the ranks' state "
                                         f"diverged: {eng.ops.last_state}")
            finally:
                eng.shutdown()
        finally:
            grid.close()
        no_process_left("sampling DP=2")
        out["dp2"] = dict(launches=grid_launches(), wall_s=time.time() - t0)
    ties, n_tok = [], 0
    for ids, (slot, a) in one.items():
        b = dp[ids][1]
        n_tok += len(a)
        calls = rec.slot_calls(slot)
        drawn = [int(c["tokens"][slot]) for c in calls][:len(a)]
        if drawn != a:
            raise AssertionError(f"sampling DP=2: slot {slot}'s tokens were "
                                 f"not all drawn on the device: {a} vs {drawn}")
        if a == b:
            continue
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        if j >= min(len(a), len(b)) or j >= len(calls):
            raise AssertionError(f"sampling DP=2: slot {slot}: one run "
                                 f"stopped where the other went on ({j})")
        # the 1x1 draw again, each logit moved by at most the bound
        # (delta) toward the DP run's pick: that pick up by delta, every
        # other token down by delta (the change that favours it most, in
        # the penalties, the top_k / top_p / min_p cuts and the scores)
        call = calls[j]
        row = call["logits"][slot]
        delta = bound * float(row.abs().max())
        change = torch.full_like(row, -delta)
        change[b[j]] = delta
        same, gap, kept = rec.replay(call, slot)
        moved, _, _ = rec.replay(call, slot, change)
        log(f"sampling DP=2: slot {slot} first differs at generated token "
            f"{j}: {a[j]} (1x1, replayed {same}) vs {b[j]} ("
            f"{'in' if b[j] in kept else 'not in'} the 1x1 draw's kept set "
            f"of {len(kept)}); the 1x1 draw's two best Gumbel scores "
            f"{gap:.4e} apart (bound / T {delta / SAMP_TEMP:.4e}); with each "
            f"logit moved by at most {delta:.4e} toward {b[j]} it draws "
            f"{moved}")
        if same != a[j] or moved != b[j]:
            raise AssertionError(f"sampling DP=2: slot {slot} differs from the "
                                 "1x1 run beyond a near-tie")
        ties.append((slot, j, gap, delta))
    log(f"sampling DP=2 at temperature {SAMP_TEMP}: {n_tok} sampled tokens of "
        f"{len(one)} requests, {len(ties)} requests parted at a near-tie; "
        f"1x1 {out['1x1']['wall_s']:.2f}s, DP=2 {out['dp2']['wall_s']:.2f}s "
        f"[{smi}]")
    out.update(tokens=n_tok, ties=ties, bound=bound)
    return out


def sampling_phase(path: str, lm, smi: str, par: dict) -> dict:
    """The device sampler on the card against the host chain (A6), with a
    torch generator and numpy seeds of its own: the kept candidate sets
    of eight prefill rows of the smoke model without and with penalties
    over a filled ring; N_DRAWS draws from one row; a served burst that
    mixes the lanes (lane_burst_cycle); a DP=2 cycle at temperature
    SAMP_TEMP against 1x1 (dp_sampled_cycle)."""
    from tpu_engine_torch.sampling import SamplingParams

    t_phase = time.time()
    cfg = lm.cfg
    rng = np.random.default_rng(SAMP_SEED)
    prompts = rng.integers(300, cfg.n_vocab, (8, 64)).tolist()
    rows = tf_logits(LL.forward_step, lm.weights, cfg,
                     _kv_cache(cfg, 8, 128, "cuda"), prompts, 0)[0][0]
    host = rows.cpu().numpy()
    plain = SamplingParams(temperature=SAMP_TEMP, top_k=40, top_p=0.9,
                           min_p=0.05, repeat_penalty=1.0)
    pen = SamplingParams(temperature=SAMP_TEMP, top_k=40, top_p=0.9,
                         min_p=0.05, repeat_penalty=1.3,
                         frequency_penalty=0.4, presence_penalty=0.6)
    # a filled ring: 64 tokens of each row's 100 best, with repeats
    rings = [rng.choice(np.argsort(-host[b])[:100], 64).tolist()
             for b in range(8)]
    out = {"kept": kept_sets(rows, plain, [[] for _ in range(8)]),
           "kept penalties": kept_sets(rows, pen, rings)}
    log(f"sampling: kept sets equal on the card and the host, without "
        f"penalties {out['kept']} and with them over a filled ring "
        f"{out['kept penalties']} (tol {KEEP_TOL})")
    out["draws"] = draws_check(rows[0], plain, host_kept(host[0], plain, []))
    srv, th, base = start_server()
    try:
        out["burst"] = lane_burst_cycle(srv, base, path, lm, smi)
    finally:
        stop_server(srv, th)
    out["dp2"] = dp_sampled_cycle(path, lm, par["served_bounds"]["f16"], smi)
    out["wall_s"] = time.time() - t_phase
    log(f"sampling: the phase in {out['wall_s']:.1f}s [{smi}]")
    return out


# ------------------------------------------------------------------ load
LOAD_SEED = 18      # the load phase's own numpy seed: no other phase's draws
LOAD_SOURCE = ("tpu_engine_torch/csrc/extract.cu",
               "tpu_engine/native/convert.cc:312")  # not a Pallas kernel
LOAD_SHAPE = (4096, 4096)  # each format's timed tensor (Llama-2-7B's wq)
LOAD_RAGGED = 333   # rows of each format's second tensor: a ragged grid edge
# byte offsets of each block's f16 fields (d, and dmin / m where present)
F16_AT = {"Q4_0": (0,), "Q4_1": (0, 2), "Q5_0": (0,), "Q5_1": (0, 2),
          "Q8_0": (0,), "Q2_K": (80, 82), "Q3_K": (108,), "Q4_K": (0, 2),
          "Q5_K": (0, 2), "Q6_K": (208,)}


def random_blocks(rng, ty, n: int, k: int) -> np.ndarray:
    """n rows of k elements of type ty as random block bytes: every byte
    random, each f16 field a random finite bit pattern (negatives, zeros,
    subnormals; an Inf/NaN exponent turned into a subnormal one)."""
    from tpu_engine_torch.gguf.constants import GGML_BLOCK_INFO

    blk, nbytes = GGML_BLOCK_INFO[ty]
    nb = n * k // blk
    raw = rng.integers(0, 256, size=(nb, nbytes), dtype=np.uint8)
    for off in F16_AT[ty.name]:
        h = rng.integers(0, 1 << 16, size=nb).astype(np.uint16)
        h[(h & 0x7C00) == 0x7C00] &= 0x83FF
        raw[:, off:off + 2] = h.view(np.uint8).reshape(nb, 2)
    return raw.reshape(-1)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bytes (an f32 -0.0 differs from 0.0)."""
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def extract_rows(timer: Timer, smi: str) -> list[dict]:
    """The extract kernel against extract_plain for every LAYOUTS format at
    LOAD_SHAPE and at LOAD_RAGGED rows, equal bit for bit; at LOAD_SHAPE
    its time (median of 20 after the L2 flush), the plain version's (host
    numpy, median of 3) and its byte bound (raw in, qs, scale and bias
    out)."""
    from tpu_engine_torch.quant.device_format import LAYOUTS

    rng = np.random.default_rng(LOAD_SEED)
    rows = []
    k = LOAD_SHAPE[1]
    for ty in LAYOUTS:
        for n in (LOAD_SHAPE[0], LOAD_RAGGED):
            host = torch.from_numpy(random_blocks(rng, ty, n, k))
            raw = host.cuda()
            out = EX.alloc(ty, n, k, "cuda")
            EX.extract_cuda(raw, ty, n, k, out)
            torch.cuda.synchronize()
            want = EX.extract_plain(host, ty, n, k)
            if not all((a is None and b is None) or bits_equal(a, b)
                       for a, b in zip(out, want)):
                raise AssertionError(f"extract {ty.name} {n}x{k}: the kernel "
                                     "differs from extract_plain")
            nbytes = raw.numel() + sum(t.numel() * t.element_size()
                                       for t in out if t is not None)
            row = dict(kernel="extract", format=ty.name, shape=f"{n}x{k}",
                       main=n == LOAD_SHAPE[0], max_abs_err=0.0,  # equal bits
                       bytes=nbytes,
                       bound_ms=nbytes / HBM_BYTES_S * 1e3, bound_by="bytes",
                       library_ms=None)
            if row["main"]:
                row["ms"] = timer(lambda: EX.extract_cuda(raw, ty, n, k, out))
                row["plain_ms"] = _median_s(
                    lambda: EX.extract_plain(host, ty, n, k)) * 1e3
                log(f"extract {ty.name} {n}x{k}: {row['ms']:.4f} ms (bound "
                    f"{row['bound_ms']:.4f}, bytes), plain (numpy) "
                    f"{row['plain_ms']:.1f} ms; equal bits [{smi}]")
            else:
                log(f"extract {ty.name} {n}x{k}: equal bits")
            rows.append(row)
            del raw, out
    return rows


def quantized_equal(a, b, where: str = "") -> int:
    """Every quantized QTensor of weight tree a equals b's bit for bit
    (qs, scale, bias; any devices); returns how many were compared."""
    if isinstance(a, W.QTensor):
        if a.kind == "dense":
            return 0
        if ((a.kind, a.group, a.shape) != (b.kind, b.group, b.shape)
                or not all((x is None and y is None) or bits_equal(x, y)
                           for x, y in ((a.qs, b.qs), (a.scale, b.scale),
                                        (a.bias, b.bias)))):
            raise AssertionError(f"{where}: the card's load differs from the "
                                 "CPU's")
        return 1
    if isinstance(a, dict):
        return sum(quantized_equal(v, b[k], f"{where}.{k}")
                   for k, v in a.items())
    if isinstance(a, list):
        return sum(quantized_equal(v, w, f"{where}[{i}]")
                   for i, (v, w) in enumerate(zip(a, b)))
    return 0


def load_against_cpu(path: str, lm, label: str) -> dict:
    """Load path again on the CPU (extract_plain: numpy, the route before
    the kernel) and hold lm's quantized tensors to it bit for bit."""
    from tpu_engine_torch.model.loader import load_model

    t0 = time.time()
    ref = load_model(path, device="cpu")
    cpu_s = time.time() - t0
    n = quantized_equal(lm.weights, ref.weights, label)
    log(f"{label}: {n} quantized tensors of the card's load equal the CPU "
        f"load's bit for bit; CPU load {cpu_s:.1f}s, split "
        f"{ {k: round(v, 3) for k, v in ref.load_split.items()} }")
    return dict(tensors=n, cpu_s=cpu_s, cpu_split=ref.load_split)


def load_phase(path: str, smi: str, timer: Timer) -> tuple[dict, list]:
    """The extract kernel (extract_rows), then the smoke model loaded on the
    card by load_model, the main path of a load, with every count zeroed
    just before and read just after; its quantized tensors held to a CPU
    load's. Returns (result, kernel rows)."""
    from tpu_engine_torch.model.loader import load_model

    t_phase = time.time()
    rows = extract_rows(timer, smi)
    torch.cuda.empty_cache()
    zero_launches()
    t0 = time.time()
    lm = load_model(path, device="cuda")
    torch.cuda.synchronize()
    card_s = time.time() - t0
    launches = grid_launches()
    if not launches["extract"]:
        raise AssertionError("load: load_model extracted nothing on the card")
    log(f"load: {path} on the card in {card_s:.2f}s, split "
        f"{ {k: round(v, 3) for k, v in lm.load_split.items()} }; launches "
        f"{launches} [{smi}]")
    out = dict(launches=launches, card_s=card_s, split=lm.load_split,
               **load_against_cpu(path, lm, "load smoke model"))
    del lm
    torch.cuda.empty_cache()
    out["wall_s"] = time.time() - t_phase
    log(f"load: the phase in {out['wall_s']:.1f}s [{smi}]")
    return out, rows


def load_line(rows: list[dict], launches: int) -> dict:
    """The kernels line of extract: the ten formats at LOAD_SHAPE, one
    tensor each, summed (and each under "formats")."""
    sel = [r for r in rows if r["main"]]
    return dict(name="extract", route="cuda", source=LOAD_SOURCE[0],
                replaces=LOAD_SOURCE[1], launches=int(launches),
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=sum(r["ms"] for r in sel),
                plain_ms=sum(r["plain_ms"] for r in sel),
                bound_ms=sum(r["bound_ms"] for r in sel), bound_by="bytes",
                library_ms=None,
                shapes=f"{LOAD_SHAPE[0]}x{LOAD_SHAPE[1]} of each LAYOUTS "
                       "format, summed",
                formats=[dict(format=r["format"], ms=r["ms"],
                              plain_ms=r["plain_ms"], bound_ms=r["bound_ms"])
                         for r in sel])


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


def summarize(rows: list[dict], launches: dict, tp_launches: dict,
              fam_rows: list[dict], fam_launches: dict, phi_rows: list[dict],
              phi_launches: dict, load_rows: list[dict],
              load_launches: int) -> list[dict]:
    """One line per kernel: the main-path shape set of a decode step for the
    projections (M=8, summed over the layer's tensors of that kernel); for
    attention the row attn_cases marks (B=8 KH=32 decode at fills 1..511
    and the B=1 Tc=512 history-0 prefill: f16 "td", q8_0 "dt"; the rope
    kernels at the same shapes with self-extend at ATTN_GA). The qmm lines
    carry under "encoder" an encoder layer's products (ENC_LAYERS) at each
    bucket of ENC_MS, with library_ms cuBLAS bf16 on the same shapes.
    Then a line "<kernel> tp2" for each kernel at a TP=2 rank's shapes
    (PAR_QMM, PAR_ATTN), its launches those of the TP=2 runs (tp_launches:
    rank 0's and its follower's), and a line "<kernel> families" for each
    kernel at the family phase's shapes (fam_rows: FAM_QMM, FAM_ATTN), its
    launches those of the family models' runs and served cycles, and a
    line "<kernel> phi3 tp2" for qmm_nib4 and qmm_i8 at a TP=2 phi3 rank's
    shapes (phi_rows: PHI_TP_QMM), its launches those of phi3's TP=2 model
    check and served cycle (both ranks). Last, the line of the load's
    kernel, extract (load_line), its launches those of the main path's
    loads (load_launches)."""
    out = []
    for name, (src, repl) in SOURCES.items():
        if name.startswith("qmm"):
            sel = [r for r in rows if r["kernel"] == name and r["M"] == 8
                   and r["timed"] and not r.get("encoder") and not r.get("tp")]
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
    for sfx, sub, counts in (("tp2", [r for r in rows if r.get("tp")],
                              tp_launches),
                             ("families", fam_rows, fam_launches),
                             ("phi3 tp2", phi_rows, phi_launches)):
        for name, (src, repl) in SOURCES.items():
            sel = [r for r in sub if r["kernel"] == name]
            if sel:
                out.append(dict(
                    name=f"{name} {sfx}", route="cuda", source=src,
                    replaces=repl, launches=int(counts[name]),
                    max_abs_err=max(r["max_abs_err"] for r in sel),
                    **_sum_rows([(r, 1) for r in sel]),
                    shapes="; ".join(r["shape"] for r in sel)))
    out.append(load_line(load_rows, load_launches))
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
    rows = (qmm_phase(timer, gen) + attn_phase(timer, gen)
            + par_kernel_rows(timer, gen))
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
        detail["load"], load_rows = load_phase(path, smi, Timer(ITERS))
        detail["load_kernel_rows"] = load_rows
        detail["model"] = model_phase(path)
        detail["server"] = server_phase(path, smi)
        detail["parallel"] = parallel_phase(path, tmp, smi, detail["server"])
        detail["embedding"] = embedding_phase(tmp, smi, path, Timer(ITERS))
        from tpu_engine_torch.model.loader import load_model

        lm = load_model(path, device="cuda")
        detail["perplexity"] = perplexity_phase(lm, smi)
        detail["chat"] = chat_phase(path, lm)
        detail["multimodal"] = multimodal_phase(tmp, path, lm, smi)
        detail["families"], fam_rows, fam_launches = family_phase(
            tmp, smi, Timer(ITERS))
        detail["family_kernel_rows"] = fam_rows
        detail["grids"], phi_rows, phi_launches = grid_phase(
            tmp, path, lm, smi, detail["parallel"], Timer(ITERS))
        detail["grid_kernel_rows"] = phi_rows
        detail["sampling"] = sampling_phase(path, lm, smi, detail["parallel"])
        del lm
    # launches of the main path: the five server cycles and the three
    # embedding cycles, each counted from zero at its /loadmodel to its
    # /unloadmodel; the perplexity evaluations and the in-process chat,
    # each counted from zero; the two multimodal cycles as the server's
    cycles = list(detail["server"].values()) + [
        detail["embedding"][label]["server"] for label, *_ in ENC_MODELS] + [
        detail["embedding"]["llama causal"], detail["perplexity"],
        detail["chat"], detail["multimodal"]["llava-1.5 f16"],
        detail["multimodal"]["llava-1.6 q8_0"]]
    # the parallel phase: the TP=2 and DP=2 model runs, the three grid
    # cycles (rank 0's launches and its follower's) and the 1x1 mesh engine
    par = detail["parallel"]
    tp_cycles = [par["tp_model"], par["tp2 f16"], par["tp2 q8_0"]]
    cycles += tp_cycles + [par["dp_model"], par["dp2 f16"], par["1x1 mesh"]]
    # the grid phase (phi3 at TP=2, its 1x1 cycle, the image chats and the
    # embedding loads) and the sampling phase's burst and DP=2 cycle
    grids, samp = detail["grids"], detail["sampling"]
    cycles += [grids["phi3"]["1x1 f16"], grids["phi3"]["tp2 f16"],
               *grids["llava"].values(),
               *(v for k, v in grids["embeddings"].items()),
               samp["burst"], samp["dp2"]["1x1"], samp["dp2"]["dp2"]]
    launches = {k: sum(c["launches"][k] for c in cycles) for k in SOURCES}
    tp_launches = {k: sum(c["launches"][k] for c in tp_cycles) for k in SOURCES}
    # the load's kernel: the load phase's load_model and every cycle whose
    # counts include it (the server's and the grids' /loadmodel cycles)
    launches["extract"] = detail["load"]["launches"]["extract"] + sum(
        c["launches"]["extract"] for c in cycles if "extract" in c["launches"])
    detail["launches"] = launches
    detail["tp_launches"] = tp_launches
    detail["wall_s"] = time.time() - t_start
    log(f"chip_smoke: every phase in {detail['wall_s']:.1f}s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(detail, fh, indent=1)
    print(json.dumps({"kernels": summarize(rows, launches, tp_launches,
                                           fam_rows, fam_launches, phi_rows,
                                           phi_launches, load_rows,
                                           launches["extract"])}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
