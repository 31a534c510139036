"""Flash attention over the slot-paged KV cache: CUDA kernels attn_decode
and attn_prefill ("td" cache, csrc/attn.cu), attn_decode_dt and
attn_prefill_dt ("dt" cache, csrc/attn_dt.cu); shared code in
csrc/attn_common.cuh.

attn_decode replaces tpu_engine/kernels/flash_attention.py _decode_kernel_bh,
attn_prefill _prefill_kernel (rotated=True), attn_decode_dt _decode_kernel_dma
and _decode_kernel_t (rotated=True), attn_prefill_dt _prefill_kernel_t
(rotated=True). All take the cache with K stored pre-rotated, f32, bf16
("f16"), q8_0 or q4_0 cells (with their per-(token, kv head) scales), read
directly at cache[li, slot_ids[b]]: history cells < start[b] plus the
step's in-flight rows, per-row n_valid, sliding window and logit softcap.
Scores, softmax and the PV sum are f32 (the TPU decode kernels feed bf16
operands to their dots; the plain version and these kernels stay f32).

flash_attention() has model.llama.attention_reference's signature and is
the attention the model calls: on CUDA tensors it launches a kernel (or
raises); on CPU tensors it runs attention_reference, the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..kvcache.cache import KVCache
from ..model.config import ModelConfig
from . import _build

# launches per kernel, bumped only where a kernel is launched
LAUNCHES = {"attn_decode": 0, "attn_prefill": 0, "attn_decode_dt": 0,
            "attn_prefill_dt": 0}

# cell kind -> (attn::Kind of attn_common.cuh, stored dtype)
_KINDS = {"f32": (0, torch.float32), "f16": (1, torch.bfloat16),
          "q8_0": (2, torch.int8), "q4_0": (3, torch.uint8)}


def _fn(name: str):
    """The launcher `name` of attn.so / attn_dt.so (attn_common.cuh's
    ATTN_ENTRY): 7 pointers, kind, 4 pointers, 9 ints, scale, softcap,
    stream."""
    lib = _build.load("attn_dt" if name.endswith("_dt") else "attn")
    f = getattr(lib, name)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                      + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def _check(q, k_new, v_new, cache: KVCache, slot_ids, starts, n_valid, dt):
    """Validate the operands of one launch; returns (B, Tc, H, D, S, KH, T)."""
    B, Tc, H, D = q.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("attention kernels take CUDA tensors")
    if (cache.layout == "dt") != dt:
        raise ValueError(f"{'dt' if dt else 'td'} attention kernel given a "
                         f"{cache.layout!r} cache")
    if cache.kind not in _KINDS:
        raise ValueError(f"attention kernels: kv kind {cache.kind!r}")
    _, want = _KINDS[cache.kind]
    L, S, KH = cache.k.shape[:3]
    T = cache.max_len
    Dk = D // 2 if cache.kind == "q4_0" else D
    plane = (L, S, KH, Dk, T) if dt else (L, S, KH, T, Dk)
    if D > 128 or D % 2 or H % KH or H // KH > 64:
        raise ValueError(f"attention kernels: unsupported heads/head_dim "
                         f"H={H} KH={KH} D={D}")
    planes = [cache.k, cache.v]
    for p in planes:
        if p.dtype != want or tuple(p.shape) != plane:
            raise ValueError(f"attention kernels: {cache.kind} cache planes "
                             f"must be {want} {plane}")
    if cache.quantized:
        for s in (cache.k_scale, cache.v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (L, S, KH, T):
                raise ValueError("attention kernels: scale planes must be "
                                 f"f32 {(L, S, KH, T)}")
            planes.append(s)
    elif cache.kind in ("q8_0", "q4_0"):
        raise ValueError(f"attention kernels: {cache.kind} cache without scales")
    for name, t, shape in (("q", q, (B, Tc, H, D)),
                           ("k_new", k_new, (B, KH, Tc, D)),
                           ("v_new", v_new, (B, KH, Tc, D))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"attention kernels: {name} must be f32 {shape}")
    ints = [("slot_ids", slot_ids), ("starts", starts), ("n_valid", n_valid)]
    for name, t in ints:
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"attention kernels: {name} must be int32 [{B}]")
    for t in (q, k_new, v_new, *planes, *(t for _, t in ints)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("attention kernels: every operand must be "
                             "contiguous on one CUDA device")
    return B, Tc, H, D, S, KH, T


def attn_kernel(name: str, q, k_new, v_new, cache: KVCache, li: int,
                slot_ids, starts, n_valid, window: int, scale: float,
                softcap: float) -> torch.Tensor:
    """Launch attention kernel `name`: attn_decode / attn_prefill on a "td"
    cache, attn_decode_dt / attn_prefill_dt on a "dt" cache (decode: Tc = 1
    and at most 8 query heads per kv head). q [B, Tc, H, D] f32, k/v_new
    [B, KH, Tc, D] f32 (K rotated), slot_ids/starts/n_valid [B] int32;
    returns a new [B, Tc, H, D] f32."""
    B, Tc, H, D, S, KH, T = _check(q, k_new, v_new, cache, slot_ids, starts,
                                   n_valid, name.endswith("_dt"))
    if name.startswith("attn_decode") and (Tc != 1 or H // KH > 8):
        raise ValueError(f"{name} takes Tc == 1 and at most 8 query heads "
                         "per kv head")
    out = torch.empty_like(q)
    P = _build.ptr
    ks = P(cache.k_scale) if cache.quantized else None
    vs = P(cache.v_scale) if cache.quantized else None
    rc = _fn(name)(
        P(q), P(k_new), P(v_new), P(cache.k), P(cache.v), ks, vs,
        _KINDS[cache.kind][0], P(slot_ids), P(starts), P(n_valid), P(out),
        B, Tc, KH, H // KH, D, S, T, int(li), int(window), float(scale),
        float(softcap), _build.stream_ptr(q.device))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def flash_attention(q, cache, li, slot_ids, q_pos, n_valid, k_new, v_new,
                    cfg: ModelConfig, ga_n=1, ga_w=0, rot_cache: bool = False,
                    win=None) -> torch.Tensor:
    """Drop-in for model.llama.attention_reference. CPU tensors run the
    plain version; CUDA tensors launch, as the JAX package routes: "td"
    caches attn_decode (Tc == 1) or attn_prefill, "dt" caches
    attn_decode_dt or attn_prefill_dt."""
    if q.device.type == "cpu":
        from ..model.llama import attention_reference

        return attention_reference(q, cache, li, slot_ids, q_pos, n_valid,
                                   k_new, v_new, cfg, ga_n, ga_w,
                                   rot_cache=rot_cache, win=win)
    if not rot_cache:
        raise NotImplementedError(
            "unrotated K (self-extend, grp_attn_n > 1) is not yet supported "
            "by tpu_engine_torch's CUDA attention (a later slice ports "
            "_decode_kernel and the rotated=False kernels)")
    Tc = q.shape[1]
    window = int(cfg.layer_window(li) if win is None else win)
    args = (q.to(torch.float32).contiguous(),
            k_new.to(torch.float32).contiguous(),
            v_new.to(torch.float32).contiguous(), cache, li,
            slot_ids.to(torch.int32).contiguous(),
            q_pos[:, 0].to(torch.int32).contiguous(),
            n_valid.to(torch.int32).contiguous())
    name = ("attn_decode" if Tc == 1 else "attn_prefill") + (
        "_dt" if cache.layout == "dt" else "")
    return attn_kernel(name, *args, window, cfg.attention_scale(),
                       float(cfg.attn_logit_softcap)).to(q.dtype)
