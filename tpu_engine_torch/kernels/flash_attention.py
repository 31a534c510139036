"""Flash attention over the slot-paged KV cache: CUDA kernels attn_decode
and attn_prefill ("td" cache, csrc/attn.cu), attn_decode_dt and
attn_prefill_dt ("dt" cache, csrc/attn_dt.cu) for K stored pre-rotated;
attn_decode_rope, attn_prefill_rope (csrc/attn_rope.cu),
attn_decode_dt_rope and attn_prefill_dt_rope (csrc/attn_dt_rope.cu) for K
stored unrotated (self-extend); shared code in csrc/attn_common.cuh.

They replace, in tpu_engine/kernels/flash_attention.py: attn_decode
_decode_kernel_bh, attn_prefill _prefill_kernel (rotated=True),
attn_decode_dt _decode_kernel_dma and _decode_kernel_t (rotated=True),
attn_prefill_dt _prefill_kernel_t (rotated=True); attn_decode_rope
_decode_kernel, attn_prefill_rope _prefill_kernel (rotated=False),
attn_decode_dt_rope _decode_kernel_t (rotated=False), attn_prefill_dt_rope
_prefill_kernel_t (rotated=False). All take f32, bf16 ("f16"), q8_0 or
q4_0 cells (with their per-(token, kv head) scales), read directly at
cache[li, slot_ids[b]]: history cells < start[b] plus the step's
in-flight rows (K rotated), per-row n_valid, sliding window and logit
softcap. The rope kernels rotate each cached K cell p by cos/sin tables
[T, rope_dim/2] (rope_tables: the self-extend remap of p baked in), which
the cache keeps from their first use (KVCache.rope_tables).
Scores, softmax and the PV sum are f32 (the TPU decode kernels on
pre-rotated K feed bf16 operands to their dots; the plain version and
these kernels stay f32). The decode kernels split each row's cells into
splits of DEC_SPLIT, one block each, and merge the splits in a second
pass over a workspace the wrapper allocates; decode_split_plain is that
arithmetic in plain PyTorch, for the tests and chip_smoke.py.

flash_attention() has model.llama.attention_reference's signature and is
the attention the model calls: on CUDA tensors it launches a kernel (or
raises); on CPU tensors it runs attention_reference, the plain version.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..kvcache.cache import KVCache
from ..model.config import ModelConfig
from ..model.llama import (NEG_INF, attention_reference, rope_cos_sin,
                           self_extend_pos)
from . import _build

# kernel -> the library (csrc/<name>.cu) that holds it
_LIBS = {"attn_decode": "attn", "attn_prefill": "attn",
         "attn_decode_dt": "attn_dt", "attn_prefill_dt": "attn_dt",
         "attn_decode_rope": "attn_rope", "attn_prefill_rope": "attn_rope",
         "attn_decode_dt_rope": "attn_dt_rope",
         "attn_prefill_dt_rope": "attn_dt_rope"}

# launches per kernel, bumped only where a kernel is launched; under a lock,
# since separate engines (two loaded models) launch from their own threads
LAUNCHES = dict.fromkeys(_LIBS, 0)
_LAUNCHES_LOCK = threading.Lock()

# cache cells per decode split: attn_common.cuh's DEC_SPLIT
DEC_SPLIT = 64

# cell kind -> (attn::Kind of attn_common.cuh, stored dtype)
_KINDS = {"f32": (0, torch.float32), "f16": (1, torch.bfloat16),
          "q8_0": (2, torch.int8), "q4_0": (3, torch.uint8)}


def _fn(name: str):
    """The launcher `name` (attn_common.cuh's ATTN_ENTRY: 7 pointers, kind,
    4 pointers, 9 ints, scale, softcap, cos_t, sin_t, rd, ws, stream)."""
    f = getattr(_build.load(_LIBS[name]), name)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                      + [ctypes.c_float, ctypes.c_float]
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 2)
        f.restype = ctypes.c_int
    return f


def rope_tables(cfg: ModelConfig, T: int, ga_n, ga_w, device):
    """cos/sin [T, rope_dim/2] f32 by cache cell, the self-extend remap
    baked in: rope_cos_sin(self_extend_pos(arange(T))), the values
    attention_reference rotates cell p with. The kernels rotate by split
    halves only: "norm" rope models are de-interleaved at load
    (model/loader.py)."""
    rd = cfg.rope_dim
    if cfg.rope_type != "neox" or rd % 2 or rd > cfg.head_dim:
        raise ValueError("rope attention kernels: split-half (neox) rope of "
                         f"an even rope_dim <= head_dim only, got "
                         f"{cfg.rope_type} rope_dim={rd} head_dim={cfg.head_dim}")
    pos = self_extend_pos(torch.arange(T, dtype=torch.int32, device=device),
                          int(ga_n), int(ga_w))
    cos, sin = rope_cos_sin(pos, cfg)
    return cos.contiguous(), sin.contiguous()


def cache_rope_tables(cache: KVCache, cfg: ModelConfig, ga_n, ga_w):
    """rope_tables for `cache`'s cells, built on first use and kept in
    cache.rope_tables: a loaded model builds them once for all its layers
    and steps, and they go when its cache goes."""
    ga_n, ga_w = int(ga_n), int(ga_w)
    if ga_n <= 1:  # no remap: the identity map whatever ga_w is
        ga_n, ga_w = 1, 0
    key = (ga_n, ga_w, cfg.rope_freq_table())
    tabs = cache.rope_tables.get(key)
    if tabs is None:
        tabs = cache.rope_tables[key] = rope_tables(
            cfg, cache.max_len, ga_n, ga_w, cache.k.device)
    return tabs


def _by_pair(cache: KVCache, tables):
    """tables [T, rd/2] as [rd/2, T], the form attn_decode_dt_rope reads
    (runs of cells, as it reads the "dt" cache): kept on the cache beside
    the tables of cache_rope_tables they come from, else made here."""
    for key, val in list(cache.rope_tables.items()):
        if val[0] is tables[0]:
            pair_key = ("by_pair",) + key
            if pair_key not in cache.rope_tables:
                cache.rope_tables[pair_key] = tuple(t.t().contiguous()
                                                    for t in tables)
            return cache.rope_tables[pair_key]
    return tuple(t.t().contiguous() for t in tables)


def _check(q, k_new, v_new, cache: KVCache, slot_ids, starts, n_valid, dt,
           tables):
    """Validate the operands of one launch; returns (B, Tc, H, D, S, KH, T).
    The kernels take any even head_dim up to 256 and any number of query
    heads per kv head (attn_common.cuh)."""
    B, Tc, H, D = q.shape
    L, S, KH = cache.k.shape[:3]
    if D > 256 or D % 2 or H % KH:
        raise ValueError(f"attention kernels: unsupported heads/head_dim "
                         f"H={H} KH={KH} D={D}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("attention kernels take CUDA tensors")
    if (cache.layout == "dt") != dt:
        raise ValueError(f"{'dt' if dt else 'td'} attention kernel given a "
                         f"{cache.layout!r} cache")
    if cache.kind not in _KINDS:
        raise ValueError(f"attention kernels: kv kind {cache.kind!r}")
    _, want = _KINDS[cache.kind]
    T = cache.max_len
    Dk = D // 2 if cache.kind == "q4_0" else D
    plane = (L, S, KH, Dk, T) if dt else (L, S, KH, T, Dk)
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
    if tables is not None:
        cos, sin = tables
        for t in tables:
            if (t.dtype != torch.float32 or t.dim() != 2 or t.shape != cos.shape
                    or t.shape[0] != T or 2 * t.shape[1] > D):
                raise ValueError("attention kernels: rope tables must be f32 "
                                 f"[{T}, rope_dim/2] with rope_dim <= {D}")
            planes.append(t)
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
                softcap: float, tables=None) -> torch.Tensor:
    """Launch attention kernel `name` (a key of LAUNCHES): attn_decode* /
    attn_prefill* on a "td" cache, *_dt* on a "dt" cache (decode: Tc = 1),
    at any even head_dim up to 256 and any query-group size; the *_rope
    kernels take K stored unrotated and tables = rope_tables(...). q [B, Tc, H, D] f32,
    k/v_new [B, KH, Tc, D] f32 (K rotated), slot_ids/starts/n_valid [B]
    int32; returns a new [B, Tc, H, D] f32. Decode takes a workspace of
    (m, l, sum p v) per (row, query head, split of DEC_SPLIT cells), sized
    from cache.max_len alone: no device value is read here."""
    if name not in _LIBS:
        raise ValueError(f"no attention kernel {name!r}")
    if name.endswith("_rope") != (tables is not None):
        raise ValueError(f"{name}: rope tables go with the *_rope kernels, "
                         "and only with them")
    B, Tc, H, D, S, KH, T = _check(q, k_new, v_new, cache, slot_ids, starts,
                                   n_valid, "_dt" in name, tables)
    decode = name.startswith("attn_decode")
    if decode and Tc != 1:
        raise ValueError(f"{name} takes Tc == 1")
    out = torch.empty_like(q)
    ws = (torch.empty(B * H * decode_splits(T) * (D + 2), dtype=torch.float32,
                      device=q.device) if decode else None)
    P = _build.ptr
    ks = P(cache.k_scale) if cache.quantized else None
    vs = P(cache.v_scale) if cache.quantized else None
    rd = 2 * tables[0].shape[1] if tables else 0  # 0: nothing is rotated
    if name == "attn_decode_dt_rope":
        tables = _by_pair(cache, tables)
    cos, sin = (P(t) for t in tables) if tables else (None, None)
    rc = _fn(name)(
        P(q), P(k_new), P(v_new), P(cache.k), P(cache.v), ks, vs,
        _KINDS[cache.kind][0], P(slot_ids), P(starts), P(n_valid), P(out),
        B, Tc, KH, H // KH, D, S, T, int(li), int(window), float(scale),
        float(softcap), cos, sin, rd, None if ws is None else P(ws),
        _build.stream_ptr(q.device))
    _build.check(rc, name)
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1
    return out


def decode_splits(T: int) -> int:
    """Splits of DEC_SPLIT cells over cells [0, T]: the history and the
    in-flight cell at start <= T."""
    return T // DEC_SPLIT + 1


def _stored(cells: torch.Tensor, kind: str) -> torch.Tensor:
    """Stored cells [..., Dk] as f32 [..., D] without their scale."""
    if kind == "q4_0":
        lo = (cells & 0xF).to(torch.int32) - 8
        hi = (cells >> 4).to(torch.int32) - 8
        return torch.cat([lo, hi], dim=-1).to(torch.float32)
    return cells.to(torch.float32)


def decode_split_plain(q, cache: KVCache, li: int, slot_ids, starts, k_new,
                       v_new, window: int, scale: float, softcap: float,
                       tables=None, split: int = DEC_SPLIT) -> torch.Tensor:
    """The decode kernels' split arithmetic in plain PyTorch, for the tests
    and chip_smoke.py: attention_reference's function at Tc = 1, computed
    as the kernels compute it. Each split of `split` cells takes its own
    softmax over its cells with -1e30 masks (below the window's start, at
    or above the fill), the in-flight row folded into the split that holds
    cell start; a cached cell scores ks (q . k_stored) (K rotated as
    stored values by tables = rope_tables(...) when given), and p carries
    vs into the sum over stored V. The splits that ran (each holds a valid
    cell) merge by exp(m_s - max m); the others, all masked (m = -1e30,
    l = their cell count), weigh 0. q [B, 1, H, D]; returns [B, 1, H, D]
    f32."""
    B, _, H, D = q.shape
    KH = k_new.shape[1]
    G = H // KH
    T = cache.max_len
    NS = T // split + 1
    Tp = NS * split
    dev = q.device
    sl = slot_ids.long()
    kc, vc = cache.k[li, sl], cache.v[li, sl]
    if cache.layout == "dt":
        kc, vc = kc.transpose(-1, -2), vc.transpose(-1, -2)
    k, v = _stored(kc, cache.kind), _stored(vc, cache.kind)  # [B, KH, T, D]
    if tables is not None:
        cos, sin = tables
        h = cos.shape[1]
        x0, x1, rest = k[..., :h], k[..., h:2 * h], k[..., 2 * h:]
        k = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos, rest], -1)
    qf = q[:, 0].reshape(B, KH, G, D).to(torch.float32)
    raw = torch.einsum("bkgd,bktd->bkgt", qf, k)
    raw_new = torch.einsum("bkgd,bkd->bkg", qf, k_new[:, :, 0].to(torch.float32))
    vs = torch.ones((B, KH, T), dtype=torch.float32, device=dev)
    if cache.quantized:
        raw = raw * cache.k_scale[li, sl][:, :, None, :]
        vs = cache.v_scale[li, sl].to(torch.float32)

    def cap(x):
        return torch.tanh(x / softcap) * softcap if softcap > 0 else x

    pad = Tp - T
    sc = torch.nn.functional.pad(cap(raw * scale), (0, pad), value=NEG_INF)
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    vs = torch.nn.functional.pad(vs, (0, pad))
    start = starts.long().clamp(max=T)
    lo = (start - window + 1).clamp(min=0) if window > 0 else start * 0
    cell = torch.arange(Tp, device=dev)
    valid = (cell[None] < start[:, None]) & (cell[None] >= lo[:, None])
    sc = torch.where(valid[:, None, None], sc, NEG_INF)
    sc = sc.reshape(B, KH, G, NS, split)
    ns = torch.arange(NS, device=dev)
    holds = ns[None] == (start // split)[:, None]  # [B, NS]
    s_new = torch.where(holds[:, None, None], cap(raw_new * scale)[..., None],
                        NEG_INF)
    sc = torch.cat([sc, s_new[..., None]], -1)  # [B, KH, G, NS, split + 1]
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    l = p.sum(-1)
    pv = p[..., :split] * vs.reshape(B, KH, 1, NS, split)
    acc = torch.einsum("bkgsc,bkscd->bkgsd", pv, v.reshape(B, KH, NS, split, D))
    acc = acc + p[..., split:] * v_new[:, :, None, None, 0].to(torch.float32)
    live = (ns[None] >= (lo // split)[:, None]) & (ns[None] <= (start // split)[:, None])
    live = live[:, None, None]  # [B, 1, 1, NS]
    m_max = torch.where(live, m, float("-inf")).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - m_max), 0.0)
    out = (w[..., None] * acc).sum(-2) / (w * l).sum(-1)[..., None]
    return out.reshape(B, 1, H, D)


def flash_attention(q, cache, li, slot_ids, q_pos, n_valid, k_new, v_new,
                    cfg: ModelConfig, ga_n=1, ga_w=0, rot_cache: bool = False,
                    win=None) -> torch.Tensor:
    """Drop-in for model.llama.attention_reference. CPU tensors run the
    plain version; CUDA tensors launch, as the JAX package routes: "td"
    caches attn_decode (Tc == 1) or attn_prefill, "dt" caches
    attn_decode_dt or attn_prefill_dt; with K stored unrotated
    (rot_cache=False) the *_rope kernel of the same layout and Tc, given
    the rope tables of the cache's cells (cache_rope_tables)."""
    if q.device.type == "cpu":
        return attention_reference(q, cache, li, slot_ids, q_pos, n_valid,
                                   k_new, v_new, cfg, ga_n, ga_w,
                                   rot_cache=rot_cache, win=win)
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
    tables = None
    if not rot_cache:
        name += "_rope"
        tables = cache_rope_tables(cache, cfg, ga_n, ga_w)
    return attn_kernel(name, *args, window, cfg.attention_scale(),
                       float(cfg.attn_logit_softcap),
                       tables=tables).to(q.dtype)
