"""The tensor-parallel sharding plan: which rows or columns of each weight
a rank holds, and its slice of the KV cache.

The counterpart of the JAX package's dist/sharding.py. There a mesh and
NamedShardings let XLA place each array; here every rank is a process of
its own, so the plan is written out as slices:

  wq/wk/wv, w_gate/w_up : output features (rows, N) split      -> col-parallel
  wo, w_down            : input features (columns, K) split    -> row-parallel
                          (the ranks' partial products are summed)
  token_embd, output    : vocab rows split                     -> vocab-parallel
  KV cache              : kv heads split over "model", slots over "data"

A weight is a QTensor in the port's natural layout (model/weights.py):
qs [N, K or K/2], scale and bias [N, K/G]. A row slice cuts all three on
the same rows; a column slice cuts qs on element columns and scale/bias on
whole quantization groups, so each rank's slice is itself a valid QTensor
with the same group (the kernels need K % 32 == 0 and group 16 or 32).
Slicing follows groups, not 256-wide superblocks: at Llama-2-7B widths
w_down has K = 11008, 5504 a rank at p = 2, a multiple of 32 but not of
256. A dimension that does not divide (or, for a column slice, does not
fall on group edges) stays whole on every rank, as the JAX package
replicates what it cannot split.
"""

from __future__ import annotations

import torch

from ..kvcache.cache import KVCache
from ..model.weights import QTensor

# weight role -> which logical axis of [N, K] is split
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up"}  # split N (dim 0)
_ROW_PARALLEL = {"wo", "w_down"}  # split K (dim 1)
_VOCAB_PARALLEL = {"token_embd", "output"}  # split N (dim 0)

# GGUF tensor name (after "blk.{i}.") -> role; biases split as their rows
_GGUF_ROLE = {
    "attn_q.weight": "wq", "attn_k.weight": "wk", "attn_v.weight": "wv",
    "attn_output.weight": "wo", "ffn_gate.weight": "w_gate",
    "ffn_up.weight": "w_up", "ffn_down.weight": "w_down",
    "token_embd.weight": "token_embd", "output.weight": "output",
    "attn_q.bias": "bq", "attn_k.bias": "bk", "attn_v.bias": "bv",
}
_BIAS_OF = {"bq": "wq", "bk": "wk", "bv": "wv"}


def attached_devices() -> list[str]:
    """Every attached CUDA card, as device names. Raises without one: the
    CPU is used only when the caller names it."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "tpu_engine_torch shards over the attached CUDA devices by "
            "default and none is available; pass devices=['cpu', ...] to "
            "run the plain PyTorch path on the CPU")
    return [f"cuda:{i}" for i in range(n)]


def make_mesh(n_data: int = 1, n_model: int | None = None,
              devices=None) -> list[list[str]]:
    """The device grid [n_data][n_model] of device names; devices defaults
    to every attached card. Rank d * n_model + m runs on grid[d][m]."""
    devices = list(devices) if devices is not None else attached_devices()
    if n_model is None:
        n_model = len(devices) // n_data
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"tensor_parallel={n_model} x data_parallel="
                         f"{n_data} but only {len(devices)} devices attached")
    return [[str(devices[d * n_model + m]) for m in range(n_model)]
            for d in range(n_data)]


def role_of(name: str) -> str:
    """Role of a GGUF tensor name ("" for tensors every rank holds whole)."""
    suffix = name.split(".", 2)[-1] if name.startswith("blk.") else name
    return _GGUF_ROLE.get(suffix, "")


def _divisible(dim: int, parts: int) -> bool:
    return parts > 0 and dim % parts == 0


def split_axis(qt: QTensor, role: str, p: int) -> int | None:
    """0 (rows), 1 (columns) or None (whole) for a weight of `role` at p
    ranks."""
    if p <= 1:
        return None
    n, k = qt.shape
    if role in _COL_PARALLEL or role in _VOCAB_PARALLEL:
        return 0 if _divisible(n, p) else None
    if role in _ROW_PARALLEL:
        if not _divisible(k, p):
            return None
        if qt.kind != "dense" and (k // p) % qt.group:
            return None  # a rank's columns must be whole groups
        return 1
    return None


def slice_rows(qt: QTensor, n0: int, n1: int) -> QTensor:
    """Rows [n0, n1) of a weight (every kind: scales travel with rows)."""
    def cut(a):
        return None if a is None else a[n0:n1].contiguous()

    return QTensor(qs=cut(qt.qs), scale=cut(qt.scale), bias=cut(qt.bias),
                   kind=qt.kind, group=qt.group, shape=(n1 - n0, qt.shape[1]))


def slice_cols(qt: QTensor, k0: int, k1: int) -> QTensor:
    """Columns [k0, k1) of a weight; k0, k1 on group edges when quantized."""
    if qt.kind == "dense":
        return QTensor(qs=qt.qs[:, k0:k1].contiguous(), scale=None, bias=None,
                       kind="dense", group=0, shape=(qt.shape[0], k1 - k0))
    if k0 % qt.group or k1 % qt.group:
        raise ValueError(f"column slice [{k0}, {k1}) is not on the "
                         f"quantization group edges (group {qt.group})")
    per = 2 if qt.kind == "nib4" else 1
    g0, g1 = k0 // qt.group, k1 // qt.group

    def cut(a):
        return None if a is None else a[:, g0:g1].contiguous()

    return QTensor(qs=qt.qs[:, k0 // per:k1 // per].contiguous(),
                   scale=cut(qt.scale), bias=cut(qt.bias), kind=qt.kind,
                   group=qt.group, shape=(qt.shape[0], k1 - k0))


def shard_qtensor(qt: QTensor, role: str, p: int, r: int) -> QTensor:
    """Rank r's slice of a weight of `role` among p ranks: its rows (col-
    and vocab-parallel) or its columns (row-parallel), or the whole tensor
    when the dimension does not divide."""
    ax = split_axis(qt, role, p)
    if ax is None:
        return qt
    n, k = qt.shape
    if ax == 0:
        return slice_rows(qt, r * n // p, (r + 1) * n // p)
    return slice_cols(qt, r * k // p, (r + 1) * k // p)


def shard_vec(v: torch.Tensor, role: str, p: int, r: int) -> torch.Tensor:
    """Rank r's slice of a bias vector (bq/bk/bv split as their weight's
    rows); norms and anything else stay whole."""
    if role not in _BIAS_OF or p <= 1 or not _divisible(v.shape[-1], p):
        return v
    n = v.shape[-1]
    return v[..., r * n // p:(r + 1) * n // p].contiguous()


def shard_fused(qt: QTensor, parts: list[int], roles: list[str], p: int,
                r: int) -> QTensor:
    """Rank r's slice of a weight fused along N from parts (e.g. q|k|v or
    gate|up): each part sliced by its role, the slices fused again."""
    from ..model.weights import concat_qtensors

    out, n0 = [], 0
    for n, role in zip(parts, roles):
        out.append(shard_qtensor(slice_rows(qt, n0, n0 + n), role, p, r))
        n0 += n
    if n0 != qt.shape[0]:
        raise ValueError(f"parts {parts} do not add up to N={qt.shape[0]}")
    return concat_qtensors(out)


def shard_weights(weights: dict, cfg, p: int, r: int) -> dict:
    """Rank r's weights among p ranks, from a whole model's weights dict
    (model/loader.py layout). token_embd stays whole (the row gather stays
    local); an untied output head splits its vocab rows. Fused q|k|v and
    gate|up are cut part by part and fused again from the rank's slices."""
    H, KH, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    out = {k: v for k, v in weights.items() if k not in ("layers", "output")}
    tied = weights["output"] is weights["token_embd"]
    out["output"] = (out["token_embd"] if tied else
                     shard_qtensor(weights["output"], "output", p, r))
    layers = []
    for lw in weights["layers"]:
        slw = {}
        for name, t in lw.items():
            if name == "wqkv":
                slw[name] = shard_fused(t, [H * D, KH * D, KH * D],
                                        ["wq", "wk", "wv"], p, r)
            elif name == "w_gateup":
                nf = t.shape[0] // 2
                slw[name] = shard_fused(t, [nf, nf], ["w_gate", "w_up"], p, r)
            elif name == "bqkv":
                parts = t.split([H * D, KH * D, KH * D])
                slw[name] = torch.cat([shard_vec(v, b, p, r) for v, b in
                                       zip(parts, ("bq", "bk", "bv"))])
            elif isinstance(t, QTensor):
                slw[name] = shard_qtensor(t, name, p, r)
            else:
                slw[name] = shard_vec(t, name, p, r)
        layers.append(slw)
    out["layers"] = layers
    return out


def shard_cache(cache: KVCache, n_model: int, model_rank: int,
                n_data: int = 1, data_rank: int = 0, device=None) -> KVCache:
    """A rank's part of a KV cache [L, S, KH, ...]: kv heads
    [m * KH/n_model, ...) and, when n_data divides S, slots
    [d * S/n_data, ...). A "meta" cache (shapes only) is allocated zeroed
    on `device` at the rank's shape; a real one is copied there."""
    S, KH = cache.k.shape[1], cache.k.shape[2]
    hp = n_model if n_model > 1 and _divisible(KH, n_model) else 1
    sp = n_data if n_data > 1 and _divisible(S, n_data) else 1
    kh, sl = KH // hp, S // sp
    h0 = model_rank * kh if hp > 1 else 0
    s0 = data_rank * sl if sp > 1 else 0
    dev = torch.device(device) if device is not None else cache.k.device

    def part(a):  # cells [L, S, KH, ...] or scales [L, S, KH, T]
        if a is None:
            return None
        idx = (slice(None), slice(s0, s0 + sl), slice(h0, h0 + kh))
        if a.is_meta:
            return torch.zeros((a.shape[0], sl, kh, *a.shape[3:]),
                               dtype=a.dtype, device=dev)
        return a[idx].to(dev).clone()

    lengths = cache.lengths
    lengths = (torch.zeros((sl,), dtype=lengths.dtype, device=dev)
               if lengths.is_meta else lengths[s0:s0 + sl].to(dev).clone())
    return KVCache(k=part(cache.k), v=part(cache.v), lengths=lengths,
                   k_scale=part(cache.k_scale), v_scale=part(cache.v_scale),
                   kind=cache.kind, layout=cache.layout, slot_shards=sp)


def make_sharder(n_model: int, model_rank: int):
    """Loader hook: load_model(..., sharder=make_sharder(p, r)) cuts each
    tensor, extracted whole on the rank's device, to rank r's slice
    (token_embd whole)."""
    def sharder(name: str, t):
        role = role_of(name)
        if role == "token_embd":
            return t
        if isinstance(t, QTensor):
            return shard_qtensor(t, role, n_model, model_rank)
        return shard_vec(t, role, n_model, model_rank)

    return sharder
