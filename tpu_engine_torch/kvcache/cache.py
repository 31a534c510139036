"""Slot-paged KV cache with seq ops as index arithmetic (PyTorch port).

Same design as the JAX package's kvcache/cache.py: slot s occupies cells
[0, lengths[s]) contiguously and cell i holds the token at position i; K is
stored ROTATED when self-extend is off (rot_cache), so

  - seq_rm(slot, n, -1) == trim: lengths[s] = min(lengths[s], n)
  - seq_cp              == row copy of a slot
  - context shift       == compact + re-rope of the moved cells by -n_discard
                           (quantized K: dequantize, re-rope, requantize)

The forward step appends once per step after its layer loop (deferred
append): attention reads the step's rows in flight.

Kinds, as the reference's cache_type_k/v (f16, q8_0, q4_0) plus f32:

  f32  -> f32 cells
  f16  -> bfloat16 cells, as in the JAX package, so planes compare byte
          for byte
  q8_0 -> int8 cells + one f32 scale per (token, kv head) row
  q4_0 -> uint8 cells [..., D/2] packed split-half (byte j: element j in
          the low nibble, element j + D/2 in the high one, each + 8) + one
          f32 scale per (token, kv head) row

Layouts: "td" cells [L, S, KH, T, Dk]; "dt" cells [L, S, KH, Dk, T]
(Dk = D, or D/2 for q4_0). Scale planes are [L, S, KH, T] in both.
default_layout picks one as the JAX package does.

Unlike the JAX version every op here UPDATES THE CACHE IN PLACE (the
planes are the largest tensors of the engine; copying them per step is
what the JAX version's buffer donation avoids) and returns the same
object for call-site symmetry.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

KV_KINDS = ("f32", "f16", "q8_0", "q4_0")
QUANT_KINDS = ("q8_0", "q4_0")


@dataclass
class KVCache:
    k: torch.Tensor  # [L, S, KH, T, Dk] ("td") | [L, S, KH, Dk, T] ("dt")
    v: torch.Tensor
    lengths: torch.Tensor  # [S] int32: occupied cells per slot
    k_scale: torch.Tensor | None = None  # [L, S, KH, T] f32 when quantized
    v_scale: torch.Tensor | None = None
    kind: str = "f32"
    layout: str = "td"

    @property
    def n_layer(self) -> int:
        return self.k.shape[0]

    @property
    def n_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[4 if self.layout == "dt" else 3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def new_cache(n_layer: int, n_slots: int, max_len: int, n_kv_head: int,
              head_dim: int, dtype=torch.float32, kind: str | None = None,
              layout: str = "td", device=None) -> KVCache:
    """Zeroed cache on `device` (required: "cuda" or "cpu")."""
    if device is None:
        raise ValueError("new_cache needs an explicit device")
    if kind is None:
        kind = "f32" if dtype == torch.float32 else "f16"
    if kind not in KV_KINDS:
        raise ValueError(f"kv cache kind {kind!r} not in {KV_KINDS}")
    if layout not in ("td", "dt"):
        raise ValueError(f"kv cache layout {layout!r} not in ('td', 'dt')")

    def cshape(d):
        return ((n_layer, n_slots, n_kv_head, d, max_len) if layout == "dt"
                else (n_layer, n_slots, n_kv_head, max_len, d))

    lengths = torch.zeros((n_slots,), dtype=torch.int32, device=device)
    if kind in QUANT_KINDS:
        if kind == "q4_0":
            if head_dim % 2:
                raise ValueError("q4_0 KV needs even head_dim")
            cs, cdt = cshape(head_dim // 2), torch.uint8
        else:
            cs, cdt = cshape(head_dim), torch.int8
        sshape = (n_layer, n_slots, n_kv_head, max_len)
        return KVCache(
            k=torch.zeros(cs, dtype=cdt, device=device),
            v=torch.zeros(cs, dtype=cdt, device=device),
            lengths=lengths,
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            kind=kind, layout=layout)
    cdtype = torch.bfloat16 if kind == "f16" else dtype
    return KVCache(
        k=torch.zeros(cshape(head_dim), dtype=cdtype, device=device),
        v=torch.zeros(cshape(head_dim), dtype=cdtype, device=device),
        lengths=lengths, kind=kind, layout=layout)


# -- KV row quantization (append path) and dequantization (attention) --------

def quantize_kv_rows(x: torch.Tensor, kind: str):
    """Quantize rows x [..., D] -> (cells, scale [...] f32): symmetric
    absmax, int8 for q8_0; for q4_0 4-bit values + 8 packed split-half
    along D (low nibble = element d, high nibble = element d + D/2)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    if kind == "q8_0":
        scale = amax / 127.0
        q = torch.round(xf / torch.clamp(scale[..., None], min=1e-12))
        return torch.clamp(q, -127, 127).to(torch.int8), scale
    if kind == "q4_0":
        half = x.shape[-1] // 2
        scale = amax / 7.0
        q = torch.round(xf / torch.clamp(scale[..., None], min=1e-12))
        q = torch.clamp(q, -8, 7).to(torch.int32) + 8  # [0, 15]
        lo, hi = q[..., :half], q[..., half:]
        return (lo | (hi << 4)).to(torch.uint8), scale
    raise ValueError(kind)


def dequant_kv(cells: torch.Tensor, scale, kind: str,
               dtype=torch.float32) -> torch.Tensor:
    """Stored cells [..., Dk] (+ scale [...]) -> float [..., D]; the
    identity up to dtype for the float kinds."""
    if kind in ("f32", "f16"):
        return cells.to(dtype)
    if kind == "q8_0":
        return cells.to(dtype) * scale[..., None].to(dtype)
    if kind == "q4_0":
        lo = (cells & 0xF).to(torch.int32) - 8
        hi = (cells >> 4).to(torch.int32) - 8
        q = torch.cat([lo, hi], dim=-1)
        return q.to(dtype) * scale[..., None].to(dtype)
    raise ValueError(kind)


def _put_slot_windows(arr: torch.Tensor, vals: torch.Tensor, slot_ids,
                      starts, n_valid, active, layout: str = "td") -> None:
    """Write vals [L, B, KH, Tc, *] in place into arr: cell planes
    [L, S, KH, T, Dk] ("td") or [L, S, KH, Dk, T] ("dt"), or scale planes
    [L, S, KH, T] (vals [L, B, KH, Tc]). Row b's valid tokens land at cells
    [starts[b], starts[b] + n_valid[b]) of slot slot_ids[b]. The window
    start clamps to T - Tc when the padded window would cross the end (the
    valid tokens always fit): vals roll right by the clamp distance;
    displaced positions, pad tokens and inactive rows keep their old cells
    (a read-modify-write, as in the JAX version). Rows must name distinct
    slots."""
    is_scale = vals.ndim == 4
    t_axis = 4 if (layout == "dt" and not is_scale) else 3
    L, B, KH, Tc = vals.shape[:4]
    T = arr.shape[t_axis]
    if Tc > T:
        raise ValueError(f"append of {Tc} rows into a {T}-cell slot")
    dev = arr.device
    slot = slot_ids.to(device=dev, dtype=torch.long)
    starts = starts.to(device=dev, dtype=torch.long)
    nv = n_valid.to(device=dev, dtype=torch.long)
    act = active.to(device=dev, dtype=torch.bool)
    if Tc == 1:
        pos = torch.clamp(starts, max=T - 1)[:, None]          # [B, 1]
        ok = (act & (nv > 0))[:, None]                         # [B, 1]
        src = vals                                              # j = 0
    else:
        s_c = torch.clamp(starts, 0, max(T - Tc, 0))
        d = starts - s_c                                        # >= 0
        j = torch.arange(Tc, device=dev)
        pos = s_c[:, None] + j[None, :]                         # [B, Tc]
        ok = act[:, None] & (j[None, :] >= d[:, None]) & (
            j[None, :] - d[:, None] < nv[:, None])
        # vals rolled right by d along Tc: src[l, b, h, j] = vals[l, b, h, j - d]
        jsrc = (j[None, :] - d[:, None]) % Tc
        gidx = jsrc[None, :, None, :]
        if not is_scale:
            gidx = gidx[..., None]
        src = torch.gather(vals, 3, gidx.expand(vals.shape))
    # advanced indices [B, Tc] on dims 1 and t_axis -> selection
    # [B, Tc, L, KH(, Dk)] whatever the layout
    sl = slot[:, None].expand_as(pos)
    idx = (slice(None), sl) + (slice(None),) * (t_axis - 2) + (pos,)
    old = arr[idx]
    new = src.permute(1, 3, 0, 2, *(() if is_scale else (4,))).to(arr.dtype)
    mask = ok.reshape(ok.shape + (1,) * (new.ndim - 2))
    arr[idx] = torch.where(mask, new, old)


def append_step(cache: KVCache, k_rows: torch.Tensor, v_rows: torch.Tensor,
                slot_ids, starts, n_valid, active) -> KVCache:
    """Append one step's stacked rows (k/v_rows [L, B, KH, Tc, D], T axis
    in storage order) for all layers at once, in place; quantizes for
    q8_0/q4_0. Does NOT update the lengths (the forward step owns that)."""
    lay = cache.layout
    win = (slot_ids, starts, n_valid, active)
    if cache.kind in QUANT_KINDS:
        kc, ks = quantize_kv_rows(k_rows, cache.kind)
        vc, vs = quantize_kv_rows(v_rows, cache.kind)
        _put_slot_windows(cache.k_scale, ks, *win)
        _put_slot_windows(cache.v_scale, vs, *win)
    else:
        kc, vc = k_rows, v_rows
    _put_slot_windows(cache.k, kc, *win, layout=lay)
    _put_slot_windows(cache.v, vc, *win, layout=lay)
    return cache


def clear_all(cache: KVCache) -> KVCache:
    """llama_kv_cache_clear: every slot empty (cells stay, as in JAX)."""
    cache.lengths.zero_()
    return cache


def trim(cache: KVCache, slot: int, n: int) -> KVCache:
    """seq_rm(slot, n, -1): keep the first n cells of slot."""
    cache.lengths[slot] = torch.clamp(cache.lengths[slot], max=int(n))
    return cache


def clear_slot(cache: KVCache, slot: int) -> KVCache:
    return trim(cache, slot, 0)


def _planes(cache: KVCache) -> list[torch.Tensor]:
    return [a for a in (cache.k, cache.v, cache.k_scale, cache.v_scale)
            if a is not None]


def seq_cp(cache: KVCache, src: int, dst: int) -> KVCache:
    """Copy slot src's rows, scales included, into slot dst (system-prompt
    broadcast)."""
    for a in _planes(cache):
        a[:, dst] = a[:, src]
    cache.lengths[dst] = cache.lengths[src]
    return cache


def shift_compact(cache: KVCache, slot: int, n_keep: int, n_discard: int,
                  rope: tuple | None = None) -> KVCache:
    """Context shift: evict cells [n_keep+1, n_keep+1+n_discard) of slot and
    slide the tail down, in place. rope = (rope_dim, inv_freq_tuple) when K
    is stored rotated: moved cells re-rotate by -n_discard with the
    effective frequencies (no yarn magnitude scale), split-half form;
    quantized K is dequantized, re-rotated and requantized (llama.cpp's
    K-shift on a quantized cache), and only the moved cells and their
    scales change."""
    T = cache.max_len
    dt = cache.layout == "dt"
    dev = cache.k.device
    idx = torch.arange(T, device=dev)
    src = torch.where(idx > n_keep, idx + n_discard, idx).clamp(max=T - 1)
    moved = src != idx

    def gather_slot(arr, t_last: bool):  # the slot's row with T gathered
        row = arr[:, slot]  # [L, KH, T, Dk] | [L, KH, Dk, T] | [L, KH, T]
        return row[..., src] if t_last else row[:, :, src]

    k = gather_slot(cache.k, dt)
    v = gather_slot(cache.v, dt)
    ks = gather_slot(cache.k_scale, True) if cache.quantized else None
    vs = gather_slot(cache.v_scale, True) if cache.quantized else None
    if rope is not None:
        rd, inv_freq_t = rope
        half = rd // 2
        inv_freq = torch.tensor(inv_freq_t, dtype=torch.float32, device=dev)
        ang = torch.tensor(-float(n_discard), dtype=torch.float32) * inv_freq
        cos, sin = torch.cos(ang), torch.sin(ang)

        def rot_delta(x):  # x [..., T, D] f32
            x1, x2 = x[..., :half], x[..., half:rd]
            return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos,
                              x[..., rd:]], dim=-1)

        krow = k.transpose(-1, -2) if dt else k  # [L, KH, T, Dk]
        if cache.quantized:
            qc, qsc = quantize_kv_rows(
                rot_delta(dequant_kv(krow, ks, cache.kind)), cache.kind)
            newk = torch.where(moved[:, None], qc, krow)
            ks = torch.where(moved, qsc, ks)
        else:
            x = krow.to(torch.float32)
            newk = torch.where(moved[:, None], rot_delta(x), x)
        if dt:
            newk = newk.transpose(-1, -2)
        k = newk.to(cache.k.dtype)
    cache.k[:, slot] = k
    cache.v[:, slot] = v
    if cache.quantized:
        cache.k_scale[:, slot] = ks
        cache.v_scale[:, slot] = vs
    cache.lengths[slot] = cache.lengths[slot] - int(n_discard)
    return cache


def default_layout(kind: str | None, head_dim: int) -> str:
    """Storage layout policy, the JAX package's: "dt" for any quantized
    kind or head_dim < 128, else "td"."""
    if kind in QUANT_KINDS or head_dim < 128:
        return "dt"
    return "td"
