"""Frozen formulas: the chip's peaks, and the operations and bytes a call
needs, from its shapes alone (each input byte read once, each output byte
written once, whatever the kernel reads again).

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 989
TFLOP/s in bf16 / fp16 on the tensor cores, 3.35 TB/s of HBM. Attention
is held to the same bf16 rate as the products: the cache holds f16 or
8-bit cells, so the chip could run it on the tensor cores.

A quantized weight is counted at its GGUF block size (Q4_K 144 bytes,
Q5_K 176 and Q6_K 210 a block of 256), which is what the weight holds;
the activations at bf16 (the products' operand precision) in, f32 out.
"""

from __future__ import annotations

PEAKS = {"H100": {"flops": 989e12, "bytes_per_s": 3.35e12}}

# (program layout kind, group, has bias) -> GGUF bytes per weight
WEIGHT_BYTES = {("nib4", 32, True): 144 / 256,   # Q4_K
                ("i8", 32, True): 176 / 256,     # Q5_K
                ("i8", 16, False): 210 / 256}    # Q6_K

# bytes per cached K or V element, by cache kind (q8_0 / q4_0: 32 values
# and one f16 scale a block)
KV_BYTES = {"f32": 4.0, "f16": 2.0, "bf16": 2.0, "q8_0": 34 / 32, "q4_0": 18 / 32}


def peaks(device_name: str) -> dict | None:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def qmm_need(m: int, n: int, k: int, weight_bytes: float) -> tuple[float, float]:
    """(operations, bytes) of y[m, n] = x[m, k] @ W[n, k]^T."""
    return 2.0 * m * n * k, n * k * weight_bytes + m * k * 2.0 + m * n * 4.0


def keys_seen(start: int, n: int, window: int) -> int:
    """Sum over positions p = start..start+n-1 of the keys a query at p
    attends to (itself included): p + 1, or at most `window`."""
    def tri(lo: int, hi: int) -> int:  # sum of p + 1 for p in lo..hi
        return (hi - lo + 1) * (lo + hi + 2) // 2 if hi >= lo else 0

    end = start + n - 1
    if window <= 0:
        return tri(start, end)
    return tri(start, min(end, window - 1)) + max(0, end - max(start, window) + 1) * window


def attention_need(rows, heads: int, kv_heads: int, head_dim: int,
                   kv_bytes: float, act_bytes: float,
                   window: int) -> tuple[float, float]:
    """(operations, bytes) of causal attention for rows [(start, n_new)]:
    each row's n_new queries at positions start.. over its cached cells
    and its own new rows. Scores and the weighted sum are 2 * head_dim
    operations a key and head each."""
    ops = byts = 0.0
    for start, n in rows:
        if n <= 0:
            continue
        keys = keys_seen(start, n, window)
        ops += 4.0 * heads * head_dim * keys
        cached = min(start, window) if window > 0 else start
        byts += cached * kv_heads * head_dim * 2 * kv_bytes      # K and V cells
        byts += n * kv_heads * head_dim * 2 * act_bytes          # new K and V
        byts += n * heads * head_dim * 2 * act_bytes             # q in, out
    return ops, byts


def bound_s(ops: float, byts: float, peak: dict) -> float:
    """The least time the chip could take."""
    return max(ops / peak["flops"], byts / peak["bytes_per_s"])
