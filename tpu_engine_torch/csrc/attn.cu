// Flash attention over the "td" KV cache [L, S, KH, T, Dk] (K stored
// pre-rotated), f32, bf16, q8_0 or q4_0 cells; the kernels and their
// design are in attn_common.cuh.
//
// attn_decode replaces tpu_engine/kernels/flash_attention.py:
// _decode_kernel_bh (Tc = 1); attn_prefill replaces :_prefill_kernel
// (Tc > 1, rotated=True).

#include "attn_common.cuh"

ATTN_ENTRY(attn_decode, 0, false)
ATTN_ENTRY(attn_prefill, 1, false)
