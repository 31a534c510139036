// Flash attention over the transposed "dt" KV cache [L, S, KH, Dk, T] with
// K stored unrotated (self-extend, grp_attn_n > 1): each cached K cell is
// rotated by the cos/sin tables of its cell, the self-extend remap baked
// in, as the score loop reads it (decode, tables [rd/2, T]) or as the
// tile loader fills the tile (prefill, tables [T, rd/2]); f32, bf16, q8_0
// or q4_0 cells. The kernels and their design are in attn_common.cuh
// (ROT = true).
//
// attn_decode_dt_rope replaces tpu_engine/kernels/flash_attention.py:
// _decode_kernel_t (Tc = 1, rotated=False: the JAX package sends every
// unrotated "dt" decode there, never to _decode_kernel_dma);
// attn_prefill_dt_rope replaces :_prefill_kernel_t (Tc > 1,
// rotated=False).

#include "attn_common.cuh"

ATTN_ENTRY(attn_decode_dt_rope, 0, true, true)
ATTN_ENTRY(attn_prefill_dt_rope, 1, true, true)
