// Flash attention over the "td" KV cache [L, S, KH, T, Dk] with K stored
// unrotated (self-extend, grp_attn_n > 1): each cached K cell is rotated
// by the cos/sin tables of its cell, the self-extend remap baked in, as
// the score loop reads it (decode) or as the tile loader fills the tile
// (prefill); f32, bf16, q8_0 or q4_0 cells. The kernels and their design
// are in attn_common.cuh (ROT = true).
//
// attn_decode_rope replaces tpu_engine/kernels/flash_attention.py:
// _decode_kernel (Tc = 1; it merges all heads into one score axis under a
// block-diagonal mask, a device for the TPU's matrix unit that a block per
// (row, kv head) does not need); attn_prefill_rope replaces
// :_prefill_kernel (Tc > 1, rotated=False).

#include "attn_common.cuh"

ATTN_ENTRY(attn_decode_rope, 0, false, true)
ATTN_ENTRY(attn_prefill_rope, 1, false, true)
