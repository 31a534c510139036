// Flash attention over the transposed "dt" KV cache [L, S, KH, Dk, T]
// (K stored pre-rotated), the layout the engine picks for q8_0/q4_0 KV and
// for head_dim < 128; f32, bf16, q8_0 or q4_0 cells. The kernels and their
// design are in attn_common.cuh: the same kernels as the "td" entry
// points, with each of a split's Dk d-rows copied as one run of cells
// (decode) and the tile loader's lanes along T (prefill), where "dt"
// cells are contiguous.
//
// attn_decode_dt replaces tpu_engine/kernels/flash_attention.py:
// _decode_kernel_dma (T a multiple of 128: a flat loop over each slot's
// live blocks) and :_decode_kernel_t (any T, rotated=True). Both compute
// the same function; here the splits of cells run as blocks of their own
// and those above a row's fill exit at once, whatever T is.
// attn_prefill_dt replaces :_prefill_kernel_t (rotated=True).

#include "attn_common.cuh"

ATTN_ENTRY(attn_decode_dt, 0, true, false)
ATTN_ENTRY(attn_prefill_dt, 1, true, false)
