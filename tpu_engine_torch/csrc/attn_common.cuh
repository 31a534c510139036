// Flash attention over the slot-paged KV cache, for the deferred-append
// forward step of tpu_engine_torch/model/llama.py: the cache holds only the
// history (cells < start[b]); the step's own K/V rows arrive in flight
// (K already rotated) and fold into the same softmax. K is stored either
// pre-rotated (ROT = false) or unrotated (ROT = true, self-extend: each
// cached K cell is rotated as it is read, see below).
//
// One set of kernels serves both storage layouts and all four kinds,
// templated on (kind, layout):
//   "td" planes [L, S, KH, T, Dk], "dt" planes [L, S, KH, Dk, T];
//   f32 cells; bf16 cells ("f16"); int8 cells x scale (q8_0); uint8 cells
//   [.., D/2] packed split-half (byte j: element j in the low nibble,
//   element j + D/2 in the high one, each + 8) x scale (q4_0); scale
//   planes [L, S, KH, T] f32, one per (token, kv head), in both layouts.
// attn.cu instantiates the "td" entry points, attn_dt.cu the "dt" ones;
// attn_rope.cu and attn_dt_rope.cu the same with ROT = true. All eight
// share one C interface (ATTN_ENTRY, at the end).
//
// ROT: cos/sin tables [T, rd/2] f32 give the rotation of cache cell p, the
// self-extend remap of p already applied by the caller. A cached K cell
// is rotated on its first rd elements by split halves (the scale is
// constant over d, so the order does not matter):
//   k'[j] = k[j] cos[p][j] - k[j + rd/2] sin[p][j]
//   k'[j + rd/2] = k[j] sin[p][j] + k[j + rd/2] cos[p][j],   j < rd/2;
// elements d >= rd pass through. V and the in-flight rows are never
// rotated here. For q4_0 with rd = D the pair is the two nibbles of one
// byte, read once.
//
// What bounds them on the H100: decode reads every live cache cell of the
// slot once (start * Dk stored bytes of K and of V per kv head, plus 4 B
// of scale each when quantized, plus the table rows of the cells under
// ROT) against 3.35 TB/s; prefill over a long chunk is bound by the score
// and PV multiply-adds (4 * rows * cells * D per kv head) against the f32
// rate. Scores, softmax and the PV sum stay in f32 on the CUDA cores.
//
// Decode (decode_split_kernel, then decode_merge_kernel): a row's cells
// are cut into splits of DEC_SPLIT, and one block per (row b, kv head,
// split, chunk of up to DEC_MAXG query heads) takes one split, so a long
// row runs on as many blocks as it has splits instead of one block
// walking it tile after tile; splits above the fill or wholly below the
// sliding window exit at once. The block copies its split's stored bytes
// (bf16, int8, packed q4_0, f32) straight from cache[li, slot_ids[b]]
// into shared memory with cp.async: 16-byte pieces where addresses allow
// (8, 4 or plain loads otherwise: q4_0 at D = 64 has 32-byte cells, a
// "dt" row of T cells may not be a multiple of 16 bytes), K with its
// scales and table rows in one group and V with its scales in a second,
// so V lands while the scores are computed. Under "td" a split's cells
// are one contiguous run; under "dt" each of the Dk d-rows is a run of
// the split's cells. Cells are dequantized as the dot reads them, with
// the scale kept out of the dot as in the TPU kernel: s = ks[p] (q .
// k_stored), and vs[p] folded into p; under ROT the pair (j, j + rd/2) is
// rotated from the staged table rows in the same pass. Every thread
// works: the scores a thread per (cell, half of d), PV a thread per
// dimension, with the order of the loop turned per thread where the
// lanes of a warp would otherwise read one bank ("td" scores, "dt" PV).
// Each split writes its (m, l, sum p v) to a workspace the caller
// allocates; the merge kernel weighs the splits that ran by exp(m_s -
// max m) in a fixed order (no atomics: two runs give the same bits). The
// in-flight row (position start) belongs to the split that holds cell
// start.
//
// Prefill (prefill_kernel): one block per (row b, kv head, block of query
// positions, chunk of query heads) reads its cells 32 at a time into
// shared memory as f32 (load_tile dequantizes on the way; under ROT a
// second loop over (cell, pair) rotates K), so the rows of a block share
// each load. A thread owns PV dimensions tid and, above D = 128, tid +
// 128. Under "td" neighbouring threads load neighbouring d of one cell;
// under "dt" neighbouring cells of one d, so both read memory in order.
// The loop stops at the chunk's last position and skips tiles wholly
// outside a sliding window. Position p of a "virtual cell" is its cell
// index for p < start and start + j for in-flight row j, so one mask
// covers both:
//   ok = p <= pos_row  and  (p < start or p - start < n_valid)
//        and (window <= 0 or p > pos_row - window)
// Masked scores are -1e30 (not -inf), as in the TPU kernels; decode's
// splits hold at least one unmasked cell each, so a masked cell's weight
// is exactly 0.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_INF = -1e30f;
constexpr int TB = 32;     // cells per tile (one per lane in the softmax)
constexpr int NTH = 128;   // threads per block
constexpr int MAXD = 256;  // head_dim limit: PV dimensions tid and tid + NTH
constexpr int DEC_MAXG = 8;   // query heads per decode block
constexpr int DEC_SPLIT = 64;  // cache cells per decode split
                               // (kernels/flash_attention.py DEC_SPLIT)
constexpr int PRE_MAXR = 64;  // query rows per prefill block at D <= NTH

enum Kind { F32 = 0, BF16 = 1, Q8 = 2, Q4 = 3 };

// Every operand of one launch. n_valid is unused by decode.
struct Args {
    const float* q;      // [B, Tc, H, D]
    const float* k_new;  // [B, KH, Tc, D] this step's rows, K rotated
    const float* v_new;
    const void* kc;      // cache cell planes (layout and kind as above)
    const void* vc;
    const float* ksc;    // scale planes [L, S, KH, T]; null for f32/bf16
    const float* vsc;
    const int* slot_ids;  // [B]
    const int* starts;    // [B] history length of each row's slot
    const int* n_valid;   // [B]
    float* out;           // [B, Tc, H, D]
    int B, Tc, KH, G, D, S, T, li, window;
    float scale, softcap;
    const float* cos_t;  // [T, rd/2] rope tables by cell (ROT only)
    const float* sin_t;
    int rd;               // rotated elements of a K cell (ROT only)
    float* ws;            // decode workspace: [B * H][NS][D] sums, then
                          // [B * H][NS][2] (m, l); unused by prefill
    int gc, gs, gt;       // decode copy sizes (bytes) of cells, scales, tables
};

// The f32 value of element d of cell p in one (layer, slot, kv head)
// plane: cells at cbase, scales at sbase.
template <int KIND, bool DT>
__device__ __forceinline__ float cell_at(const void* cells, const float* scales,
                                         size_t cbase, size_t sbase, int p,
                                         int d, int T, int D)
{
    const int Dk = KIND == Q4 ? D / 2 : D;
    int j = d, sh = 0;
    if (KIND == Q4 && d >= Dk) {
        j = d - Dk;
        sh = 4;
    }
    const size_t off = cbase + (DT ? (size_t)j * T + p : (size_t)p * Dk + j);
    float x;
    if constexpr (KIND == F32) {
        x = ((const float*)cells)[off];
    } else if constexpr (KIND == BF16) {
        x = __bfloat162float(((const __nv_bfloat16*)cells)[off]);
    } else if constexpr (KIND == Q8) {
        x = (float)((const int8_t*)cells)[off];
    } else {
        x = (float)((int)((((const uint8_t*)cells)[off] >> sh) & 0xF) - 8);
    }
    if constexpr (KIND == Q8 || KIND == Q4) x *= scales[sbase + p];
    return x;
}

// Elements d and d + h (d < h <= D/2) of cell p, as cell_at gives them.
// For q4_0 with h = D/2 both are the nibbles of byte d: one read.
template <int KIND, bool DT>
__device__ __forceinline__ void cell_pair(const void* cells, const float* scales,
                                          size_t cbase, size_t sbase, int p,
                                          int d, int h, int T, int D,
                                          float* x0, float* x1)
{
    if constexpr (KIND == Q4) {
        if (h == D / 2) {
            const size_t off = cbase + (DT ? (size_t)d * T + p : (size_t)p * h + d);
            const int c = ((const uint8_t*)cells)[off];
            const float s = scales[sbase + p];
            *x0 = (float)((c & 0xF) - 8) * s;
            *x1 = (float)((c >> 4) - 8) * s;
            return;
        }
    }
    *x0 = cell_at<KIND, DT>(cells, scales, cbase, sbase, p, d, T, D);
    *x1 = cell_at<KIND, DT>(cells, scales, cbase, sbase, p, d + h, T, D);
}

// Fill the tile Ks/Vs [TB][lds] with virtual cells p = t0 .. t0 + TB - 1:
// cache cells below start, in-flight rows (k_new/v_new at new_base +
// (p - start) * D) below p_end, zeros beyond. ROT: cache cells' K
// elements d < rd come rotated from the pair loop.
template <int KIND, bool DT, bool ROT>
__device__ __forceinline__ void load_tile(float* Ks, float* Vs, int lds,
                                          const Args& a, size_t cbase,
                                          size_t sbase, size_t new_base,
                                          int t0, int start, int p_end)
{
    const int D = a.D;
    const int rd = ROT ? a.rd : 0;
    for (int i = threadIdx.x; i < TB * D; i += NTH) {
        // "dt": lanes along cells (contiguous in memory); "td": along d
        const int t = DT ? i % TB : i / D;
        const int d = DT ? i / TB : i % D;
        const int p = t0 + t;
        float kv = 0.f, vv = 0.f;
        if (p < start) {
            if (!ROT || d >= rd)
                kv = cell_at<KIND, DT>(a.kc, a.ksc, cbase, sbase, p, d, a.T, D);
            vv = cell_at<KIND, DT>(a.vc, a.vsc, cbase, sbase, p, d, a.T, D);
        } else if (p < p_end) {
            const size_t off = new_base + (size_t)(p - start) * D + d;
            kv = a.k_new[off];
            vv = a.v_new[off];
        }
        if (!ROT || p >= start || d >= rd) Ks[t * lds + d] = kv;
        Vs[t * lds + d] = vv;
    }
    if constexpr (ROT) {
        const int h = rd / 2;
        for (int i = threadIdx.x; i < TB * h; i += NTH) {
            const int t = DT ? i % TB : i / h;
            const int j = DT ? i / TB : i % h;
            const int p = t0 + t;
            if (p < start) {
                float x0, x1;
                cell_pair<KIND, DT>(a.kc, a.ksc, cbase, sbase, p, j, h, a.T, D,
                                    &x0, &x1);
                const float c = a.cos_t[(size_t)p * h + j];
                const float s = a.sin_t[(size_t)p * h + j];
                Ks[t * lds + j] = x0 * c - x1 * s;
                Ks[t * lds + j + h] = x0 * s + x1 * c;
            }
        }
    }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float cap(float s, float softcap) {
    return softcap > 0.f ? tanhf(s / softcap) * softcap : s;
}

// Online-softmax fold of the score tile S[r][0..TB) of rows r < R, one
// warp per row: S becomes p, and m/l/corr advance.
__device__ __forceinline__ void softmax_tile(float* S, int ld_s, float* m_s,
                                             float* l_s, float* c_s, int R)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < R; r += NTH / 32) {
        const float s = S[r * ld_s + lane];
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float p = expf(s - m_new);
        const float sum = warp_sum(p);
        S[r * ld_s + lane] = p;
        if (lane == 0) {
            const float corr = expf(m_prev - m_new);
            c_s[r] = corr;
            l_s[r] = l_s[r] * corr + sum;
            m_s[r] = m_new;
        }
    }
}

// Offsets of row b's slot plane for kv head kh: (cells, scales).
__device__ __forceinline__ void plane_bases(const Args& a, int KIND_Q4, int b,
                                            int kh, size_t* cbase, size_t* sbase)
{
    const int slot = min(max(a.slot_ids[b], 0), a.S - 1);
    *sbase = (((size_t)a.li * a.S + slot) * a.KH + kh) * (size_t)a.T;
    *cbase = *sbase * (size_t)(KIND_Q4 ? a.D / 2 : a.D);
}

// ---------------------------------------------------------------- decode
// Flash-decoding: one block per (row b, kv head; split s of DEC_SPLIT
// cache cells; chunk of DEC_MAXG query heads). The block stages its
// split's stored K and V bytes with cp.async (K, its scales and rope rows
// in one group, V and its scales in a second, so V arrives while the
// scores are computed), scores every cell of the split at once, takes
// the split's own softmax (m, l) and PV sum, and writes them to the
// workspace; decode_merge_kernel then combines the splits of each (row,
// query head). A split wholly below the window or above the row's fill
// exits at once; the in-flight row is folded into the one split that
// holds cell `start`.
template <int KIND>
struct Bytes {  // bytes of one stored element
    static constexpr int v = KIND == F32 ? 4 : KIND == BF16 ? 2 : 1;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}
template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)), "l"(src), "n"(N));
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `rows` runs of `run` bytes (a multiple of g) from src + r * sstride
// to dst + r * dstride in g-byte pieces: cp.async for g = 4, 8 and 16
// (both addresses g-aligned), plain loads and stores for g = 1 or 2
// (visible after the caller's barrier).
__device__ __forceinline__ void stage(unsigned char* dst, int dstride,
                                      const unsigned char* src, size_t sstride,
                                      int rows, int run, int g)
{
    const int per = run / g;  // pieces per row
    if (per <= 0) return;
    const int total = rows * per;
    // piece i = threadIdx.x + k * NTH is (row r, piece c), stepped without
    // a division per piece
    int r = threadIdx.x / per, c = threadIdx.x - r * per;
    const int dr = NTH / per, dc = NTH - dr * per;
    for (int i = threadIdx.x; i < total; i += NTH) {
        unsigned char* d = dst + (size_t)r * dstride + c * g;
        const unsigned char* s = src + r * sstride + c * g;
        if (g == 16) cp_async16(d, s);
        else if (g == 8) cp_async_ca<8>(d, s);
        else if (g == 4) cp_async_ca<4>(d, s);
        else
            for (int k = 0; k < g; k++) d[k] = s[k];
        c += dc;
        r += dr;
        if (c >= per) {
            c -= per;
            r++;
        }
    }
}

__device__ __forceinline__ int round_up(int x, int g) { return (x + g - 1) / g * g; }

// A split's staged cells as stored (no scale applied): under "td" rows of
// Dk stored elements per cell, under "dt" Dk rows of DEC_SPLIT cells.
template <int KIND, bool DT>
struct Staged {
    const unsigned char* p;
    int Dk;  // stored elements per cell
    __device__ __forceinline__ size_t at(int t, int j) const {
        return DT ? (size_t)j * DEC_SPLIT + t : (size_t)t * Dk + j;
    }
    // element d of cell t (q4_0: d < Dk the low nibble of byte d, else
    // the high nibble of byte d - Dk)
    __device__ __forceinline__ float el(int t, int d) const {
        if constexpr (KIND == F32) {
            return ((const float*)p)[at(t, d)];
        } else if constexpr (KIND == BF16) {
            return __bfloat162float(((const __nv_bfloat16*)p)[at(t, d)]);
        } else if constexpr (KIND == Q8) {
            return (float)((const int8_t*)p)[at(t, d)];
        } else {
            const bool hi = d >= Dk;
            const int c = p[at(t, hi ? d - Dk : d)];
            return (float)(((hi ? c >> 4 : c) & 0xF) - 8);
        }
    }
    // elements j and j + P of cell t; for q4_0 with P = Dk one byte
    __device__ __forceinline__ void pair(int t, int j, int P, float* x0,
                                         float* x1) const {
        if constexpr (KIND == Q4) {
            if (P == Dk) {
                const int c = p[at(t, j)];
                *x0 = (float)((c & 0xF) - 8);
                *x1 = (float)((c >> 4) - 8);
                return;
            }
        }
        *x0 = el(t, j);
        *x1 = el(t, j + P);
    }
};

// Dynamic shared memory of decode_split_kernel, in bytes.
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

struct DecodeSmem {
    size_t kv, ks, qs, ss, s2, ml, cs, sn, total;
    // GB query heads a block; h rope pairs (cos/sin [C][h], "dt" [h][C])
    __host__ __device__ DecodeSmem(int cell_bytes, int D, int h, int GB) {
        kv = align16((size_t)DEC_SPLIT * cell_bytes);  // one of K, V
        ks = 2 * kv;                                    // K, V scales [C] each
        qs = ks + 2 * DEC_SPLIT * sizeof(float);        // q [GB][D]
        ss = qs + align16((size_t)GB * D * sizeof(float));  // [GB][C]
        s2 = ss + GB * DEC_SPLIT * sizeof(float);
        ml = s2 + GB * DEC_SPLIT * sizeof(float);  // m, l [GB] each
        cs = ml + align16(2 * GB * sizeof(float));
        sn = cs + align16((size_t)DEC_SPLIT * h * sizeof(float));
        total = sn + align16((size_t)DEC_SPLIT * h * sizeof(float));
    }
};

template <int KIND, bool DT, bool ROT, int NDT, int GB>
__global__ void __launch_bounds__(NTH) decode_split_kernel(const Args a, int NS)
{
    extern __shared__ __align__(16) unsigned char dsmem[];
    constexpr int C = DEC_SPLIT, MG = GB, ES = Bytes<KIND>::v, NW = NTH / 32;
    constexpr bool QUANT = KIND == Q8 || KIND == Q4;
    static_assert(NTH == 2 * C, "scores: two threads per cell");
    const int KH = a.KH, G = a.G, D = a.D, T = a.T;
    const int Dk = KIND == Q4 ? D / 2 : D;
    const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
    const int s0 = blockIdx.y * C;
    const int g0 = blockIdx.z * MG, Gb = min(MG, G - g0);
    const int slot = min(max(a.slot_ids[b], 0), a.S - 1);  // read beside start
    const int start = min(a.starts[b], T);  // history: cells [0, start)
    const int lo = a.window > 0 ? max(0, start - a.window + 1) : 0;
    if (s0 + C <= lo || s0 > start) return;  // nothing of this split attends
    const int n = min(C, start - s0);  // cache cells [s0, s0 + n)
    const bool has_new = start - s0 < C;  // the in-flight row sits at t = n
    const int t_lo = max(0, lo - s0);     // cells below it lie outside the window
    const int t_st = t_lo & ~15;          // first staged cell (16-byte aligned in "dt")
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int h = ROT ? a.rd / 2 : 0;  // rotated pairs
    const DecodeSmem L(Dk * ES, D, h, GB);
    unsigned char* Kr = dsmem;
    unsigned char* Vr = dsmem + L.kv;
    float* ks = (float*)(dsmem + L.ks);
    float* vs = ks + C;
    float* Qs = (float*)(dsmem + L.qs);
    float* Ss = (float*)(dsmem + L.ss);
    float* S2 = (float*)(dsmem + L.s2);
    float* m_s = (float*)(dsmem + L.ml);
    float* l_s = m_s + MG;
    float* cs = (float*)(dsmem + L.cs);
    float* sn = (float*)(dsmem + L.sn);

    const size_t sbase = (((size_t)a.li * a.S + slot) * KH + kh) * (size_t)T;
    const size_t cbase = sbase * Dk;
    const int nst = n - t_st;  // staged cells
    // group 0: K cells, their scales and rope rows; group 1: V and its scales
    for (int kv = 0; kv < 2; kv++) {
        const unsigned char* cells = (const unsigned char*)(kv ? a.vc : a.kc);
        unsigned char* dst = kv ? Vr : Kr;
        if (nst > 0) {
            if constexpr (DT)
                stage(dst + t_st * ES, C * ES,
                      cells + (cbase + s0 + t_st) * ES, (size_t)T * ES, Dk,
                      round_up(nst * ES, a.gc), a.gc);
            else
                stage(dst + (size_t)t_st * Dk * ES, 0,
                      cells + (cbase + (size_t)(s0 + t_st) * Dk) * ES, 0, 1,
                      nst * Dk * ES, a.gc);
            if constexpr (QUANT)
                stage((unsigned char*)((kv ? vs : ks) + t_st), 0,
                      (const unsigned char*)((kv ? a.vsc : a.ksc) + sbase + s0 + t_st),
                      0, 1, round_up(nst * 4, a.gs), a.gs);
            if (ROT && kv == 0 && h > 0) {
                for (int c = 0; c < 2; c++) {
                    const float* tab = c ? a.sin_t : a.cos_t;
                    float* to = c ? sn : cs;
                    if constexpr (DT)  // tables [h, T]: h runs of the split's cells
                        stage((unsigned char*)(to + t_st), C * 4,
                              (const unsigned char*)(tab + s0 + t_st),
                              (size_t)T * 4, h, round_up(nst * 4, a.gt), a.gt);
                    else  // tables [T, h]: one run of the split's rows
                        stage((unsigned char*)(to + t_st * h), 0,
                              (const unsigned char*)(tab + (size_t)(s0 + t_st) * h),
                              0, 1, nst * h * 4, a.gt);
                }
            }
        }
        cp_commit();
    }
    const int H = KH * G;
    const size_t q_base = ((size_t)b * H + kh * G + g0) * D;
    const size_t new_base = ((size_t)b * KH + kh) * D;
    for (int i = tid; i < Gb * D; i += NTH) Qs[i] = a.q[q_base + i];
    cp_wait<1>();
    __syncthreads();

    // scores q . k_stored of cells [t_lo, n): pairs (j, j + P), rotated
    // from the staged table rows under ROT, then the unrotated tail
    const int P = ROT ? a.rd / 2 : D / 2;
    const Staged<KIND, DT> K{Kr, Dk};
    {   // a thread per (cell, half of the pairs): part takes pairs part +
        // 2i, i < np; under "td" thread t starts at i = t % np and wraps,
        // so that the lanes of a warp (one cell each) read other banks
        const int t = tid % C, part = tid / C;
        const int np = (P - part + 1) / 2;
        if (t >= t_lo && t < n) {
            float acc[MG];
#pragma unroll
            for (int g = 0; g < MG; g++) acc[g] = 0.f;
            int i = DT || np == 0 ? 0 : t % np;
            for (int k = 0; k < np; k++) {
                const int j = part + 2 * i;
                float x0, x1;
                K.pair(t, j, P, &x0, &x1);
                if constexpr (ROT) {
                    const int e = DT ? j * C + t : t * h + j;
                    const float c = cs[e], s = sn[e];
                    const float r = x0 * c - x1 * s;
                    x1 = x0 * s + x1 * c;
                    x0 = r;
                }
#pragma unroll
                for (int g = 0; g < MG; g++)
                    if (g < Gb)
                        acc[g] = fmaf(Qs[g * D + j], x0,
                                      fmaf(Qs[g * D + j + P], x1, acc[g]));
                if (++i == np) i = 0;
            }
            for (int d = 2 * P + part; d < D; d += 2) {
                const float x = K.el(t, d);
#pragma unroll
                for (int g = 0; g < MG; g++)
                    if (g < Gb) acc[g] = fmaf(Qs[g * D + d], x, acc[g]);
            }
#pragma unroll
            for (int g = 0; g < MG; g++)
                if (g < Gb) (part ? S2 : Ss)[g * C + t] = acc[g];
        }
    }
    if (has_new && warp == NW - 1) {  // the in-flight row (K rotated, f32)
        const float* kn = a.k_new + new_base;
        for (int g = 0; g < Gb; g++) {
            float v = 0.f;
            for (int d = lane; d < D; d += 32) v = fmaf(Qs[g * D + d], kn[d], v);
            v = warp_sum(v);
            if (lane == 0) Ss[g * C + n] = v;
        }
    }
    cp_wait<0>();
    __syncthreads();

    // the split's softmax, a warp per query head: masked entries are
    // -1e30 and weigh 0; p of a quantized cell carries its V scale
    for (int g = warp; g < Gb; g += NW) {
        float sv[C / 32];
        float m = NEG_INF;
#pragma unroll
        for (int i = 0; i < C / 32; i++) {
            const int t = lane + 32 * i;
            float x = NEG_INF;
            if (t >= t_lo && t < n) {
                float r = Ss[g * C + t] + S2[g * C + t];
                if constexpr (QUANT) r *= ks[t];
                x = cap(r * a.scale, a.softcap);
            } else if (has_new && t == n) {
                x = cap(Ss[g * C + t] * a.scale, a.softcap);
            }
            sv[i] = x;
            m = fmaxf(m, x);
        }
        m = warp_max(m);
        float l = 0.f;
#pragma unroll
        for (int i = 0; i < C / 32; i++) {
            const int t = lane + 32 * i;
            float e = expf(sv[i] - m);
            l += e;
            if (QUANT && t >= t_lo && t < n) e *= vs[t];
            Ss[g * C + t] = e;
        }
        l = warp_sum(l);
        if (lane == 0) {
            m_s[g] = m;
            l_s[g] = l;
        }
    }
    __syncthreads();

    // PV into the workspace: acc rows [B * H][NS][D], then (m, l) rows
    const Staged<KIND, DT> V{Vr, Dk};
    const size_t row0 = ((size_t)b * H + kh * G + g0) * NS + blockIdx.y;
    float* ws_acc = a.ws + row0 * D;
    float* ws_ml = a.ws + (size_t)a.B * H * NS * D + row0 * 2;
    const float* vn = a.v_new + new_base;
    // a thread per dimension, along the cells; under "dt" thread d starts
    // at cell t_lo + d % cnt and wraps, so that the lanes of a warp read
    // the [Dk][C] tile in different banks
    const int cnt = n - t_lo;
#pragma unroll
    for (int j = 0; j < NDT; j++) {
        const int d = tid + j * NTH;
        if (d >= D) continue;
        float o[MG];
#pragma unroll
        for (int g = 0; g < MG; g++) o[g] = 0.f;
        int t = t_lo + (DT && cnt > 0 ? d % cnt : 0);
        for (int k = 0; k < cnt; k++) {
            const float x = V.el(t, d);
#pragma unroll
            for (int g = 0; g < MG; g++)
                if (g < Gb) o[g] = fmaf(Ss[g * C + t], x, o[g]);
            if (DT && ++t == n) t = t_lo;
            if (!DT) t++;
        }
        const float x = has_new ? vn[d] : 0.f;
#pragma unroll
        for (int g = 0; g < MG; g++)
            if (g < Gb) {
                if (has_new) o[g] = fmaf(Ss[g * C + n], x, o[g]);
                ws_acc[(size_t)g * NS * D + d] = o[g];
            }
    }
    if (tid < Gb) {
        ws_ml[(size_t)tid * NS * 2] = m_s[tid];
        ws_ml[(size_t)tid * NS * 2 + 1] = l_s[tid];
    }
}

// One block per (row b, query head): out = sum_s w_s acc_s / sum_s w_s l_s,
// w_s = exp(m_s - max m) over the splits that ran (each holds a valid
// cell: the in-flight row, or cells between the window's start and the
// fill), read in a fixed order, so two runs give the same bits.
template <int NDT>
__global__ void __launch_bounds__(NTH) decode_merge_kernel(const Args a, int NS)
{
    const int H = a.KH * a.G, D = a.D;
    const int bh = blockIdx.x, b = bh / H;
    const int start = min(a.starts[b], a.T);
    const int lo = a.window > 0 ? max(0, start - a.window + 1) : 0;
    const int s_lo = lo / DEC_SPLIT, s_hi = start / DEC_SPLIT;
    const float* acc = a.ws + (size_t)bh * NS * D;
    const float* ml = a.ws + (size_t)a.B * H * NS * D + (size_t)bh * NS * 2;
    float m = NEG_INF;
#pragma unroll 4
    for (int s = s_lo; s <= s_hi; s++) m = fmaxf(m, ml[2 * s]);
    float den = 0.f, num[NDT];
#pragma unroll
    for (int j = 0; j < NDT; j++) num[j] = 0.f;
#pragma unroll 4
    for (int s = s_lo; s <= s_hi; s++) {
        const float w = expf(ml[2 * s] - m);
        den = fmaf(w, ml[2 * s + 1], den);
#pragma unroll
        for (int j = 0; j < NDT; j++) {
            const int d = threadIdx.x + j * NTH;
            if (d < D) num[j] = fmaf(w, acc[(size_t)s * D + d], num[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < NDT; j++) {
        const int d = threadIdx.x + j * NTH;
        if (d < D) a.out[(size_t)bh * D + d] = num[j] / fmaxf(den, 1e-30f);
    }
}

// --------------------------------------------------------------- prefill
// One block per (row b, kv head, QB query positions, chunk of GC query
// heads): R = QB * GC rows, row r = (position r / GC, head g0 + r % GC).
// grid.z walks the head chunks, so any G runs. Thread tid owns PV
// dimensions tid + j * NTH, j < NDT; at NDT = 2 the launch halves MAXR so
// that acc[NDT][MAXR] keeps its 64 registers.
template <int KIND, bool DT, bool ROT, int MAXR, int NDT>
__global__ void __launch_bounds__(NTH) prefill_kernel(const Args a, int QB,
                                                      int GC)
{
    extern __shared__ float smem[];
    const int KH = a.KH, G = a.G, D = a.D, Tc = a.Tc;
    const int R = QB * GC;  // query rows of this block: (position, head) pairs
    const int lds = D + 1;
    float* Qs = smem;                  // [R][D]
    float* Ks = Qs + R * D;            // [TB][D + 1]
    float* Vs = Ks + TB * lds;         // [TB][D + 1]
    float* Ss = Vs + TB * lds;         // [R][TB]
    float* m_s = Ss + R * TB;
    float* l_s = m_s + R;
    float* c_s = l_s + R;

    const int b = blockIdx.x / KH, kh = blockIdx.x % KH, qb = blockIdx.y;
    const int g0 = blockIdx.z * GC;          // first query head of the chunk
    const int tid = threadIdx.x;
    const int H = KH * G;
    const int start = a.starts[b];
    const int nv = a.n_valid[b];
    const int window = a.window;
    size_t cbase, sbase;
    plane_bases(a, KIND == Q4, b, kh, &cbase, &sbase);
    const size_t new_base = ((size_t)b * KH + kh) * (size_t)Tc * D;
    const int t_lo = qb * QB;                // first query position (relative)
    const int t_hi = min(Tc, t_lo + QB);     // one past the last

    for (int i = tid; i < R * D; i += NTH) {
        const int r = i / D, d = i % D;
        const int t = t_lo + r / GC, g = g0 + r % GC;
        Qs[i] = t < Tc && g < G
                    ? a.q[(((size_t)b * Tc + t) * H + kh * G + g) * D + d] : 0.f;
    }
    for (int r = tid; r < R; r += NTH) {
        m_s[r] = NEG_INF;
        l_s[r] = 0.f;
    }
    float acc[NDT][MAXR];
#pragma unroll
    for (int j = 0; j < NDT; j++)
#pragma unroll
        for (int r = 0; r < MAXR; r++) acc[j][r] = 0.f;

    const int p_end = start + t_hi;  // virtual cells [lo, p_end)
    int lo = window > 0 ? max(0, start + t_lo - window + 1) : 0;
    lo = lo / TB * TB;
    const int lane = tid & 31, wq = tid >> 5;
    for (int t0 = lo; t0 < p_end; t0 += TB) {
        __syncthreads();
        load_tile<KIND, DT, ROT>(Ks, Vs, lds, a, cbase, sbase, new_base, t0,
                                 start, p_end);
        __syncthreads();
        {   // scores: lane = cell, rows wq, wq + 4, ...
            float s[MAXR / 4];
#pragma unroll
            for (int i = 0; i < MAXR / 4; i++) s[i] = 0.f;
            // unrolled by 8: 2.8x faster on the H100 than the compiler's
            // own choice at B=1 Tc=512 (unrolled by 4: 1.04x), as
            // tpu_engine_torch/tools/attn_ab.py measures
#pragma unroll 8
            for (int d = 0; d < D; d++) {
                const float kd = Ks[lane * lds + d];
#pragma unroll
                for (int i = 0; i < MAXR / 4; i++) {
                    const int r = wq + 4 * i;
                    if (r < R) s[i] = fmaf(Qs[r * D + d], kd, s[i]);
                }
            }
            const int p = t0 + lane;
#pragma unroll
            for (int i = 0; i < MAXR / 4; i++) {
                const int r = wq + 4 * i;
                if (r < R) {
                    const int pos = start + t_lo + r / GC;
                    const bool ok = p <= pos && (p < start || p - start < nv)
                                    && (window <= 0 || p > pos - window);
                    Ss[r * TB + lane] = ok ? cap(s[i] * a.scale, a.softcap) : NEG_INF;
                }
            }
        }
        __syncthreads();
        softmax_tile(Ss, TB, m_s, l_s, c_s, R);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < NDT; j++) {
            const int d = tid + j * NTH;
            if (d < D) {
#pragma unroll
                for (int r = 0; r < MAXR; r++)
                    if (r < R) acc[j][r] *= c_s[r];
                for (int t = 0; t < TB; t++) {
                    const float v = Vs[t * lds + d];
#pragma unroll
                    for (int r = 0; r < MAXR; r++)
                        if (r < R) acc[j][r] = fmaf(Ss[r * TB + t], v, acc[j][r]);
                }
            }
        }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NDT; j++) {
        const int d = tid + j * NTH;
        if (d < D) {
#pragma unroll
            for (int r = 0; r < MAXR; r++) {
                const int t = t_lo + r / GC, g = g0 + r % GC;
                if (r < R && t < Tc && g < G)
                    a.out[(((size_t)b * Tc + t) * H + kh * G + g) * D + d] =
                        acc[j][r] / fmaxf(l_s[r], 1e-30f);
            }
        }
    }
}

// The largest of 16, 8, 4, 2 bytes that divides the address p and the
// byte counts x and y (1 if none): the copy size that keeps every piece
// of a staged run aligned.
inline int gran(const void* p, size_t x, size_t y)
{
    const size_t v = (size_t)(uintptr_t)p | x | y;
    for (int g = 16; g > 1; g >>= 1)
        if (v % g == 0) return g;
    return 1;
}

template <int KIND, bool DT, bool ROT, int NDT, int GB>
int decode_launch_g(const Args& a0, cudaStream_t stream)
{
    Args a = a0;
    if (a.ws == nullptr) return (int)cudaErrorInvalidValue;
    constexpr int ES = Bytes<KIND>::v;
    const int Dk = KIND == Q4 ? a.D / 2 : a.D;
    const int h = ROT ? a.rd / 2 : 0;
    // "td": a cell's Dk elements are one run; "dt": a d-row of T cells
    const size_t run = DT ? (size_t)a.T * ES : (size_t)Dk * ES;
    a.gc = min(gran(a.kc, run, 0), gran(a.vc, run, 0));
    const size_t srow = (size_t)a.T * 4;
    a.gs = (KIND == Q8 || KIND == Q4) ? min(gran(a.ksc, srow, 0), gran(a.vsc, srow, 0))
                                      : 4;
    // tables: "td" [T, h] (a cell's row is a run), "dt" [h, T]
    const size_t trow = DT ? srow : (size_t)h * 4;
    a.gt = ROT ? min(gran(a.cos_t, trow, 0), gran(a.sin_t, trow, 0)) : 4;
    const size_t smem = DecodeSmem(Dk * ES, a.D, h, GB).total;
    const int NS = a.T / DEC_SPLIT + 1;  // splits of cells [0, T], the in-flight cell included
    auto kern = decode_split_kernel<KIND, DT, ROT, NDT, GB>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)  // all of L1 as shared memory: more blocks an SM
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(a.B * a.KH, NS, (a.G + GB - 1) / GB);
    kern<<<grid, NTH, smem, stream>>>(a, NS);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    decode_merge_kernel<NDT><<<a.B * a.KH * a.G, NTH, 0, stream>>>(a, NS);
    return (int)cudaGetLastError();
}

// query heads a block: the power of two from 1 to DEC_MAXG that covers G
// (or a chunk of it), so that no loop over heads runs idle at G = 1
template <int KIND, bool DT, bool ROT, int NDT>
int decode_launch_d(const Args& a, cudaStream_t stream)
{
    const int g = min(a.G, DEC_MAXG);
    static_assert(DEC_MAXG == 8, "the cases below");
    return g > 4   ? decode_launch_g<KIND, DT, ROT, NDT, 8>(a, stream)
           : g > 2 ? decode_launch_g<KIND, DT, ROT, NDT, 4>(a, stream)
           : g > 1 ? decode_launch_g<KIND, DT, ROT, NDT, 2>(a, stream)
                   : decode_launch_g<KIND, DT, ROT, NDT, 1>(a, stream);
}

template <int KIND, bool DT, bool ROT>
int decode_launch(const Args& a, cudaStream_t stream)
{
    return a.D > NTH ? decode_launch_d<KIND, DT, ROT, 2>(a, stream)
                     : decode_launch_d<KIND, DT, ROT, 1>(a, stream);
}

template <int KIND, bool DT, bool ROT, int NDT>
int prefill_launch_d(const Args& a, cudaStream_t stream)
{
    constexpr int MAXR = PRE_MAXR / NDT;
    const int GC = min(a.G, MAXR);  // query heads per block
    const int QB = MAXR / GC;       // query positions per block
    const int R = QB * GC;
    const int D = a.D;
    const size_t smem = sizeof(float) *
        ((size_t)R * D + 2 * TB * (D + 1) + (size_t)R * TB + 3 * R);
    auto kern = prefill_kernel<KIND, DT, ROT, MAXR, NDT>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(a.B * a.KH, (a.Tc + QB - 1) / QB, (a.G + GC - 1) / GC);
    kern<<<grid, NTH, smem, stream>>>(a, QB, GC);
    return (int)cudaGetLastError();
}

template <int KIND, bool DT, bool ROT>
int prefill_launch(const Args& a, cudaStream_t stream)
{
    return a.D > NTH ? prefill_launch_d<KIND, DT, ROT, 2>(a, stream)
                     : prefill_launch_d<KIND, DT, ROT, 1>(a, stream);
}

// The entry point of one layout and K storage: checks the limits, then
// dispatches on the cell kind (Kind).
template <bool DT, bool ROT>
int attention(int prefill, int kind, const Args& a, cudaStream_t stream)
{
    if (a.D > MAXD || (a.D % 2) || a.G < 1 || (!prefill && a.Tc != 1))
        return (int)cudaErrorInvalidValue;
    if ((kind == Q8 || kind == Q4) && (a.ksc == nullptr || a.vsc == nullptr))
        return (int)cudaErrorInvalidValue;
    if (ROT && (a.cos_t == nullptr || a.sin_t == nullptr || a.rd < 0 ||
                (a.rd % 2) || a.rd > a.D))
        return (int)cudaErrorInvalidValue;
    switch (kind) {
    case F32:
        return prefill ? prefill_launch<F32, DT, ROT>(a, stream)
                       : decode_launch<F32, DT, ROT>(a, stream);
    case BF16:
        return prefill ? prefill_launch<BF16, DT, ROT>(a, stream)
                       : decode_launch<BF16, DT, ROT>(a, stream);
    case Q8:
        return prefill ? prefill_launch<Q8, DT, ROT>(a, stream)
                       : decode_launch<Q8, DT, ROT>(a, stream);
    case Q4:
        return prefill ? prefill_launch<Q4, DT, ROT>(a, stream)
                       : decode_launch<Q4, DT, ROT>(a, stream);
    }
    return (int)cudaErrorInvalidValue;
}

// Packs the C interface's operands (the tables read only when ROT).
inline Args make_args(const void* q, const void* k_new, const void* v_new,
                      const void* kc, const void* vc, const void* ksc,
                      const void* vsc, const void* slot_ids, const void* starts,
                      const void* n_valid, void* out, int B, int Tc, int KH,
                      int G, int D, int S, int T, int li, int window,
                      float scale, float softcap, const void* cos_t,
                      const void* sin_t, int rd, void* ws)
{
    Args a;
    a.q = (const float*)q;
    a.k_new = (const float*)k_new;
    a.v_new = (const float*)v_new;
    a.kc = kc;
    a.vc = vc;
    a.ksc = (const float*)ksc;
    a.vsc = (const float*)vsc;
    a.slot_ids = (const int*)slot_ids;
    a.starts = (const int*)starts;
    a.n_valid = (const int*)n_valid;
    a.out = (float*)out;
    a.B = B; a.Tc = Tc; a.KH = KH; a.G = G; a.D = D; a.S = S; a.T = T;
    a.li = li; a.window = window; a.scale = scale; a.softcap = softcap;
    a.cos_t = (const float*)cos_t;
    a.sin_t = (const float*)sin_t;
    a.rd = rd;
    a.ws = (float*)ws;
    a.gc = a.gs = a.gt = 4;
    return a;
}

}  // namespace attn

// The C interface of all eight entry points (attn.cu, attn_dt.cu,
// attn_rope.cu, attn_dt_rope.cu): kind is attn::Kind (0 f32, 1 bf16,
// 2 q8_0, 3 q4_0); ksc/vsc may be null for the float kinds; n_valid may be
// null for decode (Tc == 1); cos_t/sin_t are the rope tables [T, rd/2]
// f32 when ROT (the "dt" decode entry point takes them as [rd/2, T], read
// by runs of cells as it reads the cache), else null with rd 0; ws is the
// decode workspace, B * H * (T / DEC_SPLIT + 1) * (D + 2) floats (null
// for prefill).
#define ATTN_ENTRY(NAME, PREFILL, DT, ROT)                                     \
    extern "C" int NAME(const void* q, const void* k_new, const void* v_new,   \
                        const void* kc, const void* vc, const void* ksc,       \
                        const void* vsc, int kind, const void* slot_ids,       \
                        const void* starts, const void* n_valid, void* out,    \
                        int B, int Tc, int KH, int G, int D, int S, int T,     \
                        int li, int window, float scale, float softcap,        \
                        const void* cos_t, const void* sin_t, int rd,          \
                        void* ws, void* stream)                                \
    {                                                                          \
        const attn::Args a = attn::make_args(                                  \
            q, k_new, v_new, kc, vc, ksc, vsc, slot_ids, starts, n_valid, out, \
            B, Tc, KH, G, D, S, T, li, window, scale, softcap, cos_t, sin_t,   \
            rd, ws);                                                           \
        return attn::attention<DT, ROT>(PREFILL, kind, a,                      \
                                        (cudaStream_t)stream);                 \
    }
