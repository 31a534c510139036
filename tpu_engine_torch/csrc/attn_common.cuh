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
// and PV multiply-adds (2 * rows * attended cells * D per kv head, 4 *
// that in flops) against the f32 rate, 67 TFLOP/s; on the way there by
// shared-memory reads (32 words a clock an SM against 128 f32 FMAs), so
// the prefill loops read their operands as 16-byte vectors into register
// tiles. Scores, softmax and the PV sum stay in f32 on the CUDA cores.
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
// positions, chunk of query heads) walks its virtual cells in tiles of BN
// cells. At D <= 128: 256 threads, R = 64 query rows, BN = 64; at D =
// 256: 128 threads, R = 32, BN = 32 (so that the tiles fit). A thread
// owns a register tile of 4 rows x BN/16 cells of the scores and 4 rows
// x D/16 dimensions of the output, and reads Q and K along d, P (stored
// transposed) and V along the cells, as float4: 0.5 shared words per FMA
// in the scores and 0.375 in PV at D <= 128 (0.75 and 0.31 at D = 256),
// against about 1 in the element loops this replaced. The row max and sum of the online softmax
// are taken by shuffles across the 16 threads of a row, so m and l stay
// in registers. The stored bytes of each tile's cache cells (bf16, int8,
// packed q4_0, f32; their scales; under ROT their rope rows [T, rd/2])
// and its in-flight rows (f32, straight into the K and V tiles) are
// copied with cp.async (16-byte pieces where addresses allow, as in
// decode), each under half a tile of arithmetic: two barriers a tile (see
// prefill_kernel). Cache cells are dequantized (x scale) and under ROT
// rotated in one pass into the f32 tiles. Shared memory a block, bytes
// (with ROT): D = 128 f32 184320 (217088), bf16 151552 (184320), q8_0
// 135680 (168448), q4_0 127488 (160256); D = 256 f32 169984 (202752),
// bf16 137216 (169984), q8_0 121088 (153856), q4_0 112896 (145664): one
// block an SM. 158-210 registers a thread and no spills, as nvcc's
// -Xptxas -v reports them (chip_smoke.py prints them). The query blocks with the most cells run
// first; the walk starts at the first tile the window reaches and stops
// at the chunk's last position or start + n_valid, whichever is first;
// only tiles that cross the diagonal, start + n_valid or the window's
// start are masked. Position p of a "virtual cell" is its cell index for
// p < start and start + j for in-flight row j, so one mask covers both:
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
constexpr int NTH = 128;   // threads per decode block (prefill: PreGeo::NT)
constexpr int MAXD = 256;  // head_dim limit
constexpr int DEC_MAXG = 8;   // query heads per decode block
constexpr int DEC_SPLIT = 64;  // cache cells per decode split
                               // (kernels/flash_attention.py DEC_SPLIT)

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
    int gc, gs, gt;       // copy sizes (bytes) of cells, scales, tables
    int gn;               // prefill copy size (bytes) of the in-flight rows
};

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
// to dst + r * dstride in g-byte pieces, spread over NT threads: cp.async
// for g = 4, 8 and 16 (both addresses g-aligned), plain loads and stores
// for g = 1 or 2 (visible after the caller's barrier).
template <int NT = NTH>
__device__ __forceinline__ void stage(unsigned char* dst, int dstride,
                                      const unsigned char* src, size_t sstride,
                                      int rows, int run, int g)
{
    const int per = run / g;  // pieces per row
    if (per <= 0) return;
    const int total = rows * per;
    // piece i = threadIdx.x + k * NT is (row r, piece c), stepped without
    // a division per piece
    int r = threadIdx.x / per, c = threadIdx.x - r * per;
    const int dr = NT / per, dc = NT - dr * per;
    for (int i = threadIdx.x; i < total; i += NT) {
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

// C staged cells as stored (no scale applied): under "td" rows of Dk
// stored elements per cell, under "dt" Dk rows of C cells.
template <int KIND, bool DT, int C = DEC_SPLIT>
struct Staged {
    const unsigned char* p;
    int Dk;  // stored elements per cell
    __device__ __forceinline__ size_t at(int t, int j) const {
        return DT ? (size_t)j * C + t : (size_t)t * Dk + j;
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
// Tile geometry of the prefill kernel for head_dim up to DMAX (128 or
// 256): NT threads, R query rows a block, BN cells a tile; thread (ty, tx) = (tid /
// TX, tid % TX) owns rows ty * RM + i (i < RM), score cells tx + TX * j
// (j < CN) and output dimensions 4 (tx + TX u) + e (u < DN / 4, e < 4).
template <int DMAX>
struct PreGeo {
    static constexpr int NT = DMAX > 128 ? 128 : 256;  // threads
    static constexpr int TX = 16, TY = NT / TX, RM = 4;
    static constexpr int R = TY * RM;
    static constexpr int BN = DMAX > 128 ? 32 : 64;
    static constexpr int CN = BN / TX;
    static constexpr int DN = DMAX / TX;
};

// Dynamic shared memory of prefill_kernel, in bytes: f32 tiles Q [R][LD],
// K and V [BN][LD], P transposed [BN][LP] (LD = D rounded up to 4, plus 4,
// and LP = R + 4, against bank conflicts), then the stored bytes of
// the tile's cache cells as copied (K, V), their scales and, under ROT,
// their cos/sin rows [BN][h].
struct PrefillSmem {
    size_t q, k, v, p, rk, rv, ks, vs, cs, sn, total;
    int Dp, LD, LP;
    __host__ __device__ PrefillSmem(int D, int cell_bytes, int h, int R, int BN,
                                    bool quant) {
        Dp = (D + 3) / 4 * 4;
        LD = Dp + 4;
        LP = R + 4;
        q = 0;
        k = q + (size_t)R * LD * 4;
        v = k + (size_t)BN * LD * 4;
        p = v + (size_t)BN * LD * 4;
        rk = p + (size_t)BN * LP * 4;
        rv = rk + align16((size_t)BN * cell_bytes);
        ks = rv + align16((size_t)BN * cell_bytes);
        vs = ks + (quant ? BN * 4 : 0);
        cs = vs + (quant ? BN * 4 : 0);
        sn = cs + (size_t)BN * h * 4;
        total = sn + (size_t)BN * h * 4;
    }
};

// f(c, d) for every c < n, d < W, spread over the block: "dt" with c
// fastest (a staged d-row holds BN cells), "td" with d fastest (a cell's
// elements are contiguous), stepped without a division per pair.
template <bool DT, int BN, int NT, typename F>
__device__ __forceinline__ void for_cells(int n, int W, F f)
{
    if (n <= 0 || W <= 0) return;
    if constexpr (DT) {
        for (int i = threadIdx.x; i < BN * W; i += NT) {
            const int c = i % BN, d = i / BN;
            if (c < n) f(c, d);
        }
    } else {
        int c = threadIdx.x / W, d = threadIdx.x - c * W;
        const int dc = NT / W, dd = NT - dc * W;
        for (int i = threadIdx.x; i < n * W; i += NT) {
            f(c, d);
            c += dc;
            d += dd;
            if (d >= W) {
                d -= W;
                c++;
            }
        }
    }
}

// One block per (row b, kv head, QB query positions, chunk of GC query
// heads): Rb = QB * GC <= R rows, row r = (position r / GC, head g0 + r %
// GC); grid.z walks the head chunks, so any G runs, and blockIdx.y runs
// the query blocks last to first, so the blocks with the most cells
// launch first. Each tile of BN virtual cells passes two barriers:
//   A: V's in-flight rows copied (cp.async) into the V tile and the next
//      tile's stored K bytes into the staging area; this tile's staged V
//      cells dequantized into the V tile; scores from the Q and K tiles,
//      the online softmax (row max and sum by shuffles over the TX
//      threads of a row), P into its tile. Barrier.
//   B: the next tile's in-flight K rows copied into the K tile and its
//      stored V bytes into the staging area; the next tile's staged K
//      cells dequantized (ROT: rotated) into the K tile; PV. Barrier.
// Each copy runs under half a tile of arithmetic. Cells past p_end are
// zeros, so that a weight of 1 (a row with no valid cell yet) adds
// nothing.
template <int KIND, bool DT, bool ROT, int DMAX>
__global__ void __launch_bounds__(PreGeo<DMAX>::NT, 1) prefill_kernel(
    const Args a, int QB, int GC)
{
    using Geo = PreGeo<DMAX>;
    constexpr int NT = Geo::NT, TX = Geo::TX, RM = Geo::RM, R = Geo::R, BN = Geo::BN;
    constexpr int CN = Geo::CN, DN = Geo::DN, ES = Bytes<KIND>::v;
    constexpr bool QUANT = KIND == Q8 || KIND == Q4;
    extern __shared__ __align__(16) unsigned char psmem[];
    const int KH = a.KH, G = a.G, D = a.D, Tc = a.Tc, T = a.T;
    const int Dk = KIND == Q4 ? D / 2 : D;
    const int h = ROT ? a.rd / 2 : 0;  // rotated pairs
    const PrefillSmem L(D, Dk * ES, h, R, BN, QUANT);
    const int Dp = L.Dp, LD = L.LD, LP = L.LP;
    float* Qs = (float*)(psmem + L.q);
    float* Ks = (float*)(psmem + L.k);
    float* Vs = (float*)(psmem + L.v);
    float* Pt = (float*)(psmem + L.p);
    unsigned char* rK = psmem + L.rk;
    unsigned char* rV = psmem + L.rv;
    float* ksc = (float*)(psmem + L.ks);
    float* vsc = (float*)(psmem + L.vs);
    float* cs = (float*)(psmem + L.cs);
    float* sn = (float*)(psmem + L.sn);

    const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
    const int qb = gridDim.y - 1 - blockIdx.y;
    const int g0 = blockIdx.z * GC;  // first query head of the chunk
    const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
    const int H = KH * G, Rb = QB * GC;
    const int slot = min(max(a.slot_ids[b], 0), a.S - 1);
    const int start = a.starts[b];
    const int nv = a.n_valid[b];
    const int window = a.window;
    const size_t sbase = (((size_t)a.li * a.S + slot) * KH + kh) * (size_t)T;
    const size_t cbase = sbase * Dk;
    const size_t new_base = ((size_t)b * KH + kh) * (size_t)Tc * D;
    const int t_lo = qb * QB;             // first query position (relative)
    const int t_hi = min(Tc, t_lo + QB);  // one past the last
    // virtual cells [lo, p_end): those past start + n_valid are masked in
    // every row, so the walk stops there
    const int p_end = min(start + t_hi, start + max(nv, 0));
    int lo = window > 0 ? max(0, start + t_lo - window + 1) : 0;
    lo = lo / BN * BN;

    // the tile at t0: cache cells c < n_cache(t0), in-flight rows up to
    // n_live(t0), zeros beyond
    auto n_cache = [&](int t0) { return min(max(start - t0, 0), BN); };
    auto n_live = [&](int t0) { return min(max(p_end - t0, 0), BN); };
    // cp.async of the stored bytes of the tile's cache cells (K: with the
    // scales and rope rows; V: with the scales)
    auto stage_cache = [&](bool v, int t0) {
        const int n = n_cache(t0);
        if (n <= 0) return;
        const unsigned char* cells = (const unsigned char*)(v ? a.vc : a.kc);
        unsigned char* dst = v ? rV : rK;
        if constexpr (DT)  // Dk runs of the tile's cells
            stage<NT>(dst, BN * ES, cells + (cbase + t0) * ES, (size_t)T * ES, Dk,
                      round_up(n * ES, a.gc), a.gc);
        else  // one run of whole cells
            stage<NT>(dst, 0, cells + (cbase + (size_t)t0 * Dk) * ES, 0, 1,
                      n * Dk * ES, a.gc);
        if constexpr (QUANT)
            stage<NT>((unsigned char*)(v ? vsc : ksc), 0,
                      (const unsigned char*)((v ? a.vsc : a.ksc) + sbase + t0), 0, 1,
                      round_up(n * 4, a.gs), a.gs);
        if (ROT && !v && h > 0)
            for (int k = 0; k < 2; k++)
                stage<NT>((unsigned char*)(k ? sn : cs), 0,
                          (const unsigned char*)((k ? a.sin_t : a.cos_t) + (size_t)t0 * h),
                          0, 1, n * h * 4, a.gt);
    };
    // cp.async of the tile's in-flight rows (f32) into the K or V tile,
    // and zeros past p_end
    auto stage_new = [&](bool v, int t0) {
        float* dst = v ? Vs : Ks;
        const int c0 = n_cache(t0), c1 = n_live(t0);
        if (c1 > c0)
            stage<NT>((unsigned char*)(dst + (size_t)c0 * LD), LD * 4,
                      (const unsigned char*)((v ? a.v_new : a.k_new) + new_base +
                                             (size_t)(t0 + c0 - start) * D),
                      (size_t)D * 4, c1 - c0, D * 4, a.gn);
        for (int i = tid; i < (BN - c1) * Dp; i += NT)
            dst[(c1 + i / Dp) * LD + i % Dp] = 0.f;
    };
    // the staged cache cells of the tile as f32 (x scale) into the K or V
    // tile; K under ROT rotated by pairs (j, j + h), j < h
    auto dequant = [&](bool v, int t0) {
        const int n = n_cache(t0);
        float* dst = v ? Vs : Ks;
        const float* sc = v ? vsc : ksc;
        const Staged<KIND, DT, BN> S{v ? rV : rK, Dk};
        int d0 = 0;
        if (ROT && !v) {
            for_cells<DT, BN, NT>(n, h, [&](int c, int j) {
                float x0, x1;
                S.pair(c, j, h, &x0, &x1);
                if constexpr (QUANT) {
                    x0 *= sc[c];
                    x1 *= sc[c];
                }
                const float co = cs[c * h + j], si = sn[c * h + j];
                dst[c * LD + j] = x0 * co - x1 * si;
                dst[c * LD + j + h] = x0 * si + x1 * co;
            });
            d0 = 2 * h;
        }
        for_cells<DT, BN, NT>(n, D - d0, [&](int c, int e) {
            float x = S.el(c, d0 + e);
            if constexpr (QUANT) x *= sc[c];
            dst[c * LD + d0 + e] = x;
        });
    };

    for (int i = tid; i < R * Dp; i += NT) {
        const int r = i / Dp, d = i - r * Dp;
        const int t = t_lo + r / GC, g = g0 + r % GC;
        Qs[r * LD + d] = r < Rb && t < Tc && g < G && d < D
                    ? a.q[(((size_t)b * Tc + t) * H + kh * G + g) * D + d] : 0.f;
    }
    for (int i = tid; i < BN * (Dp - D); i += NT) {  // pad columns, never copied
        const int c = i / (Dp - D), d = D + i % (Dp - D);
        Ks[c * LD + d] = 0.f;
        Vs[c * LD + d] = 0.f;
    }
    float m[RM], l[RM], acc[RM][DN];
#pragma unroll
    for (int i = 0; i < RM; i++) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int k = 0; k < DN; k++) acc[i][k] = 0.f;
    }
    stage_cache(false, lo);
    stage_new(false, lo);
    stage_cache(true, lo);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    dequant(false, lo);
    __syncthreads();

    for (int t0 = lo; t0 < p_end; t0 += BN) {
        const int t1 = t0 + BN;
        const bool more = t1 < p_end;
        // ---- A
        stage_new(true, t0);
        if (more) stage_cache(false, t1);
        cp_commit();
        dequant(true, t0);
        float s[RM][CN];
#pragma unroll
        for (int i = 0; i < RM; i++)
#pragma unroll
            for (int j = 0; j < CN; j++) s[i][j] = 0.f;
        const float* qrow = Qs + ty * RM * LD;
#pragma unroll 2
        for (int d = 0; d < Dp; d += 4) {
            float4 kv[CN];
#pragma unroll
            for (int j = 0; j < CN; j++)
                kv[j] = *(const float4*)(Ks + (tx + TX * j) * LD + d);
#pragma unroll
            for (int i = 0; i < RM; i++) {
                const float4 qv = *(const float4*)(qrow + i * LD + d);
#pragma unroll
                for (int j = 0; j < CN; j++) {
                    s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
                    s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
                    s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
                    s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
                }
            }
        }
        // the mask only on tiles that cross the diagonal, the end of the
        // valid rows or the window's start
        const int last = t0 + BN - 1;
        const bool edge = !(last <= start + t_lo && last < start + nv &&
                            (window <= 0 || t0 > start + t_hi - 1 - window));
        float corr[RM];
#pragma unroll
        for (int i = 0; i < RM; i++) {
            const int pos = start + t_lo + (ty * RM + i) / GC;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < CN; j++) {
                float x = cap(s[i][j] * a.scale, a.softcap);
                if (edge) {
                    const int p = t0 + tx + TX * j;
                    const bool ok = p <= pos && (p < start || p - start < nv) &&
                                    (window <= 0 || p > pos - window);
                    x = ok ? x : NEG_INF;
                }
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
#pragma unroll
            for (int o = TX / 2; o > 0; o >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float mn = fmaxf(m[i], mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < CN; j++) {
                s[i][j] = expf(s[i][j] - mn);
                sum += s[i][j];
            }
#pragma unroll
            for (int o = TX / 2; o > 0; o >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, o);
            corr[i] = expf(m[i] - mn);
            l[i] = l[i] * corr[i] + sum;
            m[i] = mn;
        }
#pragma unroll
        for (int j = 0; j < CN; j++)
#pragma unroll
            for (int i = 0; i < RM; i += 4)
                *(float4*)(Pt + (tx + TX * j) * LP + ty * RM + i) =
                    make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
        cp_wait<0>();
        __syncthreads();
        // ---- B
        if (more) {
            stage_new(false, t1);
            stage_cache(true, t1);
        }
        cp_commit();
        if (more) dequant(false, t1);
#pragma unroll
        for (int i = 0; i < RM; i++)
#pragma unroll
            for (int k = 0; k < DN; k++) acc[i][k] *= corr[i];
        const int cn = n_live(t0);  // the zeros past it add nothing
        for (int c = 0; c < cn; c++) {
            float pr[RM];
#pragma unroll
            for (int i = 0; i < RM; i += 4) {
                const float4 x = *(const float4*)(Pt + c * LP + ty * RM + i);
                pr[i] = x.x;
                pr[i + 1] = x.y;
                pr[i + 2] = x.z;
                pr[i + 3] = x.w;
            }
#pragma unroll
            for (int u = 0; u < DN / 4; u++) {
                const int d = 4 * (tx + TX * u);
                if (d < D) {
                    const float4 x = *(const float4*)(Vs + c * LD + d);
#pragma unroll
                    for (int i = 0; i < RM; i++) {
                        acc[i][4 * u] = fmaf(pr[i], x.x, acc[i][4 * u]);
                        acc[i][4 * u + 1] = fmaf(pr[i], x.y, acc[i][4 * u + 1]);
                        acc[i][4 * u + 2] = fmaf(pr[i], x.z, acc[i][4 * u + 2]);
                        acc[i][4 * u + 3] = fmaf(pr[i], x.w, acc[i][4 * u + 3]);
                    }
                }
            }
        }
        cp_wait<0>();
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RM; i++) {
        const int r = ty * RM + i;
        const int t = t_lo + r / GC, g = g0 + r % GC;
        if (r >= Rb || t >= Tc || g >= G) continue;
        float* o = a.out + (((size_t)b * Tc + t) * H + kh * G + g) * D;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int u = 0; u < DN / 4; u++) {
            const int d = 4 * (tx + TX * u);
            if (D % 4 == 0 && d < D) {
                *(float4*)(o + d) = make_float4(acc[i][4 * u] / den, acc[i][4 * u + 1] / den,
                                                acc[i][4 * u + 2] / den, acc[i][4 * u + 3] / den);
            } else {
#pragma unroll
                for (int e = 0; e < 4; e++)
                    if (d + e < D) o[d + e] = acc[i][4 * u + e] / den;
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

template <int KIND, bool DT, bool ROT, int DMAX>
int prefill_launch_d(const Args& a0, cudaStream_t stream)
{
    using Geo = PreGeo<DMAX>;
    Args a = a0;
    constexpr int ES = Bytes<KIND>::v;
    constexpr bool QUANT = KIND == Q8 || KIND == Q4;
    const int Dk = KIND == Q4 ? a.D / 2 : a.D;
    const int h = ROT ? a.rd / 2 : 0;
    // "td": a cell's Dk elements are one run; "dt": a d-row of T cells
    const size_t run = DT ? (size_t)a.T * ES : (size_t)Dk * ES;
    a.gc = min(gran(a.kc, run, 0), gran(a.vc, run, 0));
    const size_t srow = (size_t)a.T * 4;
    a.gs = QUANT ? min(gran(a.ksc, srow, 0), gran(a.vsc, srow, 0)) : 4;
    // tables [T, h] in both layouts: a cell's row is a run
    a.gt = ROT && h > 0 ? min(gran(a.cos_t, (size_t)h * 4, 0),
                              gran(a.sin_t, (size_t)h * 4, 0)) : 4;
    a.gn = min(gran(a.k_new, (size_t)a.D * 4, 0), gran(a.v_new, (size_t)a.D * 4, 0));
    const int GC = min(a.G, Geo::R);  // query heads per block
    const int QB = Geo::R / GC;       // query positions per block
    const size_t smem = PrefillSmem(a.D, Dk * ES, h, Geo::R, Geo::BN, QUANT).total;
    auto kern = prefill_kernel<KIND, DT, ROT, DMAX>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(a.B * a.KH, (a.Tc + QB - 1) / QB, (a.G + GC - 1) / GC);
    kern<<<grid, Geo::NT, smem, stream>>>(a, QB, GC);
    return (int)cudaGetLastError();
}

template <int KIND, bool DT, bool ROT>
int prefill_launch(const Args& a, cudaStream_t stream)
{
    return a.D > 128 ? prefill_launch_d<KIND, DT, ROT, 256>(a, stream)
                     : prefill_launch_d<KIND, DT, ROT, 128>(a, stream);
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
    a.gc = a.gs = a.gt = a.gn = 4;
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
