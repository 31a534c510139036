// Flash attention over the slot-paged KV cache, for the deferred-append
// forward step of tpu_engine_torch/model/llama.py: the cache holds only the
// history (cells < start[b]); the step's own K/V rows arrive in flight
// (K already rotated) and fold into the same online softmax. K is stored
// either pre-rotated (ROT = false) or unrotated (ROT = true, self-extend:
// the loader rotates each cached K cell as it fills the tile, see below).
//
// One set of kernels serves both storage layouts and all four kinds; a
// cell loader templated on (kind, layout) turns a stored cell into f32:
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
// self-extend remap of p already applied by the caller. The loader
// dequantizes a cached K cell, then rotates its first rd elements by split
// halves (the scale is constant over d, so the order does not matter):
//   k'[j] = k[j] cos[p][j] - k[j + rd/2] sin[p][j]
//   k'[j + rd/2] = k[j] sin[p][j] + k[j + rd/2] cos[p][j],   j < rd/2;
// elements d >= rd pass through. V and the in-flight rows are never
// rotated here. A thread takes the pair (j, j + rd/2) of one cell: under
// "td" lanes run along j, under "dt" along cells. For q4_0 with rd = D the
// pair is the two nibbles of one byte, read once. Decode then also reads
// the table rows of the live cells: 2 * rd/2 * 4 B each (512 B at
// rd = 128), shared by the KH blocks of a row through L2.
//
// What bounds them on the H100: decode reads every live cache cell of the
// slot once (start * Dk stored bytes of K and of V per kv head, plus 4 B
// of scale each when quantized) against 3.35 TB/s; prefill over a long
// chunk is bound by the score and PV multiply-adds (4 * rows * cells * D
// per kv head) against the f32 rate.
// What the simple design does about it: one block per (row b, kv head,
// chunk of up to 8 query heads) (decode) or (row b, kv head, block of
// query positions, chunk of query heads) (prefill) reads its cells
// straight from cache[li, slot_ids[b]] (no gather copy), 32 at a time into
// shared memory as f32 (dequantized on the way), so the query heads of a
// chunk share each load. Any head_dim D <= 256 (even) and any query-group
// size G run: a thread owns PV dimensions tid and, above D = 128, tid +
// 128; a G past one chunk takes more blocks, each loading its own tiles.
// Under "td" neighbouring threads load neighbouring d of one cell; under
// "dt" neighbouring cells of one d, so both read memory in order. The loop stops at the row's fill (work
// scales with the live history, not the allocated T) and skips tiles
// wholly outside a sliding window. Scores, softmax and the PV sum stay in
// f32 on the CUDA cores. Position p of a "virtual cell" is its cell index
// for p < start and start + j for in-flight row j, so one mask covers
// both:
//   ok = p <= pos_row  and  (p < start or p - start < n_valid)
//        and (window <= 0 or p > pos_row - window)
// Masked scores are -1e30 (not -inf), as in the TPU kernels.

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
// One block per (row b, kv head, chunk of MAXG query heads of the group):
// grid.y walks the chunks, so any G runs; each chunk's block loads the kv
// head's tiles itself. Thread tid owns PV dimensions tid + j * NTH, j < NDT.
// The tiles' row strides are fixed by NDT (LD = NDT * NTH + 1), so the
// score loop's addresses fold to constants.
template <int KIND, bool DT, bool ROT, int MAXG, int NDT>
__global__ void __launch_bounds__(NTH) decode_kernel(const Args a)
{
    constexpr int DQ = NDT * NTH, LD = DQ + 1;  // Qs and K/V row strides
    float *Ks, *Vs, *Qs, *Ss, *m_s;  // [TB][LD], [TB][LD], [MAXG][DQ], [MAXG][TB]
    if constexpr (NDT == 1) {
        // static arrays at D <= 128 (38 KB): the same layout in dynamic
        // shared memory ran attn_decode 3-4% slower (tools/attn_ab.py)
        __shared__ float ks[TB * LD], vs[TB * LD], qs[MAXG * DQ], ss[MAXG * TB],
            mlc[3 * MAXG];
        Ks = ks, Vs = vs, Qs = qs, Ss = ss, m_s = mlc;
    } else {
        extern __shared__ float smem[];
        Ks = smem, Vs = Ks + TB * LD, Qs = Vs + TB * LD, Ss = Qs + MAXG * DQ;
        m_s = Ss + MAXG * TB;
    }
    float* l_s = m_s + MAXG;
    float* c_s = l_s + MAXG;
    const int KH = a.KH, G = a.G, D = a.D;

    const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
    const int g0 = blockIdx.y * MAXG;     // first query head of this block
    const int Gb = min(MAXG, G - g0);     // query heads of this block
    const int tid = threadIdx.x;
    const int H = KH * G;
    const int start = a.starts[b];
    const int window = a.window;
    size_t cbase, sbase;
    plane_bases(a, KIND == Q4, b, kh, &cbase, &sbase);
    const size_t new_base = ((size_t)b * KH + kh) * D;
    const size_t q_base = ((size_t)b * H + kh * G + g0) * D;

    for (int i = tid; i < Gb * D; i += NTH) {
        const int g = i / D, d = i % D;
        Qs[g * DQ + d] = a.q[q_base + i];
    }
    if (tid < MAXG) {
        m_s[tid] = NEG_INF;
        l_s[tid] = 0.f;
    }
    float acc[NDT][MAXG];
#pragma unroll
    for (int j = 0; j < NDT; j++)
#pragma unroll
        for (int g = 0; g < MAXG; g++) acc[j][g] = 0.f;

    // the query sits at position `start`; cells below lo are outside the window
    int lo = window > 0 ? max(0, start - window + 1) : 0;
    lo = lo / TB * TB;
    for (int t0 = lo; t0 <= start; t0 += TB) {
        __syncthreads();
        load_tile<KIND, DT, ROT>(Ks, Vs, LD, a, cbase, sbase, new_base, t0,
                                 start, start + 1);
        __syncthreads();
        for (int i = tid; i < Gb * TB; i += NTH) {
            const int g = i / TB, t = i % TB, p = t0 + t;
            float s = 0.f;
#pragma unroll 8
            for (int d = 0; d < D; d++) s = fmaf(Qs[g * DQ + d], Ks[t * LD + d], s);
            s = cap(s * a.scale, a.softcap);
            const bool ok = p <= start && (window <= 0 || p > start - window);
            Ss[g * TB + t] = ok ? s : NEG_INF;
        }
        __syncthreads();
        softmax_tile(Ss, TB, m_s, l_s, c_s, Gb);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < NDT; j++) {
            const int d = tid + j * NTH;
            if (d < D) {
#pragma unroll
                for (int g = 0; g < MAXG; g++) {
                    if (g < Gb) {
                        float acc_g = acc[j][g] * c_s[g];
                        for (int t = 0; t < TB; t++)
                            acc_g = fmaf(Ss[g * TB + t], Vs[t * LD + d], acc_g);
                        acc[j][g] = acc_g;
                    }
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
            for (int g = 0; g < MAXG; g++)
                if (g < Gb)
                    a.out[q_base + (size_t)g * D + d] =
                        acc[j][g] / fmaxf(l_s[g], 1e-30f);
        }
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

template <int KIND, bool DT, bool ROT, int NDT>
int decode_launch_d(const Args& a, cudaStream_t stream)
{
    constexpr int DQ = NDT * NTH, MG = DEC_MAXG;  // the kernel's layout
    const size_t smem = NDT == 1 ? 0 : sizeof(float) *
        (2 * TB * (DQ + 1) + MG * DQ + MG * TB + 3 * MG);
    auto kern = decode_kernel<KIND, DT, ROT, DEC_MAXG, NDT>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(a.B * a.KH, (a.G + DEC_MAXG - 1) / DEC_MAXG);
    kern<<<grid, NTH, smem, stream>>>(a);
    return (int)cudaGetLastError();
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
                      const void* sin_t, int rd)
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
    return a;
}

}  // namespace attn

// The C interface of all eight entry points (attn.cu, attn_dt.cu,
// attn_rope.cu, attn_dt_rope.cu): kind is attn::Kind (0 f32, 1 bf16,
// 2 q8_0, 3 q4_0); ksc/vsc may be null for the float kinds; n_valid may be
// null for decode (Tc == 1); cos_t/sin_t are the rope tables [T, rd/2]
// f32 when ROT, else null with rd 0.
#define ATTN_ENTRY(NAME, PREFILL, DT, ROT)                                     \
    extern "C" int NAME(const void* q, const void* k_new, const void* v_new,   \
                        const void* kc, const void* vc, const void* ksc,       \
                        const void* vsc, int kind, const void* slot_ids,       \
                        const void* starts, const void* n_valid, void* out,    \
                        int B, int Tc, int KH, int G, int D, int S, int T,     \
                        int li, int window, float scale, float softcap,        \
                        const void* cos_t, const void* sin_t, int rd,          \
                        void* stream)                                          \
    {                                                                          \
        const attn::Args a = attn::make_args(                                  \
            q, k_new, v_new, kc, vc, ksc, vsc, slot_ids, starts, n_valid, out, \
            B, Tc, KH, G, D, S, T, li, window, scale, softcap, cos_t, sin_t,   \
            rd);                                                               \
        return attn::attention<DT, ROT>(PREFILL, kind, a,                      \
                                        (cudaStream_t)stream);                 \
    }
