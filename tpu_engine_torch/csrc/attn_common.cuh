// Flash attention over the slot-paged KV cache with K stored pre-rotated,
// for the deferred-append forward step of tpu_engine_torch/model/llama.py:
// the cache holds only the history (cells < start[b]); the step's own K/V
// rows arrive in flight and fold into the same online softmax.
//
// One set of kernels serves both storage layouts and all four kinds; a
// cell loader templated on (kind, layout) turns a stored cell into f32:
//   "td" planes [L, S, KH, T, Dk], "dt" planes [L, S, KH, Dk, T];
//   f32 cells; bf16 cells ("f16"); int8 cells x scale (q8_0); uint8 cells
//   [.., D/2] packed split-half (byte j: element j in the low nibble,
//   element j + D/2 in the high one, each + 8) x scale (q4_0); scale
//   planes [L, S, KH, T] f32, one per (token, kv head), in both layouts.
// attn.cu instantiates the "td" entry points, attn_dt.cu the "dt" ones.
//
// What bounds them on the H100: decode reads every live cache cell of the
// slot once (start * Dk stored bytes of K and of V per kv head, plus 4 B
// of scale each when quantized) against 3.35 TB/s; prefill over a long
// chunk is bound by the score and PV multiply-adds (4 * rows * cells * D
// per kv head) against the f32 rate.
// What the simple design does about it: one block per (row b, kv head)
// (decode) or (row b, kv head, block of query positions) (prefill) reads
// its cells straight from cache[li, slot_ids[b]] (no gather copy), 32 at a
// time into shared memory as f32 (dequantized on the way), so the G query
// heads of the kv head share each load. Under "td" neighbouring threads
// load neighbouring d of one cell; under "dt" neighbouring cells of one d,
// so both read memory in order. The loop stops at the row's fill (work
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
constexpr int MAXD = 128;  // head_dim limit (one PV thread per dimension)
constexpr int DEC_MAXG = 8;
constexpr int PRE_MAXR = 64;

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

// Fill the tile Ks/Vs [TB][lds] with virtual cells p = t0 .. t0 + TB - 1:
// cache cells below start, in-flight rows (k_new/v_new at new_base +
// (p - start) * D) below p_end, zeros beyond.
template <int KIND, bool DT>
__device__ __forceinline__ void load_tile(float* Ks, float* Vs, int lds,
                                          const Args& a, size_t cbase,
                                          size_t sbase, size_t new_base,
                                          int t0, int start, int p_end)
{
    const int D = a.D;
    for (int i = threadIdx.x; i < TB * D; i += NTH) {
        // "dt": lanes along cells (contiguous in memory); "td": along d
        const int t = DT ? i % TB : i / D;
        const int d = DT ? i / TB : i % D;
        const int p = t0 + t;
        float kv = 0.f, vv = 0.f;
        if (p < start) {
            kv = cell_at<KIND, DT>(a.kc, a.ksc, cbase, sbase, p, d, a.T, D);
            vv = cell_at<KIND, DT>(a.vc, a.vsc, cbase, sbase, p, d, a.T, D);
        } else if (p < p_end) {
            const size_t off = new_base + (size_t)(p - start) * D + d;
            kv = a.k_new[off];
            vv = a.v_new[off];
        }
        Ks[t * lds + d] = kv;
        Vs[t * lds + d] = vv;
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
template <int KIND, bool DT, int MAXG>
__global__ void __launch_bounds__(NTH) decode_kernel(const Args a)
{
    __shared__ float Ks[TB][MAXD + 1];
    __shared__ float Vs[TB][MAXD + 1];
    __shared__ float Qs[MAXG][MAXD];
    __shared__ float Ss[MAXG][TB];
    __shared__ float m_s[MAXG], l_s[MAXG], c_s[MAXG];

    const int KH = a.KH, G = a.G, D = a.D;
    const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
    const int tid = threadIdx.x;
    const int H = KH * G;
    const int start = a.starts[b];
    const int window = a.window;
    size_t cbase, sbase;
    plane_bases(a, KIND == Q4, b, kh, &cbase, &sbase);
    const size_t new_base = ((size_t)b * KH + kh) * D;

    for (int i = tid; i < G * D; i += NTH) {
        const int g = i / D, d = i % D;
        Qs[g][d] = a.q[((size_t)b * H + kh * G + g) * D + d];
    }
    if (tid < MAXG) {
        m_s[tid] = NEG_INF;
        l_s[tid] = 0.f;
    }
    float acc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; g++) acc[g] = 0.f;

    // the query sits at position `start`; cells below lo are outside the window
    int lo = window > 0 ? max(0, start - window + 1) : 0;
    lo = lo / TB * TB;
    for (int t0 = lo; t0 <= start; t0 += TB) {
        __syncthreads();
        load_tile<KIND, DT>(&Ks[0][0], &Vs[0][0], MAXD + 1, a, cbase, sbase,
                            new_base, t0, start, start + 1);
        __syncthreads();
        for (int i = tid; i < G * TB; i += NTH) {
            const int g = i / TB, t = i % TB, p = t0 + t;
            float s = 0.f;
#pragma unroll 8
            for (int d = 0; d < D; d++) s = fmaf(Qs[g][d], Ks[t][d], s);
            s = cap(s * a.scale, a.softcap);
            const bool ok = p <= start && (window <= 0 || p > start - window);
            Ss[g][t] = ok ? s : NEG_INF;
        }
        __syncthreads();
        softmax_tile(&Ss[0][0], TB, m_s, l_s, c_s, G);
        __syncthreads();
        if (tid < D) {
#pragma unroll
            for (int g = 0; g < MAXG; g++) {
                if (g < G) {
                    float acc_g = acc[g] * c_s[g];
                    for (int t = 0; t < TB; t++) acc_g = fmaf(Ss[g][t], Vs[t][tid], acc_g);
                    acc[g] = acc_g;
                }
            }
        }
    }
    __syncthreads();
    if (tid < D) {
#pragma unroll
        for (int g = 0; g < MAXG; g++)
            if (g < G)
                a.out[((size_t)b * H + kh * G + g) * D + tid] =
                    acc[g] / fmaxf(l_s[g], 1e-30f);
    }
}

// --------------------------------------------------------------- prefill
template <int KIND, bool DT, int MAXR>
__global__ void __launch_bounds__(NTH) prefill_kernel(const Args a, int QB)
{
    extern __shared__ float smem[];
    const int KH = a.KH, G = a.G, D = a.D, Tc = a.Tc;
    const int R = QB * G;  // query rows of this block: (position, head) pairs
    const int lds = D + 1;
    float* Qs = smem;                  // [R][D]
    float* Ks = Qs + R * D;            // [TB][D + 1]
    float* Vs = Ks + TB * lds;         // [TB][D + 1]
    float* Ss = Vs + TB * lds;         // [R][TB]
    float* m_s = Ss + R * TB;
    float* l_s = m_s + R;
    float* c_s = l_s + R;

    const int b = blockIdx.x / KH, kh = blockIdx.x % KH, qb = blockIdx.y;
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
        const int t = t_lo + r / G, g = r % G;
        Qs[i] = t < Tc ? a.q[(((size_t)b * Tc + t) * H + kh * G + g) * D + d] : 0.f;
    }
    for (int r = tid; r < R; r += NTH) {
        m_s[r] = NEG_INF;
        l_s[r] = 0.f;
    }
    float acc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; r++) acc[r] = 0.f;

    const int p_end = start + t_hi;  // virtual cells [lo, p_end)
    int lo = window > 0 ? max(0, start + t_lo - window + 1) : 0;
    lo = lo / TB * TB;
    const int lane = tid & 31, wq = tid >> 5;
    for (int t0 = lo; t0 < p_end; t0 += TB) {
        __syncthreads();
        load_tile<KIND, DT>(Ks, Vs, lds, a, cbase, sbase, new_base, t0, start,
                            p_end);
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
                    const int pos = start + t_lo + r / G;
                    const bool ok = p <= pos && (p < start || p - start < nv)
                                    && (window <= 0 || p > pos - window);
                    Ss[r * TB + lane] = ok ? cap(s[i] * a.scale, a.softcap) : NEG_INF;
                }
            }
        }
        __syncthreads();
        softmax_tile(Ss, TB, m_s, l_s, c_s, R);
        __syncthreads();
        if (tid < D) {
#pragma unroll
            for (int r = 0; r < MAXR; r++)
                if (r < R) acc[r] *= c_s[r];
            for (int t = 0; t < TB; t++) {
                const float v = Vs[t * lds + tid];
#pragma unroll
                for (int r = 0; r < MAXR; r++)
                    if (r < R) acc[r] = fmaf(Ss[r * TB + t], v, acc[r]);
            }
        }
    }
    __syncthreads();
    if (tid < D) {
#pragma unroll
        for (int r = 0; r < MAXR; r++) {
            const int t = t_lo + r / G;
            if (r < R && t < Tc)
                a.out[(((size_t)b * Tc + t) * H + kh * G + r % G) * D + tid] =
                    acc[r] / fmaxf(l_s[r], 1e-30f);
        }
    }
}

template <int KIND, bool DT>
int decode_launch(const Args& a, cudaStream_t stream)
{
    decode_kernel<KIND, DT, DEC_MAXG><<<a.B * a.KH, NTH, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int KIND, bool DT>
int prefill_launch(const Args& a, cudaStream_t stream)
{
    const int QB = PRE_MAXR / a.G > 0 ? PRE_MAXR / a.G : 1;
    const int R = QB * a.G;
    const int D = a.D;
    const size_t smem = sizeof(float) *
        ((size_t)R * D + 2 * TB * (D + 1) + (size_t)R * TB + 3 * R);
    auto kern = prefill_kernel<KIND, DT, PRE_MAXR>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(a.B * a.KH, (a.Tc + QB - 1) / QB);
    kern<<<grid, NTH, smem, stream>>>(a, QB);
    return (int)cudaGetLastError();
}

// The entry point of one layout: checks the limits, then dispatches on the
// cell kind (Kind).
template <bool DT>
int attention(int prefill, int kind, const Args& a, cudaStream_t stream)
{
    if (a.D > MAXD || (a.D % 2) || a.G < 1 ||
        a.G > (prefill ? PRE_MAXR : DEC_MAXG) || (!prefill && a.Tc != 1))
        return (int)cudaErrorInvalidValue;
    if ((kind == Q8 || kind == Q4) && (a.ksc == nullptr || a.vsc == nullptr))
        return (int)cudaErrorInvalidValue;
    switch (kind) {
    case F32:
        return prefill ? prefill_launch<F32, DT>(a, stream) : decode_launch<F32, DT>(a, stream);
    case BF16:
        return prefill ? prefill_launch<BF16, DT>(a, stream) : decode_launch<BF16, DT>(a, stream);
    case Q8:
        return prefill ? prefill_launch<Q8, DT>(a, stream) : decode_launch<Q8, DT>(a, stream);
    case Q4:
        return prefill ? prefill_launch<Q4, DT>(a, stream) : decode_launch<Q4, DT>(a, stream);
    }
    return (int)cudaErrorInvalidValue;
}

// Packs the C interface's operands (the same for all four entry points).
inline Args make_args(const void* q, const void* k_new, const void* v_new,
                      const void* kc, const void* vc, const void* ksc,
                      const void* vsc, const void* slot_ids, const void* starts,
                      const void* n_valid, void* out, int B, int Tc, int KH,
                      int G, int D, int S, int T, int li, int window,
                      float scale, float softcap)
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
    return a;
}

}  // namespace attn

// The C interface shared by attn.cu ("td") and attn_dt.cu ("dt"): kind is
// attn::Kind (0 f32, 1 bf16, 2 q8_0, 3 q4_0); ksc/vsc may be null for the
// float kinds; n_valid may be null for decode (Tc == 1).
#define ATTN_ENTRY(NAME, PREFILL, DT)                                          \
    extern "C" int NAME(const void* q, const void* k_new, const void* v_new,   \
                        const void* kc, const void* vc, const void* ksc,       \
                        const void* vsc, int kind, const void* slot_ids,       \
                        const void* starts, const void* n_valid, void* out,    \
                        int B, int Tc, int KH, int G, int D, int S, int T,     \
                        int li, int window, float scale, float softcap,        \
                        void* stream)                                          \
    {                                                                          \
        const attn::Args a = attn::make_args(                                  \
            q, k_new, v_new, kc, vc, ksc, vsc, slot_ids, starts, n_valid, out, \
            B, Tc, KH, G, D, S, T, li, window, scale, softcap);                \
        return attn::attention<DT>(PREFILL, kind, a, (cudaStream_t)stream);    \
    }
