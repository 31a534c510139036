// Fused dequantize + matmul for the natural-layout quantized weights of
// tpu_engine_torch/model/weights.py:  y[M, N] = x[M, K] @ W[N, K]^T.
//
// qmm_nib4 (4-bit packed planes: Q4_K, Q4_0, Q4_1 at group 32, Q2_K at
// group 16) replaces the TPU kernel tpu_engine/kernels/dequant_matmul.py
// _nib4_kernel, and with it the measurement variants
// scripts/qmm_variants.py _v2_kernel (the bias folded in as a group-sum
// product) and _v3_kernel (a nibble turned into bf16 by a magic number).
// It computes the TPU kernel's function, on the tensor cores:
//   y[m, n] = sum_k xb[m, k] * bf16(q[n, k] * scale[n, k / G])   (f32 sums)
//           + sum_g xsum[m, g] * bias[n, g]                      (bias only)
// with xb = bf16(x) and xsum[m, g] = the f32 sum of xb over group g, both
// made by the wrapper (kernels/dequant_matmul.py), as the JAX wrapper
// makes them. The bias product takes the bf16x3 split of the TPU
// kernel's _bias_dot (xsum hi/lo x bias hi/lo, three products), exact to
// about 2^-17 of each term.
//
// qmm_i8 (int8 planes: Q8_0, Q6_K, Q5_0, Q5_1, Q5_K, Q3_K) replaces
// :_i8_kernel and still multiplies in f32 on the CUDA cores.
//
// What bounds qmm_nib4 on the H100: at decode (M <= 8) the bytes of the
// weights (0.5 B of nibbles plus 0.25 B of f32 scale and bias per weight)
// against 3.35 TB/s; at prefill (M = slots x bucket, up to thousands) the
// bf16 tensor-core operations, 2 M N K against 989 TFLOP/s.
// What the design does about it: a block owns BN weight rows and BM x rows
// and walks K in KC-wide chunks. Each chunk's packed nibbles, f32 scales,
// bf16 x and, with a bias, the chunk's bias and xsum columns are copied
// into shared memory by cp.async (16-byte pieces; 4-byte ones for the
// per-group values), NST - 1 chunks ahead of the one in use, so nothing
// the block reads waits on device memory once the pipe is full. The chunk
// is dequantized shared memory to shared memory, four bytes (eight
// weights) at a time: (v >> 4i & 0x000F000F) | 0x43004300 read as two
// bf16 is 128 + q for two nibbles; widened to f32, one fma with the
// group's f32 scale and -128 scale gives q * scale rounded once, then
// bf16. The products run as bf16 nvcuda::wmma fragments with f32
// accumulators, A and B swapped: weight rows are the fragment's M
// dimension and x rows its N. The bias and xsum columns are split hi | lo
// into a slab as they arrive; each full 16 groups take three more
// fragment products into the same accumulators. At decode (M <= 8) the
// m32n8k16 shape takes the eight x rows with no padding; a 32-row tile
// gives N/32 blocks, and its eight warps split each chunk's K, reducing in
// shared memory in a fixed order: a run gives the same bits every time.
// Every ragged M and N edge is masked; K % 32 == 0 is the one
// requirement. Later work: wgmma with TMA and warp specialisation at
// prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------- qmm_i8 (f32)
template <int TM, int TN, int RM, int RN, int KC>
__global__ void __launch_bounds__((TM / RM) * (TN / RN))
qmm_i8_kernel(const float* __restrict__ x, const int8_t* __restrict__ qs,
              const float* __restrict__ scale, const float* __restrict__ bias,
              float* __restrict__ y, int M, int N, int K, int lg)
{
    constexpr int NT = (TM / RM) * (TN / RN);
    constexpr int EPV = 16;        // int8 elements in one 16-byte vector
    constexpr int VPR = KC / EPV;  // qs vectors per weight-tile row
    static_assert(KC % EPV == 0 && KC % 4 == 0, "tile shape");
    __shared__ float xs[TM][KC + 1];
    __shared__ float ws[TN][KC + 1];

    const int tid = threadIdx.x;
    const int n0 = blockIdx.x * TN;
    const int m0 = blockIdx.y * TM;
    const int tx = tid % (TN / RN);
    const int ty = tid / (TN / RN);
    const int ng = K >> lg;  // groups per row

    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; i++)
#pragma unroll
        for (int j = 0; j < RN; j++) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += KC) {
        // activation chunk [TM, KC]
        for (int v = tid; v < TM * (KC / 4); v += NT) {
            const int r = v / (KC / 4), c = (v % (KC / 4)) * 4;
            const int m = m0 + r, k = k0 + c;
            float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
            if (m < M && k < K)
                val = *reinterpret_cast<const float4*>(x + (size_t)m * K + k);
            xs[r][c] = val.x;
            xs[r][c + 1] = val.y;
            xs[r][c + 2] = val.z;
            xs[r][c + 3] = val.w;
        }
        // weight chunk [TN, KC]: one 16-byte qs vector per step, dequantized
        for (int v = tid; v < TN * VPR; v += NT) {
            const int r = v / VPR, c = (v % VPR) * EPV;
            const int n = n0 + r, k = k0 + c;
            float* dst = &ws[r][c];
            if (n < N && k < K) {
                const uint4 raw = *reinterpret_cast<const uint4*>(
                    qs + (size_t)n * K + k);
                const uint32_t wv[4] = {raw.x, raw.y, raw.z, raw.w};
                // a vector spans at most two groups (EPV <= 2 * group)
                const int g0 = k >> lg, g1 = (k + EPV - 1) >> lg;
                const float* sc = scale + (size_t)n * ng;
                const float s0 = sc[g0], s1 = sc[g1];
                float b0 = 0.f, b1 = 0.f;
                if (bias != nullptr) {
                    b0 = bias[(size_t)n * ng + g0];
                    b1 = bias[(size_t)n * ng + g1];
                }
#pragma unroll
                for (int e = 0; e < EPV; e++) {
                    // byte e of the vector, from registers (constant indices)
                    const uint32_t byte = (wv[e >> 2] >> (8 * (e & 3))) & 0xFFu;
                    const float q = (float)(int8_t)byte;
                    const bool first = ((k + e) >> lg) == g0;
                    dst[e] = fmaf(q, first ? s0 : s1, first ? b0 : b1);
                }
            } else {
#pragma unroll
                for (int e = 0; e < EPV; e++) dst[e] = 0.f;
            }
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < KC; kk++) {
            float a[RM], w[RN];
#pragma unroll
            for (int i = 0; i < RM; i++) a[i] = xs[ty + i * (TM / RM)][kk];
#pragma unroll
            for (int j = 0; j < RN; j++) w[j] = ws[tx + j * (TN / RN)][kk];
#pragma unroll
            for (int i = 0; i < RM; i++)
#pragma unroll
                for (int j = 0; j < RN; j++) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RM; i++) {
        const int m = m0 + ty + i * (TM / RM);
#pragma unroll
        for (int j = 0; j < RN; j++) {
            const int n = n0 + tx + j * (TN / RN);
            if (m < M && n < N) y[(size_t)m * N + n] = acc[i][j];
        }
    }
}

int launch_i8(const float* x, const int8_t* qs, const float* scale,
              const float* bias, float* y, int M, int N, int K, int lg,
              cudaStream_t stream)
{
    if (M <= 8) {
        // decode: all rows in one tile, every weight byte read once
        dim3 grid((N + 31) / 32, 1);
        qmm_i8_kernel<8, 32, 1, 1, 256><<<grid, 256, 0, stream>>>(
            x, qs, scale, bias, y, M, N, K, lg);
    } else if (M <= 64) {
        dim3 grid((N + 63) / 64, (M + 63) / 64);
        qmm_i8_kernel<64, 64, 4, 4, 32><<<grid, 256, 0, stream>>>(
            x, qs, scale, bias, y, M, N, K, lg);
    } else {
        dim3 grid((N + 127) / 128, (M + 127) / 128);
        qmm_i8_kernel<128, 128, 8, 8, 32><<<grid, 256, 0, stream>>>(
            x, qs, scale, bias, y, M, N, K, lg);
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------- qmm_nib4 (bf16 tensor cores)
using namespace nvcuda;

// One tile configuration: a block of BN weight rows x BM x rows; warps
// tile it as (BN / WN) x (BM / WM) and split each KC-wide chunk's K
// KSPLIT ways; NST shared-memory stages; FM x FN x 16 wmma fragments
// (FM weight rows, FN x rows); at least MINB blocks per SM.
template <int BN_, int BM_, int WN_, int WM_, int KSPLIT_, int KC_, int NST_,
          int FM_, int FN_, int MINB_>
struct Cfg {
    static constexpr int BN = BN_, BM = BM_, WN = WN_, WM = WM_;
    static constexpr int KSPLIT = KSPLIT_, KC = KC_, NST = NST_;
    static constexpr int FM = FM_, FN = FN_, MINB = MINB_;
    static constexpr int NWN = BN / WN, NWM = BM / WM;
    static constexpr int NT = NWN * NWM * KSPLIT * 32;  // threads
    static constexpr int FI = WN / FM, FJ = WM / FN;    // fragments per warp
    static constexpr int KW = KC / KSPLIT;  // K of a chunk per warp
    static constexpr int LDW = KC + 8;      // bf16 row stride: weight tile, x
    static constexpr int GPC = KC / 16;     // group slots per row and chunk
    static constexpr int SW = GPC > 16 ? GPC : 16;  // bias slab columns
    static constexpr int LDB = SW + 8;      // bf16 row stride: bias slab
    static constexpr int LDO = BN + 4;      // f32 row stride: output
    // a stage: nibbles [BN][KC/2], scales [BN][GPC] f32, bias and xsum
    // [BN + BM][GPC] f32, x [BM][LDW] bf16
    static constexpr int SC_OFF = BN * KC / 2;
    static constexpr int BX_OFF = SC_OFF + BN * GPC * 4;
    static constexpr int X_OFF = BX_OFF + (BN + BM) * GPC * 4;
    static constexpr int STAGE = X_OFF + BM * LDW * 2;
    // after the stages: the weight tile [BN][LDW] bf16, then the bias slab
    // [hi | lo][BN + BM][LDB] bf16 (bias rows, then xsum rows)
    static constexpr int WT = NST * STAGE;
    static constexpr int BS = WT + BN * LDW * 2;
    static constexpr int SL = (BN + BM) * LDB;  // bf16 of one half of the slab
    static constexpr int PIPE = BS + 2 * SL * 2;
    static constexpr int OUT = KSPLIT * BM * LDO * 4;
    static constexpr int SMEM = PIPE > OUT ? PIPE : OUT;
    static_assert(KC % 64 == 0 && KW % 16 == 0 && WN % FM == 0 &&
                  WM % FN == 0 && BN % WN == 0 && BM % WM == 0, "tile shape");
    static_assert((BN * KC / 32) % NT == 0 && (BM * KC / 8) % NT == 0 &&
                  (BN * GPC) % NT == 0 && (BN * KC / 8) % NT == 0 &&
                  ((BN + BM) * GPC) % NT == 0, "work per thread");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(ok ? 16 : 0));  // 0: zero-fill
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// Eight weights from the four packed bytes v (byte j: element 2j in the
// low nibble, 2j + 1 in the high one), times the group scale s, as bf16
// in element order.
__device__ __forceinline__ uint4 dequant8(uint32_t v, float s)
{
    const float c = -128.f * s;
    float e[8];
#pragma unroll
    for (int i = 0; i < 4; i++) {
        // t's low half is element i (bits 4i.., of byte 0 or 1), its high
        // half element i + 4 (byte 2 or 3), each 128 + q as bf16
        const uint32_t t = ((v >> (4 * i)) & 0x000F000Fu) | 0x43004300u;
        e[i] = fmaf(__uint_as_float(t << 16), s, c);
        e[i + 4] = fmaf(__uint_as_float(t & 0xFFFF0000u), s, c);
    }
    return make_uint4(pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3]),
                      pack_bf16(e[4], e[5]), pack_bf16(e[6], e[7]));
}

template <class C>
__global__ void __launch_bounds__(C::NT, C::MINB)
qmm_nib4_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ xsum, const uint8_t* __restrict__ qs,
                const float* __restrict__ scale, const float* __restrict__ bias,
                float* __restrict__ y, int M, int N, int K, int lg)
{
    using FragA = wmma::fragment<wmma::matrix_a, C::FM, C::FN, 16,
                                 __nv_bfloat16, wmma::row_major>;
    using FragB = wmma::fragment<wmma::matrix_b, C::FM, C::FN, 16,
                                 __nv_bfloat16, wmma::col_major>;
    using FragC = wmma::fragment<wmma::accumulator, C::FM, C::FN, 16, float>;
    constexpr int NT = C::NT, BR = C::BN + C::BM;
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* wt = (__nv_bfloat16*)(smem + C::WT);  // [BN][LDW]
    __nv_bfloat16* slab = (__nv_bfloat16*)(smem + C::BS);

    const int tid = threadIdx.x, warp = tid >> 5;
    const int wn = warp % C::NWN, wm = (warp / C::NWN) % C::NWM;
    const int ks = warp / (C::NWN * C::NWM);
    const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM;
    const int ng = K >> lg;  // groups per row
    const int gpc = C::KC >> lg;  // groups per chunk
    const int n_chunks = (K + C::KC - 1) / C::KC;

    // copies of chunk c into stage c % NST
    auto load_chunk = [&](int c) {
        unsigned char* st = smem + (c % C::NST) * C::STAGE;
        const int k0 = c * C::KC, g0 = k0 >> lg;
        constexpr int QP = C::KC / 32;  // 16-byte pieces of a nibble row
#pragma unroll
        for (int j = 0; j < C::BN * QP / NT; j++) {
            const int i = tid + j * NT;
            const int r = i / QP, k = k0 + (i % QP) * 32, n = n0 + r;
            const bool ok = n < N && k < K;
            cp_async16(st + r * (C::KC / 2) + (i % QP) * 16,
                       ok ? qs + (size_t)n * (K / 2) + k / 2 : qs, ok);
        }
        float* sc = (float*)(st + C::SC_OFF);
#pragma unroll
        for (int j = 0; j < C::BN * C::GPC / NT; j++) {
            const int i = tid + j * NT;
            const int r = i / C::GPC, jg = i % C::GPC, n = n0 + r;
            const bool ok = n < N && g0 + jg < ng;
            if (jg < gpc)
                cp_async4(sc + i, ok ? scale + (size_t)n * ng + g0 + jg : scale, ok);
        }
        if (bias != nullptr) {  // bias rows, then xsum rows: [BN + BM][GPC]
            float* bx = (float*)(st + C::BX_OFF);
#pragma unroll
            for (int j = 0; j < BR * C::GPC / NT; j++) {
                const int i = tid + j * NT;
                const int r = i / C::GPC, jg = i % C::GPC, g = g0 + jg;
                const bool w_row = r < C::BN;
                const int row = w_row ? n0 + r : m0 + r - C::BN;
                const bool ok = (w_row ? row < N : row < M) && g < ng;
                const float* src = w_row ? bias + (size_t)row * ng + g
                                         : xsum + (size_t)row * ng + g;
                if (jg < gpc) cp_async4(bx + i, ok ? src : bias, ok);
            }
        }
        __nv_bfloat16* xs = (__nv_bfloat16*)(st + C::X_OFF);
        constexpr int XP = C::KC / 8;   // 16-byte pieces of an x row
#pragma unroll
        for (int j = 0; j < C::BM * XP / NT; j++) {
            const int i = tid + j * NT;
            const int r = i / XP, k = k0 + (i % XP) * 8, m = m0 + r;
            const bool ok = m < M && k < K;
            cp_async16(xs + r * C::LDW + (i % XP) * 8,
                       ok ? x + (size_t)m * K + k : x, ok);
        }
    };

    for (int c = 0; c < C::NST - 1; c++) {
        if (c < n_chunks) load_chunk(c);
        cp_async_commit();
    }

    FragC acc[C::FI][C::FJ];
#pragma unroll
    for (int i = 0; i < C::FI; i++)
#pragma unroll
        for (int j = 0; j < C::FJ; j++) wmma::fill_fragment(acc[i][j], 0.f);

    for (int c = 0; c < n_chunks; c++) {
        cp_async_wait<C::NST - 2>();  // chunk c has landed (this thread's part)
        __syncthreads();  // ... everyone's; and iteration c - 1 is done
        if (c + C::NST - 1 < n_chunks) load_chunk(c + C::NST - 1);
        cp_async_commit();
        const unsigned char* st = smem + (c % C::NST) * C::STAGE;
        const float* sc = (const float*)(st + C::SC_OFF);
        constexpr int WPR = C::KC / 8;  // 4-byte words of a nibble row
        constexpr int PER = C::BN * WPR / NT;
        uint32_t v[PER];  // all loads first: stores to wt may alias them
        float s[PER];
#pragma unroll
        for (int j = 0; j < PER; j++) {
            const int i = tid + j * NT;
            const int r = i / WPR, w = i % WPR;
            v[j] = *(const uint32_t*)(st + r * (C::KC / 2) + w * 4);
            s[j] = sc[r * C::GPC + ((w * 8) >> lg)];
        }
#pragma unroll
        for (int j = 0; j < PER; j++) {
            const int i = tid + j * NT;
            *(uint4*)(wt + (i / WPR) * C::LDW + (i % WPR) * 8) = dequant8(v[j], s[j]);
        }
        // the bias product's operands, split hi | lo into the slab at
        // column g % SW; a 16-group step goes to the tensor cores once its
        // last group is in (or at the last chunk, the rest of it zero)
        const int g_lo = c * gpc, g_hi = g_lo + gpc;  // this chunk's groups
        const bool fire = bias != nullptr && (g_hi % 16 == 0 || c == n_chunks - 1);
        if (bias != nullptr) {
            const float* bx = (const float*)(st + C::BX_OFF);
            constexpr int PB = BR * C::GPC / NT;
            float bv[PB];
#pragma unroll
            for (int j = 0; j < PB; j++) bv[j] = bx[tid + j * NT];
#pragma unroll
            for (int j = 0; j < PB; j++) {
                const int i = tid + j * NT;
                const int r = i / C::GPC, jg = i % C::GPC;
                if (jg < gpc) {
                    const __nv_bfloat16 hi = __float2bfloat16_rn(bv[j]);
                    __nv_bfloat16* d = slab + r * C::LDB + (g_lo + jg) % C::SW;
                    d[0] = hi;
                    d[C::SL] = __float2bfloat16_rn(bv[j] - __bfloat162float(hi));
                }
            }
            // a step that the last chunk leaves short: zero its tail
            const int tail = g_hi % 16;
            if (c == n_chunks - 1 && tail != 0) {
                const int col0 = g_hi % C::SW;
                for (int i = tid; i < 2 * BR * (16 - tail); i += NT) {
                    const int h = i / (BR * (16 - tail)), rem = i % (BR * (16 - tail));
                    slab[h * C::SL + (rem / (16 - tail)) * C::LDB + col0 +
                         rem % (16 - tail)] = __float2bfloat16_rn(0.f);
                }
            }
        }
        __syncthreads();
        const __nv_bfloat16* xs = (const __nv_bfloat16*)(st + C::X_OFF);
#pragma unroll
        for (int kk = 0; kk < C::KW; kk += 16) {
            const int k = ks * C::KW + kk;
            FragA a[C::FI];
#pragma unroll
            for (int i = 0; i < C::FI; i++)
                wmma::load_matrix_sync(
                    a[i], wt + (wn * C::WN + i * C::FM) * C::LDW + k, C::LDW);
#pragma unroll
            for (int j = 0; j < C::FJ; j++) {
                FragB b;
                wmma::load_matrix_sync(
                    b, xs + (wm * C::WM + j * C::FN) * C::LDW + k, C::LDW);
#pragma unroll
                for (int i = 0; i < C::FI; i++)
                    wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
            }
        }
        if (fire) {
            // steps ending in this chunk: groups [q0 * 16, q1 * 16)
            const int q0 = g_lo / 16, q1 = (g_hi + 15) / 16;
            for (int q = q0; q < q1; q++) {
                if (q % C::KSPLIT != ks) continue;  // one warp of a tile a step
                const __nv_bfloat16* hi = slab + (q * 16) % C::SW;
                const __nv_bfloat16* lo = hi + C::SL;
                FragA a_hi[C::FI], a_lo[C::FI];
#pragma unroll
                for (int i = 0; i < C::FI; i++) {
                    const int r = wn * C::WN + i * C::FM;
                    wmma::load_matrix_sync(a_hi[i], hi + r * C::LDB, C::LDB);
                    wmma::load_matrix_sync(a_lo[i], lo + r * C::LDB, C::LDB);
                }
#pragma unroll
                for (int j = 0; j < C::FJ; j++) {
                    const int r = C::BN + wm * C::WM + j * C::FN;
                    FragB b_hi, b_lo;
                    wmma::load_matrix_sync(b_hi, hi + r * C::LDB, C::LDB);
                    wmma::load_matrix_sync(b_lo, lo + r * C::LDB, C::LDB);
#pragma unroll
                    for (int i = 0; i < C::FI; i++) {
                        wmma::mma_sync(acc[i][j], a_hi[i], b_hi, acc[i][j]);
                        wmma::mma_sync(acc[i][j], a_hi[i], b_lo, acc[i][j]);
                        wmma::mma_sync(acc[i][j], a_lo[i], b_hi, acc[i][j]);
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();
    // out [KSPLIT][BM][LDO]: fragment (weight row i, x row j) at [j][i]
    float* out = (float*)smem + ks * C::BM * C::LDO;
#pragma unroll
    for (int i = 0; i < C::FI; i++)
#pragma unroll
        for (int j = 0; j < C::FJ; j++)
            wmma::store_matrix_sync(
                out + (wm * C::WM + j * C::FN) * C::LDO + wn * C::WN + i * C::FM,
                acc[i][j], C::LDO, wmma::mem_col_major);
    __syncthreads();
    for (int i = tid; i < C::BM * C::BN; i += NT) {
        const int m = i / C::BN, n = i % C::BN;
        float v = 0.f;
#pragma unroll
        for (int s = 0; s < C::KSPLIT; s++)
            v += ((const float*)smem)[(s * C::BM + m) * C::LDO + n];
        if (m0 + m < M && n0 + n < N) y[(size_t)(m0 + m) * N + n0 + n] = v;
    }
}

// decode (M <= 8): 32 weight rows at m32n8k16, 8 warps splitting each
// 1024-wide chunk (512-byte runs of each weight row), two stages
using DecCfg = Cfg<32, 8, 32, 8, 8, 1024, 2, 32, 8, 1>;
// M 9..64 (a slot's prefill bucket): 32 x 32 tiles, K split 4 ways
using MidCfg = Cfg<32, 32, 32, 32, 4, 256, 3, 16, 16, 2>;
// M > 64: 128 x 128 tiles, 8 warps of 64 x 32, 128-wide chunks
using PreCfg = Cfg<128, 128, 64, 32, 1, 128, 2, 16, 16, 1>;

template <class C>
int launch_nib4_cfg(const __nv_bfloat16* x, const float* xsum,
                    const uint8_t* qs, const float* scale, const float* bias,
                    float* y, int M, int N, int K, int lg, cudaStream_t stream)
{
    auto kern = qmm_nib4_kernel<C>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
    kern<<<grid, C::NT, C::SMEM, stream>>>(x, xsum, qs, scale, bias, y, M, N,
                                           K, lg);
    return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [M, K]; xsum f32 [M, K / group] (read only with a bias); qs
// uint8 [N, K / 2]; scale, bias f32 [N, K / group] (bias may be null);
// y f32 [M, N]. x and qs 16-byte aligned, K % 32 == 0, group 16 or 32.
extern "C" int qmm_nib4(const void* x, const void* xsum, const void* qs,
                        const void* scale, const void* bias, void* y, int M,
                        int N, int K, int group, void* stream)
{
    if (K % 32 || (group != 16 && group != 32) || (bias && !xsum))
        return (int)cudaErrorInvalidValue;
    const int lg = group == 16 ? 4 : 5;
    const auto xb = (const __nv_bfloat16*)x;
    const auto q = (const uint8_t*)qs;
    const auto st = (cudaStream_t)stream;
    if (M <= 8)
        return launch_nib4_cfg<DecCfg>(xb, (const float*)xsum, q, (const float*)scale,
                                       (const float*)bias, (float*)y, M, N, K, lg, st);
    if (M <= 64)
        return launch_nib4_cfg<MidCfg>(xb, (const float*)xsum, q, (const float*)scale,
                                       (const float*)bias, (float*)y, M, N, K, lg, st);
    return launch_nib4_cfg<PreCfg>(xb, (const float*)xsum, q, (const float*)scale,
                                   (const float*)bias, (float*)y, M, N, K, lg, st);
}

// x f32 [M, K]; qs int8 [N, K]; scale, bias f32 [N, K / group] (bias may
// be null); y f32 [M, N].
extern "C" int qmm_i8(const void* x, const void* qs, const void* scale,
                      const void* bias, void* y, int M, int N, int K,
                      int group, void* stream)
{
    return launch_i8((const float*)x, (const int8_t*)qs, (const float*)scale,
                     (const float*)bias, (float*)y, M, N, K,
                     group == 16 ? 4 : 5, (cudaStream_t)stream);
}
