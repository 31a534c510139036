// Fused dequantize + matmul for the natural-layout quantized weights of
// tpu_engine_torch/model/weights.py:  y[M, N] = x[M, K] @ W[N, K]^T.
//
// Two entry points, one kernel template with a weight-format parameter:
//   qmm_nib4 (4-bit packed planes: Q4_K, Q4_0, Q4_1 at group 32, Q2_K at
//   group 16) replaces the TPU kernel tpu_engine/kernels/dequant_matmul.py
//   _nib4_kernel, and with it the measurement variants
//   scripts/qmm_variants.py _v2_kernel (the bias folded in as a group-sum
//   product) and _v3_kernel (a nibble turned into bf16 by a magic number);
//   qmm_i8 (int8 planes: Q8_0, Q5_0, Q5_1, Q5_K at group 32, Q6_K, Q3_K at
//   group 16) replaces :_i8_kernel.
// Both compute their TPU kernel's function, on the tensor cores:
//   y[m, n] = sum_k xb[m, k] * bf16(q[n, k] * scale[n, k / G])   (f32 sums)
//           + sum_g xsum[m, g] * bias[n, g]                      (bias only)
// with xb = bf16(x) and xsum[m, g] = the f32 sum of xb over group g, both
// made by the wrapper (kernels/dequant_matmul.py), as the JAX wrapper
// makes them. q * scale is one f32 product of the exact integer, rounded
// once, then to bf16. The bias product takes the bf16x3 split of the TPU
// kernel's _bias_dot (xsum hi/lo x bias hi/lo, three products), exact to
// about 2^-17 of each term.
//
// What bounds them on the H100: at decode (M <= 8) the bytes of the
// weights (0.5 B of nibbles or 1 B of int8, plus 4 / G B of f32 scale and
// as much bias per weight) against 3.35 TB/s; at prefill (M = slots x
// bucket, up to thousands) the bf16 tensor-core operations, 2 M N K
// against 989 TFLOP/s.
// What the design does about it: a block owns BN weight rows and BM x rows
// and walks K in KC-wide chunks. Each chunk's weight bytes, f32 scales,
// bf16 x and, with a bias, the chunk's bias and xsum columns are copied
// into shared memory by cp.async (16-byte pieces; 4-byte ones for the
// per-group values), NST - 1 chunks ahead of the one in use, so nothing
// the block reads waits on device memory once the pipe is full. The chunk
// is dequantized shared memory to shared memory, eight weights at a time
// (Nib4::dequant8, I8::dequant8: an exact integer by a magic number, times
// the group's f32 scale, rounded once, then bf16). The products run as
// bf16 nvcuda::wmma fragments with f32 accumulators, A and B swapped:
// weight rows are the fragment's M dimension and x rows its N. The bias
// and xsum columns are split hi | lo into a slab as they arrive; each full
// 16 groups take three more fragment products into the same accumulators.
// At decode (M <= 8) the m32n8k16 shape takes the eight x rows with no
// padding; a 32-row tile gives N/32 blocks, and its eight warps split each
// chunk's K, reducing in shared memory in a fixed order: a run gives the
// same bits every time. Every ragged M and N edge is masked; K % 32 == 0
// is the one requirement. An i8 chunk holds twice a nib4 chunk's bytes, so
// each format has its own tile configurations (the Cfg lines below).
// At decode the time follows the weight count, not the bytes, and a bias
// adds about 40% (tools/qmm_ab.py --layouts): the per-weight work (the
// dequant, the bf16 tile's round trip through shared memory, the
// products), not the copies, holds it. Later work: that pass, and wgmma
// with TMA and warp specialisation at prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// A weight format: WPB weights a byte; Word holds eight weights, and
// dequant8 turns one into eight bf16 (element order) times the group's
// scale s.
struct Nib4 {
    static constexpr int WPB = 2;
    using Word = uint32_t;
    // byte j: element 2j in the low nibble, 2j + 1 in the high one
    static __device__ __forceinline__ uint4 dequant8(uint32_t v, float s)
    {
        const float c = -128.f * s;
        float e[8];
#pragma unroll
        for (int i = 0; i < 4; i++) {
            // t's low half is element i (bits 4i.., of byte 0 or 1), its
            // high half element i + 4 (byte 2 or 3), each 128 + q as bf16;
            // one fma with -128 s (exact) gives q * s rounded once
            const uint32_t t = ((v >> (4 * i)) & 0x000F000Fu) | 0x43004300u;
            e[i] = fmaf(__uint_as_float(t << 16), s, c);
            e[i + 4] = fmaf(__uint_as_float(t & 0xFFFF0000u), s, c);
        }
        return make_uint4(pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3]),
                          pack_bf16(e[4], e[5]), pack_bf16(e[6], e[7]));
    }
};

struct I8 {
    static constexpr int WPB = 1;
    using Word = uint2;
    // eight signed bytes. byte ^ 0x80 is 128 + q; placed under the f32
    // exponent of 2^23 it reads 2^23 + 128 + q, and subtracting 2^23 + 128
    // leaves q exactly (bf16's 7 mantissa bits cannot hold it). Then one
    // f32 multiply rounds q * s once; folding the subtraction into an fma
    // with -(2^23 + 128) s would not, since that product is not exact
    static __device__ __forceinline__ uint4 dequant8(uint2 v, float s)
    {
        const uint32_t w[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
        float e[8];
#pragma unroll
        for (int i = 0; i < 8; i++) {
            // result bytes: byte i % 4 of w, 0x00, 0x00, 0x4B
            const uint32_t t = __byte_perm(w[i >> 2], 0x4B000000u, 0x7440u | (i & 3));
            e[i] = __fmul_rn(__uint_as_float(t) - 8388736.f, s);
        }
        return make_uint4(pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3]),
                          pack_bf16(e[4], e[5]), pack_bf16(e[6], e[7]));
    }
};

// One tile configuration of one weight format F: a block of BN weight
// rows x BM x rows; warps tile it as (BN / WN) x (BM / WM) and split each
// KC-wide chunk's K KSPLIT ways; NST shared-memory stages; FM x FN x 16
// wmma fragments (FM weight rows, FN x rows); at least MINB blocks per SM.
template <class F_, int BN_, int BM_, int WN_, int WM_, int KSPLIT_, int KC_,
          int NST_, int FM_, int FN_, int MINB_>
struct Cfg {
    using F = F_;
    static constexpr int BN = BN_, BM = BM_, WN = WN_, WM = WM_;
    static constexpr int KSPLIT = KSPLIT_, KC = KC_, NST = NST_;
    static constexpr int FM = FM_, FN = FN_, MINB = MINB_;
    static constexpr int NWN = BN / WN, NWM = BM / WM;
    static constexpr int NT = NWN * NWM * KSPLIT * 32;  // threads
    static constexpr int FI = WN / FM, FJ = WM / FN;    // fragments per warp
    static constexpr int KW = KC / KSPLIT;  // K of a chunk per warp
    static constexpr int QROW = KC / F::WPB;  // weight bytes of a row's chunk
    static constexpr int LDW = KC + 8;      // bf16 row stride: weight tile, x
    static constexpr int GPC = KC / 16;     // group slots per row and chunk
    static constexpr int SW = GPC > 16 ? GPC : 16;  // bias slab columns
    static constexpr int LDB = SW + 8;      // bf16 row stride: bias slab
    static constexpr int LDO = BN + 4;      // f32 row stride: output
    // a stage: weight bytes [BN][QROW], scales [BN][GPC] f32, bias and xsum
    // [BN + BM][GPC] f32, x [BM][LDW] bf16
    static constexpr int SC_OFF = BN * QROW;
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
    static_assert((BN * QROW / 16) % NT == 0 && (BM * KC / 8) % NT == 0 &&
                  (BN * GPC) % NT == 0 && (BN * KC / 8) % NT == 0 &&
                  ((BN + BM) * GPC) % NT == 0, "work per thread");
    static_assert(X_OFF % 32 == 0 && STAGE % 32 == 0, "wmma alignment");
    static_assert(SMEM <= 232448 / MINB - 1024, "shared memory");
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

template <class C>
__global__ void __launch_bounds__(C::NT, C::MINB)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xsum,
           const uint8_t* __restrict__ qs, const float* __restrict__ scale,
           const float* __restrict__ bias, float* __restrict__ y, int M, int N,
           int K, int lg)
{
    using F = typename C::F;
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
        constexpr int QP = C::QROW / 16;  // 16-byte pieces of a row's chunk
        constexpr int PW = 16 * F::WPB;   // weights in a piece
#pragma unroll
        for (int j = 0; j < C::BN * QP / NT; j++) {
            const int i = tid + j * NT;
            const int r = i / QP, k = k0 + (i % QP) * PW, n = n0 + r;
            const bool ok = n < N && k < K;
            cp_async16(st + r * C::QROW + (i % QP) * 16,
                       ok ? qs + (size_t)n * (K / F::WPB) + k / F::WPB : qs, ok);
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
        using Word = typename F::Word;
        constexpr int WPR = C::KC / 8;  // eight-weight words of a row's chunk
        constexpr int PER = C::BN * WPR / NT;
        Word v[PER];  // all loads first: stores to wt may alias them
        float s[PER];
#pragma unroll
        for (int j = 0; j < PER; j++) {
            const int i = tid + j * NT;
            const int r = i / WPR, w = i % WPR;
            v[j] = *(const Word*)(st + r * C::QROW + w * (int)sizeof(Word));
            s[j] = sc[r * C::GPC + ((w * 8) >> lg)];
        }
#pragma unroll
        for (int j = 0; j < PER; j++) {
            const int i = tid + j * NT;
            *(uint4*)(wt + (i / WPR) * C::LDW + (i % WPR) * 8) = F::dequant8(v[j], s[j]);
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

// nib4. decode (M <= 8): 32 weight rows at m32n8k16, 8 warps splitting
// each 1024-wide chunk (512-byte runs of each weight row), two stages
using DecCfg = Cfg<Nib4, 32, 8, 32, 8, 8, 1024, 2, 32, 8, 1>;
// M 9..64 (a slot's prefill bucket): 32 x 32 tiles, K split 4 ways
using MidCfg = Cfg<Nib4, 32, 32, 32, 32, 4, 256, 3, 16, 16, 2>;
// M > 64: 128 x 128 tiles, 8 warps of 64 x 32, 128-wide chunks
using PreCfg = Cfg<Nib4, 128, 128, 64, 32, 1, 128, 2, 16, 16, 1>;
// i8 (a chunk twice the bytes). decode: nib4's tile with 512-wide chunks
// (512-byte runs), three stages (tools/qmm_ab.py: 1024-wide chunks, two
// blocks an SM or 16-row tiles were no faster on the Q6_K pair)
using DecCfgI8 = Cfg<I8, 32, 8, 32, 8, 8, 512, 3, 32, 8, 1>;
// M 9..64: nib4's, two stages (three would not fit two blocks an SM)
using MidCfgI8 = Cfg<I8, 32, 32, 32, 32, 4, 256, 2, 16, 16, 2>;
// M > 64: nib4's (182 KB)
using PreCfgI8 = Cfg<I8, 128, 128, 64, 32, 1, 128, 2, 16, 16, 1>;

template <class C>
int launch_cfg(const void* x, const void* xsum, const void* qs,
               const void* scale, const void* bias, void* y, int M, int N,
               int K, int lg, void* stream)
{
    auto kern = qmm_kernel<C>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
    kern<<<grid, C::NT, C::SMEM, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const float*)xsum, (const uint8_t*)qs,
        (const float*)scale, (const float*)bias, (float*)y, M, N, K, lg);
    return (int)cudaGetLastError();
}

template <class Dec, class Mid, class Pre>
int launch(const void* x, const void* xsum, const void* qs, const void* scale,
           const void* bias, void* y, int M, int N, int K, int group,
           void* stream)
{
    if (K % 32 || (group != 16 && group != 32) || (bias && !xsum))
        return (int)cudaErrorInvalidValue;
    const int lg = group == 16 ? 4 : 5;
    if (M <= 8)
        return launch_cfg<Dec>(x, xsum, qs, scale, bias, y, M, N, K, lg, stream);
    if (M <= 64)
        return launch_cfg<Mid>(x, xsum, qs, scale, bias, y, M, N, K, lg, stream);
    return launch_cfg<Pre>(x, xsum, qs, scale, bias, y, M, N, K, lg, stream);
}

}  // namespace

// x bf16 [M, K]; xsum f32 [M, K / group] (read only with a bias); qs
// uint8 [N, K / 2] (qmm_nib4) or int8 [N, K] (qmm_i8); scale, bias f32
// [N, K / group] (bias may be null); y f32 [M, N]. x and qs 16-byte
// aligned, K % 32 == 0, group 16 or 32.
extern "C" int qmm_nib4(const void* x, const void* xsum, const void* qs,
                        const void* scale, const void* bias, void* y, int M,
                        int N, int K, int group, void* stream)
{
    return launch<DecCfg, MidCfg, PreCfg>(x, xsum, qs, scale, bias, y, M, N,
                                          K, group, stream);
}

extern "C" int qmm_i8(const void* x, const void* xsum, const void* qs,
                      const void* scale, const void* bias, void* y, int M,
                      int N, int K, int group, void* stream)
{
    return launch<DecCfgI8, MidCfgI8, PreCfgI8>(x, xsum, qs, scale, bias, y, M,
                                                N, K, group, stream);
}
