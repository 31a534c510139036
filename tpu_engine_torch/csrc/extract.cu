// GGUF block bytes -> the natural-layout QTensor of
// tpu_engine_torch/model/weights.py, on the card, at model load.
//
// Replaces tpu_engine/native/convert.cc:312 te_extract_device (the JAX
// package's multithreaded host C++; not a Pallas kernel) without its
// group-transposed permutation, which only the TPU kernels read. For the
// ten formats of quant/device_format.py LAYOUTS it writes
//   qs    "nib4": uint8 [n, k/2], element 2j in the low nibble, 2j+1 high
//         "i8":   int8  [n, k]
//   scale f32 [n, k/G]
//   bias  f32 [n, k/G] (Q4_0, Q4_1, Q5_0 (zeros), Q5_1, Q2_K, Q4_K, Q5_K)
// bit for bit what the numpy to_device_format returns: every scale or bias
// is an f16 times an integer of at most 8 bits (or -8), one f32 product,
// exact, with the same sign of zero.
//
// What bounds it on the H100: bytes, the raw blocks read once and qs,
// scale and bias written once, against 3.35 TB/s; a few integer
// operations per element. It runs once per tensor per load, so the design
// is simple: rows do not matter (a row holds whole blocks, and rows are
// contiguous in the raw bytes and in every output), so the tensor is one
// flat run of elements. A thread makes one 16-byte word of qs (32 nibble
// elements or 16 int8 ones, always inside one block), decoding each
// element from its block's bytes (byte loads that the block's neighbours
// share through L1), and stores it in one vector store: neighbouring
// threads write neighbouring words. Then, in the same launch, a thread
// makes one group's scale (and bias). Grid-stride loops over both.
//
// The bit-unpacking follows convert.cc's extract_block and
// quant/formats.py (scale_min_k4, the Q3_K 12-byte scale unpack, the Q5
// high bits), element by element.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float f16_at(const uint8_t* p)
{
    return __half2float(__ushort_as_half(
        (unsigned short)(p[0] | (p[1] << 8))));
}

// ggml get_scale_min_k4: the j-th 6-bit (scale, min) of 12 packed bytes
__device__ __forceinline__ void scale_min_k4(int j, const uint8_t* q, int& d,
                                             int& m)
{
    if (j < 4) {
        d = q[j] & 63;
        m = q[j + 4] & 63;
    } else {
        d = (q[j + 4] & 0xF) | ((q[j - 4] >> 6) << 4);
        m = (q[j + 4] >> 4) | ((q[j] >> 6) << 4);
    }
}

// A format: BLK elements in BYTES bytes, groups of G elements, NIB
// (4-bit values on the card) and BIAS; q(b, e) is element e of block b in
// natural order, sb(b, j, s, m) group j's scale and bias.
struct Q4_0 {
    static constexpr int BLK = 32, BYTES = 18, G = 32;
    static constexpr bool NIB = true, BIAS = true;
    static __device__ int q(const uint8_t* b, int e)
    {
        return e < 16 ? b[2 + e] & 0xF : b[2 + e - 16] >> 4;
    }
    static __device__ void sb(const uint8_t* b, int, float& s, float& m)
    {
        s = f16_at(b);
        m = -8.0f * s;
    }
};

struct Q4_1 {
    static constexpr int BLK = 32, BYTES = 20, G = 32;
    static constexpr bool NIB = true, BIAS = true;
    static __device__ int q(const uint8_t* b, int e)
    {
        return e < 16 ? b[4 + e] & 0xF : b[4 + e - 16] >> 4;
    }
    static __device__ void sb(const uint8_t* b, int, float& s, float& m)
    {
        s = f16_at(b);
        m = f16_at(b + 2);
    }
};

// Q5_0 / Q5_1: the high bit of element e is bit e of the 32-bit qh
template <int QH, bool MIN>
struct Q5 {
    static constexpr int BLK = 32, BYTES = MIN ? 24 : 22, G = 32;
    static constexpr bool NIB = false, BIAS = true;
    static __device__ int q(const uint8_t* b, int e)
    {
        const uint8_t v = b[QH + 4 + (e & 15)];
        const int lo = e < 16 ? v & 0xF : v >> 4;
        const int hb = (b[QH + (e >> 3)] >> (e & 7)) & 1;
        return (lo | (hb << 4)) - (MIN ? 0 : 16);
    }
    static __device__ void sb(const uint8_t* b, int, float& s, float& m)
    {
        s = f16_at(b);
        m = MIN ? f16_at(b + 2) : 0.0f;
    }
};
using Q5_0 = Q5<2, false>;
using Q5_1 = Q5<4, true>;

struct Q8_0 {
    static constexpr int BLK = 32, BYTES = 34, G = 32;
    static constexpr bool NIB = false, BIAS = false;
    static __device__ int q(const uint8_t* b, int e) { return (int8_t)b[2 + e]; }
    static __device__ void sb(const uint8_t* b, int, float& s, float&)
    {
        s = f16_at(b);
    }
};

struct Q2_K {
    static constexpr int BLK = 256, BYTES = 84, G = 16;
    static constexpr bool NIB = true, BIAS = true;
    static __device__ int q(const uint8_t* b, int e)
    {
        const int h = e >> 7, j = (e >> 5) & 3, l = e & 31;
        return (b[16 + 32 * h + l] >> (2 * j)) & 3;
    }
    static __device__ void sb(const uint8_t* b, int j, float& s, float& m)
    {
        s = f16_at(b + 80) * (float)(b[j] & 0xF);
        m = -f16_at(b + 82) * (float)(b[j] >> 4);
    }
};

struct Q3_K {
    static constexpr int BLK = 256, BYTES = 110, G = 16;
    static constexpr bool NIB = false, BIAS = false;
    static __device__ int q(const uint8_t* b, int e)
    {
        const int h = e >> 7, j = (e >> 5) & 3, l = e & 31;
        const int v = (b[32 + 32 * h + l] >> (2 * j)) & 3;
        return ((b[l] >> (4 * h + j)) & 1) ? v : v - 4;
    }
    static __device__ void sb(const uint8_t* b, int j, float& s, float&)
    {
        const uint8_t* sc = b + 96;
        const int lo4 = j < 8 ? sc[j] & 0xF : sc[j - 8] >> 4;
        const int hi2 = (sc[8 + (j & 3)] >> (2 * (j >> 2))) & 3;
        s = f16_at(b + 108) * (float)((lo4 | (hi2 << 4)) - 32);
    }
};

struct Q4_K {
    static constexpr int BLK = 256, BYTES = 144, G = 32;
    static constexpr bool NIB = true, BIAS = true;
    static __device__ int q(const uint8_t* b, int e)
    {
        const int c = e >> 6, r = e & 63;
        const uint8_t v = b[16 + 32 * c + (r & 31)];
        return r < 32 ? v & 0xF : v >> 4;
    }
    static __device__ void sb(const uint8_t* b, int j, float& s, float& m)
    {
        int sc, mn;
        scale_min_k4(j, b + 4, sc, mn);
        s = f16_at(b) * (float)sc;
        m = -f16_at(b + 2) * (float)mn;
    }
};

struct Q5_K {
    static constexpr int BLK = 256, BYTES = 176, G = 32;
    static constexpr bool NIB = false, BIAS = true;
    static __device__ int q(const uint8_t* b, int e)
    {
        const int c = e >> 6, r = e & 63, l = r & 31;
        const uint8_t v = b[48 + 32 * c + l];
        const int lo = r < 32 ? v & 0xF : v >> 4;
        return lo + 16 * ((b[16 + l] >> (2 * c + (r >> 5))) & 1);
    }
    static __device__ void sb(const uint8_t* b, int j, float& s, float& m)
    {
        Q4_K::sb(b, j, s, m);
    }
};

struct Q6_K {
    static constexpr int BLK = 256, BYTES = 210, G = 16;
    static constexpr bool NIB = false, BIAS = false;
    static __device__ int q(const uint8_t* b, int e)
    {
        const int h = e >> 7, quarter = (e >> 5) & 3, l = e & 31;
        const uint8_t v = b[64 * h + 32 * (quarter & 1) + l];
        const int lo = quarter >= 2 ? v >> 4 : v & 0xF;
        const int hi = (b[128 + 32 * h + l] >> (2 * quarter)) & 3;
        return (lo | (hi << 4)) - 32;
    }
    static __device__ void sb(const uint8_t* b, int j, float& s, float&)
    {
        s = f16_at(b + 208) * (float)(int8_t)b[192 + j];
    }
};

constexpr int THREADS = 256;

// n_elems elements (a multiple of F::BLK) of raw blocks -> qs, scale, bias
template <class F>
__global__ void __launch_bounds__(THREADS)
extract_kernel(const uint8_t* __restrict__ raw, int64_t n_elems,
               uint4* __restrict__ qs, float* __restrict__ scale,
               float* __restrict__ bias)
{
    constexpr int EPW = F::NIB ? 32 : 16;  // elements a 16-byte word
    const int64_t stride = (int64_t)gridDim.x * THREADS;
    const int64_t first = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    const int64_t n_words = n_elems / EPW;
    for (int64_t w = first; w < n_words; w += stride) {
        const int64_t e0 = w * EPW;
        const uint8_t* b = raw + (e0 / F::BLK) * F::BYTES;
        const int e = (int)(e0 % F::BLK);
        uint32_t out[4];
#pragma unroll
        for (int i = 0; i < 4; i++) {
            uint32_t v = 0;
#pragma unroll
            for (int t = 0; t < 4; t++) {
                uint32_t byte;
                if (F::NIB) {
                    const int ee = e + 8 * i + 2 * t;
                    byte = (F::q(b, ee) & 0xF) | ((F::q(b, ee + 1) & 0xF) << 4);
                } else {
                    byte = (uint32_t)F::q(b, e + 4 * i + t) & 0xFF;
                }
                v |= byte << (8 * t);
            }
            out[i] = v;
        }
        qs[w] = make_uint4(out[0], out[1], out[2], out[3]);
    }
    constexpr int GPB = F::BLK / F::G;  // groups a block
    const int64_t n_groups = n_elems / F::G;
    for (int64_t gi = first; gi < n_groups; gi += stride) {
        float s, m = 0.0f;
        F::sb(raw + (gi / GPB) * F::BYTES, (int)(gi % GPB), s, m);
        scale[gi] = s;
        if (F::BIAS) bias[gi] = m;
    }
}

template <class F>
int launch(const uint8_t* raw, int64_t n_elems, void* qs, float* scale,
           float* bias, cudaStream_t stream)
{
    if (n_elems % F::BLK || (F::BIAS && bias == nullptr)) return 1;
    const int64_t words = n_elems / (F::NIB ? 32 : 16);
    int64_t blocks = (words + THREADS - 1) / THREADS;
    if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond
    if (blocks < 1) blocks = 1;
    extract_kernel<F><<<(unsigned)blocks, THREADS, 0, stream>>>(
        raw, n_elems, static_cast<uint4*>(qs), scale, bias);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// raw: n * k / BLK blocks of ggml type ggml_type (gguf/constants.py ids);
// qs 16-byte aligned; bias may be null for Q8_0, Q3_K, Q6_K. Returns 0 or
// a cudaError_t (1: a type, size or bias the kernel does not take).
int extract(int ggml_type, const void* raw, int64_t n, int64_t k, void* qs,
            float* scale, float* bias, void* stream)
{
    const uint8_t* r = static_cast<const uint8_t*>(raw);
    const int64_t ne = n * k;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (ggml_type) {
    case 2: return launch<Q4_0>(r, ne, qs, scale, bias, s);
    case 3: return launch<Q4_1>(r, ne, qs, scale, bias, s);
    case 6: return launch<Q5_0>(r, ne, qs, scale, bias, s);
    case 7: return launch<Q5_1>(r, ne, qs, scale, bias, s);
    case 8: return launch<Q8_0>(r, ne, qs, scale, bias, s);
    case 10: return launch<Q2_K>(r, ne, qs, scale, bias, s);
    case 11: return launch<Q3_K>(r, ne, qs, scale, bias, s);
    case 12: return launch<Q4_K>(r, ne, qs, scale, bias, s);
    case 13: return launch<Q5_K>(r, ne, qs, scale, bias, s);
    case 14: return launch<Q6_K>(r, ne, qs, scale, bias, s);
    default: return 1;
    }
}

}  // extern "C"
