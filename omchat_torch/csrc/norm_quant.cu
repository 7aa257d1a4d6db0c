// RMSNorm + per-row int8 quantization (K7) and residual + LayerScale +
// RMSNorm + per-row int8 quantization (K8): the w8a8 glue passes.
//
// Replaces the TPU kernels omchat_tpu/ops/norms.py:98 rmsnorm_quant (body
// _rmsnorm_quant_kernel :86, pallas_call :124) and norms.py:148
// add_rmsnorm_quant (body _add_rmsnorm_quant_kernel :57, pallas_call :181).
//
//   K7: x [rows, D] bf16, gamma [D] bf16 -> codes [rows, D] int8, row_scale [rows] fp32
//   K8: x, delta [rows, D] bf16, ls [D] bf16 (nullptr: 1), gamma [D] bf16
//       -> x_new = bf16(x + delta * ls) [rows, D], codes, row_scale
//
// Arithmetic, as in the Pallas bodies (fp32): n = (x * r) * gamma with
// r = 1 / sqrt(mean(x^2) + eps); scale = max(max|n|, 1e-6) / 127; codes =
// clip(rint(n / scale), -127, 127).  The fp32 n is quantized directly (no
// bf16 rounding of the norm output).  The products and sums that must round
// as in the reference are written with __fmul_rn / __fadd_rn, so the
// compiler does not contract them into fused multiply-adds; the division and
// sqrt are IEEE (no --use_fast_math), and rintf rounds half to even like
// jnp.round.  Both kernels take a row's sum of squares in one order (thread
// t over its 16-byte vectors t, t + 256, ... in element order, the xor tree
// over a warp's lanes, the 8 warp sums in warp order), so their bits do not
// depend on the block that takes a row.
//
// What bounds it on the H100: bytes, in principle.  At the main-path shapes
// (K7: 3200 x 3584, K8: 3096 x 3200) each element is read once or twice as
// bf16 and written once as int8 (K8 also writes x_new): 34 MB and 69 MB, 10
// and 21 us at 3.35 TB/s.  But a row is only 6-7 KB, and its statistics
// (two block reductions, an IEEE square root and divisions) are a chain of
// dependent work a row, so at K7's arithmetic intensity that chain and the
// instructions a value hold it back before the loads do.
//
// K7: a persistent grid of 256-thread blocks (three an SM, the rows split
// evenly over them) walks the rows.  A thread keeps its vectors
// of a row in registers as raw bf16 words (V = ceil(D / 2048) a thread, a
// template parameter) and gamma's in fp32, loaded once a block; it loads the
// next row's vectors before the current row's reductions, so they are in
// flight behind the barriers, computes n once into fp32 registers between
// the amax and the quantize, and stores 8 codes at a time.  No dynamic
// shared memory.  The codes are computed without a division or a conversion
// a value (codes8_rcp), to the same bits.
//
// K8: one block a row; each thread loads 16-byte vectors (8 bf16), keeps
// the row in shared memory as fp32 between the sum-of-squares, the amax and
// the quantize passes, and writes 8 codes at a time.  The TPU kernels'
// 128-row blocking is tiling only and is not carried over.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SPAN = THREADS * 8;  // elements one pass of the block's 16-byte vectors covers

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();  // red may still be read from a previous reduction
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];  // fixed order: every thread gets the same sum
    return s;
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) m = fmaxf(m, red[w]);
    return m;
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

// Element j of 8 raw bf16 values, in fp32 (exact).
__device__ __forceinline__ float elem(const uint4& v, int j) {
    const uint32_t w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
    return __uint_as_float(j & 1 ? w & 0xFFFF0000u : w << 16);
}

__device__ __forceinline__ float inv_rms(float sumsq, int D, float eps) {
    return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(sumsq, (float)D), eps)));
}

__device__ __forceinline__ float quant_scale(float amax) { return __fdiv_rn(fmaxf(amax, 1e-6f), 127.f); }

// 8 normalised values -> their 8 codes in one 8-byte word.
__device__ __forceinline__ uint2 codes8(const float (&n)[8], float scale) {
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(n[j], scale)), -127.f), 127.f);
        packed[j >> 2] |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * (j & 3));
    }
    return make_uint2(packed[0], packed[1]);
}

// K8's tail: row (fp32 in smem) -> codes + scale.  Every thread returns
// after writing its codes.
__device__ __forceinline__ void quantize_row(const float* row, const bf16* __restrict__ gamma, int D, float eps,
                                             float sumsq, float* red, int8_t* __restrict__ codes,
                                             float* __restrict__ row_scale) {
    const float r = inv_rms(sumsq, D, eps);
    float amax = 0.f;
    for (int i = threadIdx.x * 8; i < D; i += SPAN) {
        float g[8];
        load8(gamma + i, g);
#pragma unroll
        for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__fmul_rn(__fmul_rn(row[i + j], r), g[j])));
    }
    amax = block_max(amax, red);
    const float scale = quant_scale(amax);
    for (int i = threadIdx.x * 8; i < D; i += SPAN) {
        float g[8], n[8];
        load8(gamma + i, g);
#pragma unroll
        for (int j = 0; j < 8; ++j) n[j] = __fmul_rn(__fmul_rn(row[i + j], r), g[j]);
        *reinterpret_cast<uint2*>(codes + i) = codes8(n, scale);
    }
    if (threadIdx.x == 0) *row_scale = scale;
}

// K7's codes of 8 normalised values: the bits of codes8, with neither a
// division nor a float-to-int conversion a value (at K7's widths the
// instructions a value hold the kernel back before its bytes do).  y = RN(1 / scale) once a row; q0 = RN(n y),
// then twice q = RN(q + (n - scale q) y), the residual exact by FMA.  The
// first correction leaves q within an ulp of n / scale, so the second gives
// RN(n / scale) exactly (Markstein's theorem; y within half an ulp of 1 /
// scale), the value __fdiv_rn returns, wherever |n| > 2^-103 keeps the
// residual normal (below, |q| < 1e-23 and the code is 0 either way).  As
// scale = RN(amax / 127) and |n| <= amax, |q| <= 127 (1 + 2^-23), whose
// rint is 127: the clip to [-127, 127] acts only on a NaN (fmaxf makes it
// -127), so only that half of it stays.  Adding 1.5 * 2^23 then rounds to
// the nearest integer, ties to even, as rintf does, and leaves the code's
// two's complement in the low byte.
__device__ __forceinline__ uint2 codes8_rcp(const float (&n)[8], float scale, float y) {
    uint32_t u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        float q = __fmul_rn(n[j], y);
        q = __fmaf_rn(__fmaf_rn(-scale, q, n[j]), y, q);
        q = __fmaf_rn(__fmaf_rn(-scale, q, n[j]), y, q);
        u[j] = __float_as_uint(__fadd_rn(fmaxf(q, -127.f), 12582912.f));
    }
    return make_uint2(__byte_perm(__byte_perm(u[0], u[1], 0x0040), __byte_perm(u[2], u[3], 0x0040), 0x5410),
                      __byte_perm(__byte_perm(u[4], u[5], 0x0040), __byte_perm(u[6], u[7], 0x0040), 0x5410));
}

// K7's blocks an SM.  Registers: a row's vectors, the next row's, gamma's (in
// fp32) and n; three blocks fit (80 a thread) up to V = 2, the path's
// widths, where two or four (at 64 registers) read slower; one past it.
template <int V>
constexpr int K7_BLOCKS_PER_SM = V <= 2 ? 3 : 1;

template <int V>
__global__ void __launch_bounds__(THREADS, K7_BLOCKS_PER_SM<V>)
rmsnorm_quant_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma, int8_t* __restrict__ codes,
                     float* __restrict__ row_scale, int rows, int D, float eps) {
    __shared__ float red[THREADS / 32];
    const int t8 = threadIdx.x * 8;
    uint4 cur[V], nxt[V];
    float g[V][8];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        cur[k] = nxt[k] = make_uint4(0u, 0u, 0u, 0u);
        if (t8 + k * SPAN < D) {
            load8(gamma + t8 + k * SPAN, g[k]);
            cur[k] = *reinterpret_cast<const uint4*>(x + (size_t)blockIdx.x * D + t8 + k * SPAN);
        }
    }
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
        const int next = row + gridDim.x;
        if (next < rows) {  // in flight behind this row's two reductions
#pragma unroll
            for (int k = 0; k < V; ++k)
                if (t8 + k * SPAN < D) nxt[k] = *reinterpret_cast<const uint4*>(x + (size_t)next * D + t8 + k * SPAN);
        }
        float ss = 0.f;
#pragma unroll
        for (int k = 0; k < V; ++k) {
            if (t8 + k * SPAN < D) {
#pragma unroll
                for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(elem(cur[k], j), elem(cur[k], j)));
            }
        }
        const float r = inv_rms(block_sum(ss, red), D, eps);
        float n[V][8];
        float amax = 0.f;
#pragma unroll
        for (int k = 0; k < V; ++k) {
            if (t8 + k * SPAN < D) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    n[k][j] = __fmul_rn(__fmul_rn(elem(cur[k], j), r), g[k][j]);
                    amax = fmaxf(amax, fabsf(n[k][j]));
                }
            }
        }
        const float scale = quant_scale(block_max(amax, red)), y = __frcp_rn(scale);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            if (t8 + k * SPAN < D)
                *reinterpret_cast<uint2*>(codes + (size_t)row * D + t8 + k * SPAN) = codes8_rcp(n[k], scale, y);
            cur[k] = nxt[k];
        }
        if (threadIdx.x == 0) row_scale[row] = scale;
    }
}

__global__ void __launch_bounds__(THREADS)
add_rmsnorm_quant_kernel(const bf16* __restrict__ x, const bf16* __restrict__ delta, const bf16* __restrict__ ls,
                         const bf16* __restrict__ gamma, bf16* __restrict__ x_new, int8_t* __restrict__ codes,
                         float* __restrict__ row_scale, int D, float eps) {
    extern __shared__ float row[];
    __shared__ float red[THREADS / 32];
    const size_t base = (size_t)blockIdx.x * D;
    float ss = 0.f;
    for (int i = threadIdx.x * 8; i < D; i += SPAN) {
        float xv[8], dv[8], lv[8];
        load8(x + base + i, xv);
        load8(delta + base + i, dv);
        if (ls != nullptr) {
            load8(ls + i, lv);
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) lv[j] = 1.f;
        }
        uint32_t packed[4];
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
            // x + delta * ls in fp32, rounded once to bf16; the norm reads the rounded value
            const bf16 a = __float2bfloat16_rn(__fadd_rn(xv[j], __fmul_rn(dv[j], lv[j])));
            const bf16 b = __float2bfloat16_rn(__fadd_rn(xv[j + 1], __fmul_rn(dv[j + 1], lv[j + 1])));
            packed[j >> 1] = pack_bf16_raw(a, b);
            const float fa = __bfloat162float(a), fb = __bfloat162float(b);
            row[i + j] = fa;
            row[i + j + 1] = fb;
            ss = __fadd_rn(ss, __fmul_rn(fa, fa));
            ss = __fadd_rn(ss, __fmul_rn(fb, fb));
        }
        *reinterpret_cast<uint4*>(x_new + base + i) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
    const float sumsq = block_sum(ss, red);
    quantize_row(row, gamma, D, eps, sumsq, red, codes + base, row_scale + blockIdx.x);
}

// K7's grid: the blocks its launch bounds keep resident on every SM, the
// rows split evenly over them.  The SM count is read once a device.
template <int V>
void launch_rmsnorm_quant(const void* x, const void* gamma, void* codes, void* row_scale, int rows, int D, float eps,
                          cudaStream_t stream) {
    static int sms[64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    const int most = K7_BLOCKS_PER_SM<V> * sms[dev];
    const int per_block = (rows + most - 1) / most;
    rmsnorm_quant_kernel<V><<<(rows + per_block - 1) / per_block, THREADS, 0, stream>>>(
        (const bf16*)x, (const bf16*)gamma, (int8_t*)codes, (float*)row_scale, rows, D, eps);
}

}  // namespace

// D a multiple of 8 (16-byte rows of bf16), at most 16384 (8 vectors a
// thread of K7, 64 KB of fp32 row in K8's shared memory); rows >= 1; every
// pointer 16-byte aligned (PyTorch allocations are).
extern "C" int omchat_rmsnorm_quant(const void* x, const void* gamma, void* codes, void* row_scale, int rows, int D,
                                    float eps, void* stream) {
    static void (*const launch[8])(const void*, const void*, void*, void*, int, int, float, cudaStream_t) = {
        launch_rmsnorm_quant<1>, launch_rmsnorm_quant<2>, launch_rmsnorm_quant<3>, launch_rmsnorm_quant<4>,
        launch_rmsnorm_quant<5>, launch_rmsnorm_quant<6>, launch_rmsnorm_quant<7>, launch_rmsnorm_quant<8>};
    launch[std::min(8, (D + SPAN - 1) / SPAN) - 1](x, gamma, codes, row_scale, rows, D, eps, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

extern "C" int omchat_add_rmsnorm_quant(const void* x, const void* delta, const void* ls, const void* gamma,
                                        void* x_new, void* codes, void* row_scale, int rows, int D, float eps,
                                        void* stream) {
    const size_t smem = (size_t)D * sizeof(float);
    cudaFuncSetAttribute(add_rmsnorm_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    add_rmsnorm_quant_kernel<<<rows, THREADS, smem, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)delta, (const bf16*)ls, (const bf16*)gamma, (bf16*)x_new, (int8_t*)codes,
        (float*)row_scale, D, eps);
    return (int)cudaGetLastError();
}
