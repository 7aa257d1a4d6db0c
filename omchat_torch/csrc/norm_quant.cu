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
// jnp.round.
//
// What bounds it on the H100: bytes.  At the main-path shapes (K7: 3200 x
// 3584, K8: 3096 x 3200) each element is read once or twice as bf16 and
// written once as int8 (K8 also writes x_new): 34 MB and 69 MB, 10 and 21 us
// at 3.35 TB/s.  Design: one block of 256 threads per row; each thread loads
// 16-byte vectors (8 bf16), keeps the row in shared memory as fp32 between
// the sum-of-squares, the amax and the quantize passes, and writes 8 codes
// at a time.  The TPU kernel's 128-row blocking is tiling only and is not
// carried over.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

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

// Shared tail: row (fp32 in smem) -> codes + scale.  Every thread returns
// after writing its codes.
__device__ __forceinline__ void quantize_row(const float* row, const bf16* __restrict__ gamma, int D, float eps,
                                             float sumsq, float* red, int8_t* __restrict__ codes,
                                             float* __restrict__ row_scale) {
    const float var = __fdiv_rn(sumsq, (float)D);
    const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    float amax = 0.f;
    for (int i = threadIdx.x * 8; i < D; i += THREADS * 8) {
        float g[8];
        load8(gamma + i, g);
#pragma unroll
        for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__fmul_rn(__fmul_rn(row[i + j], r), g[j])));
    }
    amax = block_max(amax, red);
    const float scale = __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
    for (int i = threadIdx.x * 8; i < D; i += THREADS * 8) {
        float g[8];
        load8(gamma + i, g);
        uint32_t packed[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float n = __fmul_rn(__fmul_rn(row[i + j], r), g[j]);
            const float q = fminf(fmaxf(rintf(__fdiv_rn(n, scale)), -127.f), 127.f);
            packed[j >> 2] |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * (j & 3));
        }
        *reinterpret_cast<uint2*>(codes + i) = make_uint2(packed[0], packed[1]);
    }
    if (threadIdx.x == 0) *row_scale = scale;
}

__global__ void __launch_bounds__(THREADS)
rmsnorm_quant_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma, int8_t* __restrict__ codes,
                     float* __restrict__ row_scale, int D, float eps) {
    extern __shared__ float row[];
    __shared__ float red[THREADS / 32];
    const size_t base = (size_t)blockIdx.x * D;
    float ss = 0.f;
    for (int i = threadIdx.x * 8; i < D; i += THREADS * 8) {
        float v[8];
        load8(x + base + i, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            row[i + j] = v[j];
            ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
        }
    }
    const float sumsq = block_sum(ss, red);
    quantize_row(row, gamma, D, eps, sumsq, red, codes + base, row_scale + blockIdx.x);
}

__global__ void __launch_bounds__(THREADS)
add_rmsnorm_quant_kernel(const bf16* __restrict__ x, const bf16* __restrict__ delta, const bf16* __restrict__ ls,
                         const bf16* __restrict__ gamma, bf16* __restrict__ x_new, int8_t* __restrict__ codes,
                         float* __restrict__ row_scale, int D, float eps) {
    extern __shared__ float row[];
    __shared__ float red[THREADS / 32];
    const size_t base = (size_t)blockIdx.x * D;
    float ss = 0.f;
    for (int i = threadIdx.x * 8; i < D; i += THREADS * 8) {
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

}  // namespace

// D a multiple of 8 (16-byte rows of bf16), at most 16384 (64 KB of fp32 row
// in shared memory); every pointer 16-byte aligned (PyTorch allocations are).
extern "C" int omchat_rmsnorm_quant(const void* x, const void* gamma, void* codes, void* row_scale, int rows, int D,
                                    float eps, void* stream) {
    const size_t smem = (size_t)D * sizeof(float);
    cudaFuncSetAttribute(rmsnorm_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    rmsnorm_quant_kernel<<<rows, THREADS, smem, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)gamma, (int8_t*)codes, (float*)row_scale, D, eps);
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
