// Attention output projection fused with the glue after it (K11): dynamic
// row quantization of the attention output, int8 GEMM with the square proj /
// o_proj weight, dequantize + bias, residual + LayerScale, RMSNorm, int8
// quantization of the normed rows.
//
// Replaces the TPU kernel omchat_tpu/ops/quant_matmul.py:255
// attn_proj_glue_quant (body _proj_glue_kernel :215, pallas_call :299).
//
//   a [M, K] bf16 (attention output), x [M, N] bf16 (residual), w [N, K]
//   int8 (K == N), col_scale [N] bf16, bias [N] bf16 (nullptr: none), ls [N]
//   bf16 (nullptr: 1), gamma [N] bf16
//   -> x_new [M, N] bf16, codes [M, N] int8, row_scale [M] fp32
//   scratch from the wrapper: aq [M, K] int8, sa [M] fp32, partial [M, N / 128] fp32
//
//   sa = max(max|a|, 1e-6) / 127; aq = clip(rint(a / sa))
//   y = bf16(acc * sa * col_scale); y = bf16(y + bias)
//   x_new = bf16(x + y * ls); n = (x_new * r) * gamma, r = 1 / sqrt(mean(x_new^2) + eps)
//   row_scale = max(max|n|, 1e-6) / 127; codes = clip(rint(n / row_scale))
// in the Pallas body's order, with its roundings (products and sums forced
// by __fmul_rn / __fadd_rn, IEEE division and sqrt, round half to even).
// acc is exact in int32 and the rest up to x_new is elementwise, so x_new is
// bitwise the plain version's; only mean(x_new^2) sums in another order.
//
// What bounds it on the H100: operations.  2 M N K: 63.4 G at the ViT shape
// (M = 3096, K = N = 3200) and 82.2 G at the Qwen2 prefill (M = 3200,
// K = N = 3584): 0.032 / 0.042 ms at the dense int8 peak, against 50 / 60 MB
// of traffic.
//
// Design.  The TPU kernel keeps the whole weight (10-13 MB) resident in VMEM
// and sweeps row blocks past it; no SM's 227 KB can hold it, and the norm
// needs every column of a row before any code can be written.  So three
// launches from one C entry, each shaped for the card:
//   1. row prepass (bytes): a warp a row quantizes a into aq and sa;
//   2. the GEMM (operations) on s8_gemm_sm90.cuh's mainloop: a block per
//      128 x 128 tile of x_new, one producer warp keeping STAGES 128-deep K
//      tiles of aq and w in flight by TMA, two consumer warpgroups each
//      running wgmma m64n128k32 s8 over 64 of the tile's rows.  Its epilogue
//      dequantizes, adds bias, residual and LayerScale from the accumulator
//      registers, writes x_new and each row's sum of x_new^2 over the tile's
//      128 columns into `partial`.  The grid runs the N tiles of one row
//      block one after another, so a row block of aq is read from device
//      memory once and reused from L2, and w (13 MB) stays in the 50 MB L2;
//   3. row finish (bytes): a warp a row sums its partials in tile order,
//      reads its x_new row back (L2-resident), normalizes, and writes the
//      codes and the row scale.
#include "common.cuh"
#include "s8_gemm_sm90.cuh"

namespace {

constexpr int BM = 128, BN = 128, STAGES = 5;
constexpr int ROW_WARPS = 8;                       // rows a block of the row passes

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ uint2 quantize8(const float (&n)[8], float scale) {
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(n[j], scale)), -127.f), 127.f);
        packed[j >> 2] |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * (j & 3));
    }
    return make_uint2(packed[0], packed[1]);
}

__device__ __forceinline__ float2 load_bf16x2_f(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 1. aq and sa of row blockIdx.x * ROW_WARPS + warp.
__global__ void __launch_bounds__(32 * ROW_WARPS)
row_quant_kernel(const bf16* __restrict__ a, int8_t* __restrict__ aq, float* __restrict__ sa, int M, int K) {
    const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    if (row >= M) return;
    const bf16* arow = a + (size_t)row * K;
    float amax = 0.f;
    for (int k = lane * 8; k < K; k += 32 * 8) {
        float v[8];
        load8(arow + k, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
    }
    const float s = __fdiv_rn(fmaxf(warp_max(amax), 1e-6f), 127.f);
    for (int k = lane * 8; k < K; k += 32 * 8) {
        float v[8];
        load8(arow + k, v);
        *reinterpret_cast<uint2*>(aq + (size_t)row * K + k) = quantize8(v, s);
    }
    if (lane == 0) sa[row] = s;
}

// 2. x_new and the partial sums of squares of the 128 x 128 tile (blockIdx.x
// along N, blockIdx.y along M).
__global__ void __launch_bounds__(s8gemm::THREADS, 1)
proj_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                 const float* __restrict__ sa, const bf16* __restrict__ x, const bf16* __restrict__ col_scale,
                 const bf16* __restrict__ bias, const bf16* __restrict__ ls, bf16* __restrict__ x_new,
                 float* __restrict__ partial, int M, int N, int k_tiles) {
    const int n_tile = blockIdx.x, n0 = n_tile * BN, m0 = blockIdx.y * BM;
    s8gemm::tile<STAGES>(&map_a, &map_w, nullptr, m0, n0, k_tiles, sa, M,
                         [&](const int (&d)[64], const int (&rows)[2], const float (&sar)[2], int t) {
        float ss[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            const float2 cs = load_bf16x2_f(col_scale + col);
            const float2 b = bias ? load_bf16x2_f(bias + col) : make_float2(0.f, 0.f);
            const float2 l = ls ? load_bf16x2_f(ls + col) : make_float2(1.f, 1.f);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (rows[h] >= M) continue;
                const size_t at = (size_t)rows[h] * N + col;
                const float2 xv = load_bf16x2_f(x + at);
                const float csv[2] = {cs.x, cs.y}, bv[2] = {b.x, b.y}, lv[2] = {l.x, l.y}, xs[2] = {xv.x, xv.y};
                bf16 o[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float y = __bfloat162float(
                        __float2bfloat16_rn(__fmul_rn(__fmul_rn((float)d[4 * j + 2 * h + e], sar[h]), csv[e])));
                    if (bias) y = __bfloat162float(__float2bfloat16_rn(__fadd_rn(y, bv[e])));
                    o[e] = __float2bfloat16_rn(__fadd_rn(xs[e], __fmul_rn(y, lv[e])));
                    const float v = __bfloat162float(o[e]);
                    ss[h] = __fadd_rn(ss[h], __fmul_rn(v, v));
                }
                *reinterpret_cast<uint32_t*>(x_new + at) = pack_bf16_raw(o[0], o[1]);
            }
        }
        // each row's sum over the tile's 128 columns: its four threads (t) in a fixed order
        const int n_tiles = N / BN;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float s = ss[h];
            s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
            s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
            if (t == 0 && rows[h] < M) partial[(size_t)rows[h] * n_tiles + n_tile] = s;
        }
    });
}

// 3. codes and the row scale of row blockIdx.x * ROW_WARPS + warp.
__global__ void __launch_bounds__(32 * ROW_WARPS)
row_finish_kernel(const bf16* __restrict__ x_new, const float* __restrict__ partial, const bf16* __restrict__ gamma,
                  int8_t* __restrict__ codes, float* __restrict__ row_scale, int M, int N, float eps) {
    const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    if (row >= M) return;
    const int n_tiles = N / BN;
    float sumsq = 0.f;
    for (int i = 0; i < n_tiles; ++i) sumsq = __fadd_rn(sumsq, partial[(size_t)row * n_tiles + i]);  // tile 0 first
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(sumsq, (float)N), eps)));
    const bf16* xrow = x_new + (size_t)row * N;
    float amax = 0.f;
    for (int k = lane * 8; k < N; k += 32 * 8) {
        float v[8], gm[8];
        load8(xrow + k, v);
        load8(gamma + k, gm);
#pragma unroll
        for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__fmul_rn(__fmul_rn(v[j], rstd), gm[j])));
    }
    const float scale = __fdiv_rn(fmaxf(warp_max(amax), 1e-6f), 127.f);
    for (int k = lane * 8; k < N; k += 32 * 8) {
        float v[8], gm[8], n[8];
        load8(xrow + k, v);
        load8(gamma + k, gm);
#pragma unroll
        for (int j = 0; j < 8; ++j) n[j] = __fmul_rn(__fmul_rn(v[j], rstd), gm[j]);
        *reinterpret_cast<uint2*>(codes + (size_t)row * N + k) = quantize8(n, scale);
    }
    if (lane == 0) row_scale[row] = scale;
}

}  // namespace

// K == N, a multiple of 128 (the wrapper's gate); the three launches on `stream`.
extern "C" int omchat_proj_glue_quant(const void* a, const void* x, const void* w, const void* col_scale,
                                      const void* bias, const void* ls, const void* gamma, void* x_new, void* codes,
                                      void* row_scale, void* aq, void* sa, void* partial, int M, int N, float eps,
                                      void* stream) {
    if (M <= 0 || N <= 0 || N % BN != 0) return (int)cudaErrorInvalidValue;
    const int K = N;
    cudaStream_t s = (cudaStream_t)stream;
    const int row_blocks = (M + ROW_WARPS - 1) / ROW_WARPS;
    row_quant_kernel<<<row_blocks, 32 * ROW_WARPS, 0, s>>>((const bf16*)a, (int8_t*)aq, (float*)sa, M, K);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    CUtensorMap map_a, map_w;
    if (!s8gemm::matrix_map(&map_a, aq, M, K, BM) || !s8gemm::matrix_map(&map_w, w, N, K, BN))
        return (int)cudaErrorInvalidValue;
    err = (cudaError_t)s8gemm::launch<STAGES>(proj_gemm_kernel, dim3(N / BN, (M + BM - 1) / BM), s, map_a, map_w,
                                              (const float*)sa, (const bf16*)x, (const bf16*)col_scale,
                                              (const bf16*)bias, (const bf16*)ls, (bf16*)x_new, (float*)partial, M, N,
                                              K / s8gemm::BK);
    if (err != cudaSuccess) return (int)err;

    row_finish_kernel<<<row_blocks, 32 * ROW_WARPS, 0, s>>>((const bf16*)x_new, (const float*)partial,
                                                             (const bf16*)gamma, (int8_t*)codes, (float*)row_scale, M,
                                                             N, eps);
    return (int)cudaGetLastError();
}
