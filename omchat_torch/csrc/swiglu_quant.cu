// The w8a8 Qwen2 MLP's gate and up int8 GEMMs with a dequantize + silu * up +
// static-scale quantize epilogue (K10).
//
// Replaces the TPU kernel omchat_tpu/ops/quant_matmul.py:131
// dense_prequant_swiglu_quant_pallas (body _swiglu_kernel :119, pallas_call
// :165), reached through swiglu_quant (:187).
//
//   xq [M, K] int8, row_scale [M] fp32, wg / wu [N, K] int8 (the port stores
//   int8 kernels [out, in]), cs_g / cs_u [N] bf16, out_scale [1] fp32
//   -> out [M, N] int8
//   g = acc_g * row_scale * cs_g, u = acc_u * row_scale * cs_u (fp32);
//   codes = clip(rint(silu(g) * u * (1 / out_scale)), -127, 127)
//
// The epilogue follows the Pallas body operation by operation: the fp32
// products in its order, silu(g) = g * (1 / (1 + exp(-g))) (the logistic as
// XLA expands it), 1 / out_scale, round half to even; __fmul_rn / __fadd_rn
// keep any multiply-add from being contracted.  Only int8 codes are written:
// the [M, N] gate, up and silu * up intermediates never reach device memory.
//
// What bounds it on the H100: operations.  At the main-path shape (M = 3200,
// K = 3584, N = 18944) the two products are 4 M N K = 869 G int8 operations,
// 0.44 ms at the dense int8 peak (1979 TOPS), against ~147 MB of traffic
// (0.044 ms).  Design: K9's (fc1_gelu_quant.cu) with two B operands — 128 x 64
// output tiles, 8 warps each computing 64 x 16 of both gate and up with
// mma.sync m16n8k32 (s8, s32 accumulate) into two int32 accumulators (64
// registers a thread, as K9's one 64 x 32 accumulator); 64-deep K tiles of
// xq, gate and up staged by cp.async in a 3-stage ring (rows padded to 80
// bytes, so the fragment loads hit 32 distinct banks); rows past M are
// zero-filled and not stored.  No wgmma or TMA yet.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 64, BK = 64, STAGES = 3, THREADS = 256;
constexpr int LDS = BK + 16;  // bytes per staged row
constexpr int STAGE_BYTES = (BM + 2 * BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 61440

__device__ __forceinline__ float silu(float g) {
    // jax.nn.silu(g) = g * sigmoid(g), sigmoid = 1 / (1 + exp(-g))
    return __fmul_rn(g, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g))));
}

__global__ void __launch_bounds__(THREADS)
swiglu_quant_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wg, const int8_t* __restrict__ wu,
                    const float* __restrict__ row_scale, const bf16* __restrict__ cs_g,
                    const bf16* __restrict__ cs_u, const float* __restrict__ out_scale, int8_t* __restrict__ out,
                    int M, int N, int K) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64.., cols wn*16..
    const int KT = K / BK;

    auto load_stage = [&](int stage, int kt) {
        unsigned char* as = smem + stage * STAGE_BYTES;
        unsigned char* gs = as + BM * LDS;
        unsigned char* us = gs + BN * LDS;
        const int k0 = kt * BK;
#pragma unroll
        for (int i = 0; i < (BM * BK / 16) / THREADS; ++i) {
            const int c = tid + i * THREADS, row = c >> 2, col = (c & 3) * 16;
            const bool valid = m0 + row < M;
            cp_async16_zfill(as + row * LDS + col, xq + (size_t)(valid ? m0 + row : 0) * K + k0 + col, valid);
        }
        {  // BN * BK / 16 == THREADS: one 16-byte chunk of each weight per thread
            const int row = tid >> 2, col = (tid & 3) * 16;
            cp_async16(gs + row * LDS + col, wg + (size_t)(n0 + row) * K + k0 + col);
            cp_async16(us + row * LDS + col, wu + (size_t)(n0 + row) * K + k0 + col);
        }
    };

    int acc_g[4][2][4], acc_u[4][2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc_g[i][j][e] = acc_u[i][j][e] = 0;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < KT) load_stage(s, s);
        cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // stage kt has landed; stage kt-1 is no longer read
        if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
        cp_async_commit();
        const unsigned char* as = smem + (kt % STAGES) * STAGE_BYTES;
        const unsigned char* gs = as + BM * LDS;
        const unsigned char* us = gs + BN * LDS;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 32) {
            uint32_t a[4][4], bg[2][2], bu[2][2];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const unsigned char* r0 = as + (wm * 64 + mt * 16 + g) * LDS + kk + 4 * t;
                a[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
                a[mt][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LDS);
                a[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
                a[mt][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LDS + 16);
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const int off = (wn * 16 + nt * 8 + g) * LDS + kk + 4 * t;
                bg[nt][0] = *reinterpret_cast<const uint32_t*>(gs + off);
                bg[nt][1] = *reinterpret_cast<const uint32_t*>(gs + off + 16);
                bu[nt][0] = *reinterpret_cast<const uint32_t*>(us + off);
                bu[nt][1] = *reinterpret_cast<const uint32_t*>(us + off + 16);
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    mma_s8_16832(acc_g[mt][nt], a[mt], bg[nt][0], bg[nt][1]);
                    mma_s8_16832(acc_u[mt][nt], a[mt], bu[nt][0], bu[nt][1]);
                }
        }
    }
    cp_async_wait<0>();

    const float inv = __fdiv_rn(1.f, out_scale[0]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
        const int col = n0 + wn * 16 + nt * 8 + 2 * t;
        const float sg0 = __bfloat162float(cs_g[col]), sg1 = __bfloat162float(cs_g[col + 1]);
        const float su0 = __bfloat162float(cs_u[col]), su1 = __bfloat162float(cs_u[col + 1]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + wm * 64 + mt * 16 + g + 8 * half;
                if (row >= M) continue;
                const float rs = row_scale[row];
                const float g0 = __fmul_rn(__fmul_rn((float)acc_g[mt][nt][2 * half], rs), sg0);
                const float g1 = __fmul_rn(__fmul_rn((float)acc_g[mt][nt][2 * half + 1], rs), sg1);
                const float u0 = __fmul_rn(__fmul_rn((float)acc_u[mt][nt][2 * half], rs), su0);
                const float u1 = __fmul_rn(__fmul_rn((float)acc_u[mt][nt][2 * half + 1], rs), su1);
                const float q0 = fminf(fmaxf(rintf(__fmul_rn(__fmul_rn(silu(g0), u0), inv)), -127.f), 127.f);
                const float q1 = fminf(fmaxf(rintf(__fmul_rn(__fmul_rn(silu(g1), u1), inv)), -127.f), 127.f);
                const uint16_t packed = (uint16_t)(uint8_t)(int8_t)(int)q0 | ((uint16_t)(uint8_t)(int8_t)(int)q1 << 8);
                *reinterpret_cast<uint16_t*>(out + (size_t)row * N + col) = packed;
            }
        }
    }
}

}  // namespace

// N a multiple of 64, K a multiple of 64 (the wrapper asks for 128, the JAX
// package's gate); rows of xq and the weights 16-byte aligned (K % 16 == 0).
extern "C" int omchat_swiglu_quant(const void* xq, const void* wg, const void* wu, const void* row_scale,
                                   const void* cs_g, const void* cs_u, const void* out_scale, void* out, int M,
                                   int N, int K, void* stream) {
    if (N % BN != 0 || K % BK != 0) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(swiglu_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    const dim3 grid(N / BN, (M + BM - 1) / BM);
    swiglu_quant_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const int8_t*)xq, (const int8_t*)wg, (const int8_t*)wu, (const float*)row_scale, (const bf16*)cs_g,
        (const bf16*)cs_u, (const float*)out_scale, (int8_t*)out, M, N, K);
    return (int)cudaGetLastError();
}
