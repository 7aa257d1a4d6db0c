// int8 GEMM with a dequantize + bias + tanh-GELU + static-scale quantize
// epilogue: the w8a8 ViT fc1 (K9).
//
// Replaces the TPU kernel omchat_tpu/ops/quant_matmul.py:62
// dense_prequant_gelu_quant_pallas (body _fc1_kernel :50, pallas_call :98),
// reached through fc1_gelu_quant (:336).
//
//   xq [M, K] int8, row_scale [M] fp32, w [N, K] int8 (the port stores int8
//   kernels [out, in]), col_scale [N] bf16, bias [N] bf16 (nullptr: none),
//   out_scale [1] fp32 -> out [M, N] int8
//   h = acc * row_scale * col_scale + bias (fp32); codes =
//   clip(rint(gelu_tanh(h) * (1 / out_scale)), -127, 127)
//
// The epilogue follows the Pallas body operation by operation (its products,
// sums and 1/out_scale, round half to even), with tanhf — not the
// approximate tanh.approx.f32 — and the roundings forced with __fmul_rn /
// __fadd_rn so no multiply-add is contracted.  Only int8 codes are written:
// the [M, N] bf16 intermediate never reaches device memory.
//
// What bounds it on the H100: operations.  At the main-path shape (M = 3096,
// K = 3200, N = 12800) the product is 2 M N K = 253.6 G int8 operations,
// 0.128 ms at the dense int8 peak (1979 TOPS), against 90.5 MB of traffic
// (0.027 ms).  Design: 128 x 128 output tiles, 8 warps each computing 64 x 32
// with mma.sync m16n8k32 (s8, s32 accumulate); 64-deep K tiles of both
// operands staged by cp.async in a 3-stage ring (rows padded to 80 bytes, so
// the fragment loads hit 32 distinct banks); rows past M are zero-filled and
// not stored.  No wgmma or TMA yet.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, THREADS = 256;
constexpr int LDS = BK + 16;  // bytes per staged row
constexpr int STAGE_BYTES = (BM + BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 61440

__device__ __forceinline__ float gelu_tanh(float h) {
    // jax.nn.gelu(approximate=True): h * (0.5 * (1 + tanh(sqrt(2/pi) * (h + 0.044715 * h^3))))
    const float h3 = __fmul_rn(__fmul_rn(h, h), h);
    const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(h, __fmul_rn(0.044715f, h3)));
    return __fmul_rn(h, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

__global__ void __launch_bounds__(THREADS)
fc1_gelu_quant_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w, const float* __restrict__ row_scale,
                      const bf16* __restrict__ col_scale, const bf16* __restrict__ bias,
                      const float* __restrict__ out_scale, int8_t* __restrict__ out, int M, int N, int K) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64.., cols wn*32..
    const int KT = K / BK;

    auto load_stage = [&](int stage, int kt) {
        unsigned char* as = smem + stage * STAGE_BYTES;
        unsigned char* bs = as + BM * LDS;
        const int k0 = kt * BK;
#pragma unroll
        for (int i = 0; i < (BM * BK / 16) / THREADS; ++i) {
            const int c = tid + i * THREADS, row = c >> 2, col = (c & 3) * 16;
            const bool valid = m0 + row < M;
            cp_async16_zfill(as + row * LDS + col, xq + (size_t)(valid ? m0 + row : 0) * K + k0 + col, valid);
        }
#pragma unroll
        for (int i = 0; i < (BN * BK / 16) / THREADS; ++i) {
            const int c = tid + i * THREADS, row = c >> 2, col = (c & 3) * 16;
            cp_async16(bs + row * LDS + col, w + (size_t)(n0 + row) * K + k0 + col);
        }
    };

    int acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

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
        const unsigned char* bs = as + BM * LDS;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 32) {
            uint32_t a[4][4], b[4][2];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const unsigned char* r0 = as + (wm * 64 + mt * 16 + g) * LDS + kk + 4 * t;
                a[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
                a[mt][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LDS);
                a[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
                a[mt][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LDS + 16);
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const unsigned char* c0 = bs + (wn * 32 + nt * 8 + g) * LDS + kk + 4 * t;
                b[nt][0] = *reinterpret_cast<const uint32_t*>(c0);
                b[nt][1] = *reinterpret_cast<const uint32_t*>(c0 + 16);
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) mma_s8_16832(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
        }
    }
    cp_async_wait<0>();

    const float inv = __fdiv_rn(1.f, out_scale[0]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        const float cs0 = __bfloat162float(col_scale[col]), cs1 = __bfloat162float(col_scale[col + 1]);
        const float b0 = bias ? __bfloat162float(bias[col]) : 0.f;
        const float b1 = bias ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + wm * 64 + mt * 16 + g + 8 * half;
                if (row >= M) continue;
                const float rs = row_scale[row];
                float h0 = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * half], rs), cs0);
                float h1 = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * half + 1], rs), cs1);
                if (bias) {
                    h0 = __fadd_rn(h0, b0);
                    h1 = __fadd_rn(h1, b1);
                }
                const float q0 = fminf(fmaxf(rintf(__fmul_rn(gelu_tanh(h0), inv)), -127.f), 127.f);
                const float q1 = fminf(fmaxf(rintf(__fmul_rn(gelu_tanh(h1), inv)), -127.f), 127.f);
                const uint16_t packed = (uint16_t)(uint8_t)(int8_t)(int)q0 | ((uint16_t)(uint8_t)(int8_t)(int)q1 << 8);
                *reinterpret_cast<uint16_t*>(out + (size_t)row * N + col) = packed;
            }
        }
    }
}

}  // namespace

// N a multiple of 128, K a multiple of 64 (the wrapper asks for 128, the
// JAX package's gate); rows of xq and w 16-byte aligned (K % 16 == 0).
extern "C" int omchat_fc1_gelu_quant(const void* xq, const void* w, const void* row_scale, const void* col_scale,
                                     const void* bias, const void* out_scale, void* out, int M, int N, int K,
                                     void* stream) {
    cudaFuncSetAttribute(fc1_gelu_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    const dim3 grid(N / BN, (M + BM - 1) / BM);
    fc1_gelu_quant_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const int8_t*)xq, (const int8_t*)w, (const float*)row_scale, (const bf16*)col_scale, (const bf16*)bias,
        (const float*)out_scale, (int8_t*)out, M, N, K);
    return (int)cudaGetLastError();
}
