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
// the [M, N] bf16 intermediate never reaches device memory.  The int32
// product is exact in any K order and the epilogue is elementwise, so the
// codes do not depend on the tiling.
//
// What bounds it on the H100: operations.  At the main-path shape (M = 3096,
// K = 3200, N = 12800) the product is 2 M N K = 253.6 G int8 operations,
// 0.128 ms at the dense int8 peak (1979 TOPS), against 90.5 MB of traffic
// (0.027 ms).  At M = 128 it is bytes: the weight's 41.0 MB (0.012 ms)
// against 10.5 G operations (0.005 ms).
//
// Design: the GEMM runs on s8_gemm_sm90.cuh's mainloop, as K11's does.  A
// block computes a 128 x 128 tile of the output: one producer warp keeps
// STAGES 128-deep K tiles of xq and w in flight by TMA (rows past M read as
// zeros and are not stored), two consumer warpgroups each run wgmma
// m64n128k32 s8 over 64 of the tile's rows, and the epilogue works from the
// accumulator registers.  Two blocks share an SM, a 3-stage ring each, so
// one block's tanh epilogue runs while the other's wgmma do (one block an
// SM with 5 stages measured slower: PERF.md).
//
// Tile order: blockIdx.x runs along M, so the grid sweeps every row block of
// one column tile before the next, as the TPU kernel's grid (N outer, M
// inner) keeps a weight tile resident across its M sweep.  The ~130-260
// blocks in flight cover 5-11 column tiles, so each weight tile should be
// read from device memory once and reused from L2 by the other row blocks,
// while xq (9.9 MB at M = 3096) stays in the 50 MB L2.  Device-memory bytes
// of w, reckoned from the shapes (not measured): at M = 3096, 41.0 MB, once
// (a column-major sweep that re-streamed it for each of the 25 row blocks
// would read 1.02 GB); at M = 128, 41.0 MB, one row block either way.
#include "common.cuh"
#include "s8_gemm_sm90.cuh"

namespace {

constexpr int BM = 128, BN = 128;
constexpr int BLOCKS_PER_SM = 2, STAGES = 3;  // 96 KB of ring a block

__device__ __forceinline__ float gelu_tanh(float h) {
    // jax.nn.gelu(approximate=True): h * (0.5 * (1 + tanh(sqrt(2/pi) * (h + 0.044715 * h^3))))
    const float h3 = __fmul_rn(__fmul_rn(h, h), h);
    const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(h, __fmul_rn(0.044715f, h3)));
    return __fmul_rn(h, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

// The 128 x 128 output tile (blockIdx.x along M, blockIdx.y along N).
__global__ void __launch_bounds__(s8gemm::THREADS, BLOCKS_PER_SM)
fc1_gelu_quant_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                      const float* __restrict__ row_scale, const bf16* __restrict__ col_scale,
                      const bf16* __restrict__ bias, const float* __restrict__ out_scale, int8_t* __restrict__ out,
                      int M, int N, int k_tiles) {
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    s8gemm::tile<STAGES>(&map_x, &map_w, nullptr, m0, n0, k_tiles, row_scale, M,
                         [&](const int (&d)[64], const int (&rows)[2], const float (&rs)[2], int t) {
        const float inv = __fdiv_rn(1.f, out_scale[0]);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            const float cs[2] = {__bfloat162float(col_scale[col]), __bfloat162float(col_scale[col + 1])};
            const float b[2] = {bias ? __bfloat162float(bias[col]) : 0.f, bias ? __bfloat162float(bias[col + 1]) : 0.f};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (rows[h] >= M) continue;
                uint32_t packed = 0;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float v = __fmul_rn(__fmul_rn((float)d[4 * j + 2 * h + e], rs[h]), cs[e]);
                    if (bias) v = __fadd_rn(v, b[e]);
                    const float q = fminf(fmaxf(rintf(__fmul_rn(gelu_tanh(v), inv)), -127.f), 127.f);
                    packed |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * e);
                }
                *reinterpret_cast<uint16_t*>(out + (size_t)rows[h] * N + col) = (uint16_t)packed;
            }
        }
    });
}

}  // namespace

// N and K multiples of 128 (the wrapper's gate, the JAX package's); xq and
// w contiguous with 16-byte-aligned bases, as their TMA maps need.
extern "C" int omchat_fc1_gelu_quant(const void* xq, const void* w, const void* row_scale, const void* col_scale,
                                     const void* bias, const void* out_scale, void* out, int M, int N, int K,
                                     void* stream) {
    if (M <= 0 || N <= 0 || K <= 0 || N % BN != 0 || K % s8gemm::BK != 0) return (int)cudaErrorInvalidValue;
    CUtensorMap map_x, map_w;
    if (!s8gemm::matrix_map(&map_x, xq, M, K, BM) || !s8gemm::matrix_map(&map_w, w, N, K, BN))
        return (int)cudaErrorInvalidValue;
    return s8gemm::launch<STAGES>(fc1_gelu_quant_kernel, dim3((M + BM - 1) / BM, N / BN), (cudaStream_t)stream,
                                  map_x, map_w, (const float*)row_scale, (const bf16*)col_scale, (const bf16*)bias,
                                  (const float*)out_scale, (int8_t*)out, M, N, K / s8gemm::BK);
}
