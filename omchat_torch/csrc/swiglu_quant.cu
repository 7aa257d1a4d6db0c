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
// The int32 products are exact in any K order and the epilogue is
// elementwise, so the codes do not depend on the tiling.
//
// What bounds it on the H100: operations at the prefill, bytes at the
// serving shapes.  At M = 3200 (K = 3584, N = 18944) the two products are 4
// M N K = 869 G int8 operations, 0.44 ms at the dense int8 peak (1979 TOPS),
// against ~208 MB of traffic (0.062 ms); at M = 128 the weights' 135.8 MB
// take 0.041 ms against 0.018 ms of operations.
//
// Design: the GEMM runs on s8_gemm_sm90.cuh's mainloop (K9's and K11's).  A
// block computes a 128 x 64 tile of the output.  Its B stage is 128 rows:
// gate rows [n0, n0 + 64) in rows 0-63 and up rows [n0, n0 + 64) in rows
// 64-127, two 64-row TMA boxes from two maps (produce's map_b_hi).  So
// consume runs unchanged, wgmma m64n128k32 s8 over 64 of the tile's rows in
// each of two consumer warpgroups, with the same MMA work a block as K9's
// and K11's, and one 64-register accumulator a thread: in its layout d[4 j +
// e] (j < 8) is gate column 8 j + 2 t + e % 2 and d[4 (j + 8) + e] is up of
// the same column, in the same thread, so the epilogue pairs them in
// registers.  Rows past M read as zeros and are not stored.  Two blocks
// share an SM, a 3-stage ring each, so one block's epilogue runs while the
// other's wgmma do (one block an SM with 5 stages measured slower: PERF.md).
//
// Tile order: blockIdx.x runs along M, so the grid sweeps every row block of
// one column tile before the next, as the TPU kernel's grid (N outer, M
// inner) keeps a weight tile resident across its M sweep, and each weight
// tile should be read from device memory once while xq (11.5 MB at M =
// 3200) stays in the 50 MB L2.  Device-memory bytes of wg and wu, reckoned
// from the shapes (not measured): at M = 3200, 135.8 MB, once (a
// column-major sweep that re-streamed them for each of the 25 row blocks
// would read 3.4 GB, ~1.0 ms of HBM); at M = 128, 135.8 MB, one row block
// either way.
#include "common.cuh"
#include "s8_gemm_sm90.cuh"

namespace {

constexpr int BM = 128, BN = 64;  // the output tile; a B stage holds BN gate rows and BN up rows
constexpr int BLOCKS_PER_SM = 2, STAGES = 3;  // 96 KB of ring a block

__device__ __forceinline__ float silu(float g) {
    // jax.nn.silu(g) = g * sigmoid(g), sigmoid = 1 / (1 + exp(-g))
    return __fmul_rn(g, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g))));
}

// The 128 x 64 output tile (blockIdx.x along M, blockIdx.y along N).
__global__ void __launch_bounds__(s8gemm::THREADS, BLOCKS_PER_SM)
swiglu_quant_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_g,
                    const __grid_constant__ CUtensorMap map_u, const float* __restrict__ row_scale,
                    const bf16* __restrict__ cs_g, const bf16* __restrict__ cs_u, const float* __restrict__ out_scale,
                    int8_t* __restrict__ out, int M, int N, int k_tiles) {
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    // d[4 j + 2 h + e] is gate and d[4 (j + BN / 8) + 2 h + e] up of column n0 + 8 j + 2 t + e (j < 8)
    s8gemm::tile<STAGES>(&map_x, &map_g, &map_u, m0, n0, k_tiles, row_scale, M,
                         [&](const int (&d)[64], const int (&rows)[2], const float (&rs)[2], int t) {
        const float inv = __fdiv_rn(1.f, out_scale[0]);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            const float sg[2] = {__bfloat162float(cs_g[col]), __bfloat162float(cs_g[col + 1])};
            const float su[2] = {__bfloat162float(cs_u[col]), __bfloat162float(cs_u[col + 1])};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (rows[h] >= M) continue;
                uint32_t packed = 0;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float gv = __fmul_rn(__fmul_rn((float)d[4 * j + 2 * h + e], rs[h]), sg[e]);
                    const float uv = __fmul_rn(__fmul_rn((float)d[4 * (j + BN / 8) + 2 * h + e], rs[h]), su[e]);
                    const float q = fminf(fmaxf(rintf(__fmul_rn(__fmul_rn(silu(gv), uv), inv)), -127.f), 127.f);
                    packed |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * e);
                }
                *reinterpret_cast<uint16_t*>(out + (size_t)rows[h] * N + col) = (uint16_t)packed;
            }
        }
    });
}

}  // namespace

// N a multiple of 64 and K of 128 (the wrapper asks N % 128, the JAX
// package's gate); xq, wg and wu contiguous with 16-byte-aligned bases, as
// their TMA maps need.
extern "C" int omchat_swiglu_quant(const void* xq, const void* wg, const void* wu, const void* row_scale,
                                   const void* cs_g, const void* cs_u, const void* out_scale, void* out, int M,
                                   int N, int K, void* stream) {
    if (M <= 0 || N <= 0 || K <= 0 || N % BN != 0 || K % s8gemm::BK != 0) return (int)cudaErrorInvalidValue;
    CUtensorMap map_x, map_g, map_u;
    if (!s8gemm::matrix_map(&map_x, xq, M, K, BM) || !s8gemm::matrix_map(&map_g, wg, N, K, BN) ||
        !s8gemm::matrix_map(&map_u, wu, N, K, BN))
        return (int)cudaErrorInvalidValue;
    return s8gemm::launch<STAGES>(swiglu_quant_kernel, dim3((M + BM - 1) / BM, N / BN), (cudaStream_t)stream,
                                  map_x, map_g, map_u, (const float*)row_scale, (const bf16*)cs_g, (const bf16*)cs_u,
                                  (const float*)out_scale, (int8_t*)out, M, N, K / s8gemm::BK);
}
