// The int8 GEMM mainloop for Hopper (sm_90a): A [M, K] and B [N, K] int8,
// both K-major as stored, through TMA into 128-byte-swizzled shared tiles and
// wgmma.mma_async m64n128k32 s32.s8.s8 into int32 accumulators, over an
// mbarrier ring fed by one producer thread; tile() is a block's whole body
// up to its epilogue.  Users: K11 (proj_glue_quant.cu), K9
// (fc1_gelu_quant.cu) and K10 (swiglu_quant.cu, whose B stage is two
// matrices: produce's map_b_hi); each keeps only its epilogue and its grid.
//
// A stage holds BK = 128 values of K: one 128-byte row per matrix row, which
// is one swizzle row, so a tile of R rows is R x 128 bytes, [R / 8] swizzle
// atoms of 1024 bytes (every tile starts on a 1024-byte boundary).  TMA writes
// it with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r lies at
// chunk c ^ (r % 8) of its row.  One wgmma takes k32, 32 bytes of a row: the
// K-major descriptor of rows [row, row + 64 or 128) and K bytes [32 kk, 32 kk +
// 32) starts at tile + row * 128 + kk * 32 bytes, SBO = 1024 (from one 8-row
// group to the next), LBO unused, as sm90.cuh's bf16 descriptor over one
// 64-column half (the same 128-byte rows, 16 bf16 to the 32 bytes).
// chip_probes/wgmma_desc_probe.py (mode 4) checks it against torch._int_mm.
//
// int8 products are exact in int32 (K * 127^2 < 2^31 for K < 133,000), so
// the order of the K steps does not change a bit of the result.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace s8gemm {

constexpr int BK = 128;  // K values (bytes) a stage: one 128-byte swizzle row

// The ring of one block: STAGES stages of a BM-row A tile and a BN-row B
// tile, and their barriers.  Place it on a 1024-byte boundary.
template <int BM, int BN, int STAGES>
struct Ring {
    static_assert(BM % 64 == 0 && BN % 8 == 0, "a tile is whole swizzle atoms, A whole wgmma row blocks");
    alignas(1024) int8_t a[STAGES][BM * BK];
    alignas(1024) int8_t b[STAGES][BN * BK];
    uint64_t full[STAGES];   // a stage's two tiles have landed
    uint64_t empty[STAGES];  // every consumer warp is done with a stage
};

// d (64 x 128, s32) = (accumulate ? d : 0) + A (64 x 32) B^T (B 128 x 32), both
// K-major s8 in shared memory.  Accumulator layout as m64nNk16's (sm90.cuh):
// per warp w of the group, g = lane / 4, t = lane % 4,
// d[4 j + e] = D[16 w + g + 8 (e / 2)][8 j + 2 t + e % 2].
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Keeps the compiler from moving accumulator reads or writes across a wgmma wait.
template <int N>
__device__ __forceinline__ void reg_fence(int (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// K-major descriptor of rows [row, ...) and K bytes [32 kk, 32 kk + 32) of a
// tile at shared address `tile` (kk < 4).
__device__ __forceinline__ uint64_t desc(uint32_t tile, int row, int kk) {
    return sm90::desc_sw128(tile + row * 128 + kk * 32, 16, sm90::SWIZZLE_ATOM);
}

// One box of a rank-2 map into shared memory at (c0, c1) = (K byte, row),
// completing on `bar`; rows past the matrix read zeros (and still count their
// bytes).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
            "r"(sm90::smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

// Thread 0 initialises the ring's barriers (the caller synchronises after):
// full takes one arrival (the producer's, with the bytes), empty one from
// each of `consumer_warps` warps.
template <int BM, int BN, int STAGES>
__device__ __forceinline__ void init(Ring<BM, BN, STAGES>& r, int consumer_warps) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            sm90::mbar_init(&r.full[s], 1);
            sm90::mbar_init(&r.empty[s], consumer_warps);
        }
        sm90::mbar_fence_init();
    }
}

// The producer, one thread: the k_tiles K tiles of A rows [m0, m0 + BM) and
// B rows [n0, n0 + BN), each stage once every consumer warp has released it.
// With map_b_hi, a B stage is two boxes of BN / 2 rows from two matrices:
// rows [n0, n0 + BN / 2) of map_b into the tile's first BN / 2 rows and the
// same rows of map_b_hi into its last BN / 2 (both maps built with box_rows
// BN / 2).  A half is whole swizzle atoms, so the second box starts on a
// 1024-byte boundary and the swizzle holds across it.
template <int BM, int BN, int STAGES>
__device__ __forceinline__ void produce(Ring<BM, BN, STAGES>& r, const CUtensorMap* map_a, const CUtensorMap* map_b,
                                        int m0, int n0, int k_tiles, const CUtensorMap* map_b_hi = nullptr) {
    static_assert(BN % 16 == 0, "each half of a split B tile is whole swizzle atoms");
    sm90::tma_prefetch_map(map_a);
    sm90::tma_prefetch_map(map_b);
    if (map_b_hi) sm90::tma_prefetch_map(map_b_hi);
    for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) sm90::mbar_wait(&r.empty[s], (kt / STAGES - 1) & 1);
        sm90::mbar_arrive_expect_tx(&r.full[s], (BM + BN) * BK);
        tma_load_2d(r.a[s], map_a, &r.full[s], kt * BK, m0);
        tma_load_2d(r.b[s], map_b, &r.full[s], kt * BK, n0);
        if (map_b_hi) tma_load_2d(r.b[s] + BN / 2 * BK, map_b_hi, &r.full[s], kt * BK, n0);
    }
}

// A consumer warpgroup: d = rows [row0, row0 + 64) of A times the BN = 128
// rows of B, over all k_tiles stages.  One stage's wgmma stay in flight while
// the next stage's are issued; a stage is released once its wgmma are done.
template <int BM, int STAGES>
__device__ __forceinline__ void consume(int (&d)[64], Ring<BM, 128, STAGES>& r, int row0, int k_tiles) {
    const int lane = threadIdx.x & 31;
    for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        sm90::mbar_wait(&r.full[s], (kt / STAGES) & 1);
        const uint32_t ta = sm90::smem_u32(r.a[s]), tb = sm90::smem_u32(r.b[s]);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) wgmma_m64n128k32_s8(d, desc(ta, row0, kk), desc(tb, 0, kk), kt > 0 || kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous stage's wgmma are done
        reg_fence(d);
        if (kt > 0 && lane == 0) sm90::mbar_arrive(&r.empty[(kt - 1) % STAGES]);
    }
    sm90::wgmma_wait<0>();
    reg_fence(d);
}

// The block of a 128-row output tile: CONSUMER_WARPS warps in two consumer
// warpgroups of 64 tile rows each, and a producer warp.
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);

// The body of a block over the tile at rows [m0, m0 + 128) of A and B stage
// rows [n0, ...) (map_b_hi as in produce), with a ring of STAGES stages in
// the dynamic shared memory (launch: below).  The producer warp feeds the
// ring and returns; each consumer thread runs consume and hands its
// accumulators to epi(d, rows, rs, t): thread (w, g, t) of its warpgroup
// (g = lane / 4, t = lane % 4) holds tile rows 16 w + g (h = 0) and 16 w + g
// + 8 (h = 1), which are rows[h] of A, with their row_scale in rs[h] (0 past
// M; the epilogue stores no row past M), in d[4 j + 2 h + e], the product
// with B stage row 8 j + 2 t + e (j < 16, e < 2).
template <int STAGES, class Epilogue>
__device__ __forceinline__ void tile(const CUtensorMap* map_a, const CUtensorMap* map_b, const CUtensorMap* map_b_hi,
                                     int m0, int n0, int k_tiles, const float* __restrict__ row_scale, int M,
                                     Epilogue&& epi) {
    extern __shared__ unsigned char smem_raw[];
    using R = Ring<128, 128, STAGES>;
    R& r = *reinterpret_cast<R*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    init(r, CONSUMER_WARPS);
    __syncthreads();
    if (warp == CONSUMER_WARPS) {
        if (lane == 0) produce(r, map_a, map_b, m0, n0, k_tiles, map_b_hi);
        return;
    }

    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    const int row0 = (warp >> 2) * 64;  // the warpgroup's rows of the tile
    consume(d, r, row0, k_tiles);

    const int g = lane >> 2, t = lane & 3;
    int rows[2];
    float rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        rows[h] = m0 + row0 + 16 * (warp & 3) + g + 8 * h;
        rs[h] = rows[h] < M ? row_scale[rows[h]] : 0.f;
    }
    epi(d, rows, rs, t);
}

// Host: launches `kernel`, whose body is tile<STAGES>, over `grid` on
// `stream`, with the ring's dynamic shared memory (and room to align it to
// 1024 bytes).
template <int STAGES, class... Params, class... Args>
inline int launch(void (*kernel)(Params...), dim3 grid, cudaStream_t stream, Args... args) {
    constexpr int smem = (int)sizeof(Ring<128, 128, STAGES>) + 1024;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kernel<<<grid, THREADS, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

// Host: a rank-2 map over an int8 matrix [rows, cols] (row stride `cols`
// bytes, a multiple of 16; base 16-byte aligned), read in boxes of 128 bytes
// of columns x box_rows rows with the 128-byte swizzle.  False if
// cuTensorMapEncodeTiled refuses it.
inline bool matrix_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols, uint32_t box_rows) {
    sm90::EncodeTiledFn fn = sm90::encode_tiled();
    if (!fn) return false;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {cols};
    const cuuint32_t box[2] = {(cuuint32_t)BK, box_rows};
    const cuuint32_t estr[2] = {1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, estr,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace s8gemm
