// Hopper (sm_90a) building blocks: TMA tile loads completing on mbarriers and
// wgmma on 128-byte-swizzled shared tiles.  Users: K16b and K16c
// (flash_attention_bwd.cu) and the forward mainloop of flash_fwd_sm90.cuh,
// which K1 and K5 (packed_qkv_norm_attention.cu), K2 (flash_attention.cu),
// K14 (paged_flash_prefill.cu) and K16a (flash_attention_bwd.cu) run; the
// int8 mainloop of s8_gemm_sm90.cuh (K9, K10, K11) builds on the
// descriptor, the TMA map encoder and the barriers; K12 and K13
// (paged_decode_split.cuh) take the mbarrier helpers alone.
//
// The shared tile: R rows of a head-width-128 bf16 matrix, stored as two
// 64-column halves ([2][R][64], half h at h * R * 128 bytes), each written by
// one TMA box with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r
// lies at chunk c ^ (r % 8) of its 128-byte row.  Every half starts on a
// 1024-byte boundary (the swizzle atom is 8 rows x 128 bytes).
//
// wgmma descriptors over such a tile (PTX ISA, "Matrix Descriptor Format";
// 14-bit fields in 16-byte units):
//   K-major (the reduction runs along the 128 columns; A or B^T):
//     start = half (k / 64) + row * 128 + (k % 64) * 2 bytes, SBO = 1024
//     (from one 8-row group to the next), LBO unused;
//   MN-major (the reduction runs along the rows, B of P V; transpose bit):
//     start = row * 128 bytes, LBO = R * 128 (from one 64-column half to the
//     next, along N), SBO = 1024 (from one 8-row group to the next, along K).
// chip_probes/wgmma_desc_probe.py checks both against torch.matmul.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int SWIZZLE_ATOM = 1024;  // bytes: 8 rows x 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and the other threads.
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of asynchronous transactions.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    return done != 0;
}

// Blocks until the phase with the given parity has completed.  A wait that
// outlasts MBAR_TIMEOUT_CYCLES (about 10 s) traps, so that a lost arrival
// ends the launch with an error instead of hanging the card.
constexpr long long MBAR_TIMEOUT_CYCLES = 20000000000ll;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    if (mbar_try_wait(bar, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try_wait(bar, parity))
        if (clock64() - t0 > MBAR_TIMEOUT_CYCLES) __trap();
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a rank-4 tensor map into shared memory, completing on `bar`.
// Coordinates are innermost first; rows past the tensor's extent read zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
        "[%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Makes this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma operands read from shared memory), before a barrier.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// A barrier among `count` threads (whole warps) of the block on hardware
// barrier `id` (0 is __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// A 128-byte-swizzle descriptor; addresses and offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: rows [row, row + 64 or N) and columns [16 kk, 16 kk + 16)
// of a tile of `rows` rows at `tile` (shared address).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows, int row, int kk) {
    return desc_sw128(tile + (kk >> 2) * rows * 128 + row * 128 + (kk & 3) * 32, 16, SWIZZLE_ATOM);
}

// MN-major B operand: rows [16 kk, 16 kk + 16) (the reduction) by all 128
// columns (N) of a tile of `rows` rows.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows, int kk) {
    return desc_sw128(tile + kk * 16 * 128, rows * 128, SWIZZLE_ATOM);
}

// Orders this thread's register writes (accumulators, A fragments) before the
// wgmma that read them.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma_wait (the asm statements above do not name the registers).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of m64nN (fp32), per warp w of the group and with
// g = lane / 4, t = lane % 4: d[4 j + e] = D[16 w + g + 8 (e / 2)][8 j + 2 t + e % 2].

// d (64 x 64, fp32) = (accumulate ? d : 0) + A (64 x 16) B^T (B 64 x 16), both
// K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, fp32) = (accumulate ? d : 0) + A (64 x 16) B^T (B 128 x 16), both
// K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, fp32) = (accumulate ? d : 0) + A (64 x 16) B (16 x 128): A in
// registers (per warp, the m16n8k16 A fragment of its 16 rows), B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                    int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so that
// the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// A rank-4 map over x[d3][d2][d1][width] of `elem_bytes`-byte elements (bf16:
// 2, e4m3 as uint8: 1) with row strides s1, s2, s3 (elements), read in boxes
// of 128 bytes of columns x 1 x `rows` x 1 with the 128-byte swizzle.  A box
// that reaches past column `width` (a head narrower than 128) gets zeros there,
// not the next head's columns.  Returns
// false if cuTensorMapEncodeTiled refuses it (a base not 16-byte aligned, a stride not a
// multiple of 16 bytes).
inline bool rows_map(CUtensorMap* map, const void* x, int elem_bytes, uint64_t d1, uint64_t d2, uint64_t d3,
                     uint64_t s1, uint64_t s2, uint64_t s3, uint32_t rows, uint64_t width = 128) {
    EncodeTiledFn fn = encode_tiled();
    if (!fn) return false;
    const cuuint64_t dims[4] = {width, d1, d2, d3};
    const cuuint64_t strides[3] = {s1 * elem_bytes, s2 * elem_bytes, s3 * elem_bytes};
    const cuuint32_t box[4] = {128u / elem_bytes, 1, rows, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUtensorMapDataType dt = elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
    return fn(map, dt, 4, const_cast<void*>(x), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
