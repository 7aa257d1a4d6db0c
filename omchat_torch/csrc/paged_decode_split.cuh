// The split-KV paged decode that K12 (paged_flash_decode.cu) and K13
// (paged_flash_decode_manual.cu) share: everything but the copies.
//
// The function (omchat_tpu/ops/paged_attention.py:110 paged_flash_decode and
// :270 paged_flash_decode_manual compute the same one):
//   q            [B, H, D] bf16 (the [B, 1, H, D] query)
//   k/v_pages    [NP, KVH, PS, D] page-major pool (PS 16, 32, 64 or 128),
//                bf16 or e4m3; a layered pool [L, P+1, ...] is passed flat and
//                `page_offset` (the layer's first page) is added to every
//                table entry
//   lengths      [B] int32 valid rows, EXCLUDING the in-flight token
//   tables       [B, *] int32 rows of `table_stride`, `width` entries used
//   k_new/v_new  [B, KVH, D] bf16 the self column, or null (no self column)
//   out          [B, H, D] bf16
//   scratch      fp32 [B * H * splits * (D + 2)] from the wrapper
// D, the head width, a multiple of 8 from 8 to 128 (bf16) or of 16 from 16
// to 128 (e4m3): the kernels are built for the padded widths 32, 64, 96 and
// 128 and take D at run time, as K3 does (flash_decode_stacked.cu): the
// ring's columns D .. DP - 1 zeroed once a block, q's in registers, only
// the D columns below it stored, the scale D^-0.5.
// And the split: `splits` chunks of `rows` rows (a multiple of STAGE_ROWS)
// covering the capacity width * PS, chosen on the host from the capacity,
// never from the lengths on the card (ops/paged_attention.py:paged_splits).
// An e4m3 pool is widened to bf16 in registers; p and the self column go
// into the products as bf16, as the TPU kernels cast the pages to q's dtype.
//
// A block per (chunk, kv head, request), grid (splits, KVH, B), of WARPS
// warps: CONSUMERS consumer warps and one producer warp, which fills a ring
// of NBUF stages in shared memory.  A stage is 64 cache rows of the block's
// kv head, K then V, each row in a padded shared row (DP + 16 bytes' worth:
// the mma operand loads meet no bank conflicts); a row past the request's
// length holds a copy of its last valid row, and its column is masked.  The
// kernels differ only in how the producer fills a stage (K12: 16-byte
// cp.async from every lane; K13: a bulk copy a row), so what a stage holds,
// and every sum from there on, is the same in both: consume_chunk below is
// their one consumer, and the two kernels compute the same bits.
//
// The consumers: each scores all 64 columns of a stage (the GQA group's q
// rows as one mma.sync row tile, attend_tile) and keeps DP / CONSUMERS of the
// output columns, then writes the block's fp32 (m, l, acc) into the scratch
// (store_split_state).  The merge (split_merge_kernel in common.cuh,
// launched by launch() as the split kernel's programmatic dependent) merges
// a q head's chunks in a fixed order, folds the self column in after the
// merge and normalises: a second launch gives the same bits.  A chunk wholly
// past the request's length copies nothing and writes an empty state (m =
// -inf, l = 0), so a request of length 0 returns exactly v_new.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace paged_split {

constexpr int STAGE_ROWS = 64;        // cache rows per stage; a chunk's rows are a multiple of it
constexpr int CONSUMERS = 2;          // consumer warps, each 1 / CONSUMERS of the output columns
constexpr int WARPS = CONSUMERS + 1;  // and one producer warp
constexpr int MAX_GROUP = 16;         // q rows of the mma tile (the GQA group, padded)
constexpr int MERGE_WARPS = 2;        // warps of a merge block (one q head)
constexpr int MERGE_PER = 4;          // splits a merge warp loads in one pass

// Ring depth: 3 stages in bf16 (102 KiB, two blocks an SM), 4 in e4m3 (72 KiB).
template <typename E>
struct Ring;
template <>
struct Ring<bf16> {
    static constexpr int NBUF = 3;
};
template <>
struct Ring<e4m3> {
    static constexpr int NBUF = 4;
};

// A stage of padded width DP (padded_width in common.cuh): each row holds the
// head's d columns, zeros up to DP, then 16 bytes of bank spread.
template <int DP, typename E>
struct Stage {
    static constexpr int NBUF = Ring<E>::NBUF;
    static constexpr int LD = DP + 16 / (int)sizeof(E);  // padded shared row (bank spread), 16-byte aligned
    static constexpr int ELEMS = STAGE_ROWS * LD;       // values of K (or V) in a stage
    static constexpr size_t SMEM = (size_t)NBUF * 2 * ELEMS * sizeof(E);  // [NBUF][K, V][STAGE_ROWS][LD]
};

// The block's chunk: rows [begin, end) of the `len` its request's table maps,
// in `stages` stages; m_out / l_out / acc_out its partial rows in the scratch.
struct Chunk {
    int len, begin, end, stages;
    float *m_out, *l_out, *acc_out;
};

__device__ __forceinline__ Chunk block_chunk(const int* lengths, float* scratch, int B, int H, int KVH, int PS,
                                             int width, int rows, int d) {
    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int splits = gridDim.x, group = H / KVH;
    const size_t n = (size_t)B * KVH * splits * group;
    const size_t r0 = (((size_t)b * KVH + kvh) * splits + split) * group;  // the block's first partial row
    Chunk c;
    c.len = min(lengths[b], width * PS);  // the columns the table maps
    c.begin = split * rows;
    c.end = min(c.begin + rows, c.len);
    c.stages = c.begin < c.end ? (c.end - c.begin + STAGE_ROWS - 1) / STAGE_ROWS : 0;
    c.m_out = scratch + n * d + r0;
    c.l_out = c.m_out + n;
    c.acc_out = scratch + r0 * d;
    return c;
}

// A chunk past the request's length writes its empty state and reports true.
__device__ __forceinline__ bool empty_chunk(const Chunk& c, int group) {
    if (c.stages > 0) return false;
    for (int gi = threadIdx.x; gi < group; gi += blockDim.x) {
        c.m_out[gi] = -INFINITY;
        c.l_out[gi] = 0.f;
    }
    return true;
}

// Zero the ring's columns d .. DP - 1 (no copy writes them), by every thread
// of the block before the __syncthreads after init_ring.
template <int DP, typename E>
__device__ __forceinline__ void zero_ring_padding(E* ring, int d) {
    using St = Stage<DP, E>;
    zero_pad_columns<DP>(ring, St::NBUF * 2 * STAGE_ROWS, St::LD, d);
}

// Barrier setup by thread 0, before a __syncthreads: full[s] completes when
// `full_count` arrivals (and their announced bytes) have landed a stage,
// empty[s] when every consumer warp is done with it.
template <int NBUF>
__device__ __forceinline__ void init_ring(uint64_t (&full)[NBUF], uint64_t (&empty)[NBUF], int full_count) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < NBUF; ++s) {
            sm90::mbar_init(&full[s], full_count);
            sm90::mbar_init(&empty[s], CONSUMERS);
        }
        sm90::mbar_fence_init();
    }
}

// The pool offset (elements) of row `row` of the chunk's request and kv head,
// clamped to the request's last valid row.
__device__ __forceinline__ size_t row_src(const int* table, const Chunk& c, int row, int PS, size_t page_elems,
                                          size_t head_off, int page_offset, int d) {
    row = min(row, c.len - 1);
    return (size_t)(table[row / PS] + page_offset) * page_elems + head_off + (size_t)(row % PS) * d;
}

// The consumer warps (warp < CONSUMERS) of either kernel: the chunk's
// stages in order from the ring, then the block's split state.  Warp w
// keeps output columns [w DP / CONSUMERS, (w + 1) DP / CONSUMERS), those
// below d reaching the scratch.
template <int DP, typename E>
__device__ __forceinline__ void consume_chunk(const bf16* __restrict__ q, const E* ring, const Chunk& c,
                                              uint64_t* full, uint64_t* empty, int H, int KVH, float scale_log2,
                                              int d) {
    using St = Stage<DP, E>;
    constexpr int DV = DP / CONSUMERS;
    const int kvh = blockIdx.y, b = blockIdx.z, group = H / KVH;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // the group's q rows (rows >= group are zero) as one mma row tile
    uint32_t qa[DP / 16][4];
    load_q_group<DP>(qa, q + ((size_t)b * H + (size_t)kvh * group) * d, group, d);
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[DV / 8][4];
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    for (int p = 0; p < c.stages; ++p) {
        const int s = p % St::NBUF;
        sm90::mbar_wait(&full[s], (p / St::NBUF) & 1);
        const int c0 = c.begin + p * STAGE_ROWS;
        const E* ks = ring + (size_t)s * 2 * St::ELEMS;
        auto mask = [&](int, int col, float sc) { return c0 + col < c.end ? sc * scale_log2 : OMCHAT_MASK_VALUE; };
        attend_tile<DP, STAGE_ROWS, DV>(qa, ks, ks + St::ELEMS + warp * DV, St::LD, m, l, acc, mask);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
    // m and l are the same in both warps (the same scores in the same order): warp 0 writes them
    store_split_state<DV>(m, l, acc, group, warp * DV, warp == 0, c.m_out, c.l_out, c.acc_out, d);
}

// Host: check the shape, launch the split kernel on grid (splits, KVH, B) and
// the merge as its programmatic dependent; returns a cudaError_t.
template <typename E>
using SplitKernel = void (*)(const bf16*, const E*, const E*, const int*, const int*, float*, int, int, int, int, int,
                             int, int, int, int, float);

template <int DP, typename E, bool EXACT>
int launch(SplitKernel<E> kernel, const void* q, const void* k_pages, const void* v_pages, const void* lengths,
           const void* tables, const void* k_new, const void* v_new, void* out, void* scratch, int B, int H, int KVH,
           int PS, int D, int table_stride, int width, int page_offset, int splits, int rows, void* stream) {
    if (KVH <= 0 || H % KVH != 0 || H / KVH > MAX_GROUP) return (int)cudaErrorInvalidValue;
    if (!split_width_ok(D, DP, (int)sizeof(E)) || !(PS == 16 || PS == 32 || PS == 64 || PS == 128))
        return (int)cudaErrorInvalidValue;
    if (splits < 1 || rows < STAGE_ROWS || rows % STAGE_ROWS != 0 || (long long)splits * rows < (long long)width * PS)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    constexpr size_t smem = Stage<DP, E>::SMEM;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);  // the true width's softmax scale
    cudaStream_t s = (cudaStream_t)stream;
    kernel<<<dim3(splits, KVH, B), 32 * WARPS, smem, s>>>((const bf16*)q, (const E*)k_pages, (const E*)v_pages,
                                                          (const int*)lengths, (const int*)tables, (float*)scratch, B,
                                                          H, KVH, PS, D, table_stride, width, page_offset, rows,
                                                          scale_log2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_merge_dependent(split_merge_kernel<MERGE_WARPS, MERGE_PER, EXACT ? DP : 0>, dim3(H, B),
                                       dim3(32 * MERGE_WARPS), s, (const float*)scratch, (const bf16*)q,
                                       (const bf16*)k_new, (const bf16*)v_new, (bf16*)out, B, KVH, splits, H / KVH,
                                       scale_log2, D);
}

// The split kernel of padded width padded_width(D), or width 128's own,
// KERNEL<DP, E, EXACT>::fn(), launched (a width none takes is refused by
// launch).
template <template <int, typename, bool> class KERNEL, typename E, typename... A>
int launch_width(int D, A... a) {
    switch (D == 128 ? 0 : padded_width(D)) {
        case 0: return launch<128, E, true>(KERNEL<128, E, true>::fn(), a...);
        case 32: return launch<32, E, false>(KERNEL<32, E, false>::fn(), a...);
        case 64: return launch<64, E, false>(KERNEL<64, E, false>::fn(), a...);
        case 96: return launch<96, E, false>(KERNEL<96, E, false>::fn(), a...);
        default: return launch<128, E, false>(KERNEL<128, E, false>::fn(), a...);
    }
}

}  // namespace paged_split
