// Paged decode with the in-flight token as a self column, its pages streamed
// through a ring of bulk asynchronous copies: the manual-copy variant of the
// serving engine's decode attention (--decode-kernel manual).
//
// Replaces the TPU kernel omchat_tpu/ops/paged_attention.py:270
// paged_flash_decode_manual (body _paged_decode_manual_kernel :196,
// pallas_call :327; the fold is omchat_tpu/ops/online_softmax.py:64).
//
// The function is K12's (paged_flash_decode.cu):
//   q            [B, H, D] bf16 (the [B, 1, H, D] query)
//   k/v_pages    [NP, KVH, PS, D] page-major pool (PS 16, 32, 64 or 128), bf16 or, through
//                omchat_paged_flash_decode_manual_e4m3, e4m3; a layered pool
//                [L, P+1, ...] is passed flat and `page_offset` (the layer's
//                first page) is added to every table entry
//   lengths      [B] int32 valid rows, EXCLUDING the in-flight token
//   tables       [B, *] int32 rows of `table_stride`, `width` entries used
//   k_new/v_new  [B, KVH, D] bf16 the self column, or null (no self column)
//   out          [B, H, D] bf16
// and, unlike K12's entry, `scratch`, fp32 [B * H * splits * (D + 2)] from
// the wrapper, and the split: `splits` chunks of `rows` rows (a multiple of
// 64) covering the capacity width * PS (ops/paged_attention.py:manual_splits,
// chosen on the host from the capacity, never from the lengths on the card).
// An e4m3 pool is widened to bf16 in registers; p and the self column go into
// the products as bf16, as the TPU kernel casts the pages to q's dtype
// (paged_attention.py:247,250).
//
// What sets it apart from K12 is the copy schedule.  The TPU kernel walks a
// request's page list with NBUF = 4 pages in flight through
// pltpu.make_async_copy and DMA semaphores (paged_attention.py:225-258).  Here
// one producer warp does the same with the TMA engine's bulk copies
// (cp.async.bulk, completing on an mbarrier): it keeps a ring of NBUF stages
// in shared memory filled while the consumer warps run the online softmax on
// the stage that has landed, and each consumer warp releases a stage through
// a second mbarrier.
//
// What bounds it on the H100: bytes (~27 MB of K/V a layer at the serving
// workload's mid-decode point in bf16, ~8 us at 3.35 TB/s; half in e4m3).
//
// Design (split-KV, as K3 in flash_decode_stacked.cu).  A block per (chunk,
// kv head, request): grid (splits, KVH, B), so that the longest request's
// rows spread over many SMs instead of setting the time from one.  A stage
// is 64 cache rows of one kv head, each row bulk-copied (K and V, 256 bytes
// each in bf16) into a padded shared row (row stride D + 16 bytes' worth, so
// the mma operand loads meet no bank conflicts, as K3's): lane 0 of the
// producer warp waits for the stage to be free and announces its bytes, then
// each of the 32 lanes copies two rows.  A row's page is looked up from the
// table per row, so chunks, stages and their order are fixed in rows, not
// pages, and every page size computes the same bits; a row past the
// request's length re-reads its last valid row (the column is masked), so
// every stage completes the same transaction count.  NBUF = 3 stages in bf16
// (102 KiB, two blocks an SM), 4 in e4m3 (72 KiB).  A chunk wholly past the
// request's length issues no copy, waits on no barrier and writes an empty
// state (m = -inf, l = 0).  Two consumer warps each score all 64 columns of
// a stage (the GQA group's q rows as one mma.sync row tile, attend_tile) and
// keep 64 of the 128 output columns (K3's finding: no merge across warps),
// then write the block's fp32 (m, l, acc) into the scratch
// (store_split_state).  The merge (split_merge_kernel in common.cuh,
// launched from the same entry as the split kernel's programmatic dependent)
// merges a q head's chunks in a fixed order, folds the self column in after
// the merge and normalises, as K3's: a second launch gives the same bits.
// A block's stages wait on their copies one after another (~4-6 us a stage
// on the H100 whatever the copy size or the consumers' work, PERF.md), so the
// host keeps chunks to at most 4 stages (ops/paged_attention.py).
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int STAGE_ROWS = 64;         // cache rows per stage; a chunk's rows are a multiple of it
constexpr int CONSUMERS = 2;           // consumer warps, each 1 / CONSUMERS of the output columns
constexpr int WARPS = CONSUMERS + 1;   // and one producer warp
constexpr int MAX_GROUP = 16;          // q rows of the mma tile (the GQA group, padded)
constexpr int MERGE_WARPS = 2;         // warps of a merge block (one q head)
constexpr int MERGE_PER = 4;           // splits a merge warp loads in one pass

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

// One bulk copy global -> shared by the TMA engine (16-byte aligned, a
// multiple of 16 bytes), completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            sm90::smem_u32(smem)),
        "l"(gmem), "r"(bytes), "r"(sm90::smem_u32(bar))
        : "memory");
}

template <int D, typename E>
__global__ void __launch_bounds__(32 * WARPS)
manual_split_kernel(const bf16* __restrict__ q, const E* __restrict__ k_pages, const E* __restrict__ v_pages,
                    const int* __restrict__ lengths, const int* __restrict__ tables, float* __restrict__ scratch,
                    int B, int H, int KVH, int PS, int table_stride, int width, int page_offset, int rows,
                    float scale_log2) {
    constexpr int NBUF = Ring<E>::NBUF;
    constexpr int LD = D + 16 / (int)sizeof(E);  // padded shared row (bank spread), 16-byte aligned
    constexpr int STAGE = STAGE_ROWS * LD;        // values of K (or V) in a stage
    constexpr unsigned ROW_BYTES = D * sizeof(E);
    constexpr int DV = D / CONSUMERS;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    E* ring = reinterpret_cast<E*>(smem_raw);       // [NBUF][K, V][STAGE_ROWS][LD]
    __shared__ __align__(8) uint64_t full[NBUF];   // a stage's copies have landed
    __shared__ __align__(8) uint64_t empty[NBUF];  // every consumer warp is done with a stage

    trigger_merge_launch();  // the merge blocks may start; they wait for these stores
    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int splits = gridDim.x, group = H / KVH;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t n = (size_t)B * KVH * splits * group;
    const size_t r0 = (((size_t)b * KVH + kvh) * splits + split) * group;  // the block's first partial row
    float* m_out = scratch + n * D + r0;
    float* l_out = m_out + n;
    const int len = min(lengths[b], width * PS);  // the columns the table maps
    const int c_begin = split * rows;
    const int c_end = min(c_begin + rows, len);
    if (c_begin >= c_end) {  // the chunk lies past the request's length
        for (int gi = threadIdx.x; gi < group; gi += blockDim.x) {
            m_out[gi] = -INFINITY;
            l_out[gi] = 0.f;
        }
        return;
    }
    const int n_stages = (c_end - c_begin + STAGE_ROWS - 1) / STAGE_ROWS;

    if (threadIdx.x == 0) {
        for (int s = 0; s < NBUF; ++s) {
            sm90::mbar_init(&full[s], 1);
            sm90::mbar_init(&empty[s], CONSUMERS);
        }
        sm90::mbar_fence_init();
    }
    __syncthreads();

    if (warp == CONSUMERS) {
        // Producer: lane 0 waits for the stage and announces its bytes, then
        // every lane copies rows lane, lane + 32 of K and of V.
        const int* table = tables + (size_t)b * table_stride;
        const size_t head_off = (size_t)kvh * PS * D;
        const size_t page_elems = (size_t)KVH * PS * D;
        for (int p = 0; p < n_stages; ++p) {
            const int s = p % NBUF;
            if (lane == 0) {
                if (p >= NBUF) sm90::mbar_wait(&empty[s], (p / NBUF - 1) & 1);
                sm90::mbar_arrive_expect_tx(&full[s], 2 * STAGE_ROWS * ROW_BYTES);
            }
            __syncwarp();
            E* kd = ring + (size_t)s * 2 * STAGE;
            for (int r = lane; r < STAGE_ROWS; r += 32) {
                // a row past the length re-reads the last valid one: its column is masked
                const int row = min(c_begin + p * STAGE_ROWS + r, len - 1);
                const size_t src = (size_t)(table[row / PS] + page_offset) * page_elems + head_off + (size_t)(row % PS) * D;
                bulk_copy(kd + r * LD, k_pages + src, ROW_BYTES, &full[s]);
                bulk_copy(kd + STAGE + r * LD, v_pages + src, ROW_BYTES, &full[s]);
            }
        }
        return;
    }

    // Consumers: the group's q rows (rows >= group are zero) as one mma row
    // tile; each warp scores every column of a stage and keeps DV output
    // columns from warp * DV on.
    uint32_t qa[D / 16][4];
    load_q_group<D>(qa, q + ((size_t)b * H + (size_t)kvh * group) * D, group);
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[DV / 8][4];
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    for (int p = 0; p < n_stages; ++p) {
        const int s = p % NBUF;
        sm90::mbar_wait(&full[s], (p / NBUF) & 1);
        const int c0 = c_begin + p * STAGE_ROWS;
        const E* ks = ring + (size_t)s * 2 * STAGE;
        auto mask = [&](int, int col, float sc) { return c0 + col < c_end ? sc * scale_log2 : OMCHAT_MASK_VALUE; };
        attend_tile<D, STAGE_ROWS, DV>(qa, ks, ks + STAGE + warp * DV, LD, m, l, acc, mask);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
    // m and l are the same in both warps (the same scores in the same order): warp 0 writes them
    store_split_state<D, DV>(m, l, acc, group, warp * DV, warp == 0, m_out, l_out, scratch + r0 * D);
}

template <int D, typename E>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* lengths, const void* tables,
           const void* k_new, const void* v_new, void* out, void* scratch, int B, int H, int KVH, int PS, int D_arg,
           int table_stride, int width, int page_offset, int splits, int rows, void* stream) {
    if (KVH <= 0 || H % KVH != 0 || H / KVH > MAX_GROUP) return (int)cudaErrorInvalidValue;
    if (D_arg != D || !(PS == 16 || PS == 32 || PS == 64 || PS == 128)) return (int)cudaErrorInvalidValue;
    if (splits < 1 || rows < STAGE_ROWS || rows % STAGE_ROWS != 0 || (long long)splits * rows < (long long)width * PS)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    constexpr size_t smem = (size_t)Ring<E>::NBUF * 2 * STAGE_ROWS * (D + 16 / sizeof(E)) * sizeof(E);
    cudaFuncSetAttribute(manual_split_kernel<D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
    cudaStream_t s = (cudaStream_t)stream;
    manual_split_kernel<D, E><<<dim3(splits, KVH, B), 32 * WARPS, smem, s>>>(
        (const bf16*)q, (const E*)k_pages, (const E*)v_pages, (const int*)lengths, (const int*)tables,
        (float*)scratch, B, H, KVH, PS, table_stride, width, page_offset, rows, scale_log2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_merge_dependent(split_merge_kernel<D, MERGE_WARPS, MERGE_PER>, dim3(H, B),
                                       dim3(32 * MERGE_WARPS), s, (const float*)scratch, (const bf16*)q,
                                       (const bf16*)k_new, (const bf16*)v_new, (bf16*)out, B, KVH, splits, H / KVH,
                                       scale_log2);
}

}  // namespace

extern "C" int omchat_paged_flash_decode_manual(const void* q, const void* k_pages, const void* v_pages,
                                                const void* lengths, const void* tables, const void* k_new,
                                                const void* v_new, void* out, void* scratch, int B, int H, int KVH,
                                                int page_size, int D, int table_stride, int width, int page_offset,
                                                int splits, int rows, void* stream) {
    return launch<128, bf16>(q, k_pages, v_pages, lengths, tables, k_new, v_new, out, scratch, B, H, KVH, page_size,
                             D, table_stride, width, page_offset, splits, rows, stream);
}

extern "C" int omchat_paged_flash_decode_manual_e4m3(const void* q, const void* k_pages, const void* v_pages,
                                                     const void* lengths, const void* tables, const void* k_new,
                                                     const void* v_new, void* out, void* scratch, int B, int H,
                                                     int KVH, int page_size, int D, int table_stride, int width,
                                                     int page_offset, int splits, int rows, void* stream) {
    return launch<128, e4m3>(q, k_pages, v_pages, lengths, tables, k_new, v_new, out, scratch, B, H, KVH, page_size,
                             D, table_stride, width, page_offset, splits, rows, stream);
}
