// Paged decode with the in-flight token as a self column, its pages streamed
// through a ring of bulk asynchronous copies: the manual-copy variant of the
// serving engine's decode attention (--decode-kernel manual).
//
// Replaces the TPU kernel omchat_tpu/ops/paged_attention.py:270
// paged_flash_decode_manual (body _paged_decode_manual_kernel :196,
// pallas_call :327; the fold is omchat_tpu/ops/online_softmax.py:64).
//
// The function, the split and the consumers are K12's (paged_flash_decode.cu):
// paged_decode_split.cuh holds them, so that the two kernels compute the same
// bits; the entry's arguments are the ones listed there.
//
// What sets it apart from K12 is the copy schedule.  The TPU kernel walks a
// request's page list with NBUF = 4 pages in flight through
// pltpu.make_async_copy and DMA semaphores (paged_attention.py:225-258).  Here
// the producer warp does the same with the TMA engine's bulk copies
// (cp.async.bulk, completing on an mbarrier): lane 0 waits for a stage to be
// free and announces its bytes, then each of the 32 lanes bulk-copies two
// rows of K and of V (D values each: 256 bytes in bf16 at D = 128) into
// their padded shared rows.
// A row's page is looked up from the table per row, so chunks, stages and
// their order are fixed in rows, not pages, and every page size computes the
// same bits; the copy of a row past the length re-reads the last valid row,
// so every stage completes the same transaction count.
//
// What bounds it on the H100: bytes (~27 MB of K/V a layer at the serving
// workload's mid-decode point in bf16, ~8 us at 3.35 TB/s; half in e4m3).
// A block's stages wait on their copies one after another (~4-6 us a stage
// on the H100 whatever the copy size or the consumers' work, PERF.md), so the
// host keeps chunks to at most 4 stages (ops/paged_attention.py).
#include "paged_decode_split.cuh"

namespace {

using namespace paged_split;

// One bulk copy global -> shared by the TMA engine (16-byte aligned, a
// multiple of 16 bytes), completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            sm90::smem_u32(smem)),
        "l"(gmem), "r"(bytes), "r"(sm90::smem_u32(bar))
        : "memory");
}

template <int DP, typename E, bool EXACT>
__global__ void __launch_bounds__(32 * WARPS)
manual_split_kernel(const bf16* __restrict__ q, const E* __restrict__ k_pages, const E* __restrict__ v_pages,
                    const int* __restrict__ lengths, const int* __restrict__ tables, float* __restrict__ scratch,
                    int B, int H, int KVH, int PS, int d_arg, int table_stride, int width, int page_offset,
                    int rows, float scale_log2) {
    const int d = EXACT ? DP : d_arg;  // the head width
    using St = Stage<DP, E>;
    const unsigned row_bytes = d * sizeof(E);  // a multiple of 16, as a bulk copy needs
    extern __shared__ __align__(128) unsigned char smem_raw[];
    E* ring = reinterpret_cast<E*>(smem_raw);       // [NBUF][K, V][STAGE_ROWS][LD]
    __shared__ __align__(8) uint64_t full[St::NBUF];   // a stage's copies have landed
    __shared__ __align__(8) uint64_t empty[St::NBUF];  // every consumer warp is done with a stage

    trigger_merge_launch();  // the merge blocks may start; they wait for these stores
    const Chunk c = block_chunk(lengths, scratch, B, H, KVH, PS, width, rows, d);
    if (empty_chunk(c, H / KVH)) return;
    zero_ring_padding<DP>(ring, d);
    init_ring(full, empty, 1);
    __syncthreads();

    if (threadIdx.x >> 5 == CONSUMERS) {
        // Producer: lane 0 waits for the stage and announces its bytes, then
        // every lane copies rows lane, lane + 32 of K and of V.
        const int lane = threadIdx.x & 31;
        const int* table = tables + (size_t)blockIdx.z * table_stride;
        const size_t head_off = (size_t)blockIdx.y * PS * d;
        const size_t page_elems = (size_t)KVH * PS * d;
        for (int p = 0; p < c.stages; ++p) {
            const int s = p % St::NBUF;
            if (lane == 0) {
                if (p >= St::NBUF) sm90::mbar_wait(&empty[s], (p / St::NBUF - 1) & 1);
                sm90::mbar_arrive_expect_tx(&full[s], 2 * STAGE_ROWS * row_bytes);
            }
            __syncwarp();
            E* kd = ring + (size_t)s * 2 * St::ELEMS;
            for (int r = lane; r < STAGE_ROWS; r += 32) {
                const size_t src = row_src(table, c, c.begin + p * STAGE_ROWS + r, PS, page_elems, head_off,
                                           page_offset, d);
                bulk_copy(kd + r * St::LD, k_pages + src, row_bytes, &full[s]);
                bulk_copy(kd + St::ELEMS + r * St::LD, v_pages + src, row_bytes, &full[s]);
            }
        }
        return;
    }
    consume_chunk<DP, E>(q, ring, c, full, empty, H, KVH, scale_log2, d);
}

template <int DP, typename E, bool EXACT>
struct Split {
    static SplitKernel<E> fn() { return manual_split_kernel<DP, E, EXACT>; }
};

}  // namespace

extern "C" int omchat_paged_flash_decode_manual(const void* q, const void* k_pages, const void* v_pages,
                                                const void* lengths, const void* tables, const void* k_new,
                                                const void* v_new, void* out, void* scratch, int B, int H, int KVH,
                                                int page_size, int D, int table_stride, int width, int page_offset,
                                                int splits, int rows, void* stream) {
    return paged_split::launch_width<Split, bf16>(D, q, k_pages, v_pages, lengths, tables, k_new, v_new, out,
                                                  scratch, B, H, KVH, page_size, D, table_stride, width,
                                                  page_offset, splits, rows, stream);
}

extern "C" int omchat_paged_flash_decode_manual_e4m3(const void* q, const void* k_pages, const void* v_pages,
                                                     const void* lengths, const void* tables, const void* k_new,
                                                     const void* v_new, void* out, void* scratch, int B, int H,
                                                     int KVH, int page_size, int D, int table_stride, int width,
                                                     int page_offset, int splits, int rows, void* stream) {
    return paged_split::launch_width<Split, e4m3>(D, q, k_pages, v_pages, lengths, tables, k_new, v_new, out,
                                                  scratch, B, H, KVH, page_size, D, table_stride, width,
                                                  page_offset, splits, rows, stream);
}
