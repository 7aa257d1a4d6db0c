// One query token per request attending to its K/V through a page table, with
// the in-flight token folded in as a self column: the serving engine's decode
// attention.
//
// Replaces the TPU kernel omchat_tpu/ops/paged_attention.py:110
// paged_flash_decode (body _paged_decode_kernel :38, pallas_call :181; the
// fold is omchat_tpu/ops/online_softmax.py:64 fold_self_column).
//
// The function, its operands, the split and the consumers are in
// paged_decode_split.cuh, which K13 (paged_flash_decode_manual.cu, the
// manual-copy variant) shares: the two kernels compute the same bits, and
// differ only in how a stage's rows reach shared memory.
//
// What bounds it on the H100: bytes.  At the serving workload's mid-decode
// point (16 requests, ~13.5k cached rows in all) a layer reads ~27 MB of K/V
// for ~0.1 GFLOP, ~8 us at 3.35 TB/s; half in e4m3.
//
// Design: split-KV, a block per (chunk, kv head, request), so that the
// longest request's rows spread over many SMs instead of setting the time
// from one.  The producer warp fills the ring with 16-byte cp.async copies
// (cp.async.cg, L2 only): each lane copies one 16-byte piece a pass,
// neighbouring lanes on neighbouring bytes of a row, so a pass moves 512
// bytes (at D = 128 two whole bf16 rows, four e4m3 rows; a narrower row's
// pieces run on into the next row).  When a lane's copies of a stage are
// issued it hands them to the stage's full barrier
// (cp.async.mbarrier.arrive.noinc), which completes once all 32 lanes' copies
// have landed; the consumers wait on it as on K13's bulk copies.  A row past
// the request's length copies its last valid row, as K13's does.  Many small
// copies in flight at once from one warp is the copy path that read fastest
// in K13's shape (PERF.md), and the table lookups stay per row, so every page
// size computes page size 128's bits.
#include "paged_decode_split.cuh"

namespace {

using namespace paged_split;

// An arrival on `bar` once every cp.async this thread issued before has
// landed; the barrier's count includes it (noinc).
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(sm90::smem_u32(bar)) : "memory");
}

template <int DP, typename E, bool EXACT>
__global__ void __launch_bounds__(32 * WARPS)
paged_split_kernel(const bf16* __restrict__ q, const E* __restrict__ k_pages, const E* __restrict__ v_pages,
                   const int* __restrict__ lengths, const int* __restrict__ tables, float* __restrict__ scratch,
                   int B, int H, int KVH, int PS, int d_arg, int table_stride, int width, int page_offset,
                   int rows, float scale_log2) {
    const int d = EXACT ? DP : d_arg;  // the head width
    using St = Stage<DP, E>;
    constexpr int VEC = 16 / (int)sizeof(E);  // values in a 16-byte piece
    extern __shared__ __align__(128) unsigned char smem_raw[];
    E* ring = reinterpret_cast<E*>(smem_raw);       // [NBUF][K, V][STAGE_ROWS][LD]
    __shared__ __align__(8) uint64_t full[St::NBUF];   // a stage's copies have landed
    __shared__ __align__(8) uint64_t empty[St::NBUF];  // every consumer warp is done with a stage

    trigger_merge_launch();  // the merge blocks may start; they wait for these stores
    const Chunk c = block_chunk(lengths, scratch, B, H, KVH, PS, width, rows, d);
    if (empty_chunk(c, H / KVH)) return;
    zero_ring_padding<DP>(ring, d);
    init_ring(full, empty, 32);  // one noinc arrival a producer lane
    __syncthreads();

    if (threadIdx.x >> 5 == CONSUMERS) {
        // Lane i copies pieces i, i + 32, ... of the stage's rows, tracked as
        // (row, piece).  Where a row's pieces divide a pass of 32 (a width of
        // 2^k pieces: 16 at d = 128 in bf16, two rows a pass) a lane keeps
        // its piece and steps whole rows.
        const int lane = threadIdx.x & 31;
        const int pieces = d / VEC;                              // 16-byte pieces in a row
        const int step_r = 32 / pieces, step_p = 32 % pieces;   // a pass of 32 pieces, in rows and pieces
        const int* table = tables + (size_t)blockIdx.z * table_stride;
        const size_t head_off = (size_t)blockIdx.y * PS * d;
        const size_t page_elems = (size_t)KVH * PS * d;
        auto copy = [&](E* kd, int p, int r, int col) {
            const size_t src = row_src(table, c, c.begin + p * STAGE_ROWS + r, PS, page_elems, head_off,
                                       page_offset, d) + col;
            cp_async16(kd + r * St::LD + col, k_pages + src);
            cp_async16(kd + St::ELEMS + r * St::LD + col, v_pages + src);
        };
        for (int p = 0; p < c.stages; ++p) {
            const int s = p % St::NBUF;
            if (p >= St::NBUF) sm90::mbar_wait(&empty[s], (p / St::NBUF - 1) & 1);
            E* kd = ring + (size_t)s * 2 * St::ELEMS;
            if (step_p == 0) {
#pragma unroll 4
                for (int r = lane / pieces; r < STAGE_ROWS; r += step_r) copy(kd, p, r, (lane % pieces) * VEC);
            } else {
                for (int r = lane / pieces, pc = lane % pieces; r < STAGE_ROWS;) {
                    copy(kd, p, r, pc * VEC);
                    r += step_r;
                    pc += step_p;
                    if (pc >= pieces) {
                        pc -= pieces;
                        ++r;
                    }
                }
            }
            cp_async_arrive_noinc(&full[s]);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");  // leave no copy of this thread in flight
        return;
    }
    consume_chunk<DP, E>(q, ring, c, full, empty, H, KVH, scale_log2, d);
}

template <int DP, typename E, bool EXACT>
struct Split {
    static SplitKernel<E> fn() { return paged_split_kernel<DP, E, EXACT>; }
};

}  // namespace

extern "C" int omchat_paged_flash_decode(const void* q, const void* k_pages, const void* v_pages, const void* lengths,
                                         const void* tables, const void* k_new, const void* v_new, void* out,
                                         void* scratch, int B, int H, int KVH, int page_size, int D, int table_stride,
                                         int width, int page_offset, int splits, int rows, void* stream) {
    return paged_split::launch_width<Split, bf16>(D, q, k_pages, v_pages, lengths, tables, k_new, v_new, out,
                                                  scratch, B, H, KVH, page_size, D, table_stride, width,
                                                  page_offset, splits, rows, stream);
}

extern "C" int omchat_paged_flash_decode_e4m3(const void* q, const void* k_pages, const void* v_pages,
                                              const void* lengths, const void* tables, const void* k_new,
                                              const void* v_new, void* out, void* scratch, int B, int H, int KVH,
                                              int page_size, int D, int table_stride, int width, int page_offset,
                                              int splits, int rows, void* stream) {
    return paged_split::launch_width<Split, e4m3>(D, q, k_pages, v_pages, lengths, tables, k_new, v_new, out,
                                                  scratch, B, H, KVH, page_size, D, table_stride, width,
                                                  page_offset, splits, rows, stream);
}
