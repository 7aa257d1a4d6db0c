// Paged decode with the in-flight token as a self column, its pages streamed
// through a ring of bulk asynchronous copies: the manual-copy variant of the
// serving engine's decode attention (--decode-kernel manual).
//
// Replaces the TPU kernel omchat_tpu/ops/paged_attention.py:270
// paged_flash_decode_manual (body _paged_decode_manual_kernel :196,
// pallas_call :327; the fold is omchat_tpu/ops/online_softmax.py:64).
//
// The contract is K12's (paged_flash_decode.cu), and so is the function:
//   q            [B, H, D] bf16 (the [B, 1, H, D] query)
//   k/v_pages    [NP, KVH, PS, D] page-major pool (PS 16, 32, 64 or 128), bf16 or, through
//                omchat_paged_flash_decode_manual_e4m3, e4m3; a layered pool
//                [L, P+1, ...] is passed flat and `page_offset` (the layer's
//                first page) is added to every table entry
//   lengths      [B] int32 valid rows, EXCLUDING the in-flight token
//   tables       [B, *] int32 rows of `table_stride`, `width` entries used
//   k_new/v_new  [B, KVH, D] bf16 the self column, or null (no self column)
//   out          [B, H, D] bf16
// An e4m3 pool is widened to bf16 in registers; p and the self column go into
// the products as bf16, as the TPU kernel casts the pages to q's dtype
// (paged_attention.py:247,250).
//
// What sets it apart from K12 is the copy schedule.  The TPU kernel walks a
// request's page list with NBUF = 4 pages in flight through
// pltpu.make_async_copy and DMA semaphores (paged_attention.py:225-258).  Here
// one producer warp does the same with the TMA engine's bulk copies
// (cp.async.bulk, one instruction per K or V slice, completing on an
// mbarrier): it keeps a ring of NBUF stages in shared memory filled while 8
// consumer warps run the online softmax on the stage that has landed, and each
// consumer warp releases a stage through a second mbarrier.  K12 instead has
// every thread issue 16-byte cp.async copies into a double buffer.
//
// The ring's unit is 128 cache rows of one kv head: 128 / PS page slices
// (each PS x D values, contiguous in the [NP, KVH, PS, D] pool), one bulk copy
// of K and one of V per slice.  A whole 128-row page of 4 kv heads is 128 KiB
// of K plus 128 KiB of V in bf16, more than the 227 KiB a block may hold.  A
// stage holds K and V of 128 rows: 64 KiB in bf16, so NBUF = 3 (192 KiB), and
// 32 KiB in e4m3, so NBUF = 4 (128 KiB).  As in K12, a stage, each consumer
// warp's 16 columns and the merge order do not depend on PS, so every page
// size computes the same bits as PS = 128.  A stage's slots past the last page
// the request reads are filled with a copy of that page (its columns are
// masked), so every stage completes the same transaction count.
//
// Grid: one block per (kv head, request), as K12, not the TPU kernel's one
// program per request: (B,) would be 16 blocks on 132 SMs at the serving
// workload, (KVH, B) is 64, and each block's slices are then contiguous.
//
// What bounds it on the H100: bytes, as K12 (~27 MB of K/V a layer at the
// serving workload's mid-decode point in bf16, ~8 us at 3.35 TB/s; half in
// e4m3).  The bulk-copied rows are not padded, so the mma operand loads from
// shared memory meet bank conflicts; a 128-byte-swizzled tensor map would
// remove them and is later work.
#include "common.cuh"

namespace {

constexpr int STAGE_ROWS = 128;               // cache rows per stage (128 / PS page slices)
constexpr int CONSUMERS = 8;                  // consumer warps
constexpr int WARPS = CONSUMERS + 1;          // and one producer warp
constexpr int COLS = STAGE_ROWS / CONSUMERS;  // stage columns per consumer warp
constexpr int ROWS = 16;                      // q rows of the mma tile (the GQA group, padded)

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive once and expect `bytes` of bulk copies to complete on the barrier.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done = 0;
    while (!done) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    }
}

// One bulk copy global -> shared by the TMA engine (16-byte aligned, a
// multiple of 16 bytes), completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_u32(smem)),
        "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

template <int D, typename E, int PS>
__global__ void __launch_bounds__(32 * WARPS)
paged_flash_decode_manual_kernel(const bf16* __restrict__ q, const E* __restrict__ k_pages,
                                 const E* __restrict__ v_pages, const int* __restrict__ lengths,
                                 const int* __restrict__ tables, const bf16* __restrict__ k_new,
                                 const bf16* __restrict__ v_new, bf16* __restrict__ out, int H, int KVH,
                                 int table_stride, int width, int page_offset, float scale_log2) {
    constexpr int NBUF = Ring<E>::NBUF;
    constexpr int SLICE = PS * D;           // values of one kv head's page slice
    constexpr int STAGE = STAGE_ROWS * D;   // values of K (or V) in a stage
    constexpr int SLOTS = STAGE_ROWS / PS;  // page slices a stage holds
    constexpr unsigned SLICE_BYTES = SLICE * sizeof(E);
    extern __shared__ __align__(128) unsigned char smem_raw[];
    E* ring = reinterpret_cast<E*>(smem_raw);  // [NBUF][K, V][STAGE_ROWS][D]
    __shared__ __align__(8) uint64_t full[NBUF];   // a stage's copies have landed
    __shared__ __align__(8) uint64_t empty[NBUF];  // every consumer warp is done with a stage

    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int group = H / KVH;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    const int len = min(lengths[b], width * PS);  // the columns the table maps
    const int n_pages = len > 0 ? (len + PS - 1) / PS : 0;
    const int n_stages = (len + STAGE_ROWS - 1) / STAGE_ROWS;
    const int* table = tables + (size_t)b * table_stride;
    const bf16* qb = q + ((size_t)b * H + (size_t)kvh * group) * D;

    if (threadIdx.x == 0) {
        for (int s = 0; s < NBUF; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    if (warp == CONSUMERS) {
        // Producer: one lane issues the copies, refilling a stage once all
        // consumer warps have released its previous page.
        if (lane == 0) {
            const size_t page_elems = (size_t)KVH * SLICE;
            for (int p = 0; p < n_stages; ++p) {
                const int s = p % NBUF;
                if (p >= NBUF) mbar_wait(&empty[s], (p / NBUF - 1) & 1);
                E* kd = ring + (size_t)s * 2 * STAGE;
                mbar_arrive_expect_tx(&full[s], 2 * SLOTS * SLICE_BYTES);
                for (int i = 0; i < SLOTS; ++i) {
                    const int pg = min(p * SLOTS + i, n_pages - 1);
                    const size_t src = (size_t)(table[pg] + page_offset) * page_elems + (size_t)kvh * SLICE;
                    bulk_copy(kd + i * SLICE, k_pages + src, SLICE_BYTES, &full[s]);
                    bulk_copy(kd + STAGE + i * SLICE, v_pages + src, SLICE_BYTES, &full[s]);
                }
            }
        }
        __syncwarp();
    } else {
        // Consumers: the group's q rows (rows >= group are zero) as one mma
        // row tile; warp w takes columns [w * COLS, (w + 1) * COLS) of every
        // page with its own online softmax.
        uint32_t qa[D / 16][4];
        load_q_group<D>(qa, qb, group);
        for (int p = 0; p < n_stages; ++p) {
            const int s = p % NBUF;
            mbar_wait(&full[s], (p / NBUF) & 1);
            const int c0 = p * STAGE_ROWS + warp * COLS;
            if (c0 < len) {  // a warp whose columns all lie past the length skips its share
                const E* ks = ring + (size_t)s * 2 * STAGE + warp * COLS * D;
                const E* vs = ks + STAGE;
                auto mask = [&](int, int col, float sc) { return c0 + col < len ? sc * scale_log2 : OMCHAT_MASK_VALUE; };
                attend_tile<D, COLS>(qa, ks, vs, D, m, l, acc, mask);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);
        }
    }
    __syncthreads();  // every copy issued has landed and been read: the ring is free

    // Merge the consumer warps' states, fold the self column in, write the
    // group's rows (as K12).
    const size_t row = (size_t)b * KVH + kvh;
    merge_fold_store<D, CONSUMERS, ROWS>(reinterpret_cast<float*>(smem_raw), m, l, acc, qb,
                                         k_new != nullptr ? k_new + row * D : nullptr,
                                         v_new != nullptr ? v_new + row * D : nullptr,
                                         out + ((size_t)b * H + (size_t)kvh * group) * D, group, scale_log2);
}

template <int D, typename E, int PS>
int launch_ps(const void* q, const void* k_pages, const void* v_pages, const void* lengths, const void* tables,
              const void* k_new, const void* v_new, void* out, int B, int H, int KVH, int D_arg, int table_stride,
              int width, int page_offset, void* stream) {
    if (KVH <= 0 || H % KVH != 0 || H / KVH > ROWS) return (int)cudaErrorInvalidValue;
    if (D_arg != D) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    constexpr size_t smem = (size_t)Ring<E>::NBUF * 2 * STAGE_ROWS * D * sizeof(E);
    static_assert((2 * CONSUMERS * ROWS + ROWS + CONSUMERS * ROWS * D) * sizeof(float) <= smem,
                  "the merge scratch must fit the ring");
    cudaFuncSetAttribute(paged_flash_decode_manual_kernel<D, E, PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
    dim3 grid(KVH, B);
    paged_flash_decode_manual_kernel<D, E, PS><<<grid, 32 * WARPS, smem, (cudaStream_t)stream>>>(
        (const bf16*)q, (const E*)k_pages, (const E*)v_pages, (const int*)lengths, (const int*)tables,
        (const bf16*)k_new, (const bf16*)v_new, (bf16*)out, H, KVH, table_stride, width, page_offset, scale_log2);
    return (int)cudaGetLastError();
}

// The page sizes the kernel is built for (the serving engine refuses any other).
template <int D, typename E, typename... Args>
int launch(int page_size, Args... args) {
    switch (page_size) {
        case 16: return launch_ps<D, E, 16>(args...);
        case 32: return launch_ps<D, E, 32>(args...);
        case 64: return launch_ps<D, E, 64>(args...);
        case 128: return launch_ps<D, E, 128>(args...);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" int omchat_paged_flash_decode_manual(const void* q, const void* k_pages, const void* v_pages,
                                                const void* lengths, const void* tables, const void* k_new,
                                                const void* v_new, void* out, int B, int H, int KVH, int page_size,
                                                int D, int table_stride, int width, int page_offset, void* stream) {
    return launch<128, bf16>(page_size, q, k_pages, v_pages, lengths, tables, k_new, v_new, out, B, H, KVH, D,
                             table_stride, width, page_offset, stream);
}

extern "C" int omchat_paged_flash_decode_manual_e4m3(const void* q, const void* k_pages, const void* v_pages,
                                                     const void* lengths, const void* tables, const void* k_new,
                                                     const void* v_new, void* out, int B, int H, int KVH,
                                                     int page_size, int D, int table_stride, int width,
                                                     int page_offset, void* stream) {
    return launch<128, e4m3>(page_size, q, k_pages, v_pages, lengths, tables, k_new, v_new, out, B, H, KVH, D,
                             table_stride, width, page_offset, stream);
}
