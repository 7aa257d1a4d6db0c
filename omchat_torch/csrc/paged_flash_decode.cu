// One query token per request attending to its K/V through a page table, with
// the in-flight token folded in as a self column: the serving engine's decode
// attention.
//
// Replaces the TPU kernel omchat_tpu/ops/paged_attention.py:110
// paged_flash_decode (body _paged_decode_kernel :38, pallas_call :181; the
// fold is omchat_tpu/ops/online_softmax.py:64 fold_self_column).
//
//   q            [B, H, D] bf16 (the [B, 1, H, D] query)
//   k/v_pages    [NP, KVH, PS, D] bf16 page-major pool (PS 16, 32, 64 or 128),
//                or e4m3 through omchat_paged_flash_decode_e4m3 (the fp8 pool); a layered
//                pool [L, P+1, ...] is passed flat and `page_offset` (the
//                layer's first page) is added to every table entry
//   lengths      [B] int32 valid rows, EXCLUDING the in-flight token
//   tables       [B, *] int32 rows of `table_stride`, `width` entries used
//   k_new/v_new  [B, KVH, D] bf16 the self column, or null (no self column)
//   out          [B, H, D] bf16
//
// Only the pages below ceil(length / PS) (and at most `width`) are read; a
// request of length 0 reads none and returns v_new (or zeros without a self
// column).
//
// What bounds it on the H100: bytes.  At the serving workload's mid-decode
// point (16 requests, ~13.5k cached rows in all) a layer reads ~27 MB of K/V
// for ~0.1 GFLOP, ~8 us at 3.35 TB/s.  Design: one block per (kv head,
// request), 8 warps.  The block walks its request's columns in stages of 128
// rows: 128 / PS pages of the block's kv head, each page's PS x 128 slice of K
// and of V (32 KiB each a stage in bf16) staged in shared memory once, by
// cp.async double-buffered against the previous stage's math, and serves all
// the GQA group's query heads: the group's q rows (7 for Qwen2-7B, padded to
// 16) are one mma.sync row tile, and each warp takes 16 of the page's 128
// columns with its own fp32 online softmax (exp2 domain, scale folded into
// the scores).  After the last stage the 8 warps' states merge through shared
// memory in a fixed order, then the self column folds in.  A stage, each
// warp's 16 columns and the merge order do not depend on PS, so every page
// size computes the same bits as PS = 128 on the same logical cache; a stage's
// rows past the last mapped page are zero-filled (and masked).  At 16 requests x 4
// kv heads that is 64 blocks on 132 SMs: half the card idles, and a long
// request's block walks all of its pages alone (no split-KV yet).
//
// An e4m3 pool is staged as stored (half the bytes of a bf16 page) and widened
// to bf16 in registers; p, and the self column (bf16, never rounded to the
// pool's type), go into the products as bf16, as the TPU kernel casts the
// pages to q's dtype (paged_attention.py:84,88).
#include "common.cuh"

namespace {

constexpr int STAGE_ROWS = 128;           // cache rows per stage (128 / PS pages)
constexpr int WARPS = 8;                  // warps per block
constexpr int COLS = STAGE_ROWS / WARPS;  // stage columns per warp
constexpr int ROWS = 16;                  // q rows of the mma tile (the GQA group, padded)

template <int D, typename E, int PS>
__global__ void __launch_bounds__(32 * WARPS)
paged_flash_decode_kernel(const bf16* __restrict__ q, const E* __restrict__ k_pages,
                          const E* __restrict__ v_pages, const int* __restrict__ lengths,
                          const int* __restrict__ tables, const bf16* __restrict__ k_new,
                          const bf16* __restrict__ v_new, bf16* __restrict__ out, int H, int KVH, int table_stride,
                          int width, int page_offset, float scale_log2) {
    constexpr int VEC = 16 / (int)sizeof(E);  // elements per 16-byte chunk
    constexpr int LD = D + VEC;               // padded smem row (bank spread), 16-byte aligned
    constexpr int STAGE = 2 * STAGE_ROWS * LD;  // K and V of one stage, elements
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* buf = reinterpret_cast<E*>(smem_raw);

    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int group = H / KVH;
    const int warp = threadIdx.x >> 5;

    // q fragments of the group's heads (rows >= group are zero).
    const bf16* qb = q + ((size_t)b * H + (size_t)kvh * group) * D;
    uint32_t qa[D / 16][4];
    load_q_group<D>(qa, qb, group);

    const int len = min(lengths[b], width * PS);  // the columns the table maps
    const int n_pages = len > 0 ? (len + PS - 1) / PS : 0;
    const int n_stages = (len + STAGE_ROWS - 1) / STAGE_ROWS;
    const size_t page_elems = (size_t)KVH * PS * D;
    const size_t head_off = (size_t)kvh * PS * D;
    const int* table = tables + (size_t)b * table_stride;

    auto stage = [&](int p, int s) {
        E* kd = buf + s * STAGE;
        E* vd = kd + STAGE_ROWS * LD;
        for (int idx = threadIdx.x; idx < STAGE_ROWS * (D / VEC); idx += blockDim.x) {
            const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
            const int pos = p * STAGE_ROWS + r, pg = pos / PS;
            const bool mapped = pg < n_pages;  // else zero-filled: past the last page the request reads
            const size_t src = mapped ? (size_t)(table[pg] + page_offset) * page_elems + head_off +
                                            (size_t)(pos % PS) * D + c
                                      : 0;
            cp_async16_zfill(kd + r * LD + c, k_pages + src, mapped);
            cp_async16_zfill(vd + r * LD + c, v_pages + src, mapped);
        }
        cp_async_commit();
    };

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    if (n_stages > 0) stage(0, 0);
    for (int p = 0; p < n_stages; ++p) {
        if (p + 1 < n_stages) {
            stage(p + 1, (p + 1) & 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int c0 = p * STAGE_ROWS + warp * COLS;
        if (c0 < len) {  // a warp whose columns all lie past the length skips its share
            const E* ks = buf + (p & 1) * STAGE + warp * COLS * LD;
            const E* vs = ks + STAGE_ROWS * LD;
            auto mask = [&](int, int col, float s) { return c0 + col < len ? s * scale_log2 : OMCHAT_MASK_VALUE; };
            attend_tile<D, COLS>(qa, ks, vs, LD, m, l, acc, mask);
        }
        __syncthreads();  // the buffer is free for the stage after next
    }

    // Merge the warps' states through shared memory (the page buffers are
    // free), fold the self column in, write the group's rows.
    const size_t row = (size_t)b * KVH + kvh;
    merge_fold_store<D, WARPS, ROWS>(reinterpret_cast<float*>(smem_raw), m, l, acc, qb,
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
    constexpr size_t smem = 2 * 2 * (size_t)STAGE_ROWS * (D + 16 / sizeof(E)) * sizeof(E);  // two stages of K and V
    static_assert((2 * WARPS * ROWS + ROWS + WARPS * ROWS * D) * sizeof(float) <= smem,
                  "the merge scratch must fit the page buffers");
    cudaFuncSetAttribute(paged_flash_decode_kernel<D, E, PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
    dim3 grid(KVH, B);
    paged_flash_decode_kernel<D, E, PS><<<grid, 32 * WARPS, smem, (cudaStream_t)stream>>>(
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

extern "C" int omchat_paged_flash_decode(const void* q, const void* k_pages, const void* v_pages, const void* lengths,
                                         const void* tables, const void* k_new, const void* v_new, void* out, int B,
                                         int H, int KVH, int page_size, int D, int table_stride, int width,
                                         int page_offset, void* stream) {
    return launch<128, bf16>(page_size, q, k_pages, v_pages, lengths, tables, k_new, v_new, out, B, H, KVH, D,
                             table_stride, width, page_offset, stream);
}

extern "C" int omchat_paged_flash_decode_e4m3(const void* q, const void* k_pages, const void* v_pages,
                                              const void* lengths, const void* tables, const void* k_new,
                                              const void* v_new, void* out, int B, int H, int KVH, int page_size,
                                              int D, int table_stride, int width, int page_offset, void* stream) {
    return launch<128, e4m3>(page_size, q, k_pages, v_pages, lengths, tables, k_new, v_new, out, B, H, KVH, D,
                             table_stride, width, page_offset, stream);
}
