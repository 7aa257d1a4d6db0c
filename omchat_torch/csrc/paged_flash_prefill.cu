// Causal GQA attention of one prefill chunk per request, reading the cached
// K/V through the request's page table instead of a gathered copy.
//
// Replaces the TPU kernel omchat_tpu/ops/paged_attention.py:442
// paged_flash_prefill (body _paged_prefill_kernel :385, pallas_call :514).
//
//   q            [B, C, H, D] bf16, already multiplied (in bf16) by D^-0.5 * log2(e)
//   k/v_pages    [P, KVH, PS, D] bf16, one layer's page-major pool (PS % 64 == 0)
//   q_offset     [B] int32 position of the chunk's first row (page-aligned)
//   kv_len       [B] int32 valid positions, this chunk's rows included
//   tables       [B, *] int32 rows of `table_stride`, `width` entries used
//   out          [B, C, H, D] bf16; rows past a request's chunk length are
//                computed but are padding
//
// Query row i of request b sits at position q_offset[b] + i and sees column
// j iff j <= q_offset[b] + i and j < kv_len[b].
//
// What bounds it on the H100: tensor-core operations.  A 1024-row chunk over
// 2048 positions is ~11 GFLOP against ~17 MB of q/k/v/out (~11 us at
// 989 TFLOP/s, ~5 us at 3.35 TB/s).  Design: K2's (flash_attention.cu) —
// one block per (16 query rows, kv head, request), one warp per q head of the
// GQA group sharing every staged 64-row K/V tile, mma.sync m16n8k16 with an
// online exp2 softmax in registers — with each tile addressed through
// tables[b][col / PS] at row col % PS: a 64-row tile never straddles a page.
// The TPU kernel's grid re-walked the pages per (kv head, q block) and paid a
// per-step issue cost; here each block walks only the tiles below its causal
// diagonal and kv_len, and reads them straight from the pool.  No TMA, wgmma
// or pipelining yet.
#include "common.cuh"

namespace {

constexpr int ROWS = 16;      // query rows per block (one mma row tile per warp)
constexpr int KV_TILE = 64;   // kv rows per shared-memory tile
constexpr int MAX_GROUP = 8;  // 256 threads

template <int D>
__global__ void __launch_bounds__(32 * MAX_GROUP)
paged_flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                           const bf16* __restrict__ v_pages, bf16* __restrict__ out, const int* __restrict__ q_offset,
                           const int* __restrict__ kv_len, const int* __restrict__ tables, int C, int H, int KVH,
                           int PS, int table_stride, int width) {
    constexpr int LD = D + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* ks = reinterpret_cast<bf16*>(smem_raw);
    bf16* vs = ks + KV_TILE * LD;

    const int group = H / KVH;
    const int b = blockIdx.z;
    const int kvh = blockIdx.y;
    const int r0 = blockIdx.x * ROWS;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int head = kvh * group + warp;

    const int qoff = q_offset[b];
    const int klen = kv_len[b];
    const int* table = tables + (size_t)b * table_stride;

    uint32_t qa[D / 16][4];
    {
        const int row_a = r0 + g, row_b = r0 + g + 8;
        const bf16* qa_row = q + ((size_t)(b * C + row_a) * H + head) * D;
        const bf16* qb_row = q + ((size_t)(b * C + row_b) * H + head) * D;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const int c = kk * 16 + 2 * t;
            qa[kk][0] = row_a < C ? *reinterpret_cast<const uint32_t*>(qa_row + c) : 0u;
            qa[kk][1] = row_b < C ? *reinterpret_cast<const uint32_t*>(qb_row + c) : 0u;
            qa[kk][2] = row_a < C ? *reinterpret_cast<const uint32_t*>(qa_row + c + 8) : 0u;
            qa[kk][3] = row_b < C ? *reinterpret_cast<const uint32_t*>(qb_row + c + 8) : 0u;
        }
    }

    // kv columns this block needs: below kv_len and the mapped pages, and at
    // or below the diagonal of its last row.
    int end = min(klen, width * PS);
    end = min(end, min(r0 + ROWS, C) - 1 + qoff + 1);
    const int n_tiles = end > 0 ? (end + KV_TILE - 1) / KV_TILE : 0;

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    const size_t page_elems = (size_t)KVH * PS * D;
    const size_t head_off = (size_t)kvh * PS * D;
    constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
    const int nthreads = blockDim.x;

    for (int j = 0; j < n_tiles; ++j) {
        const int c0 = j * KV_TILE;
        const size_t base = (size_t)table[c0 / PS] * page_elems + head_off + (size_t)(c0 % PS) * D;
        __syncthreads();  // the previous tile is no longer read
        for (int idx = threadIdx.x; idx < KV_TILE * CHUNKS; idx += nthreads) {
            const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
            *reinterpret_cast<uint4*>(ks + r * LD + c) =
                *reinterpret_cast<const uint4*>(k_pages + base + (size_t)r * D + c);
            *reinterpret_cast<uint4*>(vs + r * LD + c) =
                *reinterpret_cast<const uint4*>(v_pages + base + (size_t)r * D + c);
        }
        __syncthreads();
        const int row_a = r0 + g;
        auto mask = [&](int half, int col, float s) {
            const int kvpos = c0 + col;
            const int qpos = row_a + half * 8 + qoff;
            return kvpos < klen && kvpos <= qpos ? s : OMCHAT_MASK_VALUE;
        };
        attend_tile<D, KV_TILE>(qa, ks, vs, LD, m, l, acc, mask);
    }

    const int row_a = r0 + g, row_b = r0 + g + 8;
    bf16* oa = row_a < C ? out + ((size_t)(b * C + row_a) * H + head) * D : nullptr;
    bf16* ob = row_b < C ? out + ((size_t)(b * C + row_b) * H + head) * D : nullptr;
    store_rows<D>(acc, l, oa, ob);
}

template <int D>
int launch(const void* q, const void* k_pages, const void* v_pages, void* out, const void* q_offset,
           const void* kv_len, const void* tables, int B, int C, int H, int KVH, int PS, int table_stride, int width,
           void* stream) {
    const int group = H / KVH;
    const size_t smem = 2 * (size_t)KV_TILE * (D + 8) * sizeof(bf16);
    cudaFuncSetAttribute(paged_flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    dim3 grid((C + ROWS - 1) / ROWS, KVH, B);
    paged_flash_prefill_kernel<D><<<grid, 32 * group, smem, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k_pages, (const bf16*)v_pages, (bf16*)out, (const int*)q_offset,
        (const int*)kv_len, (const int*)tables, C, H, KVH, PS, table_stride, width);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int omchat_paged_flash_prefill(const void* q, const void* k_pages, const void* v_pages, void* out,
                                          const void* q_offset, const void* kv_len, const void* tables, int B, int C,
                                          int H, int KVH, int PS, int D, int table_stride, int width, void* stream) {
    if (KVH <= 0 || H % KVH != 0 || H / KVH > MAX_GROUP) return (int)cudaErrorInvalidValue;
    if (D != 128 || PS <= 0 || PS % KV_TILE != 0) return (int)cudaErrorInvalidValue;
    if (B == 0 || C == 0) return 0;
    return launch<128>(q, k_pages, v_pages, out, q_offset, kv_len, tables, B, C, H, KVH, PS, table_stride, width,
                       stream);
}
