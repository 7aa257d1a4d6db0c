// Causal GQA attention of one prefill chunk per request, reading the cached
// K/V through the request's page table instead of a gathered copy (K14).
//
// Replaces the TPU kernel omchat_tpu/ops/paged_attention.py:442
// paged_flash_prefill (body _paged_prefill_kernel :385, pallas_call :514).
//
//   q            [B, C, H, D] bf16, already multiplied (in bf16) by D^-0.5 * log2(e);
//                D a multiple of 8 from 8 to 128 (of 16 on the e4m3 pool), K2's widths
//   k/v_pages    [P, KVH, PS, D] bf16, or e4m3 through omchat_paged_flash_prefill_e4m3
//                (the fp8 pool), one layer's page-major pool (PS 16, 32, 64 or 128)
//   q_offset     [B] int32 position of the chunk's first row (page-aligned)
//   kv_len       [B] int32 valid positions, this chunk's rows included
//   tables       [B, *] int32 rows of `table_stride`, `width` entries used
//   out          [B, C, H, D] bf16; rows past a request's chunk length are
//                padding (a 128-row tile of them is written as zeros)
//
// Query row i of request b sits at position q_offset[b] + i and sees column
// j iff j <= q_offset[b] + i and j < kv_len[b].
//
// What bounds it on the H100: tensor-core operations.  A 1024-row chunk over
// 2048 positions is ~11 GFLOP against ~17 MB of q/k/v/out (~11 us at
// 989 TFLOP/s, ~5 us at 3.35 TB/s).  K14 is K2 (flash_attention.cu) over a
// page table, so it runs K2's TMA + wgmma mainloop (flash_fwd_sm90.cuh) with
// one difference, in the producer: each 128-row K / V tile arrives as
// 128 / PS TMA boxes, one a page, from tables[b][col / PS] (a page past the
// mapped ones reads zeros and is masked).  On the same values the two
// kernels therefore compute the same bits, so the engine's chunk route (K14)
// and the gathered route it replaced (gather + K2) give the same logits.  The
// TPU kernel's grid re-walked the pages per (kv head, q block) and paid a
// per-step issue cost; here each block loads only the tiles below its causal
// diagonal and kv_len, straight from the pool.  An e4m3 pool is staged as
// stored and widened to bf16 once per block; p is rounded to bf16, as the TPU
// kernel casts the pages to q's dtype before its products
// (paged_attention.py:423,429).  Below D = 128 the maps declare the true
// width, as K2's do, so TMA fills a page box's columns past D with zeros.
#include "flash_fwd_sm90.cuh"

namespace {

template <bool KV8>
int launch(const void* q, const void* k_pages, const void* v_pages, void* out, const void* q_offset,
           const void* kv_len, const void* tables, int B, int C, int H, int KVH, int PS, int D, int table_stride,
           int width, int num_pages, void* stream) {
    if (D < 8 || D > fwd90::HD || D % (KV8 ? 16 : 8) || width <= 0 || num_pages <= 0)
        return (int)cudaErrorInvalidValue;
    if (B == 0 || C == 0) return 0;
    fwd90::Params p{};
    p.head_dim = D;
    p.out = (bf16*)out;
    p.out_row = (long long)H * D;
    p.out_batch = (long long)C * H * D;
    p.q_offset = (const int*)q_offset;
    p.kv_len = (const int*)kv_len;
    p.B = B, p.S = C, p.H = H, p.KVH = KVH, p.T = width * PS;
    p.causal = 1;
    p.q_scale = 1.f;
    p.mask_value = OMCHAT_MASK_VALUE;
    p.tables = (const int*)tables;
    p.table_stride = table_stride, p.table_width = width, p.page_size = PS, p.num_pages = num_pages;
    const int eb = KV8 ? 1 : 2;
    CUtensorMap mq, mk, mv;
    // the maps declare the true width D: TMA fills a tile's columns past it with zeros
    if (!sm90::rows_map(&mq, q, 2, H, C, B, D, (uint64_t)H * D, (uint64_t)C * H * D, fwd90::BM, D) ||
        !sm90::rows_map(&mk, k_pages, eb, KVH, PS, num_pages, (uint64_t)PS * D, D, (uint64_t)KVH * PS * D, PS, D) ||
        !sm90::rows_map(&mv, v_pages, eb, KVH, PS, num_pages, (uint64_t)PS * D, D, (uint64_t)KVH * PS * D, PS, D))
        return (int)cudaErrorInvalidValue;
    return fwd90::launch<KV8, false>(mq, mk, mv, p, stream);
}

}  // namespace

extern "C" int omchat_paged_flash_prefill(const void* q, const void* k_pages, const void* v_pages, void* out,
                                          const void* q_offset, const void* kv_len, const void* tables, int B, int C,
                                          int H, int KVH, int PS, int D, int table_stride, int width, int num_pages,
                                          void* stream) {
    return launch<false>(q, k_pages, v_pages, out, q_offset, kv_len, tables, B, C, H, KVH, PS, D, table_stride, width,
                         num_pages, stream);
}

extern "C" int omchat_paged_flash_prefill_e4m3(const void* q, const void* k_pages, const void* v_pages, void* out,
                                               const void* q_offset, const void* kv_len, const void* tables, int B,
                                               int C, int H, int KVH, int PS, int D, int table_stride, int width,
                                               int num_pages, void* stream) {
    return launch<true>(q, k_pages, v_pages, out, q_offset, kv_len, tables, B, C, H, KVH, PS, D, table_stride, width,
                        num_pages, stream);
}
