// Causal / non-causal GQA flash attention forward over the cache layer (K2).
//
// Replaces the TPU kernel omchat_tpu/ops/flash_attention.py:246 flash_attention
// (body _attn_core, :35; pallas_call :462) on the Qwen2 prefill path (the
// single request, and the batched short prefill of the paged engine), and its
// segment-ids body _attn_kernel_seg (:208) on the packed forward
// (omchat_flash_attention_seg: qwen2_forward(segment_ids=) on the kernel
// route, a packed batch's loss without its backward).
//
//   q   [B, S, H, D] bf16, already multiplied (in bf16) by D^-0.5 * log2(e);
//       D a multiple of 8 from 8 to 128 (128 on the LLM, 64 and 72 on the
//       CLIP / SigLIP / InternViT-300M towers)
//   k,v [B, KVH, T, D] bf16 or e4m3 (a layer of the stacked cache, "bntd";
//       the e4m3 entry point omchat_flash_attention_e4m3 takes the fp8 cache,
//       at D a multiple of 16: TMA strides an e4m3 row of D bytes only in
//       whole 16 bytes)
//   each read in place through its own element strides (head, row, batch):
//   a "btnd" view, or v as a column block of a fused qkv, too
//   q_offset, kv_len [B] int32; query row i sits at kv position i + q_offset
//   out [B, S, H, D] bf16
// Rows whose position is at or past kv_len are unspecified (a causal row tile
// wholly past it writes zeros); a batch with kv_len 0 writes zeros.
//
// With segment ids (omchat_flash_attention_seg): seg [B, S] int32, T == S and
// no q_offset; row i attends to column j only where seg[j] == seg[i] >= 0, so
// a row of padding (a negative id) writes zeros.  The block lists the kv tiles
// whose id ranges meet its rows' before its loop (list_meeting_tiles) and
// loads only those, as the TPU kernel windows its kv blocks per q block
// (flash_attention.py:359-377); every listed tile is masked, because a
// document boundary may cut any tile.  The work a packed batch needs is each
// document's own triangle (or square), which the tile list brings the kernel
// to within the tiles that a boundary cuts.
//
// What bounds it on the H100: at the main-path shape (S=3200, T=3328, H=28,
// KVH=4, causal) the work is ~77 GFLOP against ~30 MB of q/k/v/out, so
// tensor-core operations; only wgmma reaches Hopper's tensor-core rate.  The
// design is the TMA + wgmma forward mainloop of flash_fwd_sm90.cuh (a block
// per 128 q rows of one q head and batch, two consumer warpgroups, a producer
// warp, a 2-stage K / V ring), with per-batch offsets and lengths, the finite
// mask value of the JAX kernels and no lse.  On an e4m3 cache the tiles are
// staged as stored and widened once per block, and the PV product takes p
// rounded to e4m3, as the TPU kernel's p.astype(v.dtype) does
// (flash_attention.py:145,162).  The TPU kernel's "anchored" walk is a
// bookkeeping trick of that machine; a plain online softmax computes the same
// function.  Below D = 128 the block still computes on 128-column tiles: the
// maps declare the true D, so TMA zero-fills the columns past it instead of
// reading the next head's (a "btnd" view), and the store writes D columns a
// row; on e4m3 the zero bytes widen to zeros.  Times at the main path's
// shapes: PERF.md section 6.
#include "flash_fwd_sm90.cuh"

namespace {

// Element strides (head, row, batch) of q, k and v.
template <bool E4M3, bool SEG = false>
int launch(const void* q, long long q_sh, long long q_sr, long long q_sb, const void* k, long long k_sh,
           long long k_sr, long long k_sb, const void* v, long long v_sh, long long v_sr, long long v_sb, void* out,
           const void* q_offset, const void* kv_len, int B, int S, int H, int KVH, int T, int D, int causal,
           void* stream, const void* seg = nullptr) {
    if (D < 8 || D > fwd90::HD || D % (E4M3 ? 16 : 8)) return (int)cudaErrorInvalidValue;
    fwd90::Params p{};
    p.head_dim = D;
    p.out = (bf16*)out;
    p.out_row = (long long)H * D;
    p.out_batch = (long long)S * H * D;
    p.q_offset = (const int*)q_offset;
    p.kv_len = (const int*)kv_len;
    p.B = B, p.S = S, p.H = H, p.KVH = KVH, p.T = T;
    p.causal = causal;
    p.q_scale = 1.f;
    p.mask_value = OMCHAT_MASK_VALUE;
    p.seg = (const int*)seg;
    const long long qs[3] = {q_sh, q_sr, q_sb}, ks[3] = {k_sh, k_sr, k_sb}, vs[3] = {v_sh, v_sr, v_sb};
    CUtensorMap mq, mk, mv;
    if (!fwd90::dense_maps(&mq, &mk, &mv, p, q, qs, k, ks, v, vs, E4M3 ? 1 : 2)) return (int)cudaErrorInvalidValue;
    return fwd90::launch<E4M3, E4M3, false, SEG>(mq, mk, mv, p, stream);
}

}  // namespace

extern "C" int omchat_flash_attention(const void* q, long long q_sh, long long q_sr, long long q_sb, const void* k,
                                      long long k_sh, long long k_sr, long long k_sb, const void* v, long long v_sh,
                                      long long v_sr, long long v_sb, void* out, const void* q_offset,
                                      const void* kv_len, int B, int S, int H, int KVH, int T, int D, int causal,
                                      void* stream) {
    return launch<false>(q, q_sh, q_sr, q_sb, k, k_sh, k_sr, k_sb, v, v_sh, v_sr, v_sb, out, q_offset, kv_len, B, S,
                         H, KVH, T, D, causal, stream);
}

extern "C" int omchat_flash_attention_e4m3(const void* q, long long q_sh, long long q_sr, long long q_sb,
                                           const void* k, long long k_sh, long long k_sr, long long k_sb,
                                           const void* v, long long v_sh, long long v_sr, long long v_sb, void* out,
                                           const void* q_offset, const void* kv_len, int B, int S, int H, int KVH,
                                           int T, int D, int causal, void* stream) {
    return launch<true>(q, q_sh, q_sr, q_sb, k, k_sh, k_sr, k_sb, v, v_sh, v_sr, v_sb, out, q_offset, kv_len, B, S,
                        H, KVH, T, D, causal, stream);
}

// Segment ids seg [B, S] int32 (T == S, no q_offset), bf16 q / k / v.
extern "C" int omchat_flash_attention_seg(const void* q, long long q_sh, long long q_sr, long long q_sb,
                                          const void* k, long long k_sh, long long k_sr, long long k_sb,
                                          const void* v, long long v_sh, long long v_sr, long long v_sb, void* out,
                                          const void* seg, const void* kv_len, int B, int S, int H, int KVH, int D,
                                          int causal, void* stream) {
    if (!seg) return (int)cudaErrorInvalidValue;
    return launch<false, true>(q, q_sh, q_sr, q_sb, k, k_sh, k_sr, k_sb, v, v_sh, v_sr, v_sb, out, nullptr, kv_len,
                               B, S, H, KVH, S, D, causal, stream, seg);
}
