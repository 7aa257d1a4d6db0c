// qk-RMSNorm + non-causal packed self-attention over the unsplit qkv rows of
// InternViT-6B (K1), and the same attention without the norm for a tower
// without qk-norm (K5).
//
// K1 replaces the TPU kernel omchat_tpu/ops/flash_attention.py:559
// packed_qkv_norm_attention (body _packed_qkv_norm_kernel :527, norm on load
// :538-543, pallas_call :603); K5 replaces :624 packed_self_attention (body
// _packed_kernel :483, pallas_call :670).  Two kernels:
//
// omchat_qk_norm_prepass (K1's first step): per row of qkv [rows, 3*HD] bf16
// (HD = H*128), the q and k column blocks are read once; rstd over their HD
// columns in fp32, rsqrt(mean(x^2) + eps), and
//   qn = bf16(x * rstd_q * gq),  kn = bf16(x * rstd_k * gk)
// (gq, gk [HD] fp32; gq carries D^-0.5 * log2(e)) are written to qkn
// [2, rows, HD]: exactly the values the TPU body rounds before its QK dot.
// One warp a (row, q or k), holding the row in registers (up to 4096
// columns; InternViT-6B has 3200) with every load in flight at once.  The TPU kernel kept
// qn / kn out of HBM because its whole [SP, SP] block sat in VMEM; a Hopper
// block holds 227 KB, so the normalised rows make one round trip through HBM
// (~80 MB at the main-path shape, bound by bytes) and the attention below
// reads them like any q and k.
//
// omchat_packed_attention (K1's second step, and K5): non-causal attention of
// q over k, v, each [B, SP, H*128] bf16 with its own row and batch strides
// (K1: qn, kn and the v block of qkv in place; K5: the qkv chunk views, in
// place), columns at or past valid_len masked with -inf, out [B, SP, H*128]
// (rows >= valid_len unspecified).  q_scale != 1 (K5: D^-0.5 * log2(e)): q is
// multiplied by it in fp32 and rounded to bf16 before the QK dot, as the TPU
// body's prescale.  It is the TMA + wgmma forward mainloop of
// flash_fwd_sm90.cuh in its non-causal form: a block per 128 q rows of one
// head and tile, the 1025 valid columns as 8 kv tiles of 128 and a last one
// computed as 64 columns.
//
// What bounds them on the H100: the attention does ~41 GFLOP per launch at the
// main-path shape (3 tiles, SP=1032, H=25) against ~60 MB moved: tensor-core
// operations.  The prepass moves ~80 MB and computes little: bytes.  Times:
// PERF.md section 6.
#include "flash_fwd_sm90.cuh"

namespace {

constexpr int PRE_WARPS = 8;
constexpr int PRE_CHUNKS = 16;  // 16-byte chunks a lane holds: rows of up to 32 * 16 * 8 = 4096 columns

__global__ void __launch_bounds__(32 * PRE_WARPS)
qk_norm_prepass_kernel(const bf16* __restrict__ qkv, const float* __restrict__ gq, const float* __restrict__ gk,
                       bf16* __restrict__ qkn, int rows, int HD, float eps) {
    const int w = blockIdx.x * PRE_WARPS + threadIdx.x / 32, lane = threadIdx.x & 31;
    if (w >= 2 * rows) return;
    const int which = w & 1, row = w >> 1;  // the q and k blocks of a row are neighbouring warps
    const bf16* x = qkv + (size_t)row * 3 * HD + (size_t)which * HD;
    const float* gamma = which ? gk : gq;
    bf16* y = qkn + ((size_t)which * rows + row) * HD;
    const int chunks = HD / 8;
    uint4 v[PRE_CHUNKS];  // the lane's chunks lane, lane + 32, ...: every load in flight at once
#pragma unroll
    for (int i = 0; i < PRE_CHUNKS; ++i) {
        const int c = lane + 32 * i;
        v[i] = c < chunks ? *reinterpret_cast<const uint4*>(x + 8 * c) : make_uint4(0, 0, 0, 0);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < PRE_CHUNKS; ++i) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            ss += f.x * f.x + f.y * f.y;
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float r = rsqrtf(ss / HD + eps);
#pragma unroll
    for (int i = 0; i < PRE_CHUNKS; ++i) {
        const int c = lane + 32 * i;
        if (c >= chunks) break;
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
        const float4 g0 = __ldg(reinterpret_cast<const float4*>(gamma + 8 * c));
        const float4 g1 = __ldg(reinterpret_cast<const float4*>(gamma + 8 * c + 4));
        const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        uint4 out;
        uint32_t* ow = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            ow[e] = pack_bf16(f.x * r * g[2 * e], f.y * r * g[2 * e + 1]);
        }
        *reinterpret_cast<uint4*>(y + 8 * c) = out;
    }
}

}  // namespace

// qkv [rows, 3*HD] contiguous bf16 (HD a multiple of 8, at most 4096; rows
// 16-byte aligned), gq / gk [HD] fp32 16-byte aligned, qkn [2, rows, HD] bf16.
extern "C" int omchat_qk_norm_prepass(const void* qkv, const void* gq, const void* gk, void* qkn, int rows, int HD,
                                      float eps, void* stream) {
    if (rows <= 0 || HD <= 0 || HD % 8 != 0 || HD > 32 * PRE_CHUNKS * 8) return (int)cudaErrorInvalidValue;
    const int blocks = (2 * rows + PRE_WARPS - 1) / PRE_WARPS;
    qk_norm_prepass_kernel<<<blocks, 32 * PRE_WARPS, 0, (cudaStream_t)stream>>>(
        (const bf16*)qkv, (const float*)gq, (const float*)gk, (bf16*)qkn, rows, HD, eps);
    return (int)cudaGetLastError();
}

// q, k, v [B, SP, H*128] bf16, unit column stride, element strides (row,
// batch) each; out [B, SP, H*128] contiguous.
extern "C" int omchat_packed_attention(const void* q, long long q_sr, long long q_sb, const void* k, long long k_sr,
                                       long long k_sb, const void* v, long long v_sr, long long v_sb, float q_scale,
                                       void* out, int B, int SP, int H, int D, int valid_len, void* stream) {
    if (D != fwd90::HD || valid_len < 1 || valid_len > SP) return (int)cudaErrorInvalidValue;
    fwd90::Params p{};
    p.out = (bf16*)out;
    p.out_row = (long long)H * D;
    p.out_batch = (long long)SP * H * D;
    p.kv_len_all = valid_len;
    p.B = B, p.S = SP, p.H = H, p.KVH = H, p.T = SP;
    p.causal = 0;
    p.q_scale = q_scale;
    p.mask_value = -INFINITY;
    const long long qs[3] = {D, q_sr, q_sb}, ks[3] = {D, k_sr, k_sb}, vs[3] = {D, v_sr, v_sb};
    CUtensorMap mq, mk, mv;
    if (!fwd90::dense_maps(&mq, &mk, &mv, p, q, qs, k, ks, v, vs, 2)) return (int)cudaErrorInvalidValue;
    return fwd90::launch<false, false>(mq, mk, mv, p, stream);
}
