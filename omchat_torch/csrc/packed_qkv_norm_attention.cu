// qk-RMSNorm + non-causal packed self-attention over the unsplit qkv rows of
// InternViT-6B.
//
// Replaces the TPU kernel omchat_tpu/ops/flash_attention.py:559
// packed_qkv_norm_attention (body _packed_qkv_norm_kernel :527, pallas_call
// :603).
//
//   qkv    [B, SP, 3*H*D] bf16 as the fused qkv matmul writes it; head h reads
//          columns h*D (q), H*D + h*D (k) and 2*H*D + h*D (v) of each row
//   rq, rk [B, SP] fp32 per-token rstd over the flattened H*D axis (computed
//          outside, as in JAX)
//   gq, gk [H*D] fp32 gammas; gq already carries D^-0.5 * log2(e)
//   out    [B, SP, H*D] bf16; rows >= valid_len are garbage (as on the TPU)
//
// q and k are normalised on load, x * rstd * gamma in fp32 and rounded to bf16
// before the QK dot, exactly as the TPU body does (:538-543).  Columns at or
// past valid_len are masked with -inf (the TPU kernel's mask).
//
// What bounds it on the H100: ~41 GFLOP per launch at the main-path shape
// (3 tiles, SP=1032, H=25, D=128) against ~40 MB moved, so tensor-core
// operations.  The TPU kernel holds a whole [SP, SP] fp32 score block per
// (b, h) in VMEM (4.3 MB at SP=1032), far over the 227 KB of shared memory a
// Hopper block gets, so this is a tiled online-softmax kernel instead: one
// block per (64 query rows, head, batch), four warps of 16 rows each,
// 64-row K/V tiles normalised into shared memory, QK^T and PV on mma.sync
// m16n8k16 with fp32 accumulation.  It computes the same function; it is not
// carried over block by block.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 16 * WARPS;  // query rows per block
constexpr int KV_TILE = 64;

template <int D>
__global__ void __launch_bounds__(32 * WARPS)
packed_qkv_norm_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ rq,
                                 const float* __restrict__ rk, const float* __restrict__ gq,
                                 const float* __restrict__ gk, bf16* __restrict__ out, int SP, int H,
                                 int valid_len) {
    constexpr int LD = D + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* ks = reinterpret_cast<bf16*>(smem_raw);
    bf16* vs = ks + KV_TILE * LD;

    const int HD = H * D;
    const int row_stride = 3 * HD;
    const int b = blockIdx.z;
    const int h = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row_a = blockIdx.x * ROWS + warp * 16 + g;
    const int row_b = row_a + 8;

    const bf16* base = qkv + (size_t)b * SP * row_stride;
    const float* rq_b = rq + (size_t)b * SP;
    const float* rk_b = rk + (size_t)b * SP;
    const float* gq_h = gq + h * D;
    const float* gk_h = gk + h * D;

    // Normalised q fragments: (x * rstd) * gamma in fp32, rounded to bf16.
    uint32_t qa[D / 16][4];
    {
        const bf16* xa = base + (size_t)row_a * row_stride + h * D;
        const bf16* xb = base + (size_t)row_b * row_stride + h * D;
        const float ra = row_a < SP ? rq_b[row_a] : 0.f;
        const float rb = row_b < SP ? rq_b[row_b] : 0.f;
        auto frag = [&](const bf16* x, float r, bool ok, int c) -> uint32_t {
            if (!ok) return 0u;
            return pack_bf16(__bfloat162float(x[c]) * r * gq_h[c], __bfloat162float(x[c + 1]) * r * gq_h[c + 1]);
        };
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const int c = kk * 16 + 2 * t;
            qa[kk][0] = frag(xa, ra, row_a < SP, c);
            qa[kk][1] = frag(xb, rb, row_b < SP, c);
            qa[kk][2] = frag(xa, ra, row_a < SP, c + 8);
            qa[kk][3] = frag(xb, rb, row_b < SP, c + 8);
        }
    }

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    constexpr int CHUNKS = D / 8;
    const int n_tiles = (valid_len + KV_TILE - 1) / KV_TILE;
    for (int j = 0; j < n_tiles; ++j) {
        const int c0 = j * KV_TILE;
        __syncthreads();
        for (int idx = threadIdx.x; idx < KV_TILE * CHUNKS; idx += 32 * WARPS) {
            const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
            uint4 kn = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
            if (c0 + r < SP) {
                const bf16* row = base + (size_t)(c0 + r) * row_stride;
                const uint4 kx = *reinterpret_cast<const uint4*>(row + HD + h * D + c);
                vv = *reinterpret_cast<const uint4*>(row + 2 * HD + h * D + c);
                const float rr = rk_b[c0 + r];
                const bf16* kxe = reinterpret_cast<const bf16*>(&kx);
                uint32_t* kne = reinterpret_cast<uint32_t*>(&kn);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    kne[e] = pack_bf16(__bfloat162float(kxe[2 * e]) * rr * gk_h[c + 2 * e],
                                       __bfloat162float(kxe[2 * e + 1]) * rr * gk_h[c + 2 * e + 1]);
                }
            }
            *reinterpret_cast<uint4*>(ks + r * LD + c) = kn;
            *reinterpret_cast<uint4*>(vs + r * LD + c) = vv;
        }
        __syncthreads();
        auto mask = [&](int, int col, float s) { return c0 + col < valid_len ? s : -INFINITY; };
        attend_tile<D, KV_TILE>(qa, ks, vs, LD, m, l, acc, mask);
    }

    bf16* oa = row_a < SP ? out + ((size_t)b * SP + row_a) * HD + h * D : nullptr;
    bf16* ob = row_b < SP ? out + ((size_t)b * SP + row_b) * HD + h * D : nullptr;
    store_rows<D>(acc, l, oa, ob);
}

template <int D>
int launch(const void* qkv, const void* rq, const void* rk, const void* gq, const void* gk, void* out, int B, int SP,
           int H, int valid_len, void* stream) {
    const size_t smem = 2 * (size_t)KV_TILE * (D + 8) * sizeof(bf16);
    cudaFuncSetAttribute(packed_qkv_norm_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    dim3 grid((SP + ROWS - 1) / ROWS, H, B);
    packed_qkv_norm_attention_kernel<D><<<grid, 32 * WARPS, smem, (cudaStream_t)stream>>>(
        (const bf16*)qkv, (const float*)rq, (const float*)rk, (const float*)gq, (const float*)gk, (bf16*)out, SP, H,
        valid_len);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int omchat_packed_qkv_norm_attention(const void* qkv, const void* rq, const void* rk, const void* gq,
                                                const void* gk, void* out, int B, int SP, int H, int D,
                                                int valid_len, void* stream) {
    if (valid_len < 1 || valid_len > SP) return (int)cudaErrorInvalidValue;
    if (D != 128) return (int)cudaErrorInvalidValue;
    return launch<128>(qkv, rq, rk, gq, gk, out, B, SP, H, valid_len, stream);
}
