// qk-RMSNorm + non-causal packed self-attention over the unsplit qkv rows of
// InternViT-6B (K1), and the same attention without the norm for a tower
// without qk-norm (K5).
//
// K1 replaces the TPU kernel omchat_tpu/ops/flash_attention.py:559
// packed_qkv_norm_attention (body _packed_qkv_norm_kernel :527, pallas_call
// :603).  K5 replaces omchat_tpu/ops/flash_attention.py:624
// packed_self_attention (body _packed_kernel :483, pallas_call :670): the
// kernel below with NORM = false, entry omchat_packed_self_attention:
//   q, k, v  [B, SP, H*D] bf16 lane slices, each row `row_stride` and each
//            batch `batch_stride` elements apart (the chunk(3) views of the
//            fused qkv, read in place: no copy)
//   q_scale  fp32 factor on q, rounded to bf16 before the QK dot (as the TPU
//            body's prescale): D^-0.5 * log2(e), or 1 where the caller
//            already folded it into q
//   out      [B, SP, H*D] bf16; rows >= valid_len are garbage
// The softmax, masking and products are K1's.
//
// K1's operands:
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

// NORM: K1 (q and k normalised on load; q_scale unused).  !NORM: K5 (q
// multiplied by q_scale, k as stored; rq, rk, gq, gk unused).
template <int D, bool NORM>
__global__ void __launch_bounds__(32 * WARPS)
packed_attention_kernel(const bf16* __restrict__ q_base, const bf16* __restrict__ k_base,
                        const bf16* __restrict__ v_base, const float* __restrict__ rq, const float* __restrict__ rk,
                        const float* __restrict__ gq, const float* __restrict__ gk, float q_scale,
                        bf16* __restrict__ out, int SP, int H, long long batch_stride, int row_stride,
                        int valid_len) {
    constexpr int LD = D + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* ks = reinterpret_cast<bf16*>(smem_raw);
    bf16* vs = ks + KV_TILE * LD;

    const int HD = H * D;
    const int b = blockIdx.z;
    const int h = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row_a = blockIdx.x * ROWS + warp * 16 + g;
    const int row_b = row_a + 8;

    const size_t boff = (size_t)b * batch_stride + (size_t)h * D;
    const bf16* q_bh = q_base + boff;
    const bf16* k_bh = k_base + boff;
    const bf16* v_bh = v_base + boff;
    const float* rq_b = NORM ? rq + (size_t)b * SP : nullptr;
    const float* rk_b = NORM ? rk + (size_t)b * SP : nullptr;
    const float* gq_h = NORM ? gq + h * D : nullptr;
    const float* gk_h = NORM ? gk + h * D : nullptr;

    // q fragments in fp32, rounded to bf16: (x * rstd) * gamma (K1) or
    // x * q_scale (K5).
    uint32_t qa[D / 16][4];
    {
        const bf16* xa = q_bh + (size_t)row_a * row_stride;
        const bf16* xb = q_bh + (size_t)row_b * row_stride;
        const float ra = NORM ? (row_a < SP ? rq_b[row_a] : 0.f) : q_scale;
        const float rb = NORM ? (row_b < SP ? rq_b[row_b] : 0.f) : q_scale;
        auto frag = [&](const bf16* x, float r, bool ok, int c) -> uint32_t {
            if (!ok) return 0u;
            if (!NORM) return pack_bf16(__bfloat162float(x[c]) * r, __bfloat162float(x[c + 1]) * r);
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
                const size_t row = (size_t)(c0 + r) * row_stride + c;
                const uint4 kx = *reinterpret_cast<const uint4*>(k_bh + row);
                vv = *reinterpret_cast<const uint4*>(v_bh + row);
                if (NORM) {
                    const float rr = rk_b[c0 + r];
                    const bf16* kxe = reinterpret_cast<const bf16*>(&kx);
                    uint32_t* kne = reinterpret_cast<uint32_t*>(&kn);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        kne[e] = pack_bf16(__bfloat162float(kxe[2 * e]) * rr * gk_h[c + 2 * e],
                                           __bfloat162float(kxe[2 * e + 1]) * rr * gk_h[c + 2 * e + 1]);
                    }
                } else {
                    kn = kx;
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

template <int D, bool NORM>
int launch(const bf16* q, const bf16* k, const bf16* v, const void* rq, const void* rk, const void* gq,
           const void* gk, float q_scale, void* out, int B, int SP, int H, long long batch_stride, int row_stride,
           int valid_len, void* stream) {
    if (valid_len < 1 || valid_len > SP) return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * (size_t)KV_TILE * (D + 8) * sizeof(bf16);
    cudaFuncSetAttribute(packed_attention_kernel<D, NORM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    dim3 grid((SP + ROWS - 1) / ROWS, H, B);
    packed_attention_kernel<D, NORM><<<grid, 32 * WARPS, smem, (cudaStream_t)stream>>>(
        q, k, v, (const float*)rq, (const float*)rk, (const float*)gq, (const float*)gk, q_scale, (bf16*)out, SP, H,
        batch_stride, row_stride, valid_len);
    return (int)cudaGetLastError();
}

}  // namespace

// K1: q, k and v are the three column blocks of each qkv row.
extern "C" int omchat_packed_qkv_norm_attention(const void* qkv, const void* rq, const void* rk, const void* gq,
                                                const void* gk, void* out, int B, int SP, int H, int D,
                                                int valid_len, void* stream) {
    if (D != 128) return (int)cudaErrorInvalidValue;
    const bf16* base = (const bf16*)qkv;
    const int HD = H * D;
    return launch<128, true>(base, base + HD, base + 2 * HD, rq, rk, gq, gk, 1.f, out, B, SP, H,
                             (long long)SP * 3 * HD, 3 * HD, valid_len, stream);
}

// K5: q, k, v with one layout (element strides; 16-byte aligned rows).
extern "C" int omchat_packed_self_attention(const void* q, const void* k, const void* v, float q_scale, void* out,
                                            int B, int SP, int H, int D, long long batch_stride, int row_stride,
                                            int valid_len, void* stream) {
    if (D != 128) return (int)cudaErrorInvalidValue;
    return launch<128, false>((const bf16*)q, (const bf16*)k, (const bf16*)v, nullptr, nullptr, nullptr, nullptr,
                              q_scale, out, B, SP, H, batch_stride, row_stride, valid_len, stream);
}
