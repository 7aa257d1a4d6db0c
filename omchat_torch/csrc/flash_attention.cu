// Causal / non-causal GQA flash attention forward over a head-major KV layout.
//
// Replaces the TPU kernel omchat_tpu/ops/flash_attention.py:246 flash_attention
// (body _attn_core, :35; pallas_call :462) on the Qwen2 prefill path, kv_format
// "bntd", without segment ids.
//
//   q   [B, S, H, D] bf16, already multiplied (in bf16) by D^-0.5 * log2(e)
//   k,v [B, KVH, T, D] bf16 (a layer of the stacked cache)
//   q_offset, kv_len [B] int32; query row i sits at kv position i + q_offset
//   out [B, S, H, D] bf16
//
// What bounds it on the H100: at the main-path shape (S=3200, T=3328, H=28,
// KVH=4, D=128, causal) the work is ~77 GFLOP against ~30 MB of q/k/v/out, so
// it is bound by tensor-core operations, not bytes.  Design: one block per
// (16 query rows, kv head, batch) with one warp per q head of the GQA group
// (7 warps for Qwen2-7B), so every K/V tile staged in shared memory serves the
// whole group once; QK^T and PV run on mma.sync m16n8k16 with fp32
// accumulation and an online exp2 softmax kept in registers.  Tiles above the
// causal diagonal or past kv_len are skipped, not masked.  The TPU kernel's
// "anchored" walk is a bookkeeping trick of that machine; a plain online
// softmax computes the same function.  No TMA, wgmma or pipelining yet.
#include "common.cuh"

namespace {

constexpr int ROWS = 16;     // query rows per block (one mma row tile per warp)
constexpr int KV_TILE = 64;  // kv rows per shared-memory tile
constexpr int MAX_GROUP = 8;  // 256 threads: leaves the compiler 255 registers a thread

template <int D>
__global__ void __launch_bounds__(32 * MAX_GROUP)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       bf16* __restrict__ out, const int* __restrict__ q_offset, const int* __restrict__ kv_len,
                       int S, int H, int KVH, int T, int causal) {
    constexpr int LD = D + 8;  // padded smem row (bank spread), 16-byte aligned
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

    // q fragments straight from global memory into registers.
    uint32_t qa[D / 16][4];
    {
        const int row_a = r0 + g, row_b = r0 + g + 8;
        const bf16* qa_row = q + ((size_t)(b * S + row_a) * H + head) * D;
        const bf16* qb_row = q + ((size_t)(b * S + row_b) * H + head) * D;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const int c = kk * 16 + 2 * t;
            qa[kk][0] = row_a < S ? *reinterpret_cast<const uint32_t*>(qa_row + c) : 0u;
            qa[kk][1] = row_b < S ? *reinterpret_cast<const uint32_t*>(qb_row + c) : 0u;
            qa[kk][2] = row_a < S ? *reinterpret_cast<const uint32_t*>(qa_row + c + 8) : 0u;
            qa[kk][3] = row_b < S ? *reinterpret_cast<const uint32_t*>(qb_row + c + 8) : 0u;
        }
    }

    // kv columns this block needs: below kv_len and, if causal, at or below
    // the diagonal of its last valid row.
    int end = min(klen, T);
    if (causal) end = min(end, min(r0 + ROWS, S) - 1 + qoff + 1);
    const int n_tiles = end > 0 ? (end + KV_TILE - 1) / KV_TILE : 0;

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    const bf16* kbase = k + (size_t)(b * KVH + kvh) * T * D;
    const bf16* vbase = v + (size_t)(b * KVH + kvh) * T * D;
    constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
    const int nthreads = blockDim.x;

    for (int j = 0; j < n_tiles; ++j) {
        const int c0 = j * KV_TILE;
        __syncthreads();  // the previous tile is no longer read
        for (int idx = threadIdx.x; idx < KV_TILE * CHUNKS; idx += nthreads) {
            const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
            uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
            if (c0 + r < T) {
                kv4 = *reinterpret_cast<const uint4*>(kbase + (size_t)(c0 + r) * D + c);
                vv4 = *reinterpret_cast<const uint4*>(vbase + (size_t)(c0 + r) * D + c);
            }
            *reinterpret_cast<uint4*>(ks + r * LD + c) = kv4;
            *reinterpret_cast<uint4*>(vs + r * LD + c) = vv4;
        }
        __syncthreads();
        const int row_a = r0 + g;
        auto mask = [&](int half, int col, float s) {
            const int kvpos = c0 + col;
            const int qpos = row_a + half * 8 + qoff;
            const bool ok = kvpos < klen && (!causal || kvpos <= qpos);
            return ok ? s : OMCHAT_MASK_VALUE;
        };
        attend_tile<D, KV_TILE>(qa, ks, vs, LD, m, l, acc, mask);
    }

    const int row_a = r0 + g, row_b = r0 + g + 8;
    bf16* oa = row_a < S ? out + ((size_t)(b * S + row_a) * H + head) * D : nullptr;
    bf16* ob = row_b < S ? out + ((size_t)(b * S + row_b) * H + head) * D : nullptr;
    store_rows<D>(acc, l, oa, ob);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, const void* q_offset, const void* kv_len, int B,
           int S, int H, int KVH, int T, int causal, void* stream) {
    const int group = H / KVH;
    const size_t smem = 2 * (size_t)KV_TILE * (D + 8) * sizeof(bf16);
    cudaFuncSetAttribute(flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    dim3 grid((S + ROWS - 1) / ROWS, KVH, B);
    flash_attention_kernel<D><<<grid, 32 * group, smem, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (const int*)q_offset, (const int*)kv_len, S, H,
        KVH, T, causal);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int omchat_flash_attention(const void* q, const void* k, const void* v, void* out, const void* q_offset,
                                      const void* kv_len, int B, int S, int H, int KVH, int T, int D, int causal,
                                      void* stream) {
    if (KVH <= 0 || H % KVH != 0 || H / KVH > MAX_GROUP) return (int)cudaErrorInvalidValue;
    if (D != 128) return (int)cudaErrorInvalidValue;  // the head width of Qwen2-7B and InternViT-6B
    return launch<128>(q, k, v, out, q_offset, kv_len, B, S, H, KVH, T, causal, stream);
}
