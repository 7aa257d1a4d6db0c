// One query token per request attending to its K/V through a page table, with
// the in-flight token folded in as a self column: the serving engine's decode
// attention.
//
// Replaces the TPU kernel omchat_tpu/ops/paged_attention.py:110
// paged_flash_decode (body _paged_decode_kernel :38, pallas_call :181; the
// fold is omchat_tpu/ops/online_softmax.py:64 fold_self_column).
//
//   q            [B, H, D] bf16 (the [B, 1, H, D] query)
//   k/v_pages    [NP, KVH, PS, D] bf16 page-major pool (PS = 128); a layered
//                pool [L, P+1, ...] is passed flat and `page_offset` (the
//                layer's first page) is added to every table entry
//   lengths      [B] int32 valid rows, EXCLUDING the in-flight token
//   tables       [B, *] int32 rows of `table_stride`, `width` entries used
//   k_new/v_new  [B, KVH, D] bf16 the self column, or null (no self column)
//   out          [B, H, D] bf16
//
// Only the pages below ceil(length / PS) are read; a request of length 0
// reads none and returns v_new (or zeros without a self column).
//
// What bounds it on the H100: bytes.  At the serving workload's mid-decode
// point (16 requests, ~13.5k cached rows in all) a layer reads ~27 MB of K/V
// for ~0.1 GFLOP, ~8 us at 3.35 TB/s.  Design: one block per (kv head,
// request), 8 warps.  Each live page's K and V slice of the block's kv head
// (128 rows x 128 x bf16, 32 KiB each) is staged in shared memory once, by
// cp.async double-buffered against the previous page's math, and serves all
// the GQA group's query heads: the group's q rows (7 for Qwen2-7B, padded to
// 16) are one mma.sync row tile, and each warp takes 16 of the page's 128
// columns with its own fp32 online softmax (exp2 domain, scale folded into
// the scores).  After the last page the 8 warps' states merge through shared
// memory in a fixed order, then the self column folds in.  At 16 requests x 4
// kv heads that is 64 blocks on 132 SMs: half the card idles, and a long
// request's block walks all of its pages alone (no split-KV yet).
#include "common.cuh"

namespace {

constexpr int PS = 128;           // page rows
constexpr int WARPS = 8;          // warps per block
constexpr int COLS = PS / WARPS;  // page columns per warp
constexpr int ROWS = 16;          // q rows of the mma tile (the GQA group, padded)

template <int D>
__global__ void __launch_bounds__(32 * WARPS)
paged_flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                          const bf16* __restrict__ v_pages, const int* __restrict__ lengths,
                          const int* __restrict__ tables, const bf16* __restrict__ k_new,
                          const bf16* __restrict__ v_new, bf16* __restrict__ out, int H, int KVH, int table_stride,
                          int width, int page_offset, float scale_log2) {
    constexpr int LD = D + 8;  // padded smem row (bank spread), 16-byte aligned
    constexpr int STAGE = 2 * PS * LD;  // K and V of one page, elements
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* buf = reinterpret_cast<bf16*>(smem_raw);

    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int group = H / KVH;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;

    // q fragments of the group's heads (rows >= group are zero).
    const bf16* qb = q + ((size_t)b * H + (size_t)kvh * group) * D;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        qa[kk][0] = g < group ? *reinterpret_cast<const uint32_t*>(qb + (size_t)g * D + c) : 0u;
        qa[kk][1] = g + 8 < group ? *reinterpret_cast<const uint32_t*>(qb + (size_t)(g + 8) * D + c) : 0u;
        qa[kk][2] = g < group ? *reinterpret_cast<const uint32_t*>(qb + (size_t)g * D + c + 8) : 0u;
        qa[kk][3] = g + 8 < group ? *reinterpret_cast<const uint32_t*>(qb + (size_t)(g + 8) * D + c + 8) : 0u;
    }

    const int len = lengths[b];
    const int n_pages = len > 0 ? min((len + PS - 1) / PS, width) : 0;
    const size_t page_elems = (size_t)KVH * PS * D;
    const size_t head_off = (size_t)kvh * PS * D;
    const int* table = tables + (size_t)b * table_stride;

    auto stage = [&](int p, int s) {
        const size_t page = (size_t)(table[p] + page_offset);
        const bf16* ksrc = k_pages + page * page_elems + head_off;
        const bf16* vsrc = v_pages + page * page_elems + head_off;
        bf16* kd = buf + s * STAGE;
        bf16* vd = kd + PS * LD;
        for (int idx = threadIdx.x; idx < PS * (D / 8); idx += blockDim.x) {
            const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
            cp_async16(kd + r * LD + c, ksrc + (size_t)r * D + c);
            cp_async16(vd + r * LD + c, vsrc + (size_t)r * D + c);
        }
        cp_async_commit();
    };

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    if (n_pages > 0) stage(0, 0);
    for (int p = 0; p < n_pages; ++p) {
        if (p + 1 < n_pages) {
            stage(p + 1, (p + 1) & 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int c0 = p * PS + warp * COLS;
        if (c0 < len) {  // a warp whose columns all lie past the length skips its share
            const bf16* ks = buf + (p & 1) * STAGE + warp * COLS * LD;
            const bf16* vs = ks + PS * LD;
            auto mask = [&](int, int col, float s) { return c0 + col < len ? s * scale_log2 : OMCHAT_MASK_VALUE; };
            attend_tile<D, COLS>(qa, ks, vs, LD, m, l, acc, mask);
        }
        __syncthreads();  // the buffer is free for the page after next
    }

    // Merge the warps' states through shared memory (the page buffers are free).
    float* m_s = reinterpret_cast<float*>(smem_raw);      // [WARPS][ROWS]
    float* l_s = m_s + WARPS * ROWS;                        // [WARPS][ROWS]
    float* self_s = l_s + WARPS * ROWS;                     // [ROWS]
    float* acc_s = self_s + ROWS;                           // [WARPS][ROWS][D]
    if (t == 0) {
        m_s[warp * ROWS + g] = m[0];
        m_s[warp * ROWS + g + 8] = m[1];
        l_s[warp * ROWS + g] = l[0];
        l_s[warp * ROWS + g + 8] = l[1];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
        const int col = dt * 8 + 2 * t;
        float* a0 = acc_s + ((size_t)warp * ROWS + g) * D + col;
        float* a8 = acc_s + ((size_t)warp * ROWS + g + 8) * D + col;
        a0[0] = acc[dt][0];
        a0[1] = acc[dt][1];
        a8[0] = acc[dt][2];
        a8[1] = acc[dt][3];
    }
    // Self-column scores, one row per warp and pass (fp32 dot of bf16 inputs).
    if (k_new != nullptr) {
        const bf16* kn = k_new + ((size_t)b * KVH + kvh) * D;
        for (int r = warp; r < group; r += WARPS) {
            float s = 0.f;
            for (int d = lane; d < D; d += 32) s += __bfloat162float(qb[(size_t)r * D + d]) * __bfloat162float(kn[d]);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
            if (lane == 0) self_s[r] = s * scale_log2;
        }
    }
    __syncthreads();

    const bf16* vn = v_new != nullptr ? v_new + ((size_t)b * KVH + kvh) * D : nullptr;
    bf16* ob = out + ((size_t)b * H + (size_t)kvh * group) * D;
    for (int i = threadIdx.x; i < group * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        float mg = -INFINITY;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) mg = fmaxf(mg, m_s[w * ROWS + r]);
        float lsum = 0.f, a = 0.f;
        if (mg != -INFINITY) {
#pragma unroll
            for (int w = 0; w < WARPS; ++w) {
                const float mw = m_s[w * ROWS + r];
                if (mw == -INFINITY) continue;  // a warp that saw no column
                const float sc = exp2f(mw - mg);
                lsum += l_s[w * ROWS + r] * sc;
                a += acc_s[((size_t)w * ROWS + r) * D + d] * sc;
            }
        }
        if (vn != nullptr) {
            const float ss = self_s[r];
            const float m_new = fmaxf(mg, ss);
            const float alpha = exp2f(mg - m_new);  // mg = -inf (no cached row): 0
            const float p = exp2f(ss - m_new);
            lsum = lsum * alpha + p;
            a = a * alpha + __bfloat162float(__float2bfloat16(p)) * __bfloat162float(vn[d]);
        }
        ob[(size_t)r * D + d] = __float2bfloat16(lsum == 0.f ? 0.f : a / lsum);
    }
}

template <int D>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* lengths, const void* tables,
           const void* k_new, const void* v_new, void* out, int B, int H, int KVH, int table_stride, int width,
           int page_offset, void* stream) {
    constexpr int LD = D + 8;
    const size_t smem = 2 * 2 * (size_t)PS * LD * sizeof(bf16);  // two stages of K and V
    static_assert((2 * WARPS * ROWS + ROWS + WARPS * ROWS * D) * sizeof(float) <= 2 * 2 * PS * (D + 8) * sizeof(bf16),
                  "the merge scratch must fit the page buffers");
    cudaFuncSetAttribute(paged_flash_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
    dim3 grid(KVH, B);
    paged_flash_decode_kernel<D><<<grid, 32 * WARPS, smem, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k_pages, (const bf16*)v_pages, (const int*)lengths, (const int*)tables,
        (const bf16*)k_new, (const bf16*)v_new, (bf16*)out, H, KVH, table_stride, width, page_offset, scale_log2);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int omchat_paged_flash_decode(const void* q, const void* k_pages, const void* v_pages, const void* lengths,
                                         const void* tables, const void* k_new, const void* v_new, void* out, int B,
                                         int H, int KVH, int page_size, int D, int table_stride, int width,
                                         int page_offset, void* stream) {
    if (KVH <= 0 || H % KVH != 0 || H / KVH > ROWS) return (int)cudaErrorInvalidValue;
    if (D != 128 || page_size != PS) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    return launch<128>(q, k_pages, v_pages, lengths, tables, k_new, v_new, out, B, H, KVH, table_stride, width,
                       page_offset, stream);
}
