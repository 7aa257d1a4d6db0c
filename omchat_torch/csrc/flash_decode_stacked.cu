// One query token's GQA attention against one layer of the stacked, read-only
// KV cache, with the in-flight token folded in as a self column (K3), and the
// same against a per-layer cache that already holds the token (K6).
//
// K3 replaces the TPU kernel omchat_tpu/ops/decode_attention.py:109
// flash_decode_stacked (body _decode_kernel_stacked :86, pallas_call :185;
// the fold is omchat_tpu/ops/online_softmax.py:64 fold_self_column).
// K6 replaces omchat_tpu/ops/decode_attention.py:198 flash_decode (body
// _decode_kernel :38, pallas_call :260): the kernel below with SELF = false,
// entry omchat_flash_decode[_e4m3]:
//   q [B, H, D] bf16, k/v cache [B, KVH, T, D] bf16 or e4m3, cache_len [B]
//   int32 valid rows INCLUDING the new token, out [B, H, D] bf16; a request
//   of length 0 writes zeros (the TPU kernel's l == 0 guard).
//
// K3's operands:
//   q            [B, H, D] bf16 (the [B, 1, H, D] query)
//   k/v cache    [L, B, KVH, T, D] bf16, or e4m3 through
//                omchat_flash_decode_stacked_e4m3 (the fp8 cache); layer `layer`
//                is reached by pointer offset, never sliced
//   cache_len    [B] int32 valid rows in the cache, EXCLUDING the new token
//   k_new/v_new  [B, KVH, D] bf16 the in-flight token's K/V
//   out          [B, H, D] bf16
//
// Softmax in the natural-exp domain with scale D^-0.5, as the TPU kernel does;
// p is rounded to bf16 for the PV product, l sums the fp32 p.  An e4m3 cache
// is widened to fp32 on load (exact), and p and the bf16 self column are not
// rounded to it, as the TPU kernel casts K/V to q's dtype
// (decode_attention.py:66,72).
//
// What bounds it on the H100: bytes.  At the main path's ~3.1k cached rows a
// layer reads ~6.4 MB of K/V for ~1.6 MFLOP, ~2 us at 3.35 TB/s.  Design: one
// block per (batch, kv head), 16 warps striding over the cache rows; each
// warp keeps an online softmax per q head of the group (lane owns D/32
// columns), then the warps merge their states through shared memory in a
// fixed order and warp 0 folds the self column and writes the group's heads.
// At B=1 that is only KVH=4 blocks on 132 SMs, so it runs far from the byte
// bound; splitting the cache across blocks is later work.  K6 has K3's bound
// (the same bytes but the self column) and its design.
#include "common.cuh"

namespace {

constexpr int WARPS = 16;
constexpr int MAX_GROUP = 8;

template <int D, typename E, bool SELF>
__global__ void __launch_bounds__(32 * WARPS)
flash_decode_stacked_kernel(const bf16* __restrict__ q, const E* __restrict__ k_cache,
                            const E* __restrict__ v_cache, const int* __restrict__ cache_len, int layer,
                            const bf16* __restrict__ k_new, const bf16* __restrict__ v_new, bf16* __restrict__ out,
                            int B, int KVH, int T, int group, float sm_scale) {
    constexpr int PER = D / 32;  // columns owned by a lane
    __shared__ float q_s[MAX_GROUP][D];
    __shared__ float m_s[WARPS][MAX_GROUP];
    __shared__ float l_s[WARPS][MAX_GROUP];
    __shared__ float acc_s[MAX_GROUP][D];

    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int H = KVH * group;
    const int d0 = lane * PER;

    for (int i = threadIdx.x; i < group * D; i += blockDim.x) {
        const int gi = i / D, d = i % D;
        q_s[gi][d] = __bfloat162float(q[((size_t)b * H + kvh * group + gi) * D + d]);
    }
    for (int i = threadIdx.x; i < MAX_GROUP * D; i += blockDim.x) acc_s[i / D][i % D] = 0.f;
    __syncthreads();

    float qr[MAX_GROUP][PER];
#pragma unroll
    for (int gi = 0; gi < MAX_GROUP; ++gi)
#pragma unroll
        for (int i = 0; i < PER; ++i) qr[gi][i] = gi < group ? q_s[gi][d0 + i] : 0.f;

    float m[MAX_GROUP], l[MAX_GROUP], acc[MAX_GROUP][PER];
#pragma unroll
    for (int gi = 0; gi < MAX_GROUP; ++gi) {
        m[gi] = -INFINITY;
        l[gi] = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[gi][i] = 0.f;
    }

    const size_t plane = (((size_t)layer * B + b) * KVH + kvh) * T * D;
    const E* kc = k_cache + plane;
    const E* vc = v_cache + plane;
    const int len = min(cache_len[b], T);

    for (int r = warp; r < len; r += WARPS) {
        float kf[PER], vf[PER];
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            kf[i] = to_f32(kc[(size_t)r * D + d0 + i]);
            vf[i] = to_f32(vc[(size_t)r * D + d0 + i]);
        }
#pragma unroll
        for (int gi = 0; gi < MAX_GROUP; ++gi) {
            if (gi >= group) break;
            float s = 0.f;
#pragma unroll
            for (int i = 0; i < PER; ++i) s += qr[gi][i] * kf[i];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
            s *= sm_scale;
            const float m_new = fmaxf(m[gi], s);
            const float alpha = __expf(m[gi] - m_new);
            const float p = __expf(s - m_new);
            const float pb = __bfloat162float(__float2bfloat16(p));
            l[gi] = l[gi] * alpha + p;
#pragma unroll
            for (int i = 0; i < PER; ++i) acc[gi][i] = acc[gi][i] * alpha + pb * vf[i];
            m[gi] = m_new;
        }
    }

    // Merge the warps' states: global max first, then each warp adds its
    // rescaled share in warp order (deterministic).
    if (lane == 0)
#pragma unroll
        for (int gi = 0; gi < MAX_GROUP; ++gi) {
            m_s[warp][gi] = m[gi];
            l_s[warp][gi] = l[gi];
        }
    __syncthreads();
    float mg[MAX_GROUP], lg[MAX_GROUP], scale[MAX_GROUP];
#pragma unroll
    for (int gi = 0; gi < MAX_GROUP; ++gi) {
        mg[gi] = -INFINITY;
        for (int w = 0; w < WARPS; ++w) mg[gi] = fmaxf(mg[gi], m_s[w][gi]);
        lg[gi] = 0.f;
        for (int w = 0; w < WARPS; ++w)
            if (m_s[w][gi] != -INFINITY) lg[gi] += l_s[w][gi] * __expf(m_s[w][gi] - mg[gi]);
        scale[gi] = m[gi] == -INFINITY ? 0.f : __expf(m[gi] - mg[gi]);
    }
    // (every loop over the group is unrolled to MAX_GROUP with a guard, so the
    // per-head arrays stay in registers instead of local memory)
    for (int w = 0; w < WARPS; ++w) {
        if (warp == w) {
#pragma unroll
            for (int gi = 0; gi < MAX_GROUP; ++gi)
                if (gi < group)
#pragma unroll
                    for (int i = 0; i < PER; ++i) acc_s[gi][d0 + i] += acc[gi][i] * scale[gi];
        }
        __syncthreads();
    }

    // Without a self column (K6): normalise, warp 0 only; a row that saw no
    // column writes zeros.
    if (!SELF && warp == 0) {
#pragma unroll
        for (int gi = 0; gi < MAX_GROUP; ++gi) {
            if (gi >= group) break;
            const float inv = lg[gi] == 0.f ? 0.f : 1.f / lg[gi];
            bf16* o = out + ((size_t)b * H + kvh * group + gi) * D;
#pragma unroll
            for (int i = 0; i < PER; ++i) o[d0 + i] = __float2bfloat16(acc_s[gi][d0 + i] * inv);
        }
    }
    // Self column (the in-flight token), then normalise: warp 0 only.
    if (SELF && warp == 0) {
        const bf16* kn = k_new + ((size_t)b * KVH + kvh) * D;
        const bf16* vn = v_new + ((size_t)b * KVH + kvh) * D;
#pragma unroll
        for (int gi = 0; gi < MAX_GROUP; ++gi) {
            if (gi >= group) break;
            float s = 0.f;
#pragma unroll
            for (int i = 0; i < PER; ++i) s += qr[gi][i] * __bfloat162float(kn[d0 + i]);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
            s *= sm_scale;
            const float m_new = fmaxf(mg[gi], s);
            const float alpha = __expf(mg[gi] - m_new);
            const float p = __expf(s - m_new);
            const float pb = __bfloat162float(__float2bfloat16(p));
            const float l_new = lg[gi] * alpha + p;
            const float inv = 1.f / l_new;
            bf16* o = out + ((size_t)b * H + kvh * group + gi) * D;
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                const float a = acc_s[gi][d0 + i] * alpha + pb * __bfloat162float(vn[d0 + i]);
                o[d0 + i] = __float2bfloat16(a * inv);
            }
        }
    }
}

template <int D, typename E, bool SELF>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* cache_len, int layer,
           const void* k_new, const void* v_new, void* out, int B, int KVH, int T, int D_arg, int group,
           void* stream) {
    if (group < 1 || group > MAX_GROUP) return (int)cudaErrorInvalidValue;
    if (D_arg != D) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const float sm_scale = 1.f / sqrtf((float)D);
    dim3 grid(KVH, B);
    flash_decode_stacked_kernel<D, E, SELF><<<grid, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (const bf16*)q, (const E*)k_cache, (const E*)v_cache, (const int*)cache_len, layer, (const bf16*)k_new,
        (const bf16*)v_new, (bf16*)out, B, KVH, T, group, sm_scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int omchat_flash_decode_stacked(const void* q, const void* k_cache, const void* v_cache,
                                           const void* cache_len, int layer, const void* k_new, const void* v_new,
                                           void* out, int B, int KVH, int T, int D, int group, void* stream) {
    return launch<128, bf16, true>(q, k_cache, v_cache, cache_len, layer, k_new, v_new, out, B, KVH, T, D, group,
                                   stream);
}

extern "C" int omchat_flash_decode_stacked_e4m3(const void* q, const void* k_cache, const void* v_cache,
                                                const void* cache_len, int layer, const void* k_new,
                                                const void* v_new, void* out, int B, int KVH, int T, int D, int group,
                                                void* stream) {
    return launch<128, e4m3, true>(q, k_cache, v_cache, cache_len, layer, k_new, v_new, out, B, KVH, T, D, group,
                                   stream);
}

// K6: the per-layer cache [B, KVH, T, D] is layer 0 of a one-layer stack.
extern "C" int omchat_flash_decode(const void* q, const void* k_cache, const void* v_cache, const void* cache_len,
                                   void* out, int B, int KVH, int T, int D, int group, void* stream) {
    return launch<128, bf16, false>(q, k_cache, v_cache, cache_len, 0, nullptr, nullptr, out, B, KVH, T, D, group,
                                    stream);
}

extern "C" int omchat_flash_decode_e4m3(const void* q, const void* k_cache, const void* v_cache,
                                        const void* cache_len, void* out, int B, int KVH, int T, int D, int group,
                                        void* stream) {
    return launch<128, e4m3, false>(q, k_cache, v_cache, cache_len, 0, nullptr, nullptr, out, B, KVH, T, D, group,
                                    stream);
}
