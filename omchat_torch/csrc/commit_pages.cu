// In-place commit of M whole K/V pages into a page-major pool: the prefill
// commit of the serving engine.
//
// Replaces the TPU kernel omchat_tpu/ops/paged_attention.py:695 commit_pages
// (body _commit_pages_kernel :688, pallas_call :741).
//
//   k_pool, v_pool  [NP, KVH, PS, D] bf16, written in place (PyTorch's
//                   counterpart of the TPU call's input_output_aliases), or
//                   e4m3 through omchat_commit_pages_e4m3: the bf16 chunks are
//                   rounded in the kernel as jnp.astype(float8_e4m3fn) rounds
//                   them before the TPU call (paged_attention.py:751; NaN past
//                   464, common.cuh bf16x8_to_e4m3x8)
//   pages           [M] int32 destination page of chunk m
//   k_src, v_src    the chunks, chunk m = (g, c) with g = m / C, c = m % C:
//                   head h's PS x D page rows start at element
//                   g * stride_g + c * stride_c + h * stride_h and are
//                   contiguous.  The engine passes its contiguous scratch
//                   cache [L*B, KVH, T, D] as-is (stride_g = KVH*T*D,
//                   stride_c = PS*D, stride_h = T*D), so no transposed copy of
//                   it is ever made.
//
// Duplicate destinations occur only on the parking page (replica pad rows,
// chunks past a request's pages): garbage over garbage in no defined order,
// so nothing asserts uniqueness.
//
// What bounds it on the H100: bytes (each page is read once and written once,
// 2 x 128 KiB for K and V; into e4m3, 128 KiB read and 64 KiB written each).
// Design: one block per destination page, 16-byte vector loads of 8 source
// values, consecutive threads on consecutive addresses; the e4m3 variant
// stores each vector's 8 rounded bytes as one 8-byte store.  The rounding
// must not cost more than the bytes: it rounds two values an instruction
// (common.cuh bf16x2_to_e4m3x2).
#include "common.cuh"

namespace {

// 8 source values (one 16-byte vector) as stored in the pool: as they are, or
// rounded to e4m3 one byte each (common.cuh, the store K4 shares).
__device__ __forceinline__ uint4 store_as(uint4 x, uint4*) { return x; }
__device__ __forceinline__ uint2 store_as(uint4 x, uint2*) { return bf16x8_to_e4m3x8(x); }

// The pool as vectors V (uint4: 8 bf16; uint2: 8 e4m3): one per source vector.
template <typename V>
__global__ void __launch_bounds__(256)
commit_pages_kernel(V* __restrict__ k_pool, V* __restrict__ v_pool, const int* __restrict__ pages,
                    const uint4* __restrict__ k_src, const uint4* __restrict__ v_src, int C, long long stride_g,
                    long long stride_c, long long stride_h, int KVH, int head_vecs) {
    const int m = blockIdx.x;
    const long long g = m / C, c = m % C;
    const size_t dst = (size_t)pages[m] * KVH * head_vecs;
    const long long src = g * stride_g + c * stride_c;  // in 16-byte vectors
    for (int h = 0; h < KVH; ++h) {
        const uint4* ks = k_src + src + h * stride_h;
        const uint4* vs = v_src + src + h * stride_h;
        V* kd = k_pool + dst + (size_t)h * head_vecs;
        V* vd = v_pool + dst + (size_t)h * head_vecs;
        for (int i = threadIdx.x; i < head_vecs; i += blockDim.x) {
            kd[i] = store_as(ks[i], kd);
            vd[i] = store_as(vs[i], vd);
        }
    }
}

template <typename V>
int launch(void* k_pool, void* v_pool, const void* pages, const void* k_src, const void* v_src, int M, int C,
           long long stride_g, long long stride_c, long long stride_h, int KVH, int PS, int D, void* stream) {
    if (M == 0) return 0;
    if (C <= 0 || (PS * D) % 8 || stride_g % 8 || stride_c % 8 || stride_h % 8) return (int)cudaErrorInvalidValue;
    commit_pages_kernel<V><<<M, 256, 0, (cudaStream_t)stream>>>(
        (V*)k_pool, (V*)v_pool, (const int*)pages, (const uint4*)k_src, (const uint4*)v_src, C, stride_g / 8,
        stride_c / 8, stride_h / 8, KVH, PS * D / 8);
    return (int)cudaGetLastError();
}

}  // namespace

// bf16 chunks into a bf16 pool (a bitwise copy); strides in source elements,
// each a multiple of 8 (16 bytes).
extern "C" int omchat_commit_pages(void* k_pool, void* v_pool, const void* pages, const void* k_src,
                                   const void* v_src, int M, int C, long long stride_g, long long stride_c,
                                   long long stride_h, int KVH, int PS, int D, void* stream) {
    return launch<uint4>(k_pool, v_pool, pages, k_src, v_src, M, C, stride_g, stride_c, stride_h, KVH, PS, D, stream);
}

// bf16 chunks into an e4m3 pool (8-byte aligned), rounded in the kernel; the
// same source strides.
extern "C" int omchat_commit_pages_e4m3(void* k_pool, void* v_pool, const void* pages, const void* k_src,
                                        const void* v_src, int M, int C, long long stride_g, long long stride_c,
                                        long long stride_h, int KVH, int PS, int D, void* stream) {
    return launch<uint2>(k_pool, v_pool, pages, k_src, v_src, M, C, stride_g, stride_c, stride_h, KVH, PS, D, stream);
}
