// In-place commit of M whole K/V pages into a page-major pool: the prefill
// commit of the serving engine.
//
// Replaces the TPU kernel omchat_tpu/ops/paged_attention.py:695 commit_pages
// (body _commit_pages_kernel :688, pallas_call :741).
//
//   k_pool, v_pool  [NP, KVH, PS, D] bf16, written in place (PyTorch's
//                   counterpart of the TPU call's input_output_aliases)
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
// 2 x 128 KiB for K and V).  Design: one block per destination page, 16-byte
// vector copies, consecutive threads on consecutive addresses.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
commit_pages_kernel(uint4* __restrict__ k_pool, uint4* __restrict__ v_pool, const int* __restrict__ pages,
                    const uint4* __restrict__ k_src, const uint4* __restrict__ v_src, int C, long long stride_g,
                    long long stride_c, long long stride_h, int KVH, int head_vecs) {
    const int m = blockIdx.x;
    const long long g = m / C, c = m % C;
    const size_t dst = (size_t)pages[m] * KVH * head_vecs;
    const long long src = g * stride_g + c * stride_c;  // in 16-byte vectors
    for (int h = 0; h < KVH; ++h) {
        const uint4* ks = k_src + src + h * stride_h;
        const uint4* vs = v_src + src + h * stride_h;
        uint4* kd = k_pool + dst + (size_t)h * head_vecs;
        uint4* vd = v_pool + dst + (size_t)h * head_vecs;
        for (int i = threadIdx.x; i < head_vecs; i += blockDim.x) {
            kd[i] = ks[i];
            vd[i] = vs[i];
        }
    }
}

}  // namespace

// 16-bit elements (the bf16 pool); strides in elements, each a multiple of 8.
extern "C" int omchat_commit_pages(void* k_pool, void* v_pool, const void* pages, const void* k_src,
                                   const void* v_src, int M, int C, long long stride_g, long long stride_c,
                                   long long stride_h, int KVH, int PS, int D, void* stream) {
    if (M == 0) return 0;
    if (C <= 0 || (PS * D) % 8 || stride_g % 8 || stride_c % 8 || stride_h % 8) return (int)cudaErrorInvalidValue;
    commit_pages_kernel<<<M, 256, 0, (cudaStream_t)stream>>>(
        (uint4*)k_pool, (uint4*)v_pool, (const int*)pages, (const uint4*)k_src, (const uint4*)v_src, C,
        stride_g / 8, stride_c / 8, stride_h / 8, KVH, PS * D / 8);
    return (int)cudaGetLastError();
}
