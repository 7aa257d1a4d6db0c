// In-place commit of N single-token K/V rows into a page-major pool.
//
// Replaces the TPU kernel omchat_tpu/ops/paged_attention.py:619 commit_rows
// (body _commit_rows_kernel :598, pallas_call :674).  On the decode path the
// pool is the stacked cache [L, B, KVH, T, D] seen as [L*B, KVH, T, D]: each
// (layer, batch) row of the cache is one "page" and the offset is the write
// position.
//
//   k_pool, v_pool  [P, KVH, PS, D], written in place (PyTorch's counterpart of
//                   the TPU call's input_output_aliases)
//   pages, offsets  [N] int32
//   k_rows, v_rows  [N, KVH, D], same element type as the pools
//
// The TPU kernel moves an 8-row window per row because of its sublane tiling;
// here exactly the one row per (page, offset) is written and nothing else is
// touched.  What bounds it on the H100: nothing but launch latency — the main
// path commits 28 rows of 2 x 4 x 128 bf16 (57 KB in, 57 KB out) per decode
// step.  Design: one block per row, threads over KVH * D elements.
#include "common.cuh"

namespace {

template <typename T>
__global__ void commit_rows_kernel(T* __restrict__ k_pool, T* __restrict__ v_pool, const int* __restrict__ pages,
                                   const int* __restrict__ offsets, const T* __restrict__ k_rows,
                                   const T* __restrict__ v_rows, int KVH, int PS, int D) {
    const int n = blockIdx.x;
    const size_t page = (size_t)pages[n];
    const size_t off = (size_t)offsets[n];
    for (int i = threadIdx.x; i < KVH * D; i += blockDim.x) {
        const int h = i / D, d = i % D;
        const size_t dst = ((page * KVH + h) * PS + off) * D + d;
        k_pool[dst] = k_rows[(size_t)n * KVH * D + i];
        v_pool[dst] = v_rows[(size_t)n * KVH * D + i];
    }
}

}  // namespace

// 16-bit elements (the bf16 cache); the copy is bitwise.
extern "C" int omchat_commit_rows(void* k_pool, void* v_pool, const void* pages, const void* offsets,
                                  const void* k_rows, const void* v_rows, int N, int KVH, int PS, int D,
                                  void* stream) {
    if (N == 0) return 0;
    const int threads = KVH * D < 512 ? KVH * D : 512;
    commit_rows_kernel<unsigned short><<<N, threads, 0, (cudaStream_t)stream>>>(
        (unsigned short*)k_pool, (unsigned short*)v_pool, (const int*)pages, (const int*)offsets,
        (const unsigned short*)k_rows, (const unsigned short*)v_rows, KVH, PS, D);
    return (int)cudaGetLastError();
}
