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
//   k_rows, v_rows  [N, KVH, D], same element type as the pools; bf16 rows
//                   into an e4m3 pool through omchat_commit_rows_e4m3, which
//                   rounds each value as jnp.astype(float8_e4m3fn) does (NaN
//                   past 464, common.cuh f32_to_e4m3), as the TPU kernel's
//                   .astype(ko_ref.dtype) stores it (paged_attention.py:609)
//
// The TPU kernel moves an 8-row window per row because of its sublane tiling;
// here exactly the one row per (page, offset) is written and nothing else is
// touched.  What bounds it on the H100: nothing but launch latency — the main
// path commits 28 rows of 2 x 4 x 128 bf16 (57 KB in, 57 KB out) per decode
// step.  Design: one block per row, threads over KVH * D elements.
#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned short store_as(unsigned short x, unsigned short*) { return x; }
__device__ __forceinline__ unsigned char store_as(unsigned short x, unsigned char*) {
    return f32_to_e4m3(__uint_as_float((unsigned)x << 16));  // the bf16 bits widened to f32
}

template <typename T>
__global__ void commit_rows_kernel(T* __restrict__ k_pool, T* __restrict__ v_pool, const int* __restrict__ pages,
                                   const int* __restrict__ offsets, const unsigned short* __restrict__ k_rows,
                                   const unsigned short* __restrict__ v_rows, int KVH, int PS, int D) {
    const int n = blockIdx.x;
    const size_t page = (size_t)pages[n];
    const size_t off = (size_t)offsets[n];
    for (int i = threadIdx.x; i < KVH * D; i += blockDim.x) {
        const int h = i / D, d = i % D;
        const size_t dst = ((page * KVH + h) * PS + off) * D + d;
        k_pool[dst] = store_as(k_rows[(size_t)n * KVH * D + i], k_pool);
        v_pool[dst] = store_as(v_rows[(size_t)n * KVH * D + i], v_pool);
    }
}

template <typename T>
int launch(void* k_pool, void* v_pool, const void* pages, const void* offsets, const void* k_rows, const void* v_rows,
           int N, int KVH, int PS, int D, void* stream) {
    if (N == 0) return 0;
    const int threads = KVH * D < 512 ? KVH * D : 512;
    commit_rows_kernel<T><<<N, threads, 0, (cudaStream_t)stream>>>(
        (T*)k_pool, (T*)v_pool, (const int*)pages, (const int*)offsets, (const unsigned short*)k_rows,
        (const unsigned short*)v_rows, KVH, PS, D);
    return (int)cudaGetLastError();
}

}  // namespace

// bf16 rows into a bf16 pool; the copy is bitwise.
extern "C" int omchat_commit_rows(void* k_pool, void* v_pool, const void* pages, const void* offsets,
                                  const void* k_rows, const void* v_rows, int N, int KVH, int PS, int D,
                                  void* stream) {
    return launch<unsigned short>(k_pool, v_pool, pages, offsets, k_rows, v_rows, N, KVH, PS, D, stream);
}

// bf16 rows into an e4m3 pool, rounded in the kernel.
extern "C" int omchat_commit_rows_e4m3(void* k_pool, void* v_pool, const void* pages, const void* offsets,
                                       const void* k_rows, const void* v_rows, int N, int KVH, int PS, int D,
                                       void* stream) {
    return launch<unsigned char>(k_pool, v_pool, pages, offsets, k_rows, v_rows, N, KVH, PS, D, stream);
}
