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
//   k_rows, v_rows  [N, KVH, D] bf16; into a bf16 pool the copy is bitwise,
//                   into an e4m3 pool (omchat_commit_rows_e4m3) each value is
//                   rounded as jnp.astype(float8_e4m3fn) rounds it (NaN past
//                   464, common.cuh bf16x2_to_e4m3x2), as the TPU kernel's
//                   .astype(ko_ref.dtype) stores it (paged_attention.py:609)
//
// Rows sharing a (page, offset) race; only the parking page of the serving
// engine receives such rows.  The TPU kernel moves an 8-row window per row
// because of its sublane tiling; here exactly the one row per (page, offset)
// is written and no other byte of the pools changes.
//
// What bounds it on the H100: its launch.  The decode step commits 28 rows
// of 2 x 4 x 128 bf16 (57 KB in, 57 KB out: 0.03 us at 3.35 TB/s); the
// serving roll 28 x 16 rows.  Design: nothing a thread does may cost more
// than the launch, so a thread moves one 16-byte vector of 8 values (an
// 8-byte vector of e4m3 into an e4m3 pool, rounded two values an
// instruction), with no division: the block is (a head's vectors, heads,
// rows), the grid (row groups, K then V), so a thread finds its vector from
// its coordinates alone (K and V of a row in one block read 12-20% slower).
// A row whose head width D is not a multiple of 8, or whose pointers a
// vector cannot take, goes through the same kernel one value a thread.
// omchat_commit_rows_floor launches a kernel that does nothing on the same
// grid: the launch floor K4 is read against.
#include "common.cuh"

namespace {

// One unit of a row as the pool stores it: a 16-byte vector of 8 bf16 values
// as it is or as its 8 e4m3 bytes, or one bf16 value as it is or as its byte.
__device__ __forceinline__ uint4 store_as(uint4 x, uint4*) { return x; }
__device__ __forceinline__ uint2 store_as(uint4 x, uint2*) { return bf16x8_to_e4m3x8(x); }
__device__ __forceinline__ unsigned short store_as(unsigned short x, unsigned short*) { return x; }
__device__ __forceinline__ unsigned char store_as(unsigned short x, unsigned char*) {
    return (unsigned char)bf16x2_to_e4m3x2(x);  // the upper value is +0, so its byte is 0
}

// threadIdx: (x) a unit of a head, (y) a head, (z) a row of the block's rows;
// blockIdx: (x) the block's rows, (y) 0 for K, 1 for V.  `units` units make
// one head's D values (D / 8 vectors, or D values).
template <typename P, typename S>
__global__ void commit_rows_kernel(P* __restrict__ k_pool, P* __restrict__ v_pool, const int* __restrict__ pages,
                                   const int* __restrict__ offsets, const S* __restrict__ k_rows,
                                   const S* __restrict__ v_rows, int N, int KVH, int PS, int units) {
    const int n = blockIdx.x * blockDim.z + threadIdx.z;
    if (n >= N) return;
    P* pool = blockIdx.y ? v_pool : k_pool;
    const S* row = (blockIdx.y ? v_rows : k_rows) + (size_t)n * KVH * units;
    const size_t slot = (size_t)pages[n] * KVH * PS + offsets[n];  // (page, head 0, offset), in rows of D values
    for (int h = threadIdx.y; h < KVH; h += blockDim.y) {
        P* dst = pool + (slot + (size_t)h * PS) * units;
        const S* src = row + h * units;
        for (int i = threadIdx.x; i < units; i += blockDim.x) dst[i] = store_as(src[i], dst);
    }
}

__global__ void floor_kernel() {}

// Rows a block: a block moves this many rows' K (or V) values.  1, 2 and 4
// read within 10% of each other on the H100, 8 slower into e4m3 (PERF.md, K4).
constexpr int ROWS_PER_BLOCK = 2;

// The block and grid for N rows of KVH heads of `units` units, ROWS_PER_BLOCK
// rows a block: a warp's lanes over a head's units, then heads, so that 64
// threads cover a 4 x 128 row of 16-byte vectors (a block has at most 128
// threads).
struct Shape {
    dim3 grid, block;
};

Shape shape(int N, int KVH, int units) {
    const int x = units < 32 ? units : 32;
    int y = 64 / x;
    y = y < 1 ? 1 : (y > KVH ? KVH : y);
    return {dim3((N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, 2), dim3(x, y, ROWS_PER_BLOCK)};
}

bool aligned(const void* p, size_t bytes) { return ((size_t)p % bytes) == 0; }

template <typename P, typename S>
int run(void* k_pool, void* v_pool, const void* pages, const void* offsets, const void* k_rows, const void* v_rows,
        int N, int KVH, int PS, int units, void* stream) {
    const Shape s = shape(N, KVH, units);
    commit_rows_kernel<P, S><<<s.grid, s.block, 0, (cudaStream_t)stream>>>(
        (P*)k_pool, (P*)v_pool, (const int*)pages, (const int*)offsets, (const S*)k_rows, (const S*)v_rows, N, KVH,
        PS, units);
    return (int)cudaGetLastError();
}

// VEC: the 16-byte vector type of the pool's 8 values (uint4 bf16, uint2
// e4m3); ONE: one value of the pool.
template <typename VEC, typename ONE>
int launch(void* k_pool, void* v_pool, const void* pages, const void* offsets, const void* k_rows, const void* v_rows,
           int N, int KVH, int PS, int D, void* stream) {
    if (N == 0) return 0;
    const bool vec = D % 8 == 0 && aligned(k_pool, sizeof(VEC)) && aligned(v_pool, sizeof(VEC)) &&
                     aligned(k_rows, 16) && aligned(v_rows, 16);
    if (vec)
        return run<VEC, uint4>(k_pool, v_pool, pages, offsets, k_rows, v_rows, N, KVH, PS, D / 8, stream);
    return run<ONE, unsigned short>(k_pool, v_pool, pages, offsets, k_rows, v_rows, N, KVH, PS, D, stream);
}

}  // namespace

// bf16 rows into a bf16 pool; the copy is bitwise.
extern "C" int omchat_commit_rows(void* k_pool, void* v_pool, const void* pages, const void* offsets,
                                  const void* k_rows, const void* v_rows, int N, int KVH, int PS, int D,
                                  void* stream) {
    return launch<uint4, unsigned short>(k_pool, v_pool, pages, offsets, k_rows, v_rows, N, KVH, PS, D, stream);
}

// bf16 rows into an e4m3 pool, rounded in the kernel.
extern "C" int omchat_commit_rows_e4m3(void* k_pool, void* v_pool, const void* pages, const void* offsets,
                                       const void* k_rows, const void* v_rows, int N, int KVH, int PS, int D,
                                       void* stream) {
    return launch<uint2, unsigned char>(k_pool, v_pool, pages, offsets, k_rows, v_rows, N, KVH, PS, D, stream);
}

// A kernel that does nothing, on the grid the commit of N rows of KVH x D
// bf16 values (16-byte vectors) launches: the launch floor under K4's time.
extern "C" int omchat_commit_rows_floor(int N, int KVH, int D, void* stream) {
    if (N == 0) return 0;
    const Shape s = shape(N, KVH, D % 8 == 0 ? D / 8 : D);
    floor_kernel<<<s.grid, s.block, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
