// One query token's GQA attention against one layer of the stacked, read-only
// KV cache, with the in-flight token folded in as a self column (K3), and the
// same against a per-layer cache that already holds the token (K6).
//
// K3 replaces the TPU kernel omchat_tpu/ops/decode_attention.py:109
// flash_decode_stacked (body _decode_kernel_stacked :86, pallas_call :185;
// the fold is omchat_tpu/ops/online_softmax.py:64 fold_self_column).
// K6 replaces omchat_tpu/ops/decode_attention.py:198 flash_decode (body
// _decode_kernel :38, pallas_call :260): the kernels below with SELF = false,
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
// Both take `scratch`, fp32 [B * H * splits * (D + 2)] from the wrapper, and
// the split: `splits` chunks of `rows` rows (a multiple of 64) covering T
// (ops/decode_attention.py:decode_splits, chosen on the host from T, B, KVH
// and the SM count, never from the lengths on the card).  D, the head
// width, is a multiple of 8 from 8 to 128 on a bf16 cache and of 16 from 16
// to 128 on an e4m3 cache (rows of whole 16-byte copies), as the JAX kernels
// take any width.
//
// What bounds it on the H100: bytes.  At the main path's ~3.2k cached rows a
// layer reads ~6.8 MB of K/V (3328 x 4 kv heads x 128 x 2 bytes, K and V) for
// ~1.6 MFLOP: 0.0020 ms at 3.35 TB/s.
//
// Design (split-KV).  The TPU kernel walks 512-row tiles of one (batch, kv
// head) in order on one core (grid (B, KVH, T / block_k)).  Here the rows are
// cut into chunks and every chunk is a block of its own: grid (splits, KVH,
// B), 2 warps, 208 blocks on the 132 SMs at B = 1 (52 chunks of 64 rows).  A
// block issues all of its chunk's 16-byte cp.async copies at once (64 rows x
// 256 B of K and of V, 32 KiB in bf16, one stage; a longer chunk streams
// 64-row stages double-buffered), rows past the request's length
// zero-filled, and a chunk wholly past it loads nothing and writes an empty
// state (m = -inf, l = 0), as the TPU kernel's index map clamps the tail
// (decode_attention.py:14-16).  The GQA group's q rows are one mma.sync row
// tile (attend_tile, as K12).  Both warps score all 64 columns of a stage
// (the same scores, max and sums in each) and each computes its own half of
// the output columns, so the warps need no merge (scoring twice cost
// less than a merge through shared memory, and two warps less than four):
// each writes its columns of the block's fp32 (m, l, acc) into the scratch
// [B, KVH, splits, group] (store_split_state).  A second kernel, launched from the same entry on the
// same stream as the first one's programmatic dependent (its blocks start
// while the split blocks finish, and wait for their stores), one block of 8
// warps a q head (split_merge_kernel in common.cuh), merges the head's
// splits in a fixed order (combine_splits, so every launch gives the same
// bits), then folds K3's self column in after the merge, as fold_self_column
// follows the last tile, and normalises.
//
// Numerics: fp32 scores in the exp2 domain (D^-0.5 * log2 e folded into the
// score), p rounded to bf16 for the P V product, l summing the unrounded fp32
// p.  p is rounded against its chunk's own maximum, as the TPU kernel rounds
// against the running maximum of its 512-row tiles: the same kind of
// rounding.  An e4m3 cache is staged as stored (D bytes a row, 16 values a
// 16-byte copy) and widened to bf16 in registers (exact); p and the bf16 self
// column are not rounded to e4m3, as the TPU kernel casts K/V to q's dtype
// (decode_attention.py:66,72).  K6 has K3's bound (the same bytes but the
// self column) and its design.
//
// Head widths below 128.  The kernels are built for the padded widths 32,
// 64, 96 and 128 (padded_width in common.cuh), and the true width D comes at
// run time: a row is copied as its D columns, the stage's columns D .. DP - 1
// are zeroed once a block, q's are zero in its mma fragments, so the padding
// adds nothing to q . k; the output columns past D are never stored, and the
// scratch, the merge and the softmax scale D^-0.5 take the true D.  At D =
// 128 the work is as before.
#include "common.cuh"

namespace {

constexpr int TILE = 64;         // cache rows a stage; a chunk's rows are a multiple of it
constexpr int WARPS = 2;         // warps of a split block
constexpr int MAX_GROUP = 8;     // q rows of the mma tile that are not padding
constexpr int MERGE_WARPS = 8;   // warps of a merge block (one q head)
constexpr int MERGE_PER = 8;     // splits a merge warp loads in one pass

// The scratch: common.cuh's (split-KV decode).

template <int DP, typename E, bool EXACT>
__global__ void __launch_bounds__(32 * WARPS)
decode_split_kernel(const bf16* __restrict__ q, const E* __restrict__ k_cache, const E* __restrict__ v_cache,
                    const int* __restrict__ cache_len, int layer, float* __restrict__ scratch, int B, int KVH, int T,
                    int d_arg, int group, int rows, float scale_log2) {
    const int d = EXACT ? DP : d_arg;  // the head width
    constexpr int VEC = 16 / (int)sizeof(E);  // elements a 16-byte copy
    constexpr int LD = DP + VEC;              // padded shared row (bank spread), 16-byte aligned
    constexpr int STAGE = 2 * TILE * LD;      // K and V of one stage, elements
    constexpr int DV = DP / WARPS;            // output columns a warp
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* buf = reinterpret_cast<E*>(smem_raw);

    trigger_merge_launch();  // the merge blocks may start; they wait for these stores
    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int splits = gridDim.x;
    const int warp = threadIdx.x >> 5;
    const size_t n = (size_t)B * KVH * splits * group;
    const size_t r0 = (((size_t)b * KVH + kvh) * splits + split) * group;  // the block's first partial row
    float* m_out = scratch + n * d + r0;
    float* l_out = m_out + n;
    const int len = min(cache_len[b], T);
    const int c_begin = split * rows;
    const int c_end = min(c_begin + rows, len);
    if (c_begin >= c_end) {  // the chunk lies past the request's length
        for (int gi = threadIdx.x; gi < group; gi += blockDim.x) {
            m_out[gi] = -INFINITY;
            l_out[gi] = 0.f;
        }
        return;
    }

    const size_t plane = (((size_t)layer * B + b) * KVH + kvh) * (size_t)T * d;
    const E* kc = k_cache + plane;
    const E* vc = v_cache + plane;
    const int n_tiles = (c_end - c_begin + TILE - 1) / TILE;
    const int pieces = d / VEC;  // 16-byte copies a row
    zero_pad_columns<DP>(buf, 2 * 2 * TILE, LD, d);  // columns d .. DP - 1 of both stages' K and V rows
    auto stage = [&](int t, int s) {
        E* kd = buf + s * STAGE;
        E* vd = kd + TILE * LD;
        for (int idx = threadIdx.x; idx < TILE * pieces; idx += blockDim.x) {
            const int r = idx / pieces, c = (idx % pieces) * VEC;
            const int row = c_begin + t * TILE + r;
            const bool valid = row < c_end;  // else zero-filled: past the length or the chunk
            const size_t src = valid ? (size_t)row * d + c : 0;
            cp_async16_zfill(kd + r * LD + c, kc + src, valid);
            cp_async16_zfill(vd + r * LD + c, vc + src, valid);
        }
        cp_async_commit();
    };
    stage(0, 0);

    const int H = KVH * group;
    uint32_t qa[DP / 16][4];
    load_q_group<DP>(qa, q + ((size_t)b * H + (size_t)kvh * group) * d, group, d);
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[DV / 8][4];
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) {
            stage(t + 1, (t + 1) & 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        // every warp scores all of the stage's columns and keeps DV columns of the output
        const int c0 = c_begin + t * TILE;
        const E* ks = buf + (t & 1) * STAGE;
        auto mask = [&](int, int col, float s) { return c0 + col < c_end ? s * scale_log2 : OMCHAT_MASK_VALUE; };
        attend_tile<DP, TILE, DV>(qa, ks, ks + TILE * LD + warp * DV, LD, m, l, acc, mask);
        __syncthreads();  // the buffer is free for the stage after next
    }
    // m and l are the same in every warp (the same scores in the same order): warp 0 writes them
    store_split_state<DV>(m, l, acc, group, warp * DV, warp == 0, m_out, l_out, scratch + r0 * d, d);
}

template <int DP, typename E, bool SELF, bool EXACT>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* cache_len, int layer,
           const void* k_new, const void* v_new, void* out, void* scratch, int B, int KVH, int T, int D, int group,
           int splits, int rows, void* stream) {
    if (group < 1 || group > MAX_GROUP) return (int)cudaErrorInvalidValue;
    if (!split_width_ok(D, DP, (int)sizeof(E))) return (int)cudaErrorInvalidValue;
    if (splits < 1 || rows < TILE || rows % TILE != 0 || (long long)splits * rows < T)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    constexpr size_t smem = 2 * 2 * (size_t)TILE * (DP + 16 / sizeof(E)) * sizeof(E);  // two stages of K and V
    cudaFuncSetAttribute(decode_split_kernel<DP, E, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);  // the true width's softmax scale
    cudaStream_t s = (cudaStream_t)stream;
    decode_split_kernel<DP, E, EXACT><<<dim3(splits, KVH, B), 32 * WARPS, smem, s>>>(
        (const bf16*)q, (const E*)k_cache, (const E*)v_cache, (const int*)cache_len, layer, (float*)scratch, B, KVH,
        T, D, group, rows, scale_log2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_merge_dependent(split_merge_kernel<MERGE_WARPS, MERGE_PER, EXACT ? DP : 0>, dim3(KVH * group, B),
                                       dim3(32 * MERGE_WARPS), s, (const float*)scratch, (const bf16*)q,
                                       (const bf16*)(SELF ? k_new : nullptr), (const bf16*)(SELF ? v_new : nullptr),
                                       (bf16*)out, B, KVH, splits, group, scale_log2, D);
}

// The instantiation of padded width padded_width(D), or width 128's own (a
// width none takes is refused there).
template <typename E, bool SELF, typename... A>
int launch_width(int D, A... a) {
    switch (D == 128 ? 0 : padded_width(D)) {
        case 0: return launch<128, E, SELF, true>(a...);
        case 32: return launch<32, E, SELF, false>(a...);
        case 64: return launch<64, E, SELF, false>(a...);
        case 96: return launch<96, E, SELF, false>(a...);
        default: return launch<128, E, SELF, false>(a...);
    }
}

}  // namespace

extern "C" int omchat_flash_decode_stacked(const void* q, const void* k_cache, const void* v_cache,
                                           const void* cache_len, int layer, const void* k_new, const void* v_new,
                                           void* out, void* scratch, int B, int KVH, int T, int D, int group,
                                           int splits, int rows, void* stream) {
    return launch_width<bf16, true>(D, q, k_cache, v_cache, cache_len, layer, k_new, v_new, out, scratch, B, KVH, T,
                                    D, group, splits, rows, stream);
}

extern "C" int omchat_flash_decode_stacked_e4m3(const void* q, const void* k_cache, const void* v_cache,
                                                const void* cache_len, int layer, const void* k_new,
                                                const void* v_new, void* out, void* scratch, int B, int KVH, int T,
                                                int D, int group, int splits, int rows, void* stream) {
    return launch_width<e4m3, true>(D, q, k_cache, v_cache, cache_len, layer, k_new, v_new, out, scratch, B, KVH, T,
                                    D, group, splits, rows, stream);
}

// K6: the per-layer cache [B, KVH, T, D] is layer 0 of a one-layer stack.
extern "C" int omchat_flash_decode(const void* q, const void* k_cache, const void* v_cache, const void* cache_len,
                                   void* out, void* scratch, int B, int KVH, int T, int D, int group, int splits,
                                   int rows, void* stream) {
    return launch_width<bf16, false>(D, q, k_cache, v_cache, cache_len, 0, nullptr, nullptr, out, scratch, B, KVH, T,
                                     D, group, splits, rows, stream);
}

extern "C" int omchat_flash_decode_e4m3(const void* q, const void* k_cache, const void* v_cache,
                                        const void* cache_len, void* out, void* scratch, int B, int KVH, int T, int D,
                                        int group, int splits, int rows, void* stream) {
    return launch_width<e4m3, false>(D, q, k_cache, v_cache, cache_len, 0, nullptr, nullptr, out, scratch, B, KVH,
                                     T, D, group, splits, rows, stream);
}
