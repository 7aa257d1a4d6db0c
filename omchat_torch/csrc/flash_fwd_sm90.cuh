// The Hopper attention forward mainloop shared by K2 (flash_attention.cu:
// causal GQA prefill over the cache, bf16 or e4m3), K14
// (paged_flash_prefill.cu: K2 through page tables), K1 / K5
// (packed_qkv_norm_attention.cu: non-causal packed ViT attention) and K16a
// (flash_attention_bwd.cu: the training forward, with lse and segment ids);
// K2 takes the segment ids too (omchat_flash_attention_seg, the packed
// forward without lse).
// Head width 128; K2 and K14 also take any multiple of 8 from 8 to 128 (the
// towers' 64 and 72, Qwen2-0.5B's 64), of 16 on an e4m3 cache: their maps
// declare the true width, so TMA fills the tile's columns past it with zeros,
// which add nothing to q . k and give output columns that are never stored.
//
// The function, per batch b, q head h and q row i (position i + q_offset[b]):
//   s_j = q_i . k_j in fp32 (q already in the exp2 domain: it carries
//         D^-0.5 log2 e, from the caller or from q_scale below; LSE: q
//         carries D^-0.5 only and s_j is multiplied by log2 e in fp32),
//   column j valid iff j < kv_len[b], if causal j <= i + q_offset[b], and
//   with segment ids (SEG) seg[j] >= 0 and seg[j] == seg[i];
//   a masked s_j becomes `mask_value` (K2: the finite -0.7 FLT_MAX of the JAX
//   kernels, K1 / K5 / K16a: -inf),
//   p_j = exp2(s_j - m) under the online softmax, l = sum of the unrounded p,
//   out_i = sum_j round(p_j) v_j / l, p rounded to bf16 (P8, K2 on an e4m3
//   cache: to e4m3 against the running max, then widened exactly), and a row
//   with no column, or (SEG) of padding, writes zeros; LSE also writes the
//   natural-log lse[b, h, i] = (m + log2 l) ln 2, -inf for a row with no
//   column.
//
// The block: 128 q rows of one q head and batch.  Two consumer warpgroups of
// 64 rows, then one producer warp whose one thread issues every TMA load: Q
// once, then K / V tiles of 128 rows through a 2-stage ring of mbarriers
// (full: the bytes arrived; empty: the 8 consumer warps are done with the
// stage).  Per tile and group: S = Q K^T by wgmma m64n128k16 (both K-major
// in shared memory), the online exp2 softmax on the accumulators, O += P V by
// wgmma m64n128k16 with P from registers and V MN-major.  9 warps: ptxas
// caps a thread at 168 registers, enough for S, P and O (K16a's budget).
//
// Work skipped, not masked: the block loads only the kv tiles below
//   end = min(kv_len, (causal) the position of its last row + 1),
// and each group computes only the columns below its own end: a tile that
// holds 64 or fewer of them runs the m64n64k16 product and a 4-step P V (the
// ragged last tile of the ViT's 1025 columns, a group's share of the causal
// diagonal).  Any tile that the diagonal or kv_len cuts is masked; q_offset
// need not be a multiple of 128, so the diagonal may cut two tiles.  Under
// the causal mask a row tile whose first row's position is at or past kv_len
// (padding of a batched prefill, whose rows are unspecified) writes zeros
// without loading anything, as does a group whose first row is such padding.
// With segment ids the block lists the tiles whose ids can meet its rows
// before the loop, and loads only those.  Row tiles launch longest first; the
// q heads of one kv head are neighbouring blocks and share each K / V tile
// through L2.  Through page tables (K14) a
// tile arrives as one TMA box a page; a page past the mapped ones is read
// from outside the pool, which TMA fills with zeros, as it fills rows past T.
//
// e4m3 cache (KV8): TMA stages each K / V tile as stored (128 rows x 128
// bytes, one swizzled box, half the bytes); the 256 consumer threads widen it
// once into a bf16 tile of the layout above (e4m3 -> f16 -> bf16 is exact),
// between two barriers of the consumers, and release the e4m3 stage at once.
//
// K5 (q_scale != 1): each group multiplies its 64 Q rows by q_scale in fp32
// and rounds them to bf16 in shared memory once, after the TMA load.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace fwd90 {

constexpr int HD = 128;        // head width
constexpr int WG = 128;        // threads of a consumer warpgroup
constexpr int THREADS = 2 * WG + 32;
constexpr int BM = 128;        // q rows per block
constexpr int BN = 128;        // kv rows per tile
constexpr int STAGES = 2;
constexpr int TILE = 128 * HD * 2;  // bytes of a 128-row bf16 tile
constexpr int TILE8 = 128 * HD;     // bytes of a 128-row e4m3 tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory, from a 1024-byte boundary: Q, the K ring, the V ring, (e4m3)
// the widened K and V tiles, the barriers q_full, full[STAGES], empty[STAGES],
// then (SEG) the tile list: a count and 3 spare ints, then one int a kv tile.
template <bool KV8>
struct Smem {
    static constexpr int STAGE = KV8 ? TILE8 : TILE;  // bytes of one K (or V) stage
    static constexpr int K = TILE;
    static constexpr int V = K + STAGES * STAGE;
    static constexpr int KW = V + STAGES * STAGE;
    static constexpr int VW = KW + TILE;
    static constexpr int BAR = KV8 ? VW + TILE : KW;
    static constexpr int META = BAR + 8 * (1 + 2 * STAGES);
    static constexpr int BYTES = 1024 + META;  // with the alignment slack, without the tile list
};

struct Params {
    bf16* out;                  // row i of head h at out + b * out_batch + i * out_row + h * 128
    long long out_row, out_batch;
    const int* q_offset;        // [B], or null: 0
    const int* kv_len;          // [B], or null: kv_len_all
    int kv_len_all;
    int B, S, H, KVH, T;        // S q rows and T kv rows a batch; H / KVH q heads a kv head
    // K14: K / V rows through page tables (else null): kv row j of batch b is
    // row j % page_size of page tables[b * table_stride + j / page_size]
    // (T = table_width * page_size); the maps are over [pages, KVH, page_size, head_dim]
    const int* tables;
    int table_stride, table_width, page_size, num_pages;
    int causal;
    float q_scale;              // != 1: Q multiplied by it and rounded to bf16 after its load
    float mask_value;
    float* lse;                 // LSE: [B, H, S] fp32
    const int* seg;             // SEG: [B, S] segment ids (T == S, no q_offset); negative ids are padding
    int head_dim = HD;          // the columns of a row read and stored: a multiple of 8 (16 on e4m3), at most HD
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
    return raw + ((1024 - (sm90::smem_u32(raw) & 1023)) & 1023);
}

// The A fragment of the 16 columns 16 kk .. 16 kk + 15 of an accumulator,
// rounded as the P V product takes p (bf16, or e4m3 widened exactly).
template <bool P8, int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N], int kk) {
    a[0] = pack_p<P8>(d[8 * kk + 0], d[8 * kk + 1]);
    a[1] = pack_p<P8>(d[8 * kk + 2], d[8 * kk + 3]);
    a[2] = pack_p<P8>(d[8 * kk + 4], d[8 * kk + 5]);
    a[3] = pack_p<P8>(d[8 * kk + 6], d[8 * kk + 7]);
}

// The e4m3 tile `src` (128 rows of 128 bytes, TMA's 128-byte swizzle: the
// 16-byte chunk c of row r at chunk c ^ (r % 8)) widened into the bf16 tile
// `dst` ([2][128][64], the same swizzle in each half) by the 256 consumer
// threads: 8 values a thread and step, read as 8 bytes, written as 16.
__device__ __forceinline__ void widen_tile(const unsigned char* src, unsigned char* dst, int tid) {
#pragma unroll 4
    for (int idx = tid; idx < BN * 16; idx += 2 * WG) {
        const int r = idx >> 4, k = idx & 15, sw = r & 7;  // row, columns 8k .. 8k + 7
        const uint2 x = *reinterpret_cast<const uint2*>(src + r * 128 + (((k >> 1) ^ sw) << 4) + ((k & 1) << 3));
        uint4 y;
        y.x = e4m3x2_to_bf16x2((__nv_fp8x2_storage_t)(x.x & 0xFFFFu));
        y.y = e4m3x2_to_bf16x2((__nv_fp8x2_storage_t)(x.x >> 16));
        y.z = e4m3x2_to_bf16x2((__nv_fp8x2_storage_t)(x.y & 0xFFFFu));
        y.w = e4m3x2_to_bf16x2((__nv_fp8x2_storage_t)(x.y >> 16));
        *reinterpret_cast<uint4*>(dst + (k >> 3) * (BN * 128) + r * 128 + (((k & 7) ^ sw) << 4)) = y;
    }
}

// One group's step over one kv tile: N = 128 or 64 of its columns (c0 ..
// c0 + N - 1).  `masked`: some column is past kv_len, (causal) past a row's
// position or (SEG) may hold another segment; row_pos is the position of this
// thread's first row (the second is 8 further), sq their segment ids.
template <int N, bool P8, bool LSE, bool SEG>
__device__ __forceinline__ void attend(float (&o)[64], float (&m)[2], float (&l)[2], uint32_t q_tile, int cg,
                                       uint32_t k_tile, uint32_t v_tile, bool masked, int c0, int row_pos, int klen,
                                       int causal, float mask_value, const int* seg_b, const int (&sq)[2]) {
    const int t = threadIdx.x & 3;
    float sc[N / 2];
#pragma unroll
    for (int x = 0; x < N / 2; ++x) sc[x] = 0.f;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t da = sm90::desc_kmajor(q_tile, BM, 64 * cg, kk), db = sm90::desc_kmajor(k_tile, BN, 0, kk);
        if constexpr (N == 128)
            sm90::wgmma_m64n128k16_ss(sc, da, db, kk > 0);
        else
            sm90::wgmma_m64n64k16_ss(sc, da, db, kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(sc);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float x = LSE ? sc[4 * n + e] * LOG2E : sc[4 * n + e];
            if (masked) {
                const int col = c0 + 8 * n + 2 * t + (e & 1), pos = row_pos + 8 * (e >> 1);
                bool ok = col < klen && (!causal || col <= pos);
                if constexpr (SEG) {
                    const int sk = col < klen ? seg_b[col] : -1;
                    ok = ok && sk >= 0 && sk == sq[e >> 1];
                }
                x = ok ? x : mask_value;
            }
            sc[4 * n + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
    float alpha[2], base[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with no valid column yet keeps p = 0
        alpha[r] = exp2f(m[r] - base[r]);
        m[r] = mx[r];
    }
#pragma unroll
    for (int x = 0; x < N / 2; ++x) {
        sc[x] = exp2f(sc[x] - base[(x >> 1) & 1]);
        sum[(x >> 1) & 1] += sc[x];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = alpha[r] * l[r] + sum[r];
    }
#pragma unroll
    for (int x = 0; x < 64; ++x) o[x] *= alpha[(x >> 1) & 1];
    uint32_t pa[N / 16][4];
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) acc_to_a<P8>(pa[kk], sc, kk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) sm90::wgmma_m64n128k16_rs(o, pa[kk], sm90::desc_mnmajor(v_tile, BN, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(o);
}

// grid (H, row tiles x B); THREADS threads; the dynamic shared memory that
// launch() sets.  KV8: an e4m3 cache; P8: p rounded to e4m3 for the P V
// product; LSE: natural-log scores and the lse output; SEG: segment ids.
template <bool KV8, bool P8, bool LSE, bool SEG>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, const Params p) {
    using L = Smem<KV8>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = aligned_smem(smem_raw);
    uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
    uint64_t* full = q_full + 1;
    uint64_t* empty = full + STAGES;
    int* meta = reinterpret_cast<int*>(sm + L::META);  // SEG: [0] the tiles in the list
    int* list = meta + 4;

    const int head = blockIdx.x, b = blockIdx.y % p.B;
    const int rt = (p.S + BM - 1) / BM - 1 - blockIdx.y / p.B;  // the last (longest) row tiles first
    const int r0 = rt * BM, kvh = head / (p.H / p.KVH), tid = threadIdx.x;
    const int qoff = p.q_offset ? p.q_offset[b] : 0;
    const int klen = max(0, min(p.kv_len ? p.kv_len[b] : p.kv_len_all, p.T));
    bf16* out_b = p.out + (long long)b * p.out_batch + head * p.head_dim;
    float* lse_b = LSE ? p.lse + ((long long)b * p.H + head) * p.S : nullptr;
    const int* seg_b = SEG ? p.seg + (long long)b * p.S : nullptr;

    int end = klen;  // the block's columns: [0, end)
    if (p.causal) end = min(end, min(r0 + BM, p.S) - 1 + qoff + 1);
    int n_tiles = (p.causal && r0 + qoff >= klen) || end <= 0 ? 0 : (end + BN - 1) / BN;
    if constexpr (SEG) {  // only the tiles whose segment ids can meet the block's rows
        list_meeting_tiles(seg_b, p.S, r0, BM, 0, n_tiles, BN, meta, list);
        __syncthreads();
        n_tiles = meta[0];
    }
    if (n_tiles == 0) {  // no column, or padding rows: zeros (and an lse of -inf)
        const int chunks = p.head_dim / 8;  // 16-byte chunks a row
        for (int idx = tid; idx < BM * chunks; idx += THREADS) {
            const int row = r0 + idx / chunks;
            if (row < p.S)
                *reinterpret_cast<uint4*>(out_b + row * p.out_row + (idx % chunks) * 8) = make_uint4(0, 0, 0, 0);
        }
        if constexpr (LSE)
            if (tid < BM && r0 + tid < p.S) lse_b[r0 + tid] = -INFINITY;
        return;
    }

    if (tid == 0) {
        sm90::mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            sm90::mbar_init(&full[s], 1);
            sm90::mbar_init(&empty[s], 8);  // one arrival per consumer warp
        }
        sm90::mbar_fence_init();
    }
    __syncthreads();

    if (tid >= 2 * WG) {  // producer warp: one thread issues every load
        if (tid == 2 * WG) {
            sm90::tma_prefetch_map(&map_q);
            sm90::tma_prefetch_map(&map_k);
            sm90::tma_prefetch_map(&map_v);
            sm90::mbar_arrive_expect_tx(q_full, TILE);
            for (int h = 0; h < 2; ++h) sm90::tma_load_4d(sm + h * TILE / 2, &map_q, q_full, 64 * h, head, r0, b);
            const int* table = p.tables ? p.tables + (long long)b * p.table_stride : nullptr;
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % STAGES, c0 = (SEG ? list[i] : i) * BN;
                if (i >= STAGES) sm90::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
                sm90::mbar_arrive_expect_tx(&full[s], 2 * L::STAGE);
                unsigned char* kdst = sm + L::K + s * L::STAGE;
                unsigned char* vdst = sm + L::V + s * L::STAGE;
                // one box of `rows` rows at row r of the tile: rows c0 + r .. of batch b, or one page
                const int rows = table ? p.page_size : BN;
                for (int r = 0; r < BN; r += rows) {
                    int c2 = c0 + r, c3 = b;
                    if (table) {  // a page past the mapped ones: out of the pool, so TMA writes zeros
                        const int j = (c0 + r) / p.page_size;
                        c2 = 0;
                        c3 = j < p.table_width ? table[j] : p.num_pages;
                    }
                    for (int h = 0; h < (KV8 ? 1 : 2); ++h) {
                        sm90::tma_load_4d(kdst + h * TILE / 2 + r * 128, &map_k, &full[s], 64 * h, kvh, c2, c3);
                        sm90::tma_load_4d(vdst + h * TILE / 2 + r * 128, &map_v, &full[s], 64 * h, kvh, c2, c3);
                    }
                }
            }
        }
        return;
    }

    const int cg = tid / WG;  // consumer group: q rows w0 .. w0 + 63
    const int warp = (tid / 32) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int w0 = r0 + 64 * cg, row0 = w0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    int g_end = klen;  // the group's columns: [0, g_end)
    if (p.causal) g_end = min(g_end, min(w0 + 63, p.S - 1) + qoff + 1);
    if (w0 >= p.S || (p.causal && w0 + qoff >= klen)) g_end = 0;
    int sq[2] = {-1, -1};  // SEG: the segment ids of this thread's rows
    if constexpr (SEG) {
        sq[0] = row0 < p.S ? seg_b[row0] : -1;
        sq[1] = row0 + 8 < p.S ? seg_b[row0 + 8] : -1;
    }
    const uint32_t q_tile = sm90::smem_u32(sm);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;

    sm90::mbar_wait(q_full, 0);
    if (p.q_scale != 1.f) {  // K5: this group's 64 rows of both halves, x q_scale, rounded to bf16
        for (int c = tid % WG; c < 2 * 512; c += WG) {  // 512 16-byte chunks a half
            uint4* ptr = reinterpret_cast<uint4*>(sm + (c / 512) * (TILE / 2) + 64 * cg * 128 + (c % 512) * 16);
            uint4 x = *ptr;
            uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
                w[e] = pack_bf16(__bfloat162float(v.x) * p.q_scale, __bfloat162float(v.y) * p.q_scale);
            }
            *ptr = x;
        }
        sm90::fence_proxy_async();
        sm90::named_barrier(2 + cg, WG);
    }

    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, c0 = (SEG ? list[i] : i) * BN;
        sm90::mbar_wait(&full[s], (i / STAGES) & 1);
        uint32_t k_tile, v_tile;
        if constexpr (KV8) {
            sm90::named_barrier(1, 2 * WG);  // both groups are done with the last widened tiles
            widen_tile(sm + L::K + s * TILE8, sm + L::KW, tid);
            widen_tile(sm + L::V + s * TILE8, sm + L::VW, tid);
            sm90::fence_proxy_async();
            sm90::named_barrier(1, 2 * WG);
            __syncwarp();
            if (lane == 0) sm90::mbar_arrive(&empty[s]);
            k_tile = sm90::smem_u32(sm + L::KW);
            v_tile = sm90::smem_u32(sm + L::VW);
        } else {
            k_tile = sm90::smem_u32(sm + L::K + s * TILE);
            v_tile = sm90::smem_u32(sm + L::V + s * TILE);
        }
        const int n = min(BN, g_end - c0);  // uniform over the group
        if (n > 64) {
            const bool masked = SEG || c0 + 128 > klen || (p.causal && c0 + 127 > w0 + qoff);
            attend<128, P8, LSE, SEG>(o, m, l, q_tile, cg, k_tile, v_tile, masked, c0, row0 + qoff, klen, p.causal,
                                      p.mask_value, seg_b, sq);
        } else if (n > 0) {
            const bool masked = SEG || c0 + 64 > klen || (p.causal && c0 + 63 > w0 + qoff);
            attend<64, P8, LSE, SEG>(o, m, l, q_tile, cg, k_tile, v_tile, masked, c0, row0 + qoff, klen, p.causal,
                                     p.mask_value, seg_b, sq);
        }
        if constexpr (!KV8) {
            __syncwarp();
            if (lane == 0) sm90::mbar_arrive(&empty[s]);
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= p.S) continue;
        // a row of padding (SEG, a negative id) has no column even where the
        // finite mask value of K2 left l > 0
        const bool live = l[r] > 0.f && (!SEG || sq[r] >= 0);
        const float inv = live ? 1.f / l[r] : 0.f;
        bf16* op = out_b + row * p.out_row;
#pragma unroll
        for (int n = 0; n < 16; ++n)
            if (8 * n < p.head_dim)
                *reinterpret_cast<uint32_t*>(op + 8 * n + 2 * t) =
                    pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
        if constexpr (LSE)
            if (t == 0) lse_b[row] = live ? (m[r] + log2f(l[r])) * LN2 : -INFINITY;
    }
}

// Maps of q ([B, S, H, D], boxes of BM rows) and k, v ([B, KVH, T, D],
// `kv_bytes` a value, boxes of BN rows), D = p.head_dim, each with its element
// strides (head, row, batch).  False when cuTensorMapEncodeTiled refuses one (a
// base not 16-byte aligned, a stride not a multiple of 16 bytes).
inline bool dense_maps(CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv, const Params& p, const void* q,
                       const long long (&qs)[3], const void* k, const long long (&ks)[3], const void* v,
                       const long long (&vs)[3], int kv_bytes) {
    return sm90::rows_map(mq, q, 2, p.H, p.S, p.B, qs[0], qs[1], qs[2], BM, p.head_dim) &&
           sm90::rows_map(mk, k, kv_bytes, p.KVH, p.T, p.B, ks[0], ks[1], ks[2], BN, p.head_dim) &&
           sm90::rows_map(mv, v, kv_bytes, p.KVH, p.T, p.B, vs[0], vs[1], vs[2], BN, p.head_dim);
}

// Launches flash_fwd over maps of q and k, v: dense_maps's, or through page
// tables (K14) maps over [pages, KVH, page_size, head_dim] (d1 = KVH, d2 =
// page_size, d3 = pages) in boxes of one page.  Returns a cudaError_t.
template <bool KV8, bool P8, bool LSE = false, bool SEG = false>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, const Params& p, void* stream) {
    if (p.B <= 0 || p.S <= 0 || p.KVH <= 0 || p.H % p.KVH != 0 || p.T <= 0) return (int)cudaErrorInvalidValue;
    if (p.head_dim < 8 || p.head_dim > HD || p.head_dim % (KV8 ? 16 : 8)) return (int)cudaErrorInvalidValue;
    if (p.tables && (p.page_size < 8 || BN % p.page_size != 0)) return (int)cudaErrorInvalidValue;
    if ((LSE && !p.lse) || (SEG && (!p.seg || p.T != p.S || p.q_offset))) return (int)cudaErrorInvalidValue;
    const int smem = Smem<KV8>::BYTES + (SEG ? (4 + (p.T + BN - 1) / BN) * (int)sizeof(int) : 0);
    cudaFuncSetAttribute(flash_fwd<KV8, P8, LSE, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const dim3 grid(p.H, ((p.S + BM - 1) / BM) * p.B);
    flash_fwd<KV8, P8, LSE, SEG><<<grid, THREADS, smem, (cudaStream_t)stream>>>(mq, mk, mv, p);
    return (int)cudaGetLastError();
}

}  // namespace fwd90
