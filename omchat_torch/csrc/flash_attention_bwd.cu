// Trainable flash attention: forward with the row log-sum-exp, and the two
// backward kernels (dQ; dK/dV per kv head).
//
// Replaces the TPU kernels of omchat_tpu/ops/flash_attention_bwd.py, the
// custom-VJP attention of the training path (attention impl "pallas_vjp"):
//   K16a _fwd      (:327, pallas_call :388, body _fwd_kernel :91)
//   K16b _bwd dQ   (:421, pallas_call :494, body _bwd_dq_kernel :153)
//   K16c _bwd dK/dV (:421, pallas_call :564, body _bwd_dkv_kernel :197)
//
// Layout ("btnd", no cache, no offsets), head width D a multiple of 8 from 8
// to 128 (Qwen2-7B's and InternViT-6B's 128; Qwen2-0.5B's and
// InternViT-300M's 64; the tiny test model's 16):
//   q, dout, out, dq   [B, S, H, D]   bf16
//   k, v, dk, dv       [B, S, KVH, D] bf16 (GQA: H / KVH q heads per kv head)
//   lse, di            [B, H, S]      fp32 (natural-log lse; di = rowsum(dO * O))
//   seg                [B, S]         int32 segment ids or NULL; a row attends
//                      only to columns of its own segment, negative ids are
//                      padding and match nothing
// All three receive q already multiplied by scale = D^-0.5 and rounded to
// bf16 (the wrappers do it once a backward, as JAX does before its
// pallas_calls); K16b multiplies dQ by the scale once more, in fp32, before
// rounding it.
//
// The math, with s = (q * scale) k^T in fp32:
//   fwd:  out = softmax(s) v,  lse = log sum exp(s)  (a row with no valid
//         column: out = 0, lse = -inf)
//   dQ:   p = exp(s - lse), dS = p * (dO v^T - di), dQ = dS k * scale
//   dKV:  dV = sum_group p^T dO,  dK = sum_group dS^T (q * scale)
// p is rounded to bf16 for the PV and P^T dO products and dS for dQ and dK, as
// the TPU kernels round them.  Rows whose lse is -inf get zero gradient.
//
// What bounds them on the H100: at the LLM training shape (B=2, S=3328, H=28,
// KVH=4, causal) the forward does ~0.16 TFLOP against ~110 MB of tensors, the
// backward 3 and 4 GEMMs of the same size: all are bound by tensor-core
// operations, and only wgmma reaches Hopper's tensor-core rate.
//
// Hopper design (sm90.cuh): Q, K, V and dO tiles come by TMA into
// 128-byte-swizzled shared memory, completing on mbarriers, through a ring
// whose stages the consumers release through a second mbarrier, so the loads
// of the next tile overlap the products of this one; every product is wgmma.
// Registers set the block's shape: an SM sub-partition holds 16384, and
// ptxas allocates within what a thread gets at launch (setmaxnreg did not
// raise it: measured slower, with more spills).
//   K16a: the forward mainloop that K1, K2, K5 and K14 run
//   (flash_fwd_sm90.cuh: a block per (128 q rows, q head, batch), two
//   consumer warpgroups and a producer warp, Q once and K/V through a 2-stage
//   ring of 128-row tiles, S and P V by wgmma m64n128k16, an exp2 online
//   softmax on the accumulators), in its LSE mode (the scores multiplied by
//   log2 e in fp32, the natural-log lse written, -inf masks) and, for packed
//   rows, its SEG mode.
//   K16b: K16c's block transposed, on K16a's grid: a block per (128 q rows,
//   q head, batch), the q heads of one kv head in neighbouring blocks (their
//   K / V tiles meet in L2) and the longest causal row tiles first.  Two
//   consumer warpgroups of 64 q rows and a producer warp whose one thread
//   loads Q and dO once (TMA, 128-row boxes) and streams 64-row K / V tiles
//   through a 2-stage ring.  Each group holds its dQ rows in fp32 registers
//   (64 a thread) and lse, di for its two rows a thread; per tile S = Q K^T
//   and dP = dO V^T (m64n64k16, both K-major; 32 + 32 registers), P =
//   exp2(S log2 e - lse log2 e), dS = P (dP - di) rounded to bf16 in
//   registers, then dQ += dS K (m64n128k16, A from registers, B the K tile
//   MN-major: the form of K16c's dK += dS^T Q).  64-row kv tiles keep S, dP
//   and dQ at 128 registers, which the 9 warps' cap of 168 holds (128-row
//   tiles would need 192).  A block owns its rows' dQ: no atomics.
//   K16c: a block per (64 kv rows, kv head, batch), one warpgroup, two blocks
//   an SM; it holds its K and V in shared memory and dK, dV in fp32
//   registers (128 a thread; 231-239 in all, no spill: there is no producer
//   warp, whose 9th warp would cap every thread at 168).  Warp 0 also fills
//   the ring: (q tile of 64 rows, q head of the group) pairs, Q and dO by
//   TMA, lse and di beside them, refilling a stage once every warp has
//   released it.  Per pair: S^T = K Q^T and dP^T = V dO^T (m64n64k16,
//   K-major), then dV += P^T dO and dK += dS^T Q (m64n128k16, A from
//   registers, B MN-major).  The GQA group sum stays in the kernel, in a
//   fixed order: no atomics.  Under the causal mask the q loop starts at the
//   block's diagonal and the first kv tiles (the most q tiles) launch first.
//   Blocks of 128 kv rows (two warpgroups, one block an SM) measured no
//   faster (PERF.md) and are not built.
// All three: tiles above the causal diagonal, and with segment ids tiles
// whose segment ranges cannot meet, are skipped and never loaded (the block
// lists the tiles it needs before its loop); only the diagonal tile, a
// ragged tail (TMA reads zeros past S) or a packed tile is masked.
// Widths under 128 (K2's design): the tiles stay 128 columns wide and every
// map declares the true width D, so TMA fills the columns past D with zeros (a
// box wholly past D, the second one at D <= 64, still completes its full byte
// count).  Zero columns of Q, K, V and dO add nothing to S = Q K^T or to
// dP = dO V^T and give zero columns of dQ, dK and dV, which are never stored:
// every stride is taken at D and only the 8-column pieces below D are
// written.  A row of heads x D bf16 values is whole 16-byte pieces, as TMA's
// strides need, exactly when D is a multiple of 8.  Width 128 keeps its own
// instantiation (FULL: D a constant), the code it ran before.
#include "common.cuh"
#include "flash_fwd_sm90.cuh"
#include "sm90.cuh"

namespace {

constexpr int HD = 128;        // the tiles' columns: the widest head
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WG = 128;        // threads of a warpgroup
constexpr int TILE64 = 64 * HD * 2;    // bytes of a 64-row shared tile

// K16b (dQ)
constexpr int DQ_BM = 128;                 // q rows per block: two consumer warpgroups of 64
constexpr int DQ_BN = 64;                  // kv rows per streamed tile
constexpr int DQ_STAGES = 2;               // ring stages (one block an SM; 3 measured slower)
constexpr int DQ_THREADS = 2 * WG + 32;    // and a producer warp
constexpr int TILE128 = 128 * HD * 2;      // bytes of a 128-row shared tile

// K16c (dK/dV)
constexpr int BWD_QT = 64;     // q rows per streamed tile
constexpr int DKV_STAGE = 2 * TILE64 + 1024;  // Q tile, dO tile, then 64 x (lse2, di, seg)
constexpr int DKV_BK = 64;                     // kv rows per block: one warpgroup
constexpr int DKV_STAGES_N = 2;                // ring stages (two blocks share an SM)

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return sm90::smem_u32(p); }

// The dynamic shared memory, advanced to a 1024-byte boundary (the swizzle atom).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
    return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// The A fragment of a 16-column slice kk of a wgmma accumulator (its columns
// 16 kk .. 16 kk + 15), rounded to bf16: the accumulator layout of one
// product is the A-register layout of the next.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N], int kk) {
    a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// ---------------------------------------------------------------------------
// K16b: dQ
// ---------------------------------------------------------------------------

// shared memory: Q, dO, the ring of (K, V) stages, the barriers q_full,
// full[DQ_STAGES], empty[DQ_STAGES], then (SEG) the tile list
constexpr int DQ_Q = 0;
constexpr int DQ_DO = TILE128;
constexpr int DQ_RING = 2 * TILE128;
constexpr int DQ_BAR = DQ_RING + DQ_STAGES * 2 * TILE64;
constexpr int DQ_META = DQ_BAR + 8 * (1 + 2 * DQ_STAGES);

// FULL: head width 128, else `width` (a multiple of 8 below 128).
template <bool SEG, bool FULL>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                    const float* __restrict__ lse, const float* __restrict__ di, const int* __restrict__ seg,
                    bf16* __restrict__ dq, int B, int S, int H, int KVH, int width, int causal, float scale) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = aligned_smem(smem_raw);
    uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + DQ_BAR);
    uint64_t* full = q_full + 1;
    uint64_t* empty = full + DQ_STAGES;
    int* meta = reinterpret_cast<int*>(sm + DQ_META);  // SEG: [0] the tiles in the list
    int* list = meta + 4;

    const int head = blockIdx.x, b = blockIdx.y % B;
    const int rt = (S + DQ_BM - 1) / DQ_BM - 1 - blockIdx.y / B;  // the last (longest) row tiles first
    const int r0 = rt * DQ_BM, kvh = head / (H / KVH), tid = threadIdx.x;
    const int* seg_b = SEG ? seg + (size_t)b * S : nullptr;
    const int hd = FULL ? HD : width;
    bf16* dq_b = dq + (size_t)b * S * H * hd + (size_t)head * hd;

    const int end = causal ? min(S, r0 + DQ_BM) : S;  // the block's columns: [0, end)
    int n_tiles = (end + DQ_BN - 1) / DQ_BN;
    if constexpr (SEG) {  // only the tiles whose segment ids can meet the block's rows
        list_meeting_tiles(seg_b, S, r0, DQ_BM, 0, n_tiles, DQ_BN, meta, list);
        __syncthreads();
        n_tiles = meta[0];
    }
    if (n_tiles == 0) {  // padding rows only: zero gradient
        const int chunks = hd / 8;  // 16-byte chunks a row
        for (int idx = tid; idx < DQ_BM * chunks; idx += DQ_THREADS) {
            const int row = r0 + idx / chunks;
            if (row < S)
                *reinterpret_cast<uint4*>(dq_b + (size_t)row * H * hd + (idx % chunks) * 8) = make_uint4(0, 0, 0, 0);
        }
        return;
    }

    if (tid == 0) {
        sm90::mbar_init(q_full, 1);
        for (int s = 0; s < DQ_STAGES; ++s) {
            sm90::mbar_init(&full[s], 1);
            sm90::mbar_init(&empty[s], 8);  // one arrival per consumer warp
        }
        sm90::mbar_fence_init();
    }
    __syncthreads();

    if (tid >= 2 * WG) {  // producer warp: one thread issues every load
        if (tid == 2 * WG) {
            sm90::tma_prefetch_map(&map_q);
            sm90::tma_prefetch_map(&map_do);
            sm90::tma_prefetch_map(&map_k);
            sm90::tma_prefetch_map(&map_v);
            sm90::mbar_arrive_expect_tx(q_full, 2 * TILE128);
            for (int h = 0; h < 2; ++h) {
                sm90::tma_load_4d(sm + DQ_Q + h * TILE128 / 2, &map_q, q_full, 64 * h, head, r0, b);
                sm90::tma_load_4d(sm + DQ_DO + h * TILE128 / 2, &map_do, q_full, 64 * h, head, r0, b);
            }
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % DQ_STAGES, c0 = (SEG ? list[i] : i) * DQ_BN;
                if (i >= DQ_STAGES) sm90::mbar_wait(&empty[s], (i / DQ_STAGES - 1) & 1);
                sm90::mbar_arrive_expect_tx(&full[s], 2 * TILE64);
                unsigned char* st = sm + DQ_RING + s * 2 * TILE64;
                for (int h = 0; h < 2; ++h) {
                    sm90::tma_load_4d(st + h * TILE64 / 2, &map_k, &full[s], 64 * h, kvh, c0, b);
                    sm90::tma_load_4d(st + TILE64 + h * TILE64 / 2, &map_v, &full[s], 64 * h, kvh, c0, b);
                }
            }
        }
        return;
    }

    const int cg = tid / WG;  // consumer group: q rows w0 .. w0 + 63
    const int warp = (tid / 32) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int w0 = r0 + 64 * cg, row0 = w0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    int g_end = causal ? min(S, w0 + 64) : S;  // the group's columns: [0, g_end)
    if (w0 >= S) g_end = 0;
    float lse2[2], dd[2];
    int sq[2] = {-1, -1};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const size_t at = ((size_t)b * H + head) * S + row;
        const float lv = row < S ? lse[at] : -INFINITY;
        lse2[r] = lv == -INFINITY ? INFINITY : lv * LOG2E;  // a row with no column: p = exp2(s - inf) = 0
        dd[r] = row < S ? di[at] : 0.f;
        if (SEG) sq[r] = row < S ? seg_b[row] : -1;
    }
    const uint32_t q_tile = smem_addr(sm + DQ_Q), do_tile = smem_addr(sm + DQ_DO);
    float acc[64];
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[x] = 0.f;

    sm90::mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % DQ_STAGES, c0 = (SEG ? list[i] : i) * DQ_BN;
        sm90::mbar_wait(&full[s], (i / DQ_STAGES) & 1);
        if (c0 < g_end) {  // uniform over the group
            const uint32_t k_tile = smem_addr(sm + DQ_RING + s * 2 * TILE64), v_tile = k_tile + TILE64;
            float sa[32], dpa[32];
#pragma unroll
            for (int x = 0; x < 32; ++x) sa[x] = dpa[x] = 0.f;
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
                sm90::wgmma_m64n64k16_ss(sa, sm90::desc_kmajor(q_tile, DQ_BM, 64 * cg, kk),
                                         sm90::desc_kmajor(k_tile, DQ_BN, 0, kk), kk > 0);
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
                sm90::wgmma_m64n64k16_ss(dpa, sm90::desc_kmajor(do_tile, DQ_BM, 64 * cg, kk),
                                         sm90::desc_kmajor(v_tile, DQ_BN, 0, kk), kk > 0);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::reg_fence(sa);
            sm90::reg_fence(dpa);

            // some column past S, (causal) past a row's position or (SEG) of another segment
            const bool masked = SEG || c0 + DQ_BN > S || (causal && c0 + DQ_BN - 1 > w0);
#pragma unroll
            for (int n = 0; n < DQ_BN / 8; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int x = 4 * n + e, r = e >> 1;
                    float p = exp2f(sa[x] * LOG2E - lse2[r]);
                    if (masked) {
                        const int col = c0 + 8 * n + 2 * t + (e & 1);
                        bool ok = col < S && (!causal || col <= row0 + 8 * r);
                        if constexpr (SEG) {
                            const int sk = col < S ? seg_b[col] : -1;
                            ok = ok && sk >= 0 && sk == sq[r];
                        }
                        p = ok ? p : 0.f;
                    }
                    dpa[x] = p * (dpa[x] - dd[r]);  // dS
                }
            }
            uint32_t dsa[DQ_BN / 16][4];
#pragma unroll
            for (int kk = 0; kk < DQ_BN / 16; ++kk) acc_to_a(dsa[kk], dpa, kk);
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DQ_BN / 16; ++kk)
                sm90::wgmma_m64n128k16_rs(acc, dsa[kk], sm90::desc_mnmajor(k_tile, DQ_BN, kk), 1);  // dQ += dS K
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::reg_fence(acc);
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= S) continue;
        bf16* o = dq_b + (size_t)row * H * hd;
#pragma unroll
        for (int n = 0; n < 16; ++n)
            if (FULL || 8 * n < hd)
                *reinterpret_cast<uint32_t*>(o + 8 * n + 2 * t) =
                    pack_bf16(acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
    }
}

// ---------------------------------------------------------------------------
// K16c: dK / dV per kv head
// ---------------------------------------------------------------------------

// shared memory: K, V, the ring of (Q, dO, lse, di, segment ids) stages, the
// barriers kv_full, full[DKV_STAGES_N], empty[DKV_STAGES_N], then the tile list
constexpr int DKV_K = 0;
constexpr int DKV_V = TILE64;
constexpr int DKV_RING = 2 * TILE64;
constexpr int DKV_BAR = DKV_RING + DKV_STAGES_N * DKV_STAGE;
constexpr int DKV_META = DKV_BAR + 8 * (1 + 2 * DKV_STAGES_N);

// FULL: head width 128, else `width` (a multiple of 8 below 128).
template <bool SEG, bool FULL>
__global__ void __launch_bounds__(WG, 2)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                     const float* __restrict__ lse, const float* __restrict__ di, const int* __restrict__ seg,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int S, int H, int KVH, int width,
                     int causal) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = aligned_smem(smem_raw);
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + DKV_BAR);
    uint64_t* full = kv_full + 1;
    uint64_t* empty = full + DKV_STAGES_N;
    int* meta = reinterpret_cast<int*>(sm + DKV_META);  // [0]: q tiles in the list
    int* list = meta + 4;

    const int kvh = blockIdx.x % KVH, b = blockIdx.x / KVH;
    const int c0 = blockIdx.y * DKV_BK, group = H / KVH;  // blockIdx.y = 0 first: the most q tiles
    const int q_first = causal ? c0 / BWD_QT : 0;  // q tiles wholly above the block's rows see none of them
    const int n_cand = (S + BWD_QT - 1) / BWD_QT - q_first;
    const int tid = threadIdx.x;
    const int* seg_b = SEG ? seg + (size_t)b * S : nullptr;

    if (tid == 0) {
        sm90::mbar_init(kv_full, 1);
        for (int s = 0; s < DKV_STAGES_N; ++s) {
            sm90::mbar_init(&full[s], 32);  // warp 0's lanes (lse, di, ids) + the TMA bytes
            sm90::mbar_init(&empty[s], 4);  // one arrival per warp
        }
        sm90::mbar_fence_init();
        if (!SEG) meta[0] = n_cand;
    }
    if (SEG) list_meeting_tiles(seg_b, S, c0, DKV_BK, q_first, n_cand, BWD_QT, meta, list);
    __syncthreads();
    const int pairs = meta[0] * group;  // (q tile, q head of the group), heads innermost

    const int warp = tid / 32, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const bool loader = tid < 32;  // warp 0 also fills the ring: no producer warp, so a block of
                                   // 8 warps keeps 255 registers a thread (a 9th warp caps them at 168)
    // Stage i % DKV_STAGES_N <- pair i: lse (log2 domain), di and segment ids of its 64 q rows by the
    // warp's lanes, Q and dO by TMA.
    auto fill = [&](int i) {
        const int s = i % DKV_STAGES_N, q0 = (SEG ? list[i / group] : q_first + i / group) * BWD_QT;
        const int head = kvh * group + i % group;
        unsigned char* st = sm + DKV_RING + s * DKV_STAGE;
        float* lse_s = reinterpret_cast<float*>(st + 2 * TILE64);
        float* di_s = lse_s + BWD_QT;
        int* sq_s = reinterpret_cast<int*>(di_s + BWD_QT);
        for (int r = lane; r < BWD_QT; r += 32) {
            const int row = q0 + r;
            const size_t at = ((size_t)b * H + head) * S + row;
            lse_s[r] = row < S ? lse[at] * LOG2E : -INFINITY;
            di_s[r] = row < S ? di[at] : 0.f;
            if (SEG) sq_s[r] = row < S ? seg_b[row] : -1;
        }
        if (lane == 0) {
            sm90::mbar_arrive_expect_tx(&full[s], 2 * TILE64);
            for (int h = 0; h < 2; ++h) {
                sm90::tma_load_4d(st + h * TILE64 / 2, &map_q, &full[s], 64 * h, head, q0, b);
                sm90::tma_load_4d(st + TILE64 + h * TILE64 / 2, &map_do, &full[s], 64 * h, head, q0, b);
            }
        } else {
            sm90::mbar_arrive(&full[s]);
        }
    };
    if (loader) {
        if (lane == 0) {
            sm90::tma_prefetch_map(&map_q);
            sm90::tma_prefetch_map(&map_do);
            sm90::mbar_arrive_expect_tx(kv_full, 2 * TILE64);
            for (int h = 0; h < 2; ++h) {
                sm90::tma_load_4d(sm + DKV_K + h * TILE64 / 2, &map_k, kv_full, 64 * h, kvh, c0, b);
                sm90::tma_load_4d(sm + DKV_V + h * TILE64 / 2, &map_v, kv_full, 64 * h, kvh, c0, b);
            }
        }
        for (int i = 0; i < min(pairs, DKV_STAGES_N); ++i) fill(i);
    }

    const int kr0 = c0 + 16 * warp + g;  // this thread's kv rows: kr0, kr0 + 8
    const bool kv_ragged = c0 + DKV_BK > S;
    int sk[2] = {-1, -1};
    if (SEG) {
        sk[0] = kr0 < S ? seg_b[kr0] : -1;
        sk[1] = kr0 + 8 < S ? seg_b[kr0 + 8] : -1;
    }
    const uint32_t k_tile = smem_addr(sm + DKV_K), v_tile = smem_addr(sm + DKV_V);
    float dka[64], dva[64];
#pragma unroll
    for (int x = 0; x < 64; ++x) dka[x] = dva[x] = 0.f;

    sm90::mbar_wait(kv_full, 0);
    for (int i = 0; i < pairs; ++i) {
        // the stage pair i - 1 used is refilled once every warp has released it
        if (loader && i > 0 && i - 1 + DKV_STAGES_N < pairs) {
            sm90::mbar_wait(&empty[(i - 1) % DKV_STAGES_N], ((i - 1) / DKV_STAGES_N) & 1);
            fill(i - 1 + DKV_STAGES_N);
        }
        const int s = i % DKV_STAGES_N, q0 = (SEG ? list[i / group] : q_first + i / group) * BWD_QT;
        sm90::mbar_wait(&full[s], (i / DKV_STAGES_N) & 1);
        if (!causal || q0 + BWD_QT - 1 >= c0) {  // uniform over the group
            const unsigned char* st = sm + DKV_RING + s * DKV_STAGE;
            const uint32_t q_tile = smem_addr(st), do_tile = q_tile + TILE64;
            const float* lse_s = reinterpret_cast<const float*>(st + 2 * TILE64);
            const float* di_s = lse_s + BWD_QT;
            const int* sq_s = reinterpret_cast<const int*>(di_s + BWD_QT);
            float sa[32], dpa[32];
#pragma unroll
            for (int x = 0; x < 32; ++x) sa[x] = dpa[x] = 0.f;
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
                sm90::wgmma_m64n64k16_ss(sa, sm90::desc_kmajor(k_tile, DKV_BK, 0, kk),
                                         sm90::desc_kmajor(q_tile, BWD_QT, 0, kk), kk > 0);
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
                sm90::wgmma_m64n64k16_ss(dpa, sm90::desc_kmajor(v_tile, DKV_BK, 0, kk),
                                         sm90::desc_kmajor(do_tile, BWD_QT, 0, kk), kk > 0);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::reg_fence(sa);
            sm90::reg_fence(dpa);

            const bool diag = causal && q0 < c0 + 63;  // some q row of the tile precedes some kv row
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                const int qc = 8 * n + 2 * t;  // q rows q0 + qc, q0 + qc + 1 of the tile
                const float2 l2 = *reinterpret_cast<const float2*>(lse_s + qc);
                const float2 d2 = *reinterpret_cast<const float2*>(di_s + qc);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float lv = (e & 1) ? l2.y : l2.x, dv_ = (e & 1) ? d2.y : d2.x;
                    const int kvr = kr0 + 8 * (e >> 1);
                    bool ok = lv != -INFINITY;
                    if (diag) ok = ok && kvr <= q0 + qc + (e & 1);
                    if (kv_ragged) ok = ok && kvr < S;
                    if (SEG) {
                        const int sqv = sq_s[qc + (e & 1)];
                        ok = ok && sqv >= 0 && sqv == sk[e >> 1];
                    }
                    const float p = ok ? exp2f(sa[4 * n + e] * LOG2E - lv) : 0.f;
                    sa[4 * n + e] = p;
                    dpa[4 * n + e] = p * (dpa[4 * n + e] - dv_);  // dS^T
                }
            }
            uint32_t pa[BWD_QT / 16][4], dsa[BWD_QT / 16][4];
#pragma unroll
            for (int kk = 0; kk < BWD_QT / 16; ++kk) {
                acc_to_a(pa[kk], sa, kk);
                acc_to_a(dsa[kk], dpa, kk);
            }
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BWD_QT / 16; ++kk)
                sm90::wgmma_m64n128k16_rs(dva, pa[kk], sm90::desc_mnmajor(do_tile, BWD_QT, kk), 1);  // dV += P^T dO
#pragma unroll
            for (int kk = 0; kk < BWD_QT / 16; ++kk)
                sm90::wgmma_m64n128k16_rs(dka, dsa[kk], sm90::desc_mnmajor(q_tile, BWD_QT, kk), 1);  // dK += dS^T Q
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::reg_fence(dva);
            sm90::reg_fence(dka);
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }

    const int hd = FULL ? HD : width;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = kr0 + 8 * r;
        if (row >= S) continue;
        const size_t at = ((size_t)b * S + row) * KVH * hd + (size_t)kvh * hd;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
            if (!FULL && 8 * n >= hd) continue;
            *reinterpret_cast<uint32_t*>(dk + at + 8 * n + 2 * t) = pack_bf16(dka[4 * n + 2 * r], dka[4 * n + 2 * r + 1]);
            *reinterpret_cast<uint32_t*>(dv + at + 8 * n + 2 * t) = pack_bf16(dva[4 * n + 2 * r], dva[4 * n + 2 * r + 1]);
        }
    }
}

bool bad_shape(int B, int S, int H, int KVH, int D) {
    return D < 8 || D > HD || D % 8 != 0 || B <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0;
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

template <typename Kernel>
void allow_smem(Kernel kernel, size_t bytes) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Tensor maps over [B, S, heads, D] bf16, read `rows` rows of one head at a
// time in 128-column tiles (zeros past column D).
bool rows_map(CUtensorMap* map, const void* x, int B, int S, int heads, int D, int rows) {
    return sm90::rows_map(map, x, 2, heads, S, B, D, (uint64_t)heads * D, (uint64_t)S * heads * D, rows, D);
}

// The kernel instantiation for segment ids or none, at width 128 or another.
template <typename Kernel>
Kernel pick(bool seg, int D, Kernel seg_full, Kernel seg_narrow, Kernel full, Kernel narrow) {
    return seg ? (D == HD ? seg_full : seg_narrow) : (D == HD ? full : narrow);
}

}  // namespace

// q arrives multiplied by D^-0.5 (rounded to bf16).
extern "C" int omchat_flash_attention_fwd(const void* q, const void* k, const void* v, const void* seg, void* out,
                                          void* lse, int B, int S, int H, int KVH, int D, int causal, void* stream) {
    if (bad_shape(B, S, H, KVH, D) || misaligned(q) || misaligned(k) || misaligned(v))
        return (int)cudaErrorInvalidValue;
    fwd90::Params p{};
    p.out = (bf16*)out;
    p.out_row = (long long)H * D;
    p.out_batch = (long long)S * H * D;
    p.head_dim = D;
    p.kv_len_all = S;
    p.B = B, p.S = S, p.H = H, p.KVH = KVH, p.T = S;
    p.causal = causal;
    p.q_scale = 1.f;
    p.mask_value = -INFINITY;
    p.lse = (float*)lse;
    p.seg = (const int*)seg;
    CUtensorMap mq, mk, mv;
    if (!rows_map(&mq, q, B, S, H, D, fwd90::BM) || !rows_map(&mk, k, B, S, KVH, D, fwd90::BN) ||
        !rows_map(&mv, v, B, S, KVH, D, fwd90::BN))
        return (int)cudaErrorInvalidValue;
    return seg ? fwd90::launch<false, false, true, true>(mq, mk, mv, p, stream)
               : fwd90::launch<false, false, true, false>(mq, mk, mv, p, stream);
}

// q arrives multiplied by D^-0.5 (rounded to bf16); dQ is multiplied by `scale` in fp32 before its rounding.
extern "C" int omchat_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                             const void* lse, const void* di, const void* seg, void* dq, int B, int S,
                                             int H, int KVH, int D, int causal, float scale, void* stream) {
    if (bad_shape(B, S, H, KVH, D) || misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout))
        return (int)cudaErrorInvalidValue;
    CUtensorMap mq, mdo, mk, mv;
    if (!rows_map(&mq, q, B, S, H, D, DQ_BM) || !rows_map(&mdo, dout, B, S, H, D, DQ_BM) ||
        !rows_map(&mk, k, B, S, KVH, D, DQ_BN) || !rows_map(&mv, v, B, S, KVH, D, DQ_BN))
        return (int)cudaErrorInvalidValue;
    const int n_kt = (S + DQ_BN - 1) / DQ_BN;
    const size_t smem = 1024 + DQ_META + (seg ? (4 + n_kt) * sizeof(int) : 0);
    const dim3 grid(H, ((S + DQ_BM - 1) / DQ_BM) * B);
    auto kernel = pick(seg, D, flash_bwd_dq_kernel<true, true>, flash_bwd_dq_kernel<true, false>,
                       flash_bwd_dq_kernel<false, true>, flash_bwd_dq_kernel<false, false>);
    allow_smem(kernel, smem);
    kernel<<<grid, DQ_THREADS, smem, (cudaStream_t)stream>>>(mq, mdo, mk, mv, (const float*)lse, (const float*)di,
                                                             (const int*)seg, (bf16*)dq, B, S, H, KVH, D, causal,
                                                             scale);
    return (int)cudaGetLastError();
}

// q arrives multiplied by D^-0.5 (rounded to bf16).
extern "C" int omchat_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                              const void* lse, const void* di, const void* seg, void* dk, void* dv,
                                              int B, int S, int H, int KVH, int D, int causal, void* stream) {
    if (bad_shape(B, S, H, KVH, D) || misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout))
        return (int)cudaErrorInvalidValue;
    CUtensorMap mq, mdo, mk, mv;
    if (!rows_map(&mq, q, B, S, H, D, BWD_QT) || !rows_map(&mdo, dout, B, S, H, D, BWD_QT) ||
        !rows_map(&mk, k, B, S, KVH, D, DKV_BK) || !rows_map(&mv, v, B, S, KVH, D, DKV_BK))
        return (int)cudaErrorInvalidValue;
    const int n_qt = (S + BWD_QT - 1) / BWD_QT;
    const size_t smem = 1024 + DKV_META + (4 + n_qt) * sizeof(int);
    const dim3 grid(KVH * B, (S + DKV_BK - 1) / DKV_BK);
    auto kernel = pick(seg, D, flash_bwd_dkv_kernel<true, true>, flash_bwd_dkv_kernel<true, false>,
                       flash_bwd_dkv_kernel<false, true>, flash_bwd_dkv_kernel<false, false>);
    allow_smem(kernel, smem);
    kernel<<<grid, WG, smem, (cudaStream_t)stream>>>(mq, mdo, mk, mv, (const float*)lse, (const float*)di,
                                                     (const int*)seg, (bf16*)dk, (bf16*)dv, B, S, H, KVH, D, causal);
    return (int)cudaGetLastError();
}
