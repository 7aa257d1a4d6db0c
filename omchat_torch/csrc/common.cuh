// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is built on its own by nvcc (sm_90a) into a shared
// object with a plain C interface, loaded with ctypes
// (omchat_torch/ops/kernel_lib.py).  The C entry points return
// cudaGetLastError() right after the launch; the Python wrapper raises when
// that is not cudaSuccess.
//
// The decode kernels (K3, K6, K12, K13: attend_tile below) use the
// warp-level tensor-core product mma.sync.m16n8k16 (bf16 in, fp32
// accumulate); K1, K2, K5, K14 and K16a-c use wgmma (sm90.cuh).
// Fragment layouts, with g = lane / 4 and t = lane % 4:
//   A (16x16, row major), 4 x b32:  a0 = A[g][2t..2t+1]     a1 = A[g+8][2t..2t+1]
//                                   a2 = A[g][2t+8..2t+9]   a3 = A[g+8][2t+8..2t+9]
//   B (16x8, column major), 2 x b32: b0 = B[2t..2t+1][g]    b1 = B[2t+8..2t+9][g]
//   C (16x8, fp32), 4 floats:        c0,c1 = C[g][2t..2t+1] c2,c3 = C[g+8][2t..2t+1]
// The lower column (or row, for B) of a pair sits in the low 16 bits.
//
// K/V may be stored as e4m3 (the fp8 KV cache, one byte a value): a kernel
// stages the bytes as stored and widens them to bf16 (in registers, or once
// into a shared tile), e4m3 -> f16 -> bf16, which is exact, so the products
// see the values the JAX kernels see after astype(q.dtype).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_fp8_e4m3 e4m3;  // one byte; the raw bits are its __x member

// A finite mask value, as the JAX kernels use (-0.7 * FLT_MAX): a fully
// masked row then never produces inf - inf.
#define OMCHAT_MASK_VALUE (-0.7f * 3.4028234663852886e38f)

extern "C" const char* omchat_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(bf16 lo, bf16 hi) {
    __nv_bfloat162 v;
    v.x = lo;
    v.y = hi;
    return *reinterpret_cast<uint32_t*>(&v);
}

// Two e4m3 values (the lower in the low byte) as a packed bf16 pair; exact.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(__nv_fp8x2_storage_t raw) {
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(raw, __NV_E4M3)));
    return pack_bf16(f.x, f.y);
}

// Two consecutive stored K/V values as a packed bf16 pair (an mma B operand),
// and one value, or two values of different rows, widened the same way.
__device__ __forceinline__ uint32_t load_bf16x2(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }
__device__ __forceinline__ uint32_t load_bf16x2(const e4m3* p) {
    return e4m3x2_to_bf16x2(*reinterpret_cast<const __nv_fp8x2_storage_t*>(p));
}
__device__ __forceinline__ uint32_t pack_pair(bf16 lo, bf16 hi) { return pack_bf16_raw(lo, hi); }
__device__ __forceinline__ uint32_t pack_pair(e4m3 lo, e4m3 hi) {
    return e4m3x2_to_bf16x2((__nv_fp8x2_storage_t)(lo.__x | (hi.__x << 8)));
}
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(e4m3 x) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}

// bf16 -> e4m3 as jnp.astype(float8_e4m3fn) stores it (ops.fp8.to_e4m3):
// round to nearest even, subnormals included; what rounds past 448
// (|x| > 464), +-inf and NaN become NaN with x's sign.  The conversion
// without saturation (__NV_NOSAT) has no instruction and runs as a long
// software sequence a value, so two values are rounded an instruction with
// the saturating one (cvt.rn.satfinite.e4m3x2.f32, 448 for what rounds past
// it) and NaN, with the value's sign, is put back where the bf16 value is
// past 464, +-inf or NaN: the same bits on every bf16 input.  The row commit
// (K4) and the page commit (K15) store through these.
//   w: two bf16 values, the lower in the low half -> two e4m3 bytes, the
//   lower in the low byte
__device__ __forceinline__ unsigned bf16x2_to_e4m3x2(unsigned w) {
    constexpr unsigned PAST_464 = 0x43E8u;  // |bf16| bits above 464's: NaN in e4m3 (so are +-inf and NaN)
    unsigned short pair;
    asm("cvt.rn.satfinite.e4m3x2.f32 %0, %2, %1;\n"
        : "=h"(pair)
        : "f"(__uint_as_float(w << 16)), "f"(__uint_as_float(w & 0xFFFF0000u)));
    unsigned b = pair;
    if ((w & 0x7FFFu) > PAST_464) b = (b & 0xFF00u) | 0x7Fu | ((w >> 8) & 0x80u);
    if (((w >> 16) & 0x7FFFu) > PAST_464) b = (b & 0x00FFu) | 0x7F00u | ((w >> 16) & 0x8000u);
    return b;
}

// 8 bf16 values (one 16-byte vector) -> their 8 e4m3 bytes (one 8-byte vector).
__device__ __forceinline__ uint2 bf16x8_to_e4m3x8(uint4 x) {
    return make_uint2(bf16x2_to_e4m3x2(x.x) | (bf16x2_to_e4m3x2(x.y) << 16),
                      bf16x2_to_e4m3x2(x.z) | (bf16x2_to_e4m3x2(x.w) << 16));
}

// The PV product's A operand from two fp32 p: rounded to bf16, or (the fp8
// cache in K2, whose TPU kernel computes p.astype(v.dtype)) to e4m3 and then
// widened exactly.  0 <= p <= 1, so the saturating hardware conversion never
// saturates here and rounds as astype does.
template <bool P_E4M3>
__device__ __forceinline__ uint32_t pack_p(float lo, float hi) {
    if constexpr (P_E4M3) {
        unsigned short raw;
        asm("cvt.rn.satfinite.e4m3x2.f32 %0, %2, %1;\n" : "=h"(raw) : "f"(lo), "f"(hi));
        return e4m3x2_to_bf16x2(raw);
    } else {
        return pack_bf16(lo, hi);
    }
}

// 16-byte asynchronous copy global -> shared (Ampere+ cp.async, L2 only), and
// its group commit / wait.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// The same copy, zero-filling the 16 shared bytes instead when `valid` is
// false (gmem must still be a valid address; nothing is read from it).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp folds one kv tile of KV_TILE columns into the online softmax state
// of its 16 query rows (two rows per thread: g and g + 8).
//
//   qa     the warp's q fragments, D/16 k-steps of 4 registers, already in the
//          exp2 domain (softmax scale and log2 e folded into q);
//   ks, vs the tile's K and V rows in shared memory as stored (bf16 or e4m3,
//          widened to bf16 in registers), row stride `ld` elements; the warp
//          computes DV of the D output columns (all by default), those of V
//          from `vs` on (the split-KV decode kernels give each warp a slice);
//   mask   mask(row_half, col_in_tile, s) -> the score to use (the caller's
//          masking rule, applied to every element);
//   m, l   running row max and row sum (fp32), acc the fp32 output rows.
//
// exp2 softmax as in the JAX kernels: p = exp2(s - m_new), l accumulates the
// unrounded fp32 p, the PV product takes p rounded to bf16.
template <int D, int KV_TILE, int DV = D, typename T, typename Mask>
__device__ __forceinline__ void attend_tile(const uint32_t (&qa)[D / 16][4], const T* ks, const T* vs, int ld,
                                            float (&m)[2], float (&l)[2], float (&acc)[DV / 8][4], Mask mask) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    constexpr int NT = KV_TILE / 8;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const T* krow = ks + (nt * 8 + g) * ld;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t b0 = load_bf16x2(krow + kk * 16 + 2 * t);
            uint32_t b1 = load_bf16x2(krow + kk * 16 + 8 + 2 * t);
            mma_bf16_16816(s[nt], qa[kk], b0, b1);
        }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[nt][e] = mask(e >> 1, nt * 8 + 2 * t + (e & 1), s[nt][e]);
            mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);  // m = -inf on the first tile: alpha = 0
        m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[nt][e] = exp2f(s[nt][e] - mx[e >> 1]);
            sum[e >> 1] += s[nt][e];
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = alpha[r] * l[r] + sum[r];
    }
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) {
        acc[dt][0] *= alpha[0];
        acc[dt][1] *= alpha[0];
        acc[dt][2] *= alpha[1];
        acc[dt][3] *= alpha[1];
    }
    // PV: the score accumulators are already laid out as A fragments.
#pragma unroll
    for (int kk = 0; kk < KV_TILE / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const T* v0 = vs + (kk * 16 + 2 * t) * ld;
        const T* v8 = vs + (kk * 16 + 8 + 2 * t) * ld;
#pragma unroll
        for (int dt = 0; dt < DV / 8; ++dt) {
            const int col = dt * 8 + g;
            uint32_t b0 = pack_pair(v0[col], v0[ld + col]);
            uint32_t b1 = pack_pair(v8[col], v8[ld + col]);
            mma_bf16_16816(acc[dt], pa, b0, b1);
        }
    }
}

// Split-KV decode (K3, K6, K12, K13): the GQA group's `group` q rows at `qb`
// ([group, d] bf16, d the true head width) as one mma row tile of DP >= d
// columns; rows >= group and columns >= d are zero, so that the zero-filled
// columns of a padded K row add nothing to q . k.  d is a multiple of 8, so
// a pair of columns lies wholly below d or wholly past it.
template <int DP>
__device__ __forceinline__ void load_q_group(uint32_t (&qa)[DP / 16][4], const bf16* qb, int group, int d) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    auto at = [&](int r, int c) {
        return r < group && c < d ? *reinterpret_cast<const uint32_t*>(qb + (size_t)r * d + c) : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        qa[kk][0] = at(g, c);
        qa[kk][1] = at(g + 8, c);
        qa[kk][2] = at(g, c + 8);
        qa[kk][3] = at(g + 8, c + 8);
    }
}

// The padded widths the split-KV decode kernels are built for: a head width
// d (a multiple of 8 from 8 to 128) runs on the smallest of 32, 64, 96 and
// 128 that holds it (the mma tiles take 16 columns a step, and each of two
// warps keeps whole 8-column n-tiles of the output).  Width 128 itself, the
// 7B trunk's, runs an instantiation that knows d when compiling (EXACT), so
// its copies and stores take the code of a fixed width.
__host__ __device__ constexpr int padded_width(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : 128; }

// Whether a split-KV decode kernel of padded width DP takes head width d on a
// cache of `elem_bytes` a value: rows of whole 16-byte copies (a multiple of
// 8 in bf16, of 16 in e4m3) and DP = padded_width(d).
__host__ __device__ constexpr bool split_width_ok(int d, int DP, int elem_bytes) {
    return d >= 8 && d <= 128 && (d * elem_bytes) % 16 == 0 && padded_width(d) == DP;
}

// Zero columns d .. DP - 1 of `rows` shared rows of stride `ld` (elements of
// type E) from `base`, by the block's threads: the columns a padded row holds
// past the head width, which no copy writes.  16 bytes a store (DP - d is a
// whole number of them).
template <int DP, typename E>
__device__ __forceinline__ void zero_pad_columns(E* base, int rows, int ld, int d) {
    constexpr int VEC = 16 / (int)sizeof(E);
    const int pieces = (DP - d) / VEC;
    for (int idx = threadIdx.x; idx < rows * pieces; idx += blockDim.x)
        *reinterpret_cast<uint4*>(base + (size_t)(idx / pieces) * ld + d + (idx % pieces) * VEC) =
            make_uint4(0, 0, 0, 0);
}

// ---------------------------------------------------------------------------
// Split-KV decode (K3, K6, K12, K13): the cache's rows are cut
// into chunks, a block of a chunk writes its q rows' fp32 softmax state
// (store_split_state), and a second kernel merges the chunks of each q row
// (split_merge_kernel, over combine_splits).  A state row is m and l (exp2
// domain) and acc [d], unnormalised, relative to m, d the true head width.
// The scratch: for n = B * KVH * splits * group partial rows (row ((b * KVH +
// kvh) * splits + split) * group + gi), acc [n, d] first, then m [n], then
// l [n], all fp32.
// ---------------------------------------------------------------------------

// One warp's share of a split block's state, after its last tile: the
// rows r < group of the GQA group (the mma tile's rows g and g + 8; at most
// 16) of its DV output columns from `col0` on, those below d, into
// acc_out[r * d + c]; with `ml`, also m_out[r] and l_out[r].
template <int DV>
__device__ __forceinline__ void store_split_state(const float (&m)[2], const float (&l)[2],
                                                  const float (&acc)[DV / 8][4], int group, int col0, bool ml,
                                                  float* m_out, float* l_out, float* acc_out, int d) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        if (r >= group) continue;
#pragma unroll
        for (int dt = 0; dt < DV / 8; ++dt) {
            const int c = col0 + dt * 8 + 2 * t;
            if (c < d)
                *reinterpret_cast<float2*>(acc_out + (size_t)r * d + c) =
                    make_float2(acc[dt][2 * h], acc[dt][2 * h + 1]);
        }
        if (ml && t == 0) {
            m_out[r] = m[h];
            l_out[r] = l[h];
        }
    }
}

// The merge across split blocks for one q row, called by every thread of a
// block of NW warps: the states of n splits (m_part[s * stride], l_part[s *
// stride], acc_part[s * stride * d + c]; a split that saw no column has m =
// -inf and its acc is never read into the sums).  Lane i holds columns 4 i ..
// 4 i + 3, those below the head width d (a multiple of 8, at most 128).
// Warp w takes splits w PER .. w PER + PER - 1, then w PER + NW PER ...,
// every load of a pass issued before its sums, merges them in split order
// against its running max; then warp 0 merges the warps in warp order: a
// fixed order, so the result is bitwise the same from launch to launch.
// Then the self column (q_row . k_row, v_row; none when k_row is null) folds
// in after the merge, as omchat_tpu/ops/online_softmax.py:64
// fold_self_column follows the last tile, its p rounded to bf16 for its
// product; the row is normalised (normalize_output :76: a row with no column
// at all writes zeros) into o_row [d] bf16.  smem: NW (128 + 2) floats,
// 16-byte aligned.  Launch its kernel as a programmatic dependent of the
// split kernel (launch_merge_dependent).
template <int NW, int PER>
__device__ __forceinline__ void combine_splits(float* smem, const float* m_part, const float* l_part,
                                               const float* acc_part, int n, int stride, const bf16* q_row,
                                               const bf16* k_row, const bf16* v_row, bf16* o_row, float scale_log2,
                                               int d) {
    constexpr int W = 128;  // columns a merge block can hold: four a lane
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int c = lane * 4;
    const bool on = c < d;  // the lane holds columns of the head
    float qf[4] = {0.f, 0.f, 0.f, 0.f}, kf[4] = {0.f, 0.f, 0.f, 0.f}, vf[4];  // the self column's operands
    if (warp == 0 && k_row != nullptr && on)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            qf[i] = __bfloat162float(q_row[c + i]);
            kf[i] = __bfloat162float(k_row[c + i]);
            vf[i] = __bfloat162float(v_row[c + i]);
        }
    // Launched as a programmatic dependent of the split kernel, the block may
    // start before that kernel ends: wait here until its stores are visible
    // (a no-op otherwise).
    asm volatile("griddepcontrol.wait;\n" ::: "memory");

    float mw = -INFINITY, lw = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = warp * PER; s0 < n; s0 += NW * PER) {
        float ms[PER], ls[PER];
        float4 x[PER];
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            const bool in = s0 + j < n;
            const size_t s = (size_t)(s0 + j) * stride;
            ms[j] = in ? m_part[s] : -INFINITY;
            ls[j] = in ? l_part[s] : 0.f;
            x[j] = in && on ? *reinterpret_cast<const float4*>(acc_part + s * d + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float mb = mw;
#pragma unroll
        for (int j = 0; j < PER; ++j) mb = fmaxf(mb, ms[j]);
        if (mb == -INFINITY) continue;
        const float sc = exp2f(mw - mb);  // mw = -inf (nothing yet): 0
        lw *= sc;
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] *= sc;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            if (ms[j] == -INFINITY) continue;  // an empty split: its acc is not a number to add
            const float e = exp2f(ms[j] - mb);
            lw += ls[j] * e;
            a[0] += x[j].x * e;
            a[1] += x[j].y * e;
            a[2] += x[j].z * e;
            a[3] += x[j].w * e;
        }
        mw = mb;
    }
    float* m_s = smem;           // [NW]
    float* l_s = m_s + NW;       // [NW]
    float* a_s = l_s + NW;       // [NW][W]
    if (lane == 0) {
        m_s[warp] = mw;
        l_s[warp] = lw;
    }
    *reinterpret_cast<float4*>(a_s + warp * W + c) = make_float4(a[0], a[1], a[2], a[3]);
    __syncthreads();
    if (warp != 0) return;

    float mg = -INFINITY;
    for (int w = 0; w < NW; ++w) mg = fmaxf(mg, m_s[w]);
    float lsum = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < NW; ++w) {
        if (m_s[w] == -INFINITY) continue;  // a warp that held no split with a column
        const float e = exp2f(m_s[w] - mg);
        const float4 x = *reinterpret_cast<const float4*>(a_s + w * W + c);
        lsum += l_s[w] * e;
        o[0] += x.x * e;
        o[1] += x.y * e;
        o[2] += x.z * e;
        o[3] += x.w * e;
    }
    if (k_row != nullptr) {
        float s = qf[0] * kf[0] + qf[1] * kf[1] + qf[2] * kf[2] + qf[3] * kf[3];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        s *= scale_log2;
        const float m_new = fmaxf(mg, s);
        const float alpha = exp2f(mg - m_new);  // mg = -inf (no cached row): 0
        const float p = exp2f(s - m_new);
        const float pb = __bfloat162float(__float2bfloat16(p));
        lsum = lsum * alpha + p;
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = o[i] * alpha + pb * (on ? vf[i] : 0.f);
    }
    if (on)
#pragma unroll
        for (int i = 0; i < 4; ++i) o_row[c + i] = __float2bfloat16(lsum == 0.f ? 0.f : o[i] / lsum);
}

// The merge kernel: one block of NW warps a (q head, request), grid (H, B),
// over the scratch above; the self column k_new / v_new [B, KVH, d] (null:
// none) folds in after the merge; out [B, H, d] bf16.  DC > 0: the head
// width is DC, known when compiling (d is ignored).
template <int NW, int PER, int DC = 0>
__global__ void __launch_bounds__(32 * NW)
split_merge_kernel(const float* __restrict__ scratch, const bf16* __restrict__ q, const bf16* __restrict__ k_new,
                   const bf16* __restrict__ v_new, bf16* __restrict__ out, int B, int KVH, int splits, int group,
                   float scale_log2, int d_arg) {
    const int d = DC > 0 ? DC : d_arg;
    __shared__ __align__(16) float smem[NW * (128 + 2)];
    const int h = blockIdx.x, b = blockIdx.y;
    const int H = KVH * group, kvh = h / group, gi = h % group;
    const size_t n = (size_t)B * KVH * splits * group;
    const size_t r = ((size_t)b * KVH + kvh) * splits * group + gi;  // split 0's partial row of this head
    const size_t kv = ((size_t)b * KVH + kvh) * d;
    combine_splits<NW, PER>(smem, scratch + n * d + r, scratch + n * d + n + r, scratch + r * d, splits, group,
                            q + ((size_t)b * H + h) * d, k_new != nullptr ? k_new + kv : nullptr,
                            v_new != nullptr ? v_new + kv : nullptr, out + ((size_t)b * H + h) * d, scale_log2, d);
}

// Launch the merge kernel right behind the split kernel on `stream` as its
// programmatic dependent: the merge blocks start while the split blocks
// finish (the split kernel lets them: trigger_merge_launch) and wait in
// combine_splits for the split kernel's stores.
__device__ __forceinline__ void trigger_merge_launch() { asm volatile("griddepcontrol.launch_dependents;\n" ::); }

template <typename... Params, typename... Args>
cudaError_t launch_merge_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t stream,
                                   Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// ---------------------------------------------------------------------------
// Segment ids (packed training sequences; K16a, K16b, K16c)
// ---------------------------------------------------------------------------

// (min, max) of the non-negative segment ids of rows r0..r0+n-1 of seg_b
// (global; rows past S ignored), by one warp; every lane gets the range.  An
// all-padding range overlaps nothing.
__device__ __forceinline__ int2 warp_seg_range(const int* seg_b, int r0, int n, int S) {
    int lo = 1 << 30, hi = -(1 << 30);
    for (int i = threadIdx.x & 31; i < n; i += 32) {
        const int x = r0 + i < S ? seg_b[r0 + i] : -1;
        if (x >= 0) {
            lo = min(lo, x);
            hi = max(hi, x);
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    return make_int2(lo, hi);
}

__device__ __forceinline__ bool overlap(int2 a, int2 b) { return a.y >= b.x && a.x <= b.y; }

// With segment ids: the tiles (of `rows` rows, indices first..first+n-1)
// whose segment range meets that of rows [r0, r0 + own) go to list[0..count),
// in order; meta[0] = count.  Run by every thread of the block, which must
// synchronise after it.
__device__ inline void list_meeting_tiles(const int* seg_b, int S, int r0, int own, int first, int n, int rows,
                                          int* meta, int* list) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    const int2 mine = warp_seg_range(seg_b, r0, own, S);
    for (int j = warp; j < n; j += warps) {
        const int2 r = warp_seg_range(seg_b, (first + j) * rows, rows, S);
        if (lane == 0) list[j] = overlap(mine, r);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int count = 0;
        for (int j = 0; j < n; ++j)
            if (list[j]) list[count++] = first + j;
        meta[0] = count;
    }
}
