// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is built on its own by nvcc (sm_90a) into a shared
// object with a plain C interface, loaded with ctypes
// (omchat_torch/ops/kernel_lib.py).  The C entry points return
// cudaGetLastError() right after the launch; the Python wrapper raises when
// that is not cudaSuccess.
//
// The attention kernels use the warp-level tensor-core product
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  Fragment layouts, with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row major), 4 x b32:  a0 = A[g][2t..2t+1]     a1 = A[g+8][2t..2t+1]
//                                   a2 = A[g][2t+8..2t+9]   a3 = A[g+8][2t+8..2t+9]
//   B (16x8, column major), 2 x b32: b0 = B[2t..2t+1][g]    b1 = B[2t+8..2t+9][g]
//   C (16x8, fp32), 4 floats:        c0,c1 = C[g][2t..2t+1] c2,c3 = C[g+8][2t..2t+1]
// The lower column (or row, for B) of a pair sits in the low 16 bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

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
//   ks, vs the tile's K and V rows in shared memory, row stride `ld` elements;
//   mask   mask(row_half, col_in_tile, s) -> the score to use (the caller's
//          masking rule, applied to every element);
//   m, l   running row max and row sum (fp32), acc the fp32 output rows.
//
// exp2 softmax as in the JAX kernels: p = exp2(s - m_new), l accumulates the
// unrounded fp32 p, the PV product takes p rounded to bf16.
template <int D, int KV_TILE, typename Mask>
__device__ __forceinline__ void attend_tile(const uint32_t (&qa)[D / 16][4], const bf16* ks, const bf16* vs, int ld,
                                            float (&m)[2], float (&l)[2], float (&acc)[D / 8][4], Mask mask) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    constexpr int NT = KV_TILE / 8;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const bf16* krow = ks + (nt * 8 + g) * ld;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 2 * t);
            uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8 + 2 * t);
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
    for (int dt = 0; dt < D / 8; ++dt) {
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
        const bf16* v0 = vs + (kk * 16 + 2 * t) * ld;
        const bf16* v8 = vs + (kk * 16 + 8 + 2 * t) * ld;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
            const int col = dt * 8 + g;
            uint32_t b0 = pack_bf16_raw(v0[col], v0[ld + col]);
            uint32_t b1 = pack_bf16_raw(v8[col], v8[ld + col]);
            mma_bf16_16816(acc[dt], pa, b0, b1);
        }
    }
}

// Write a warp's 16 normalised output rows (acc / l; rows with l == 0 write
// zeros, as the JAX kernels do).  `out_row0`/`out_row8` point at the first
// element of rows g and g + 8 (nullptr skips a row past the end).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], const float (&l)[2], bf16* out_row0,
                                           bf16* out_row8) {
    const int t = threadIdx.x & 3;
    const float inv0 = l[0] == 0.f ? 1.f : 1.f / l[0];
    const float inv1 = l[1] == 0.f ? 1.f : 1.f / l[1];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
        const int col = dt * 8 + 2 * t;
        if (out_row0) *reinterpret_cast<uint32_t*>(out_row0 + col) = pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
        if (out_row8) *reinterpret_cast<uint32_t*>(out_row8 + col) = pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
}
