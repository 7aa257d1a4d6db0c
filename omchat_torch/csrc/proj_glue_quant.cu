// Attention output projection fused with the glue after it (K11): dynamic
// row quantization of the attention output, int8 GEMM with the square proj /
// o_proj weight, dequantize + bias, residual + LayerScale, RMSNorm, int8
// quantization of the normed rows.
//
// Replaces the TPU kernel omchat_tpu/ops/quant_matmul.py:255
// attn_proj_glue_quant (body _proj_glue_kernel :215, pallas_call :299).
//
//   a [M, K] bf16 (attention output), x [M, N] bf16 (residual), w [N, K]
//   int8 (K == N), col_scale [N] bf16, bias [N] bf16 (nullptr: none), ls [N]
//   bf16 (nullptr: 1), gamma [N] bf16
//   -> x_new [M, N] bf16, codes [M, N] int8, row_scale [M] fp32
//
//   sa = max(max|a|, 1e-6) / 127; aq = clip(rint(a / sa))
//   y = bf16(acc * sa * col_scale); y = bf16(y + bias)
//   x_new = bf16(x + y * ls); n = (x_new * r) * gamma, r = 1 / sqrt(mean(x_new^2) + eps)
//   row_scale = max(max|n|, 1e-6) / 127; codes = clip(rint(n / row_scale))
// in the Pallas body's order, with its roundings (products and sums forced
// by __fmul_rn / __fadd_rn, IEEE division and sqrt, round half to even).
//
// What bounds it on the H100: operations.  2 M N K: 63.4 G at the ViT shape
// (M = 3096, K = N = 3200) and 82.2 G at the Qwen2 prefill (M = 3200,
// K = N = 3584): 0.032 / 0.042 ms at the dense int8 peak, against 50 / 60 MB
// of traffic.
//
// Design.  The TPU kernel keeps the whole weight (10-13 MB) resident in VMEM
// and sweeps row blocks past it; no SM's 227 KB can hold it.  The norm needs
// every column of a row before any code can be written, so a block owns
// BM = 32 whole rows:
//   1. it quantizes its 32 rows of a (amax over K, then codes) into shared
//      memory, where they stay as the A operand of every N tile
//      (32 x (K + 16) bytes: 115 KB at K = 3584);
//   2. it walks N in 256-wide tiles, streaming w in 64-deep K tiles through a
//      3-stage cp.async ring (8 warps, each 32 rows x 32 columns, mma.sync
//      m16n8k32 s8); each tile's epilogue dequantizes, adds bias and the
//      residual, writes x_new and adds each row's sum of squares;
//   3. after the last tile it reads its own x_new rows back (L2-resident,
//      written by this block), normalizes, takes the row amax and writes
//      the codes and row scales.
// BM = 32 makes M / 32 blocks (100 at M = 3200: one wave on 132 SMs, one
// block per SM by shared memory).  Each block streams the whole weight, so w
// is read M / 32 times, from L2 (it fits the 50 MB L2; device memory
// serves it about once): a larger BM would stream it less often but leave
// SMs idle, and the rows of a (K bytes each) would no longer fit.  No wgmma,
// TMA or cluster multicast of w yet.
#include "common.cuh"

namespace {

constexpr int BM = 32, BN = 256, BK = 64, STAGES = 3, THREADS = 256, WARPS = THREADS / 32;
constexpr int LDB = BK + 16;  // bytes per staged weight row
constexpr int STAGE_BYTES = BN * LDB;
constexpr int ROWS_PER_WARP = BM / WARPS;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ uint2 quantize8(const float (&n)[8], float scale) {
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(n[j], scale)), -127.f), 127.f);
        packed[j >> 2] |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * (j & 3));
    }
    return make_uint2(packed[0], packed[1]);
}

__global__ void __launch_bounds__(THREADS)
proj_glue_quant_kernel(const bf16* __restrict__ a, const bf16* __restrict__ x, const int8_t* __restrict__ w,
                       const bf16* __restrict__ col_scale, const bf16* __restrict__ bias, const bf16* __restrict__ ls,
                       const bf16* __restrict__ gamma, bf16* x_new, int8_t* __restrict__ codes,
                       float* __restrict__ row_scale, int M, int N, float eps) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float sa_s[BM];
    __shared__ float ss_s[WARPS][BM];
    const int K = N;
    const int LDA = K + 16;  // bytes per quantized row of a: 32 distinct banks for the fragment loads
    unsigned char* as = smem;
    unsigned char* ws = smem + BM * LDA;
    const int m0 = blockIdx.x * BM;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;

    // 1. quantize the block's rows of a into shared memory (rows past M: zeros)
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
        const int r = warp * ROWS_PER_WARP + rr;
        const int row = m0 + r;
        if (row >= M) {
            for (int k = lane * 16; k < K; k += 32 * 16)
                *reinterpret_cast<uint4*>(as + r * LDA + k) = make_uint4(0, 0, 0, 0);
            if (lane == 0) sa_s[r] = 0.f;
            continue;
        }
        const bf16* arow = a + (size_t)row * K;
        float amax = 0.f;
        for (int k = lane * 8; k < K; k += 32 * 8) {
            float v[8];
            load8(arow + k, v);
#pragma unroll
            for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
        }
        const float sa = __fdiv_rn(fmaxf(warp_max(amax), 1e-6f), 127.f);
        for (int k = lane * 8; k < K; k += 32 * 8) {
            float v[8];
            load8(arow + k, v);
            *reinterpret_cast<uint2*>(as + r * LDA + k) = quantize8(v, sa);
        }
        if (lane == 0) sa_s[r] = sa;
    }

    // 2. walk N in BN-wide tiles; the K tiles of w stream through the ring
    const int KT = K / BK, NT = (N + BN - 1) / BN, total = NT * KT;
    auto load_w = [&](int stage, int it) {
        const int n0 = (it / KT) * BN, k0 = (it % KT) * BK;
        unsigned char* dst = ws + stage * STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < (BN * BK / 16) / THREADS; ++i) {
            const int c = tid + i * THREADS, row = c >> 2, col = (c & 3) * 16;
            const bool valid = n0 + row < N;
            cp_async16_zfill(dst + row * LDB + col, w + (size_t)(valid ? n0 + row : 0) * K + k0 + col, valid);
        }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < total) load_w(s, s);
        cp_async_commit();
    }
    __syncthreads();  // the quantized rows and their scales are in place

    int acc[2][4][4];
    float ss[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [m tile][row g / g+8]: sums of squares of x_new
    for (int it = 0; it < total; ++it) {
        const int nt = it / KT, kt = it % KT;
        if (kt == 0) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
        }
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (it + STAGES - 1 < total) load_w((it + STAGES - 1) % STAGES, it + STAGES - 1);
        cp_async_commit();
        const int n0 = nt * BN;
        const bool active = n0 + warp * 32 < N;  // the last tile may be narrower than BN
        if (active) {
            const unsigned char* bs = ws + (it % STAGES) * STAGE_BYTES;
#pragma unroll
            for (int kk = 0; kk < BK; kk += 32) {
                uint32_t af[2][4], bf[4][2];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    const unsigned char* r0 = as + (mt * 16 + g) * LDA + kt * BK + kk + 4 * t;
                    af[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
                    af[mt][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LDA);
                    af[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
                    af[mt][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LDA + 16);
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const unsigned char* c0 = bs + (warp * 32 + j * 8 + g) * LDB + kk + 4 * t;
                    bf[j][0] = *reinterpret_cast<const uint32_t*>(c0);
                    bf[j][1] = *reinterpret_cast<const uint32_t*>(c0 + 16);
                }
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                    for (int j = 0; j < 4; ++j) mma_s8_16832(acc[mt][j], af[mt], bf[j][0], bf[j][1]);
            }
        }
        if (kt == KT - 1 && active) {
            // epilogue of this N tile: dequantize, bias, residual; write x_new
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = n0 + warp * 32 + j * 8 + 2 * t;
                float cs[2], b[2], l[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    cs[e] = __bfloat162float(col_scale[col + e]);
                    b[e] = bias ? __bfloat162float(bias[col + e]) : 0.f;
                    l[e] = ls ? __bfloat162float(ls[col + e]) : 1.f;
                }
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int r = mt * 16 + g + 8 * half;
                        const int row = m0 + r;
                        if (row >= M) continue;
                        const float sa = sa_s[r];
                        const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * N + col);
                        const float xv[2] = {__bfloat162float(xr.x), __bfloat162float(xr.y)};
                        bf16 o[2];
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            float y = __bfloat162float(__float2bfloat16_rn(
                                __fmul_rn(__fmul_rn((float)acc[mt][j][2 * half + e], sa), cs[e])));
                            if (bias) y = __bfloat162float(__float2bfloat16_rn(__fadd_rn(y, b[e])));
                            o[e] = __float2bfloat16_rn(__fadd_rn(xv[e], __fmul_rn(y, l[e])));
                            const float v = __bfloat162float(o[e]);
                            ss[mt][half] = __fadd_rn(ss[mt][half], __fmul_rn(v, v));
                        }
                        *reinterpret_cast<uint32_t*>(x_new + (size_t)row * N + col) = pack_bf16_raw(o[0], o[1]);
                    }
                }
            }
        }
    }
    cp_async_wait<0>();

    // each row's sum of squares: over the 4 threads of a quad, then over the warps
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            float s = ss[mt][half];
            s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
            s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
            if (t == 0) ss_s[warp][mt * 16 + g + 8 * half] = s;
        }
    __syncthreads();  // also makes this block's x_new writes visible to all its threads

    // 3. RMSNorm of x_new, row amax, codes
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
        const int r = warp * ROWS_PER_WARP + rr;
        const int row = m0 + r;
        if (row >= M) continue;
        float sumsq = 0.f;
#pragma unroll
        for (int wi = 0; wi < WARPS; ++wi) sumsq = __fadd_rn(sumsq, ss_s[wi][r]);
        const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(sumsq, (float)N), eps)));
        const bf16* xrow = x_new + (size_t)row * N;
        float amax = 0.f;
        for (int k = lane * 8; k < N; k += 32 * 8) {
            float v[8], gm[8];
            load8(xrow + k, v);
            load8(gamma + k, gm);
#pragma unroll
            for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__fmul_rn(__fmul_rn(v[j], rstd), gm[j])));
        }
        const float scale = __fdiv_rn(fmaxf(warp_max(amax), 1e-6f), 127.f);
        for (int k = lane * 8; k < N; k += 32 * 8) {
            float v[8], gm[8], n[8];
            load8(xrow + k, v);
            load8(gamma + k, gm);
#pragma unroll
            for (int j = 0; j < 8; ++j) n[j] = __fmul_rn(__fmul_rn(v[j], rstd), gm[j]);
            *reinterpret_cast<uint2*>(codes + (size_t)row * N + k) = quantize8(n, scale);
        }
        if (lane == 0) row_scale[row] = scale;
    }
}

}  // namespace

// K == N, a multiple of 128 up to 4096 (the wrapper's gate).
extern "C" int omchat_proj_glue_quant(const void* a, const void* x, const void* w, const void* col_scale,
                                      const void* bias, const void* ls, const void* gamma, void* x_new, void* codes,
                                      void* row_scale, int M, int N, float eps, void* stream) {
    const int smem = BM * (N + 16) + STAGES * STAGE_BYTES;
    cudaFuncSetAttribute(proj_glue_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    proj_glue_quant_kernel<<<(M + BM - 1) / BM, THREADS, smem, (cudaStream_t)stream>>>(
        (const bf16*)a, (const bf16*)x, (const int8_t*)w, (const bf16*)col_scale, (const bf16*)bias, (const bf16*)ls,
        (const bf16*)gamma, (bf16*)x_new, (int8_t*)codes, (float*)row_scale, M, N, eps);
    return (int)cudaGetLastError();
}
