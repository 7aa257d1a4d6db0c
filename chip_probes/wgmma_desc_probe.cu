// Probe of the wgmma descriptors and TMA maps of csrc/sm90.cuh: one
// warpgroup loads tiles by TMA into 128-byte-swizzled shared memory and runs
// one product, which chip_probes/wgmma_desc_probe.py holds against
// torch.matmul.  Built on its own (nvcc -I omchat_torch/csrc), not part of
// the port's kernels.
//
//   mode 0: C[64 x 128] = A B^T     A: rows 64..127 of a 128-row tile, B: a 128-row tile (K-major, m64n128k16)
//   mode 1: C[64 x 128] = P V       P [64 x 128] in registers, V: a 128-row tile (MN-major, m64n128k16, rs)
//   mode 2: C[64 x 64]  = A B^T     A, B: 64-row tiles (K-major, m64n64k16)
//   mode 3: C[64 x 128] = P V       P [64 x 64] in registers, V: a 64-row tile (MN-major)
//   mode 4: C[64 x 128] = A B^T     int8 (s32 out): A rows 64..127 of a 128-row [128 x 128] tile, B a
//                                   [128 x 128] tile, both K-major by s8_gemm_sm90.cuh's rank-2 maps,
//                                   descriptors and m64n128k32 s8 (omchat_s8_probe)
#include "common.cuh"
#include "s8_gemm_sm90.cuh"
#include "sm90.cuh"

namespace {

__global__ void __launch_bounds__(128) probe_kernel(const __grid_constant__ CUtensorMap map_a,
                                                    const __grid_constant__ CUtensorMap map_b, const bf16* p,
                                                    float* c, int mode) {
    extern __shared__ unsigned char raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    bf16* ta = reinterpret_cast<bf16*>(base);            // up to 128 rows: 32 KB
    bf16* tb = reinterpret_cast<bf16*>(base + 32768);    // up to 128 rows: 32 KB
    uint64_t* bar = reinterpret_cast<uint64_t*>(base + 65536);
    const int rows_a = (mode == 0) ? 128 : 64;
    const int rows_b = (mode == 0 || mode == 1) ? 128 : 64;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    if (tid == 0) {
        sm90::mbar_init(bar, 1);
        sm90::mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
        const uint32_t bytes = (mode == 1 || mode == 3 ? 0 : rows_a * 256) + rows_b * 256;
        sm90::mbar_arrive_expect_tx(bar, bytes);
        for (int h = 0; h < 2; ++h) {
            if (mode != 1 && mode != 3) sm90::tma_load_4d(ta + h * rows_a * 64, &map_a, bar, 64 * h, 0, 0, 0);
            sm90::tma_load_4d(tb + h * rows_b * 64, &map_b, bar, 64 * h, 0, 0, 0);
        }
    }
    sm90::mbar_wait(bar, 0);
    const uint32_t sa = sm90::smem_u32(ta), sb = sm90::smem_u32(tb);
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    if (mode == 0 || mode == 2) {
        const int row0 = mode == 0 ? 64 : 0;
        float d32[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d32[i] = 0.f;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            const uint64_t da = sm90::desc_kmajor(sa, rows_a, row0, kk), db = sm90::desc_kmajor(sb, rows_b, 0, kk);
            if (mode == 0)
                sm90::wgmma_m64n128k16_ss(d, da, db, kk > 0);
            else
                sm90::wgmma_m64n64k16_ss(d32, da, db, kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::reg_fence(d);
        sm90::reg_fence(d32);
        if (mode == 2)
#pragma unroll
            for (int i = 0; i < 32; ++i) d[i] = d32[i];
    } else {
        const int kdim = rows_b;  // 128 or 64 rows of V: the reduction
        sm90::wgmma_fence();
        for (int kk = 0; kk < kdim / 16; ++kk) {
            // P's A fragment for rows 16 warp + g (+8), columns 16 kk + 2t (+1, +8, +9)
            const bf16* p0 = p + (16 * warp + g) * kdim + 16 * kk + 2 * t;
            const bf16* p1 = p0 + 8 * kdim;
            uint32_t a[4] = {load_bf16x2(p0), load_bf16x2(p1), load_bf16x2(p0 + 8), load_bf16x2(p1 + 8)};
            sm90::wgmma_fence();
            sm90::wgmma_m64n128k16_rs(d, a, sm90::desc_mnmajor(sb, rows_b, kk), kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::reg_fence(d);
    }
    const int n = (mode == 2) ? 64 : 128;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        if (8 * j >= n) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = 16 * warp + g + 8 * (e / 2), col = 8 * j + 2 * t + (e % 2);
            c[r * n + col] = d[4 * j + e];
        }
    }
}

// mode 4: one warpgroup, the tiles by s8gemm::tma_load_2d, four k32 steps of s8gemm's descriptors.
__global__ void __launch_bounds__(128) s8_probe_kernel(const __grid_constant__ CUtensorMap map_a,
                                                       const __grid_constant__ CUtensorMap map_b, int* c) {
    extern __shared__ unsigned char raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    int8_t* ta = reinterpret_cast<int8_t*>(base);          // 128 rows x 128 bytes
    int8_t* tb = reinterpret_cast<int8_t*>(base + 16384);  // 128 rows x 128 bytes
    uint64_t* bar = reinterpret_cast<uint64_t*>(base + 32768);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    if (tid == 0) {
        sm90::mbar_init(bar, 1);
        sm90::mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
        sm90::mbar_arrive_expect_tx(bar, 2 * 128 * 128);
        s8gemm::tma_load_2d(ta, &map_a, bar, 0, 0);
        s8gemm::tma_load_2d(tb, &map_b, bar, 0, 0);
    }
    sm90::mbar_wait(bar, 0);
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
        s8gemm::wgmma_m64n128k32_s8(d, s8gemm::desc(sm90::smem_u32(ta), 64, kk), s8gemm::desc(sm90::smem_u32(tb), 0, kk),
                                    kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    s8gemm::reg_fence(d);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[(16 * warp + g + 8 * (e / 2)) * 128 + 8 * j + 2 * t + (e % 2)] = d[4 * j + e];
}

}  // namespace

// a, b: [128, 128] int8; c: [64, 128] int32 (rows 64..127 of a times b^T)
extern "C" int omchat_s8_probe(const void* a, const void* b, void* c, void* stream) {
    CUtensorMap ma, mb;
    if (!s8gemm::matrix_map(&ma, a, 128, 128, 128) || !s8gemm::matrix_map(&mb, b, 128, 128, 128))
        return (int)cudaErrorInvalidValue;
    const int smem = 32768 + 1024 + 64;
    cudaFuncSetAttribute(s8_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    s8_probe_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(ma, mb, (int*)c);
    return (int)cudaGetLastError();
}

// a, b: [rows, 128] bf16 (b is V in modes 1 and 3); p: [64, rows_b] bf16; c: [64, 128 or 64] fp32
extern "C" int omchat_wgmma_probe(const void* a, const void* b, const void* p, void* c, int mode, void* stream) {
    const int rows_a = (mode == 0) ? 128 : 64, rows_b = (mode == 0 || mode == 1) ? 128 : 64;
    CUtensorMap ma, mb;
    if (!sm90::rows_map(&ma, a, 2, 1, rows_a, 1, 128, 128, (uint64_t)rows_a * 128, rows_a) ||
        !sm90::rows_map(&mb, b, 2, 1, rows_b, 1, 128, 128, (uint64_t)rows_b * 128, rows_b))
        return (int)cudaErrorInvalidValue;
    const int smem = 65536 + 1024 + 64;
    cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    probe_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(ma, mb, (const bf16*)p, (float*)c, mode);
    return (int)cudaGetLastError();
}
