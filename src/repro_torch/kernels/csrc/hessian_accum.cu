// H += X^T X in fp32: the calibration Gram matrix of one dense linear.
//
// Replaces: src/repro/kernels/hessian_accum.py, hessian_accum_pallas
// (_hessian_kernel), reached from core/hessian.accumulate.
//
// Bound on the H100: operations. 2*n*d^2 FLOP against (n*d + d^2)*4 bytes;
// at the main path's n = 512 tokens and d = 768 or 3072 the arithmetic
// intensity is ~200 FLOP/byte, far above the fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20). The reference pins the Gram at fp32 HIGHEST precision
// and Hopper's tensor cores take no fp32 operands, so the work runs as
// FFMA on the CUDA cores.
//
// Design: each 256-thread block owns a 64x64 tile of H, 4x4 outputs per
// thread in registers. The token axis is the reduction: 32-token slabs of
// the two 64-column panels of X are staged in shared memory and every
// staged value is reused 4 times from registers. Only tiles on or above
// the diagonal are computed; an off-diagonal tile is written to both
// (i, j) and (j, i), halving the FLOP. The kernel accumulates into the
// caller's H in place (fusing the reference's `state.H + X^T X`): each
// output is summed over all tokens first and then added to H once, the
// same rounding as the plain version. Ragged edges are masked.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int SLAB = 32;

__global__ void __launch_bounds__(256)
hessian_accum_kernel(const float* __restrict__ x, float* __restrict__ H,
                     int n, int d) {
    const int bi = blockIdx.y, bj = blockIdx.x;
    if (bj < bi) return;                       // upper triangle of tiles
    const int i0 = bi * TILE, j0 = bj * TILE;
    __shared__ float xa[SLAB][TILE];
    __shared__ float xb[SLAB][TILE];
    const int tid = threadIdx.x;
    const int tr = tid / 16, tc = tid % 16;    // 16 x 16 threads, 4x4 each
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

    for (int t0 = 0; t0 < n; t0 += SLAB) {
        for (int e = tid; e < SLAB * TILE; e += 256) {
            const int r = e / TILE, c = e % TILE;
            const int t = t0 + r;
            const bool tok = t < n;
            xa[r][c] = (tok && i0 + c < d) ? x[(long)t * d + i0 + c] : 0.f;
            xb[r][c] = (tok && j0 + c < d) ? x[(long)t * d + j0 + c] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int r = 0; r < SLAB; ++r) {
            float va[4], vb[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) va[a] = xa[r][tr * 4 + a];
#pragma unroll
            for (int b = 0; b < 4; ++b) vb[b] = xb[r][tc * 4 + b];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    acc[a][b] = fmaf(va[a], vb[b], acc[a][b]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int i = i0 + tr * 4 + a;
        if (i >= d) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const int j = j0 + tc * 4 + b;
            if (j >= d) continue;
            if (bi == bj) {
                H[(long)i * d + j] += acc[a][b];
            } else {
                H[(long)i * d + j] += acc[a][b];
                H[(long)j * d + i] += acc[a][b];
            }
        }
    }
}

}  // namespace

extern "C" int hessian_accum_launch(const float* x, float* H, int n, int d,
                                    void* stream) {
    const int tiles = (d + TILE - 1) / TILE;
    dim3 grid(tiles, tiles);
    hessian_accum_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(x, H, n, d);
    return (int)cudaGetLastError();
}
