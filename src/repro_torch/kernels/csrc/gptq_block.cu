// The GPTQ stage-1 lazy-block sweep of a stacked group of linears.
//
// Replaces: src/repro/kernels/gptq_block.py, gptq_block_pallas
// (_gptq_block_kernel), reached from core/gptq.gptq_quantize_batched.
//
// Bound on the H100: the sweep is a sequential chain of Cin dependent
// column steps, each a few operations per row plus a block barrier, so
// latency (column steps times barrier cost), not bytes or FLOP, sets its
// time. The only bulk work is the rank-bs tail update
// W[:, c2:] -= Err @ U[c1:c2, c2:], about out*in^2 FMA per member.
//
// Design: grid (B, out/R), R = 16 rows per block. Rows are exactly
// independent given U, so the row tiling changes nothing. The working rows
// live in the output buffer in global memory (the wrapper initialises it
// with w): the TPU cell kept U and the whole row tile resident, but U alone
// is Cin^2*4 bytes (37.7 MB at Cin 3072), far past a block's 227 KB. Per
// lazy block the (bs, bs) diagonal block of U and the (R, bs) row slab go
// to shared memory; every column step runs the group (scale, zero) refresh
// by masked max/min at group entry, the quantize, err = (w - dq) / U[j, j]
// and the in-block propagation wb[:, j+1:] -= err * U[j, j+1:]. The tail
// update streams U's row slab from global memory (U fits in the 50 MB L2):
// each thread owns one column and R accumulators, so a U value is loaded
// once and used for all R rows. Occupancy is low on narrow groups (out 768
// gives 48 blocks per member); that is accepted here.
//
// Numerics: quantize as w / scale (a division, not a reciprocal product)
// and round half to even (rintf), as the reference does. This file is
// compiled with -fmad=false so that the column update `w - err * u` is a
// rounded product and a rounded difference like the plain version's,
// never a fused multiply-add; the tail-update dot products use explicit
// fmaf (the plain version's matrix product fuses too).
#include <cuda_runtime.h>
#include <math.h>

#include "smem.cuh"

namespace {

constexpr int R = 16;          // rows per block
constexpr int THREADS = 256;

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(THREADS)
gptq_block_kernel(float* __restrict__ w, const float* __restrict__ u,
                  float* __restrict__ scales, float* __restrict__ zeros,
                  float* __restrict__ err_rows, int out_dim, int in_dim,
                  int bits, int group_size, int bs, int symmetric) {
    extern __shared__ float smem[];
    float* ub = smem;                          // [bs][bs]
    float* wb = ub + bs * bs;                  // [R][bs]
    float* eb = wb + R * bs;                   // [R][bs]
    __shared__ float sc[R], zr[R], ec[R], esum[R];

    const int b = blockIdx.x, r0 = blockIdx.y * R;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    float* W = w + ((long)b * out_dim + r0) * in_dim;
    const float* U = u + (long)b * in_dim * in_dim;
    const int n_groups = in_dim / group_size;
    const float qmax = exp2f((float)bits) - 1.f;
    const float half = exp2f((float)(bits - 1));

    for (int c1 = 0; c1 < in_dim; c1 += bs) {
        const int c2 = c1 + bs;
        for (int e = tid; e < bs * bs; e += THREADS)
            ub[e] = U[(long)(c1 + e / bs) * in_dim + c1 + e % bs];
        for (int e = tid; e < R * bs; e += THREADS)
            wb[e] = W[(long)(e / bs) * in_dim + c1 + e % bs];
        if (tid < R) esum[tid] = 0.f;
        __syncthreads();

        for (int j = 0; j < bs; ++j) {
            if (j % group_size == 0) {
                // masked max/min over the group's columns, one warp per row
                for (int r = warp; r < R; r += THREADS / 32) {
                    float mx = -INFINITY, mn = INFINITY, am = 0.f;
                    for (int c = j + lane; c < j + group_size; c += 32) {
                        const float v = wb[r * bs + c];
                        mx = fmaxf(mx, v);
                        mn = fminf(mn, v);
                        am = fmaxf(am, fabsf(v));
                    }
                    for (int off = 16; off > 0; off >>= 1) {
                        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
                        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
                        am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, off));
                    }
                    if (lane == 0) {
                        float scale, zero;
                        if (symmetric) {
                            scale = fmaxf(am / (half - 1.f), 1e-8f);
                            zero = 0.f;
                        } else {
                            const float wmax = fmaxf(mx, 0.f);
                            const float wmin = fminf(mn, 0.f);
                            scale = fmaxf((wmax - wmin) / qmax, 1e-8f);
                            zero = clampf(rintf(-wmin / scale), 0.f, qmax);
                        }
                        sc[r] = scale;
                        zr[r] = zero;
                        const long gi = ((long)b * out_dim + r0 + r)
                                        * n_groups + (c1 + j) / group_size;
                        scales[gi] = scale;
                        zeros[gi] = zero;
                    }
                }
                __syncthreads();
            }
            if (tid < R) {
                const float wcol = wb[tid * bs + j];
                const float scale = sc[tid], zero = zr[tid];
                float q;
                if (symmetric) {
                    q = clampf(rintf(wcol / scale), -half, half - 1.f) * scale;
                } else {
                    q = (clampf(rintf(wcol / scale) + zero, 0.f, qmax) - zero)
                        * scale;
                }
                const float err = (wcol - q) / ub[j * bs + j];
                ec[tid] = err;
                wb[tid * bs + j] = q;
                eb[tid * bs + j] = err;
                esum[tid] += err * err;
            }
            __syncthreads();
            const int width = bs - j - 1;
            for (int e = tid; e < R * width; e += THREADS) {
                const int r = e / width, c = j + 1 + e % width;
                wb[r * bs + c] = wb[r * bs + c] - ec[r] * ub[j * bs + c];
            }
            __syncthreads();
        }

        // lazy batch update of the columns right of the block
        for (int c = c2 + tid; c < in_dim; c += THREADS) {
            float acc[R];
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] = 0.f;
            for (int k = 0; k < bs; ++k) {
                const float uv = U[(long)(c1 + k) * in_dim + c];
#pragma unroll
                for (int r = 0; r < R; ++r)
                    acc[r] = fmaf(eb[r * bs + k], uv, acc[r]);
            }
#pragma unroll
            for (int r = 0; r < R; ++r)
                W[(long)r * in_dim + c] = W[(long)r * in_dim + c] - acc[r];
        }
        for (int e = tid; e < R * bs; e += THREADS)
            W[(long)(e / bs) * in_dim + c1 + e % bs] = wb[e];
        if (tid < R)
            err_rows[(long)b * out_dim + r0 + tid] += esum[tid];
        __syncthreads();
    }
}

}  // namespace

// w: (B, out, in) f32, holding the input weights and overwritten with w_q;
// out % 16 == 0 (the wrapper pads rows). err_rows must be zeroed.
extern "C" int gptq_block_launch(float* w, const float* u, float* scales,
                                 float* zeros, float* err_rows, int B,
                                 int out_dim, int in_dim, int bits,
                                 int group_size, int bs, int symmetric,
                                 void* stream) {
    const size_t smem = sizeof(float) * ((size_t)bs * bs + 2 * R * bs);
    if (grant_max_dynamic_smem<gptq_block_kernel>() < 0)
        return smem_grant_error();
    dim3 grid(B, out_dim / R);
    gptq_block_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        w, u, scales, zeros, err_rows, out_dim, in_dim, bits, group_size,
        bs, symmetric);
    return (int)cudaGetLastError();
}

extern "C" int gptq_block_rows_per_block() { return R; }
