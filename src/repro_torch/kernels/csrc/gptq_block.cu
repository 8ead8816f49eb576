// The GPTQ stage-1 lazy-block sweep of a stacked group of linears.
//
// Replaces: src/repro/kernels/gptq_block.py, gptq_block_pallas
// (_gptq_block_kernel), reached from core/gptq.gptq_quantize_batched.
//
// Bound on the H100: operations. Per member, the rank-bs tail updates
// W[:, c2:] -= Err @ U[c1:c2, c2:] are about out*in^2 FMA in fp32 (the
// <= 1e-6 pins rule out TF32), against ~out*in*bs for the column sweeps;
// but the sweeps are chains of in dependent column steps per row, so
// latency, not FLOP, sets their time unless many rows run at once.
//
// Design. Rows are exactly independent given U, so each lazy block
// [c1, c2) runs as two launches on the caller's stream:
// - the sweep: a segment of 32, 16 or 8 lanes of a warp per row (1, 2 or 4
//   rows a warp, sweep_rows_per_warp), the row's bs (<= 128) working
//   values in its lanes' registers, and the (bs, bs) diagonal block of U
//   in shared memory, shared by the block's 1-8 warps (fewer where the
//   rows would leave SMs idle, so the 288-row group runs 144 blocks, not
//   the earlier kernel's 18). A column step is warp-local: every lane of
//   the segment quantizes the column (the same division and rintf), err =
//   (w - q) / U[j, j], and each lane updates its own columns w - err*u; no
//   block barrier. The next column is shuffled from its owner before the
//   step's update and updated in every lane with the owner's operands, so
//   the shuffle is off the step's chain. The masked max/min at a group's
//   entry is a segment reduction. The errors leave through shared memory
//   as Err^T (bs, out) rows, so the tail reads them as 16-byte vectors.
// - the tail: a register-tiled FFMA GEMM over a grid of 128-row x
//   64-column tiles of W[:, c2:], 8 x 4 elements a thread, filling the
//   card; Err^T and U's slab stream through cp.async in 32-row k-chunks,
//   each U value used for 128 rows, each error for 64 columns, in passes
//   of at most 128 rows of k.
// Lazy blocks the registers cannot hold (bs > 128), or whose rows are not
// 16-byte aligned (bs % 4 != 0), take the wide sweep: a warp a row, the
// row's working values updated in place in W (L1/L2), U's block read
// through the cache, the same operations in the same order. No 16-byte
// copies: such a block's tail takes a thread an element (ascending k, one
// fmaf a step, as the tiled tail). Neither is on a main path (every
// config's blocksize is 8, 16 or 128); they keep every blocksize the
// reference takes.
//
// Numerics, bitwise the reference order of the plain version and of the
// earlier block-per-16-rows kernel: quantize as w / scale (a division, not
// a reciprocal product) and round half to even (rintf); this file is
// compiled with -fmad=false, so the column update `w - err * u` and
// Σerr² are rounded products and rounded sums, never fused; each tail
// element is acc = fmaf(err_k, u_k, acc) in ascending k from 0, then
// W - acc.
#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"
#include "smem.cuh"

namespace {

constexpr int BS_MAX = 128;        // the largest lazy block in registers,
                                   // and the tail's k rows a pass
constexpr int TC = 64;             // tail tile columns
constexpr int KC = 32;             // tail k-chunk (rows of U's slab)
constexpr int TAIL_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

// One lazy block's column sweep for RPW rows a warp: each row takes a
// segment of LPR = 32 / RPW lanes, lane l of it holding the row's columns
// l, l + LPR, ... (VPL of them). The segment's lanes quantize every column
// redundantly; the next column is broadcast before the current step's
// update and updated in every lane with the owner's operands, so the
// shuffle is off the step's critical chain.
template <int RPW>
__global__ void __launch_bounds__(256)
gptq_sweep_kernel(float* __restrict__ w, const float* __restrict__ u,
                  float* __restrict__ scales, float* __restrict__ zeros,
                  float* __restrict__ err_rows, float* __restrict__ errt,
                  int out_dim, int in_dim, int ld_e, int bits,
                  int group_size, int bs, int c1, int symmetric) {
    constexpr int LPR = 32 / RPW, VPL = BS_MAX / LPR;
    extern __shared__ __align__(16) float smem[];
    float* ub = smem;                          // [bs][bs]
    const int rows = blockDim.x / 32 * RPW;    // rows of the block
    float* es = ub + bs * bs;                  // [bs][rows]

    const int b = blockIdx.y, r0 = blockIdx.x * rows;
    const int tid = threadIdx.x, lane = tid % 32;
    const int ri = tid / 32 * RPW + lane / LPR, l = lane % LPR;
    const int r = r0 + ri;
    const bool active = r < out_dim;
    const float* U = u + (long)b * in_dim * in_dim;
    float* W = w + ((long)b * out_dim + r) * in_dim + c1;
    const int n_groups = in_dim / group_size;
    const float qmax = exp2f((float)bits) - 1.f;
    const float half = exp2f((float)(bits - 1));

    for (int e = tid; e < bs * bs / 4; e += blockDim.x) {
        const int i = e / (bs / 4), c = 4 * (e % (bs / 4));
        cp_async16(ub + i * bs + c, U + (long)(c1 + i) * in_dim + c1 + c,
                   16);
    }
    cp_async_commit();

    // rows past out_dim run on zeros and store nothing
    float wv[VPL], ev[VPL];
#pragma unroll
    for (int t = 0; t < VPL; ++t) {
        const int c = l + LPR * t;
        wv[t] = active && c < bs ? W[c] : 0.f;
        ev[t] = 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    float esum = 0.f, scale = 1.f, zero = 0.f;
    int gleft = 0;                             // columns left in the group
    float wnext = __shfl_sync(FULL, wv[0], 0, LPR);
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
        if (LPR * v >= bs) break;
        for (int jj = 0; jj < LPR; ++jj) {
            const int j = LPR * v + jj;
            if (j >= bs) break;
            const float wcol = wnext;          // column j through step j-1
            // column j + 1 through step j - 1, from its owner
            const float nxt = jj + 1 < LPR ? wv[v]
                                           : wv[v + 1 < VPL ? v + 1 : v];
            const float pre = __shfl_sync(FULL, nxt, (jj + 1) % LPR, LPR);
            if (gleft == 0) {
                // masked max/min over the group's columns
                float mx = -INFINITY, mn = INFINITY, am = 0.f;
#pragma unroll
                for (int t = 0; t < VPL; ++t) {
                    const int c = l + LPR * t;
                    if (c >= j && c < j + group_size && c < bs) {
                        mx = fmaxf(mx, wv[t]);
                        mn = fminf(mn, wv[t]);
                        am = fmaxf(am, fabsf(wv[t]));
                    }
                }
#pragma unroll
                for (int off = LPR / 2; off > 0; off >>= 1) {
                    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off, LPR));
                    mn = fminf(mn, __shfl_xor_sync(FULL, mn, off, LPR));
                    am = fmaxf(am, __shfl_xor_sync(FULL, am, off, LPR));
                }
                if (symmetric) {
                    scale = fmaxf(am / (half - 1.f), 1e-8f);
                    zero = 0.f;
                } else {
                    const float wmax = fmaxf(mx, 0.f);
                    const float wmin = fminf(mn, 0.f);
                    scale = fmaxf((wmax - wmin) / qmax, 1e-8f);
                    zero = clampf(rintf(-wmin / scale), 0.f, qmax);
                }
                if (l == 0 && active) {
                    const long gi = ((long)b * out_dim + r) * n_groups
                                    + (c1 + j) / group_size;
                    scales[gi] = scale;
                    zeros[gi] = zero;
                }
                gleft = group_size;
            }
            --gleft;
            float q;
            if (symmetric) {
                q = clampf(rintf(wcol / scale), -half, half - 1.f) * scale;
            } else {
                q = (clampf(rintf(wcol / scale) + zero, 0.f, qmax) - zero)
                    * scale;
            }
            const float* urow = ub + j * bs;
            const float err = (wcol - q) / urow[j];
            esum += err * err;
#pragma unroll
            for (int t = 0; t < VPL; ++t) {
                const int c = l + LPR * t;
                if (c > j && c < bs) wv[t] = wv[t] - err * urow[c];
            }
            if (l == jj) {
                wv[v] = q;
                ev[v] = err;
            }
            if (j + 1 < bs) wnext = pre - err * urow[j + 1];
        }
    }
    if (active) {
#pragma unroll
        for (int t = 0; t < VPL; ++t) {
            const int c = l + LPR * t;
            if (c < bs) W[c] = wv[t];
        }
        if (l == 0) err_rows[(long)b * out_dim + r] += esum;
    }
#pragma unroll
    for (int t = 0; t < VPL; ++t) {
        const int c = l + LPR * t;
        if (c < bs) es[c * rows + ri] = ev[t];
    }
    __syncthreads();
    // Err^T rows: errt[b][c][r0 .. r0 + rows)
    float* E = errt + (long)b * bs * ld_e;
    for (int e = tid; e < bs * rows; e += blockDim.x) {
        const int c = e / rows, i = e % rows;
        if (r0 + i < out_dim) E[(long)c * ld_e + r0 + i] = es[e];
    }
}

// One lazy block's column sweep, a warp a row, for any bs: the row's
// working values stay in W (each step's update is read back by the next
// after __syncwarp), U's diagonal block is read through the cache. Column
// j: every lane quantizes it (the same division and rintf), err = (w - q)
// / U[j, j], the lanes update the later columns w - err * u, lane 0 stores
// q and err. A group's scale and zero come from a warp max/min over its
// columns at its first column, as in the register sweep.
__global__ void __launch_bounds__(256)
gptq_sweep_wide_kernel(float* __restrict__ w, const float* __restrict__ u,
                       float* __restrict__ scales, float* __restrict__ zeros,
                       float* __restrict__ err_rows, float* __restrict__ errt,
                       int out_dim, int in_dim, int ld_e, int bits,
                       int group_size, int bs, int c1, int symmetric) {
    const int b = blockIdx.y;
    const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (r >= out_dim) return;                  // the whole warp
    const float* U = u + (long)b * in_dim * in_dim + (long)c1 * in_dim + c1;
    float* W = w + ((long)b * out_dim + r) * in_dim + c1;
    float* E = errt + (long)b * bs * ld_e + r;
    const int n_groups = in_dim / group_size;
    const float qmax = exp2f((float)bits) - 1.f;
    const float half = exp2f((float)(bits - 1));
    float esum = 0.f, scale = 1.f, zero = 0.f;
    for (int j = 0; j < bs; ++j) {
        if (j % group_size == 0) {
            float mx = -INFINITY, mn = INFINITY, am = 0.f;
            for (int c = j + lane; c < j + group_size; c += 32) {
                const float v = W[c];
                mx = fmaxf(mx, v);
                mn = fminf(mn, v);
                am = fmaxf(am, fabsf(v));
            }
            for (int off = 16; off > 0; off >>= 1) {
                mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
                mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));
                am = fmaxf(am, __shfl_xor_sync(FULL, am, off));
            }
            if (symmetric) {
                scale = fmaxf(am / (half - 1.f), 1e-8f);
                zero = 0.f;
            } else {
                const float wmax = fmaxf(mx, 0.f);
                const float wmin = fminf(mn, 0.f);
                scale = fmaxf((wmax - wmin) / qmax, 1e-8f);
                zero = clampf(rintf(-wmin / scale), 0.f, qmax);
            }
            if (lane == 0) {
                const long gi = ((long)b * out_dim + r) * n_groups
                                + (c1 + j) / group_size;
                scales[gi] = scale;
                zeros[gi] = zero;
            }
        }
        const float wcol = W[j];
        float q;
        if (symmetric) {
            q = clampf(rintf(wcol / scale), -half, half - 1.f) * scale;
        } else {
            q = (clampf(rintf(wcol / scale) + zero, 0.f, qmax) - zero)
                * scale;
        }
        const float* urow = U + (long)j * in_dim;
        const float err = (wcol - q) / urow[j];
        esum += err * err;
        for (int c = j + 1 + lane; c < bs; c += 32)
            W[c] = W[c] - err * urow[c];
        __syncwarp();
        if (lane == 0) {
            W[j] = q;
            E[(long)j * ld_e] = err;
        }
        __syncwarp();
    }
    if (lane == 0) err_rows[(long)b * out_dim + r] += esum;
}

// W[:, c2:] -= Err @ U[c1:c2, c2:], a thread an element (any bs): the
// tail of the wide sweep's lazy blocks whose rows are not 16-byte aligned.
__global__ void __launch_bounds__(128)
gptq_tail_simple_kernel(float* __restrict__ w, const float* __restrict__ u,
                        const float* __restrict__ errt, int out_dim,
                        int in_dim, int ld_e, int bs, int c1) {
    const int b = blockIdx.z, r = blockIdx.y;
    const int c = c1 + bs + blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= in_dim) return;
    const float* E = errt + (long)b * bs * ld_e + r;
    const float* U = u + (long)b * in_dim * in_dim + (long)c1 * in_dim + c;
    float acc = 0.f;
    for (int k = 0; k < bs; ++k)
        acc = fmaf(E[(long)k * ld_e], U[(long)k * in_dim], acc);
    float* p = w + ((long)b * out_dim + r) * in_dim + c;
    *p = *p - acc;
}

// W[:, c2:] -= Err @ U[c1:c2, c2:] for one (16 RT) x 64 tile of member b:
// 16 x 16 threads, RT x 4 elements each.
template <int RT>
__global__ void __launch_bounds__(TAIL_THREADS)
gptq_tail_kernel(float* __restrict__ w, const float* __restrict__ u,
                 const float* __restrict__ errt, int out_dim, int in_dim,
                 int ld_e, int bs, int c1) {
    constexpr int TR = 16 * RT;                // tile rows
    extern __shared__ __align__(16) float smem[];
    const int kmax = bs < BS_MAX ? bs : BS_MAX;  // k rows a pass
    float* es = smem;                          // [kmax][TR] rows of Err^T
    float* us = smem + kmax * TR;              // [kmax][TC] U's slab
    const int b = blockIdx.z;
    const int c2 = c1 + bs;
    const int col0 = c2 + blockIdx.x * TC, r0 = blockIdx.y * TR;
    const int tid = threadIdx.x;
    const float* E0 = errt + (long)b * bs * ld_e;
    const float* U0 = u + (long)b * in_dim * in_dim;
    const int ty = tid / 16, tx = tid % 16;
    float acc[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // k in passes of at most BS_MAX rows (one pass for bs <= 128)
    for (int kb0 = 0; kb0 < bs; kb0 += BS_MAX) {
        const int kb = min(BS_MAX, bs - kb0);
        const float* E = E0 + (long)kb0 * ld_e;
        const float* U = U0 + (long)kb0 * in_dim;
        const int n_chunks = (kb + KC - 1) / KC;

        for (int ch = 0; ch < n_chunks; ++ch) {
            const int k0 = ch * KC, kn = min(KC, kb - k0);
            for (int e = tid; e < kn * (TR / 4); e += TAIL_THREADS) {
                const int k = k0 + e / (TR / 4), i = 4 * (e % (TR / 4));
                // ld_e is a multiple of TR: the whole granule is in the buffer
                cp_async16(es + k * TR + i, E + (long)k * ld_e + r0 + i,
                           r0 + i < out_dim ? 16 : 0);
            }
            for (int e = tid; e < kn * (TC / 4); e += TAIL_THREADS) {
                const int k = k0 + e / (TC / 4), i = 4 * (e % (TC / 4));
                const bool ok = col0 + i < in_dim;
                cp_async16(us + k * TC + i,
                           ok ? U + (long)(c1 + k) * in_dim + col0 + i : U,
                           ok ? 16 : 0);
            }
            cp_async_commit();
        }

        for (int ch = 0; ch < n_chunks; ++ch) {
            // chunk ch has landed once at most n_chunks - 1 - ch are in flight
            switch (n_chunks - 1 - ch) {
            case 0: cp_async_wait<0>(); break;
            case 1: cp_async_wait<1>(); break;
            case 2: cp_async_wait<2>(); break;
            default: cp_async_wait<3>(); break;
            }
            __syncthreads();
            const int k0 = ch * KC, kn = min(KC, kb - k0);
            auto step = [&](int k) {
                float e4[RT];
#pragma unroll
                for (int h = 0; h < RT / 4; ++h) {
                    const float4 ev = *reinterpret_cast<const float4*>(
                        es + k * TR + 4 * ty + 64 * h);
                    e4[4 * h] = ev.x;
                    e4[4 * h + 1] = ev.y;
                    e4[4 * h + 2] = ev.z;
                    e4[4 * h + 3] = ev.w;
                }
                const float4 uv = *reinterpret_cast<const float4*>(
                    us + k * TC + 4 * tx);
                const float u4[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
                for (int i = 0; i < RT; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(e4[i], u4[j], acc[i][j]);
            };
            if (kn == KC) {
#pragma unroll
                for (int k = k0; k < k0 + KC; ++k) step(k);
            } else {
                for (int k = k0; k < k0 + kn; ++k) step(k);
            }
        }
        // the next pass overwrites the staged rows
        if (kb0 + BS_MAX < bs) __syncthreads();
    }

    // element (i, j) of the thread: row r0 + 4 ty + 64 (i / 4) + i % 4
    const int c = col0 + 4 * tx;
    if (c >= in_dim) return;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const int r = r0 + 4 * ty + 64 * (i / 4) + i % 4;
        if (r < out_dim) {
            float4* p = reinterpret_cast<float4*>(
                w + ((long)b * out_dim + r) * in_dim + c);
            float4 v = *p;
            v.x = v.x - acc[i][0];
            v.y = v.y - acc[i][1];
            v.z = v.z - acc[i][2];
            v.w = v.w - acc[i][3];
            *p = v;
        }
    }
}

// the tail's row tile is 16 TAIL_RT = 128 rows: on the H100, faster than
// 64 rows at every group of 2048 rows or more, within 3 % on the others
constexpr int TAIL_RT = 8;

// Rows a sweep warp takes: as many (1, 2 or 4) as still leave 2048 warps
// (~16 an SM) for the B * out rows. A warp's instructions for one column
// step serve all its rows' quantize, so wide groups run faster with more
// rows a warp; narrow ones are bound by one step's latency and want the
// most warps (the H100 sweep in PERF.md: 1 row a warp fastest up to 3072
// rows, 2 at 4096, 4 from 8192).
int sweep_rows_per_warp(long rows) {
    int rpw = 4;
    while (rpw > 1 && rows / rpw < 2048) rpw /= 2;
    return rpw;
}

template <int RPW>
int sweep_launch(dim3 grid, int threads, size_t smem, cudaStream_t s,
                 float* w, const float* u, float* scales, float* zeros,
                 float* err_rows, float* errt, int out_dim, int in_dim,
                 int ld_e, int bits, int group_size, int bs, int c1,
                 int symmetric) {
    const int lim = grant_max_dynamic_smem<gptq_sweep_kernel<RPW>>();
    if (lim < 0) return smem_grant_error();
    if (smem > (size_t)lim) return (int)cudaErrorInvalidValue;
    gptq_sweep_kernel<RPW><<<grid, threads, smem, s>>>(
        w, u, scales, zeros, err_rows, errt, out_dim, in_dim, ld_e, bits,
        group_size, bs, c1, symmetric);
    return (int)cudaGetLastError();
}

constexpr int SMS = 132;

}  // namespace

// w: (B, out, in) f32, holding the input weights and overwritten with w_q;
// err_rows (B, out) must be zeroed; errt (B, bs, ld_e) scratch for the
// errors, ld_e a multiple of 128 >= out. bs dividing in, group_size <= bs
// dividing it. Enqueues 2 launches per lazy block (the last block has no
// tail): the register sweep and the tiled tail where bs is a multiple of
// 4 up to 128, else the wide sweep, and the tiled tail (bs a multiple of
// 4) or the simple one.
extern "C" int gptq_block_launch(float* w, const float* u, float* scales,
                                 float* zeros, float* err_rows, float* errt,
                                 int B, int out_dim, int in_dim, int ld_e,
                                 int bits, int group_size, int bs,
                                 int symmetric, void* stream) {
    constexpr auto tail = &gptq_tail_kernel<TAIL_RT>;
    constexpr int tr = 16 * TAIL_RT;
    const cudaStream_t s = (cudaStream_t)stream;
    if (bs < 1 || in_dim % bs || group_size < 1 || group_size > bs ||
        bs % group_size || ld_e % tr || ld_e < out_dim)
        return (int)cudaErrorInvalidValue;
    const bool in_registers = bs % 4 == 0 && bs <= BS_MAX;
    const bool tiled_tail = bs % 4 == 0;
    const int tail_lim = grant_max_dynamic_smem<tail>();
    if (tail_lim < 0) return smem_grant_error();
    const size_t tail_smem =
        sizeof(float) * (size_t)(bs < BS_MAX ? bs : BS_MAX) * (tr + TC);
    if (tail_smem > (size_t)tail_lim) return (int)cudaErrorInvalidValue;
    // warps a sweep block: 8, or fewer while the blocks would leave SMs idle
    const int rpw = sweep_rows_per_warp((long)B * out_dim);
    int warps = 8;
    while (warps > 1
           && (long)B * ((out_dim + warps * rpw - 1) / (warps * rpw)) < SMS)
        warps /= 2;
    const int rows = warps * rpw;
    const size_t sweep_smem = sizeof(float) * ((size_t)bs * bs + bs * rows);
    const dim3 sweep_grid((out_dim + rows - 1) / rows, B);
    const auto sweep = rpw == 4 ? sweep_launch<4>
                       : rpw == 2 ? sweep_launch<2> : sweep_launch<1>;
    const dim3 wide_grid((out_dim + 7) / 8, B);
    for (int c1 = 0; c1 < in_dim; c1 += bs) {
        int err;
        if (in_registers) {
            err = sweep(sweep_grid, 32 * warps, sweep_smem, s, w, u, scales,
                        zeros, err_rows, errt, out_dim, in_dim, ld_e, bits,
                        group_size, bs, c1, symmetric);
        } else {
            gptq_sweep_wide_kernel<<<wide_grid, 256, 0, s>>>(
                w, u, scales, zeros, err_rows, errt, out_dim, in_dim, ld_e,
                bits, group_size, bs, c1, symmetric);
            err = (int)cudaGetLastError();
        }
        if (err) return err;
        const int rest = in_dim - c1 - bs;
        if (rest == 0) continue;
        if (tiled_tail) {
            const dim3 tail_grid((rest + TC - 1) / TC,
                                 (out_dim + tr - 1) / tr, B);
            tail<<<tail_grid, TAIL_THREADS, tail_smem, s>>>(
                w, u, errt, out_dim, in_dim, ld_e, bs, c1);
        } else {
            gptq_tail_simple_kernel<<<dim3((rest + 127) / 128, out_dim, B),
                                      128, 0, s>>>(
                w, u, errt, out_dim, in_dim, ld_e, bs, c1);
        }
        err = (int)cudaGetLastError();
        if (err) return err;
    }
    return 0;
}
