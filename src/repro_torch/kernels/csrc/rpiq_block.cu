// All Gauss-Seidel rounds of RPIQ stage 2 for a stacked group of linears.
//
// Replaces: src/repro/kernels/rpiq_block.py, rpiq_block_pallas
// (_rpiq_block_kernel, _project), reached from core/rpiq.rpiq_refine_batched.
//
// Bound on the H100: operations. Per round and column block the closed loop
// does three n x bs x out products (the stale block output X_i B^T, the
// right-hand side X_i^T D_i, the fresh block output X_i B_new^T) and one
// bs x bs x out solve against the pre-factored H_i^-1, plus a full X W^T per
// round for the projected loss and one for Y_q at round 0:
// 2*n*in*out*(1 + T) + T*(6*n*in*out + 2*bs*in*out) FLOP per member, all
// fp32 FFMA (the reference pins fp32 and the tensor cores take none).
//
// What held the first version back: one block per 16 output rows (18
// blocks for a 288-row group on 132 SMs), operands staged synchronously in
// 16-deep slabs with two barriers each, a 2 x 4 register tile (3 shared
// loads per 8 FMAs), and X re-read from L2 for every 16 rows.
//
// Design. A block owns 32 output rows of one member; where the row tiles
// leave more than half the SMs idle (ops.rpiq_block_geometry) a
// thread-block cluster of C = 2, 4 or 8 blocks shares each tile's tokens,
// 1/C each: its share of the running Y_q (in shared memory when it fits,
// else in the y_q output) and of every product over tokens. Per column
// block:
//  1. B_old (32 x bs) and 64-token chunks of X_i (64 x bs) stream through
//     a two-slot cp.async ring, the next chunk in flight while one is used;
//     per chunk the stale output X_i B_old^T (a 4 x 2 register tile a
//     thread, 16-byte shared loads along the contraction, a warp reading 4
//     rows of X_i and 8 of B), Y_q <- Y_q - y_qi and the directed residual
//     D = y_orig - (Y_q - y_qi);
//  2. the right-hand side X_i^T D, one ascending sum over all n tokens per
//     output, the order of the first version: without a cluster from D in
//     shared memory, chunk by chunk in registers (4 x 4 a thread); in a
//     cluster each block writes D of its tokens to device memory and, after
//     a cluster barrier, sums the columns of its 32/C output rows over all
//     tokens, streaming X_i and D (through L2) again;
//  3. B* = H_i^-1 rhs for those rows (H_i^-1 read through L1), projection
//     onto the grid, the damped update, written to W; after a cluster
//     barrier every block copies the other rows of B_new from its peers'
//     shared memory (B_old/B_new alternate between two buffers, so two
//     cluster barriers a column block suffice);
//  4. the fresh output X_i B_new^T, Y_q <- (Y_q - y_qi) + X_i B_new^T;
//     without a cluster and with one chunk (n <= 64) X_i is still in the
//     ring and is not read again.
// Round 0 and each round's projected loss stream (chunk, column block)
// pairs of X and W through the same ring. Every round runs, keeping the
// Pallas kernel's deferred-bookkeeping split: Gamma and the projected loss
// are summed in fp64 (each fp32 residual squared exactly, per thread, per
// block in a fixed tree, then over the cluster in rank order) into a
// (B, tiles, t_max+1) fp64 array the host sums in tile order (no atomics):
// fp32 sums of n x out squares carried ~1e-6 of rounding, as much as the
// pins allow at a 288-row group. Each round's projected candidate goes to
// wp_all[b, t]; the host replays the early stop and the strict-improvement
// choice (ops._rpiq_select). Rows are independent given X and H_i^-1, so
// the row split is exact, and every product sums in the order of the first
// version (the stale and fresh outputs and Y_q over ascending k, the
// right-hand side over ascending tokens, the solve over ascending k):
// w_cont, the candidates and Y_q are bitwise the first version's; only
// the Gamma and loss sums take another order.
//
// Numerics: the grid projection divides (w / s) and rounds half to even
// (rintf). This file is compiled with -fmad=false so that the elementwise
// steps (directed residual, damped update, Y_q update) round each product
// and sum like the plain version; the dot products use explicit fmaf.
// Keeping Y_q - y_qi in place of Y_q between the two halves of a column
// block stores the very value the plain version rounds to in
// y_q - y_qi + X_i B_new^T, so the trajectory is unchanged.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"
#include "smem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int BO = 32;         // output rows per block
constexpr int NC = 64;         // tokens per chunk
constexpr int BS_MAX = 128;    // widest column block
constexpr int RED = 64;        // fp64 slots of the loss partials

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float project(float b, float s, float z,
                                         float qmax, float half,
                                         int symmetric) {
    if (symmetric) return clampf(rintf(b / s), -half, half - 1.f) * s;
    const float q = clampf(rintf(b / s) + z, 0.f, qmax);
    return (q - z) * s;
}

// Thread layout of an R x N output tile: thread (tx, ty) owns rows
// ty + TY*i and columns tx + TX*j; a warp covers (at most) 8 x 4 of the
// TX x TY threads, so its 16-byte shared loads along k read at most 8
// distinct rows of B and 4 of A (one wavefront each).
template <int R, int N>
struct Tile {
    static constexpr int TX = N < 16 ? N : 16;
    static constexpr int TY = THREADS / TX;
    static constexpr int MI = R / TY;
    static constexpr int OJ = N / TX;
    static constexpr int TXW = TX < 8 ? TX : 8;     // per warp
    static constexpr int WX = TX / TXW;             // warps across
    static_assert(MI >= 1 && R % TY == 0 && N % TX == 0, "tile layout");
    __device__ static int tx() {
        return (threadIdx.x / 32 % WX) * TXW + threadIdx.x % 32 % TXW;
    }
    __device__ static int ty() {
        return (threadIdx.x / 32 / WX) * (32 / TXW) + threadIdx.x % 32 / TXW;
    }
};

// acc[i][j] += sum_k A[r_i][k] * B[o_j][k] over ascending k < K (K % 4 ==
// 0): both operands contiguous along k, read 16 bytes at a time; rows of A
// at or past `rows` read as 0.
template <int R, int N>
__device__ __forceinline__ void gemm_nt(
    const float* A, int lda, int rows, const float* B, int ldb, int K,
    float (&acc)[Tile<R, N>::MI][Tile<R, N>::OJ]) {
    using T = Tile<R, N>;
    const int tx = T::tx(), ty = T::ty();
#pragma unroll 4
    for (int k = 0; k < K; k += 4) {
        float4 a[T::MI], b[T::OJ];
#pragma unroll
        for (int i = 0; i < T::MI; ++i) {
            const int r = ty + T::TY * i;
            a[i] = r < rows ? *reinterpret_cast<const float4*>(
                                  A + (long)r * lda + k)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < T::OJ; ++j)
            b[j] = *reinterpret_cast<const float4*>(
                B + (tx + T::TX * j) * ldb + k);
#pragma unroll
        for (int i = 0; i < T::MI; ++i)
#pragma unroll
            for (int j = 0; j < T::OJ; ++j) {
                float v = acc[i][j];
                v = fmaf(a[i].x, b[j].x, v);
                v = fmaf(a[i].y, b[j].y, v);
                v = fmaf(a[i].z, b[j].z, v);
                v = fmaf(a[i].w, b[j].w, v);
                acc[i][j] = v;
            }
    }
}

// The right-hand side X_i^T D (BS_MAX x BO): thread (tx, ty) owns columns
// c = ty*4 + e of X_i and outputs o = tx*4 + f (a warp: 8 x 4 threads).
constexpr int RHS_TX = BO / 4;
static_assert(THREADS / RHS_TX * 4 == BS_MAX, "right-hand-side layout");

// acc[e][f] += sum_{m < rows} Xs[m][c_e] * Ds[m][o_f], ascending m.
__device__ __forceinline__ void gemm_rhs(const float* Xs, int ld,
                                         const float* Ds, int rows,
                                         float (&acc)[4][4]) {
    const int tx = threadIdx.x % RHS_TX, ty = threadIdx.x / RHS_TX;
#pragma unroll 4
    for (int m = 0; m < rows; ++m) {
        const float4 x = *reinterpret_cast<const float4*>(Xs + m * ld +
                                                          ty * 4);
        const float4 d = *reinterpret_cast<const float4*>(Ds + m * BO +
                                                          tx * 4);
        const float a[4] = {x.x, x.y, x.z, x.w};
        const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int f = 0; f < 4; ++f) acc[e][f] = fmaf(a[e], dv[f],
                                                         acc[e][f]);
    }
}

// acc[i] += sum_{m < rows} Xs[m][c_i] * Dsl[m][o0 + o], ascending m: the
// right-hand side of NS output rows from o0, thread (o, ty) owning columns
// c = ty*CPT + i of X_i; Dsl rows are BO wide.
template <int NS>
__device__ __forceinline__ void gemm_rhs_slice(const float* Xs, int ld,
                                               const float* Dsl, int o0,
                                               int rows,
                                               float (&acc)[NS / 2]) {
    constexpr int CPT = NS / 2;
    const int o = threadIdx.x % NS, ty = threadIdx.x / NS;
#pragma unroll 4
    for (int m = 0; m < rows; ++m) {
        const float* xr = Xs + m * ld + ty * CPT;
        float a[CPT];
        if constexpr (CPT % 4 == 0) {
#pragma unroll
            for (int g = 0; g < CPT / 4; ++g) {
                const float4 v = *reinterpret_cast<const float4*>(xr + 4 * g);
                a[4 * g] = v.x; a[4 * g + 1] = v.y;
                a[4 * g + 2] = v.z; a[4 * g + 3] = v.w;
            }
        } else {
            const float2 v = *reinterpret_cast<const float2*>(xr);
            a[0] = v.x; a[1] = v.y;
        }
        const float dv = Dsl[m * BO + o0 + o];
#pragma unroll
        for (int i = 0; i < CPT; ++i) acc[i] = fmaf(a[i], dv, acc[i]);
    }
}

// Start the copies of items 0..cnt-1 through a two-slot ring and run
// body(j, slot) on each once it has landed; fetch(j, slot) starts item
// j's cp.async copies (no commit). Groups committed before the call are waited
// for with item 0. Every thread of the block must call it.
template <typename Fetch, typename Body>
__device__ __forceinline__ void stream2(int cnt, Fetch fetch, Body body) {
    if (cnt > 0) fetch(0, 0);
    cp_async_commit();
    for (int j = 0; j < cnt; ++j) {
        if (j + 1 < cnt) fetch(j + 1, (j + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        body(j, j & 1);
        __syncthreads();
    }
    cp_async_wait<0>();
    __syncthreads();
}

// Floats of dynamic shared memory besides the running Y_q.
size_t fixed_floats(int split, int bs) {
    const size_t ld = bs + 4;
    return 2 * NC * ld + 2 * BO * ld + NC * BO + 2 * NC * BO +
           (BO / split) * ld + 2 * RED;
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
rpiq_block_kernel(const float* __restrict__ w0,
                  const float* __restrict__ yo_all,
                  const float* __restrict__ x_all,
                  const float* __restrict__ hinv_all,
                  const float* __restrict__ s_all,
                  const float* __restrict__ z_all, float* __restrict__ wc_all,
                  float* __restrict__ wp_all, float* __restrict__ yq_all,
                  double* __restrict__ hist, double* __restrict__ pls,
                  float* __restrict__ dbuf, int yq_in_smem, int out_dim,
                  int in_dim, int n, int bs, int t_max, float alpha,
                  int bits, int symmetric) {
    using TA = Tile<NC, BO>;              // chunk products, NC x BO
    constexpr int NS = BO / C;            // output rows this block solves
    using TS = Tile<BS_MAX, NS>;          // the solve, bs x NS
    extern __shared__ __align__(16) float sm[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = C == 1 ? 0 : (int)cluster.block_rank();
    const int tile = blockIdx.y, b = blockIdx.z;
    const int o0 = tile * BO;
    const int tid = threadIdx.x;
    const int ld = bs + 4;
    const float qmax = exp2f((float)bits) - 1.f;
    const float half = exp2f((float)(bits - 1));
    // this block's tokens [t0, t0 + rows_r), in chunks of NC
    const int t0 = (int)((long)n * rank / C);
    const int rows_r = (int)((long)n * (rank + 1) / C) - t0;
    const int nch = (rows_r + NC - 1) / NC;
    const int n_cb = in_dim / bs;

    float* ring = sm;                          // 2 x NC x ld
    float* wsb = ring + 2 * NC * ld;           // 2 x BO x ld: B_old/B_new
    float* Ds = wsb + 2 * BO * ld;             // NC x BO: directed residual
    float* dsl = Ds + NC * BO;                 // 2 x NC x BO: D of a chunk
    float* rT = dsl + 2 * NC * BO;             // NS x ld: rhs^T
    // RED fp64 loss partials (16-byte aligned: every float count above is
    // a multiple of 4)
    double* red = reinterpret_cast<double*>(rT + NS * ld);
    const long wofs = ((long)b * out_dim + o0) * in_dim;
    const float* W0 = w0 + wofs;
    const float* S = s_all + wofs;
    const float* Z = z_all + wofs;
    float* Wc = wc_all + wofs;
    const float* X = x_all + ((long)b * n + t0) * in_dim;
    const float* Yo = yo_all + ((long)b * n + t0) * out_dim + o0;
    const float* Hv = hinv_all + (long)b * in_dim * bs;
    const long cand = (long)out_dim * in_dim;
    float* WP = wp_all + (long)b * (t_max + 1) * cand + (long)o0 * in_dim;
    float* Yq = yq_in_smem ? reinterpret_cast<float*>(red + RED)
                           : yq_all + ((long)b * n + t0) * out_dim + o0;
    const long ldq = yq_in_smem ? BO : out_dim;
    const long hofs = ((long)b * gridDim.y + tile) * (t_max + 1);
    // the directed residual of every token, (n, BO), when C > 1
    float* Dg = dbuf + ((long)b * gridDim.y + tile) * n * BO;

    auto csync = [&]() {
        if constexpr (C == 1) __syncthreads();
        else cluster.sync();
    };
    auto peer = [&](auto* p, int q) {
        if constexpr (C == 1) return p;
        else return cluster.map_shared_rank(p, q);
    };
    // X rows [ch*NC, ch*NC + NC) of this block, columns [c1, c1 + bs)
    auto fetch_x = [&](int slot, int ch, int c1) {
        float* dst = ring + slot * NC * ld;
        const int per = bs / 4;
        for (int e = tid; e < NC * per; e += THREADS) {
            const int r = e / per, c = (e % per) * 4;
            const bool ok = ch * NC + r < rows_r;
            cp_async16(dst + r * ld + c,
                       ok ? X + (long)(ch * NC + r) * in_dim + c1 + c : x_all,
                       ok ? 16 : 0);
        }
    };
    // BO rows of src (row stride in_dim), columns [c1, c1 + bs)
    auto fetch_w = [&](float* dst, const float* src, int c1) {
        const int per = bs / 4;
        for (int e = tid; e < BO * per; e += THREADS) {
            const int r = e / per, c = (e % per) * 4;
            cp_async16(dst + r * ld + c, src + (long)r * in_dim + c1 + c, 16);
        }
    };
    // this block's sum of v (a fixed tree) into red[slot]
    auto block_sum = [&](double v, int slot) {
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
        if (tid % 32 == 0) red[16 + tid / 32] = v;
        __syncthreads();
        if (tid == 0) {
            double s = 0.0;
            for (int w = 0; w < THREADS / 32; ++w) s += red[16 + w];
            red[slot] = s;
        }
    };
    // the cluster's sum of red[slot], in rank order, into *dst
    auto cluster_sum = [&](int slot, double* dst) {
        csync();
        if (rank == 0 && tid == 0) {
            double s = 0.0;
            for (int q = 0; q < C; ++q) s += peer(red, q)[slot];
            *dst = s;
        }
    };
    const int ctx = TA::tx(), cty = TA::ty();
    // sum over this block's tokens of (y_orig - X Wsrc^T)^2; round 0 also
    // stores X Wsrc^T as the running Y_q
    auto full_product = [&](const float* Wsrc, bool init_yq) {
        double g = 0.0;
        float acc[TA::MI][TA::OJ];
        stream2(
            nch * n_cb,
            [&](int j, int slot) {
                fetch_x(slot, j / n_cb, (j % n_cb) * bs);
                fetch_w(wsb + slot * BO * ld, Wsrc, (j % n_cb) * bs);
            },
            [&](int j, int slot) {
                if (j % n_cb == 0) {
#pragma unroll
                    for (int i = 0; i < TA::MI; ++i)
#pragma unroll
                        for (int q = 0; q < TA::OJ; ++q) acc[i][q] = 0.f;
                }
                gemm_nt<NC, BO>(ring + slot * NC * ld, ld, NC,
                                wsb + slot * BO * ld, ld, bs, acc);
                if (j % n_cb != n_cb - 1) return;
                const int ch = j / n_cb;
#pragma unroll
                for (int i = 0; i < TA::MI; ++i)
#pragma unroll
                    for (int q = 0; q < TA::OJ; ++q) {
                        const int m = ch * NC + cty + TA::TY * i;
                        const int o = ctx + TA::TX * q;
                        if (m >= rows_r) continue;
                        if (init_yq) Yq[m * ldq + o] = acc[i][q];
                        const double d = Yo[(long)m * out_dim + o] -
                                         acc[i][q];
                        g += d * d;
                    }
            });
        return g;
    };

    // round 0: W = W0, candidate slot 0 = W0 (each block its NS rows),
    // Y_q = X W0^T, Gamma_0
    for (long e = tid; e < (long)NS * in_dim; e += THREADS) {
        const long i = (long)rank * NS * in_dim + e;
        Wc[i] = W0[i];
        WP[i] = W0[i];
    }
    block_sum(full_product(W0, true), 0);
    cluster_sum(0, hist + hofs);
    if (rank == 0 && tid == 0) pls[hofs] = hist[hofs];

    int wbuf = 0;
    for (int t = 1; t <= t_max; ++t) {
        for (int cb = 0; cb < n_cb; ++cb) {
            const int c1 = cb * bs;
            float* Wcur = wsb + wbuf * BO * ld;
            wbuf ^= 1;
            fetch_w(Wcur, Wc, c1);              // B_old
            cp_async_commit();
            // 1. stale output, residual, right-hand side
            float racc[4][4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int f = 0; f < 4; ++f) racc[e][f] = 0.f;
            stream2(
                nch, [&](int j, int slot) { fetch_x(slot, j, c1); },
                [&](int j, int slot) {
                    const float* xs = ring + slot * NC * ld;
                    float acc[TA::MI][TA::OJ];
#pragma unroll
                    for (int i = 0; i < TA::MI; ++i)
#pragma unroll
                        for (int q = 0; q < TA::OJ; ++q) acc[i][q] = 0.f;
                    // y_orig of this thread's outputs, loaded before the
                    // product so that the load's latency hides behind it
                    const int rows = min(NC, rows_r - j * NC);
                    float yo[TA::MI][TA::OJ];
#pragma unroll
                    for (int i = 0; i < TA::MI; ++i)
#pragma unroll
                        for (int q = 0; q < TA::OJ; ++q) {
                            const int m = cty + TA::TY * i;
                            yo[i][q] = m < rows
                                ? Yo[((long)j * NC + m) * out_dim + ctx +
                                     TA::TX * q]
                                : 0.f;
                        }
                    gemm_nt<NC, BO>(xs, ld, NC, Wcur, ld, bs, acc);
#pragma unroll
                    for (int i = 0; i < TA::MI; ++i)
#pragma unroll
                        for (int q = 0; q < TA::OJ; ++q) {
                            const int m = cty + TA::TY * i;
                            const int o = ctx + TA::TX * q;
                            float dv = 0.f;
                            if (m < rows) {
                                const long lt = (long)j * NC + m;
                                // Y_q <- Y_q - y_qi; d = y_orig - that
                                const float rest = Yq[lt * ldq + o] -
                                                   acc[i][q];
                                Yq[lt * ldq + o] = rest;
                                dv = yo[i][q] - rest;
                                if (C > 1) Dg[(t0 + lt) * BO + o] = dv;
                            }
                            if (C == 1) Ds[m * BO + o] = dv;
                        }
                    if (C == 1) {
                        __syncthreads();
                        gemm_rhs(xs, ld, Ds, rows, racc);
                    }
                });
            if constexpr (C == 1) {
                const int tx = tid % RHS_TX, ty = tid / RHS_TX;
#pragma unroll
                for (int e = 0; e < 4; ++e)
#pragma unroll
                    for (int f = 0; f < 4; ++f)
                        if (ty * 4 + e < bs)
                            rT[(tx * 4 + f) * ld + ty * 4 + e] = racc[e][f];
            } else {
                // the right-hand side of this block's NS rows over all n
                // tokens in ascending order, from every block's residuals
                csync();
                float sacc[NS / 2];
#pragma unroll
                for (int i = 0; i < NS / 2; ++i) sacc[i] = 0.f;
                const int o0s = rank * NS;
                stream2(
                    (n + NC - 1) / NC,
                    [&](int j, int slot) {
                        float* dst = ring + slot * NC * ld;
                        const float* xb = x_all + (long)b * n * in_dim;
                        const int per = bs / 4;
                        for (int e = tid; e < NC * per; e += THREADS) {
                            const int r = e / per, c = (e % per) * 4;
                            const bool ok = j * NC + r < n;
                            cp_async16(dst + r * ld + c,
                                       ok ? xb + (long)(j * NC + r) * in_dim +
                                                c1 + c
                                          : x_all,
                                       ok ? 16 : 0);
                        }
                        // whole rows through L2 (.cg): the peers wrote them
                        float* dd = dsl + slot * NC * BO;
                        for (int e = tid; e < NC * BO / 4; e += THREADS) {
                            const int r = e / (BO / 4);
                            const bool ok = j * NC + r < n;
                            cp_async16(dd + 4 * e,
                                       ok ? Dg + (long)j * NC * BO + 4 * e
                                          : Dg,
                                       ok ? 16 : 0);
                        }
                    },
                    [&](int j, int slot) {
                        gemm_rhs_slice<NS>(ring + slot * NC * ld, ld,
                                           dsl + slot * NC * BO, o0s,
                                           min(NC, n - j * NC), sacc);
                    });
                const int o = tid % NS, ty = tid / NS;
#pragma unroll
                for (int i = 0; i < NS / 2; ++i)
                    if (ty * (NS / 2) + i < bs)
                        rT[o * ld + ty * (NS / 2) + i] = sacc[i];
            }
            __syncthreads();
            // 2. this block's NS output rows: B* = H_i^-1 rhs, projection,
            // damped update
            {
                float sacc[TS::MI][TS::OJ];
#pragma unroll
                for (int i = 0; i < TS::MI; ++i)
#pragma unroll
                    for (int q = 0; q < TS::OJ; ++q) sacc[i][q] = 0.f;
                gemm_nt<BS_MAX, NS>(Hv + (long)c1 * bs, bs, bs, rT, ld, bs,
                                    sacc);
                const int tx = TS::tx(), ty = TS::ty();
#pragma unroll
                for (int i = 0; i < TS::MI; ++i)
#pragma unroll
                    for (int q = 0; q < TS::OJ; ++q) {
                        const int c = ty + TS::TY * i;
                        const int o = rank * NS + tx + TS::TX * q;
                        if (c >= bs) continue;
                        const long wi = (long)o * in_dim + c1 + c;
                        const float bp = project(sacc[i][q], S[wi], Z[wi],
                                                 qmax, half, symmetric);
                        const float bo = Wcur[o * ld + c];
                        const float nw = bo + alpha * (bp - bo);
                        Wcur[o * ld + c] = nw;
                        Wc[wi] = nw;
                    }
            }
            csync();
            if constexpr (C > 1) {          // the peers' rows of B_new
                for (int e = tid; e < BO * bs; e += THREADS) {
                    const int o = e / bs, c = e % bs, q = o / NS;
                    if (q != rank)
                        Wcur[o * ld + c] = peer(Wcur, q)[o * ld + c];
                }
                __syncthreads();
            }
            // 3. fresh output: y_q = (y_q - y_qi) + X_i B_new^T
            auto fresh = [&](int j, int slot) {
                float acc[TA::MI][TA::OJ];
#pragma unroll
                for (int i = 0; i < TA::MI; ++i)
#pragma unroll
                    for (int q = 0; q < TA::OJ; ++q) acc[i][q] = 0.f;
                gemm_nt<NC, BO>(ring + slot * NC * ld, ld, NC, Wcur, ld, bs,
                                acc);
                const int rows = min(NC, rows_r - j * NC);
#pragma unroll
                for (int i = 0; i < TA::MI; ++i)
#pragma unroll
                    for (int q = 0; q < TA::OJ; ++q) {
                        const int m = cty + TA::TY * i;
                        if (m < rows)
                            Yq[((long)j * NC + m) * ldq + ctx + TA::TX * q] +=
                                acc[i][q];
                    }
            };
            if (C == 1 && nch == 1) {       // X_i is still in slot 0
                fresh(0, 0);
                __syncthreads();
            } else {
                stream2(nch, [&](int j, int slot) { fetch_x(slot, j, c1); },
                        fresh);
            }
        }
        // Gamma_t over this block's tokens
        double g = 0.0;
        for (int e = tid; e < rows_r * BO; e += THREADS) {
            const int m = e / BO, o = e % BO;
            const double d = Yo[(long)m * out_dim + o] - Yq[m * ldq + o];
            g += d * d;
        }
        block_sum(g, 0);
        cluster_sum(0, hist + hofs + t);
        // the projected candidate (each block its NS rows), then its loss
        float* WPt = WP + (long)t * cand;
        for (long e = tid; e < (long)NS * in_dim; e += THREADS) {
            const long i = (long)rank * NS * in_dim + e;
            WPt[i] = project(Wc[i], S[i], Z[i], qmax, half, symmetric);
        }
        csync();
        block_sum(full_product(WPt, false), 1);
        cluster_sum(1, pls + hofs + t);
    }
    if (yq_in_smem) {
        float* yout = yq_all + ((long)b * n + t0) * out_dim + o0;
        for (int e = tid; e < rows_r * BO; e += THREADS)
            yout[(long)(e / BO) * out_dim + e % BO] = Yq[e];
    }
    csync();     // no block leaves while a peer reads its shared memory
}

template <int C>
int smem_limit() {
    return grant_max_dynamic_smem<rpiq_block_kernel<C>>();
}

int limit_for(int split) {
    switch (split) {
        case 1: return smem_limit<1>();
        case 2: return smem_limit<2>();
        case 4: return smem_limit<4>();
        case 8: return smem_limit<8>();
    }
    return -2;
}

// 1 if the running Y_q of a block with this geometry fits shared memory
// beside the rest of its working set, 0 if it goes to the y_q output, -1 on
// a CUDA error, -2 for a geometry the kernel does not take.
int yq_fits(int n, int bs, int bo, int split, size_t* bytes) {
    if (bo != BO || bs < 4 || bs > BS_MAX || bs % 4) return -2;
    const int lim = limit_for(split);
    if (lim < 0) return lim;
    const size_t fixed = fixed_floats(split, bs) * sizeof(float);
    const size_t yq = (size_t)((n + split - 1) / split) * BO * sizeof(float);
    if (fixed + yq <= (size_t)lim) {
        *bytes = fixed + yq;
        return 1;
    }
    if (fixed > (size_t)lim) return -2;
    *bytes = fixed;
    return 0;
}

template <int C>
int launch(const float* const* p, float* const* o, double* const* sums,
           int B, int out_dim, int in_dim, int n, int bs, int t_max,
           float alpha, int bits, int symmetric, int in_smem, size_t smem,
           cudaStream_t stream) {
    dim3 grid(C, out_dim / BO, B);
    return launch_clustered(rpiq_block_kernel<C>, grid, THREADS, smem,
                            stream, C, p[0], p[1], p[2], p[3], p[4], p[5],
                            o[0], o[1], o[2], sums[0], sums[1], o[3], in_smem,
                            out_dim, in_dim, n, bs, t_max, alpha, bits,
                            symmetric);
}

// ---------------------------------------------------------------------------
// The wide path: column blocks the fused kernel does not take (bs > 128,
// whose X_i and B tiles overflow shared memory, or bs % 4 != 0, whose rows
// are not 16-byte aligned). None is on a main path (every config's
// blocksize is 8, 16 or 128); the path keeps every blocksize the reference
// takes. The host enqueues the same steps as separate launches of one
// tiled FFMA product (64 x 64 outputs a block, 4 x 4 a thread, k in
// 16-deep shared tiles, each sum ascending in k) with the step's
// elementwise epilogue, in the plain version's order: per round and
// column block the stale output with Y_q <- Y_q - y_qi and D, the
// right-hand side X_i^T D, the solve with the projection and damped
// update of W, the fresh output; per round Gamma, the projected
// candidate and its loss, summed in fp64 per block into (B, P, t_max+1)
// partials (P the blocks of one n x out product) that the host sums.
// ---------------------------------------------------------------------------

constexpr int WT = 64;         // output tile, rows and columns
constexpr int WK = 16;         // k a shared tile
constexpr int WTHREADS = 256;

enum WideMode { W_INIT, W_STALE, W_RHS, W_SOLVE, W_FRESH, W_GAMMA, W_PLOSS };

struct WideArgs {
    // C[i][j] = sum_k A[i sa_i + k sa_k] B[k sb_k + j sb_j] of member b,
    // whose operands start a_mem / b_mem floats after the previous one's
    const float* a;
    long sa_i, sa_k, a_mem;
    const float* b;
    long sb_k, sb_j, b_mem;
    int M, N, K;
    float* yq;                 // (B, n, out)
    const float* yo;           // (B, n, out)
    float* d;                  // (B, n, out) the directed residual
    float* rhs;                // (B, bs, out)
    float* w;                  // (B, out, in) the iterate
    const float* s;            // (B, out, in) the grid
    const float* z;
    double* part;              // (B, P, t2) fp64 loss partials
    double* part2;             // the projected loss's, at round 0
    int slot, t2, n, out, in, c1, bs, symmetric;
    float alpha, qmax, half;
};

template <int MODE>
__global__ void __launch_bounds__(WTHREADS)
rpiq_wide_kernel(WideArgs p) {
    __shared__ float As[WK][WT + 1];
    __shared__ float Bs[WK][WT + 1];
    __shared__ double red[WTHREADS / 32];
    const int b = blockIdx.z;
    const int i0 = blockIdx.y * WT, j0 = blockIdx.x * WT;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const float* A = p.a + b * p.a_mem;
    const float* B = p.b + b * p.b_mem;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < p.K; k0 += WK) {
        // neighbouring threads on the operand's unit stride
        for (int e = tid; e < WT * WK; e += WTHREADS) {
            const int i = p.sa_k == 1 ? e / WK : e % WT;
            const int k = p.sa_k == 1 ? e % WK : e / WT;
            As[k][i] = i0 + i < p.M && k0 + k < p.K
                ? A[(i0 + i) * p.sa_i + (k0 + k) * p.sa_k] : 0.f;
            const int j = p.sb_j == 1 ? e % WT : e / WK;
            const int kb = p.sb_j == 1 ? e / WT : e % WK;
            Bs[kb][j] = j0 + j < p.N && k0 + kb < p.K
                ? B[(k0 + kb) * p.sb_k + (j0 + j) * p.sb_j] : 0.f;
        }
        __syncthreads();
        const int kn = min(WK, p.K - k0);
        for (int kk = 0; kk < kn; ++kk) {
            float av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
    double g = 0.0;
    const long nout = (long)b * p.n * p.out;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gi = i0 + ty + 16 * i, gj = j0 + tx + 16 * j;
            if (gi >= p.M || gj >= p.N) continue;
            const float v = acc[i][j];
            if constexpr (MODE == W_RHS) {
                p.rhs[((long)b * p.bs + gi) * p.out + gj] = v;
            } else if constexpr (MODE == W_SOLVE) {
                // c = gi, o = gj
                const long wi = ((long)b * p.out + gj) * p.in + p.c1 + gi;
                const float bp = project(v, p.s[wi], p.z[wi], p.qmax,
                                         p.half, p.symmetric);
                const float bo = p.w[wi];
                p.w[wi] = bo + p.alpha * (bp - bo);
            } else {
                // m = gi, o = gj
                const long yi = nout + (long)gi * p.out + gj;
                if constexpr (MODE == W_INIT) {
                    p.yq[yi] = v;
                    const double dd = p.yo[yi] - v;
                    g += dd * dd;
                } else if constexpr (MODE == W_STALE) {
                    const float rest = p.yq[yi] - v;
                    p.yq[yi] = rest;
                    p.d[yi] = p.yo[yi] - rest;
                } else if constexpr (MODE == W_FRESH) {
                    p.yq[yi] = p.yq[yi] + v;
                } else if constexpr (MODE == W_GAMMA) {
                    const double dd = p.yo[yi] - p.yq[yi];
                    g += dd * dd;
                } else {                            // W_PLOSS
                    const double dd = p.yo[yi] - v;
                    g += dd * dd;
                }
            }
        }
    if constexpr (MODE == W_INIT || MODE == W_GAMMA || MODE == W_PLOSS) {
        for (int off = 16; off > 0; off >>= 1)
            g += __shfl_xor_sync(0xffffffffu, g, off);
        if (tid % 32 == 0) red[tid / 32] = g;
        __syncthreads();
        if (tid == 0) {
            double t = 0.0;
            for (int w = 0; w < WTHREADS / 32; ++w) t += red[w];
            const long blk = (long)blockIdx.y * gridDim.x + blockIdx.x;
            const long pi = ((long)b * gridDim.x * gridDim.y + blk) * p.t2
                            + p.slot;
            p.part[pi] = t;
            if constexpr (MODE == W_INIT) p.part2[pi] = t;
        }
    }
}

// dst[b][e] = src[b][e] (copy) or its projection onto the grid, e < per;
// member b of dst starts dst_mem floats after the previous one's
__global__ void rpiq_wide_project_kernel(const float* __restrict__ src,
                                         const float* __restrict__ s,
                                         const float* __restrict__ z,
                                         float* __restrict__ dst,
                                         long per, long dst_mem, long total,
                                         int copy, float qmax, float half,
                                         int symmetric) {
    for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < total;
         e += (long)gridDim.x * blockDim.x) {
        const long b = e / per, i = e - b * per;
        dst[b * dst_mem + i] = copy ? src[e]
            : project(src[e], s[e], z[e], qmax, half, symmetric);
    }
}

int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

template <int MODE>
int wide(WideArgs p, int B, cudaStream_t s) {
    const dim3 grid(cdiv(p.N, WT), cdiv(p.M, WT), B);
    rpiq_wide_kernel<MODE><<<grid, WTHREADS, 0, s>>>(p);
    return (int)cudaGetLastError();
}

int wide_project(const float* src, const float* sg, const float* zg,
                 float* dst, long per, long dst_mem, int B, int copy,
                 const WideArgs& p, cudaStream_t s) {
    const long total = per * B;
    const int blocks = cdiv(total, 256) < 132 * 8 ? cdiv(total, 256)
                                                  : 132 * 8;
    rpiq_wide_project_kernel<<<blocks, 256, 0, s>>>(
        src, sg, zg, dst, per, dst_mem, total, copy, p.qmax, p.half,
        p.symmetric);
    return (int)cudaGetLastError();
}

}  // namespace

// 1 if a launch with this geometry keeps the running Y_q in shared memory,
// 0 if it keeps it in the y_q output, < 0 as yq_fits.
extern "C" int rpiq_block_yq_in_smem(int n, int bs, int bo, int split) {
    size_t bytes;
    return yq_fits(n, bs, bo, split, &bytes);
}

// The loss partials a wide launch writes per member and round.
extern "C" int rpiq_block_wide_partials(int n, int out_dim) {
    return cdiv(n, WT) * cdiv(out_dim, WT);
}

// The wide path (any bs dividing in): shapes as rpiq_block_launch, with
// hist/pls (B, rpiq_block_wide_partials(n, out), t_max+1) fp64 and the
// scratch d (B, n, out) and rhs (B, bs, out); any row count.
extern "C" int rpiq_block_wide_launch(const float* w0, const float* y_orig,
                                      const float* x, const float* hinv,
                                      const float* s_full,
                                      const float* z_full, float* w_cont,
                                      float* wp_all, float* y_q,
                                      double* hist, double* pls, float* d,
                                      float* rhs, int B, int out_dim,
                                      int in_dim, int n, int bs, int t_max,
                                      float alpha, int bits, int symmetric,
                                      void* stream) {
    if (bs < 1 || in_dim % bs || n < 1 || t_max < 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const long oi = (long)out_dim * in_dim, no = (long)n * out_dim;
    const int t2 = t_max + 1;
    WideArgs p = {};
    p.yq = y_q; p.yo = y_orig; p.d = d; p.rhs = rhs; p.w = w_cont;
    p.s = s_full; p.z = z_full; p.t2 = t2; p.n = n; p.out = out_dim;
    p.in = in_dim; p.bs = bs; p.symmetric = symmetric; p.alpha = alpha;
    p.qmax = exp2f((float)bits) - 1.f;
    p.half = exp2f((float)(bits - 1));
    // an n x out product X Wsrc^T over the columns [c1, c1 + K)
    auto x_wt = [&](const float* wsrc, long w_mem, int c1, int K) {
        p.a = x + c1; p.sa_i = in_dim; p.sa_k = 1; p.a_mem = (long)n * in_dim;
        p.b = wsrc + c1; p.sb_k = 1; p.sb_j = in_dim; p.b_mem = w_mem;
        p.M = n; p.N = out_dim; p.K = K;
    };
    int err;
    // round 0: W = W0, candidate 0 = W0, Y_q = X W0^T, Gamma_0
    if ((err = wide_project(w0, nullptr, nullptr, w_cont, oi, oi, B, 1, p,
                            s)) ||
        (err = wide_project(w0, nullptr, nullptr, wp_all, oi, t2 * oi, B, 1,
                            p, s)))
        return err;
    x_wt(w0, oi, 0, in_dim);
    p.part = hist; p.part2 = pls; p.slot = 0;
    if ((err = wide<W_INIT>(p, B, s))) return err;
    for (int t = 1; t <= t_max; ++t) {
        for (int c1 = 0; c1 < in_dim; c1 += bs) {
            p.c1 = c1;
            x_wt(w_cont, oi, c1, bs);
            if ((err = wide<W_STALE>(p, B, s))) return err;
            // rhs[c][o] = sum_m X[m][c1 + c] D[m][o]
            p.a = x + c1; p.sa_i = 1; p.sa_k = in_dim;
            p.a_mem = (long)n * in_dim;
            p.b = d; p.sb_k = out_dim; p.sb_j = 1; p.b_mem = no;
            p.M = bs; p.N = out_dim; p.K = n;
            if ((err = wide<W_RHS>(p, B, s))) return err;
            // B*[o][c] = sum_k H_i^-1[c][k] rhs[k][o]
            p.a = hinv + (long)c1 * bs; p.sa_i = bs; p.sa_k = 1;
            p.a_mem = (long)in_dim * bs;
            p.b = rhs; p.sb_k = out_dim; p.sb_j = 1;
            p.b_mem = (long)bs * out_dim;
            p.M = bs; p.N = out_dim; p.K = bs;
            if ((err = wide<W_SOLVE>(p, B, s))) return err;
            x_wt(w_cont, oi, c1, bs);
            if ((err = wide<W_FRESH>(p, B, s))) return err;
        }
        p.part = hist; p.slot = t; p.K = 0;
        if ((err = wide<W_GAMMA>(p, B, s))) return err;
        float* wpt = wp_all + (long)t * oi;
        if ((err = wide_project(w_cont, s_full, z_full, wpt, oi, t2 * oi, B,
                                0, p, s)))
            return err;
        x_wt(wpt, t2 * oi, 0, in_dim);
        p.part = pls;
        if ((err = wide<W_PLOSS>(p, B, s))) return err;
    }
    return 0;
}

// Shapes: w0/s/z/w_cont (B, out, in), y_orig/y_q (B, n, out), x (B, n, in),
// hinv (B, in, bs), wp_all (B, t_max+1, out, in), hist/pls fp64
// (B, out/bo, t_max+1), dbuf (B, out/bo, n, bo) when split > 1 (the
// directed residuals; unused otherwise); bo = 32 rows per block with
// out % bo == 0, split 1, 2, 4 or 8 blocks per cluster sharing the tokens;
// bs a multiple of 4 up to 128 dividing in; every pointer 16-byte aligned.
extern "C" int rpiq_block_launch(const float* w0, const float* y_orig,
                                 const float* x, const float* hinv,
                                 const float* s_full, const float* z_full,
                                 float* w_cont, float* wp_all, float* y_q,
                                 double* hist, double* pls, float* dbuf,
                                 int B,
                                 int out_dim, int in_dim, int n, int bs,
                                 int t_max, float alpha, int bits,
                                 int symmetric, int bo, int split,
                                 void* stream) {
    size_t smem;
    const int fits = yq_fits(n, bs, bo, split, &smem);
    if (fits == -1) return smem_grant_error();
    if (fits < 0 || out_dim % BO || in_dim % bs || n < 1)
        return (int)cudaErrorInvalidValue;
    const float* p[6] = {w0, y_orig, x, hinv, s_full, z_full};
    float* o[4] = {w_cont, wp_all, y_q, dbuf};
    double* sums[2] = {hist, pls};
    cudaStream_t s = (cudaStream_t)stream;
    switch (split) {
        case 1: return launch<1>(p, o, sums, B, out_dim, in_dim, n, bs, t_max,
                                 alpha, bits, symmetric, fits, smem, s);
        case 2: return launch<2>(p, o, sums, B, out_dim, in_dim, n, bs, t_max,
                                 alpha, bits, symmetric, fits, smem, s);
        case 4: return launch<4>(p, o, sums, B, out_dim, in_dim, n, bs, t_max,
                                 alpha, bits, symmetric, fits, smem, s);
        case 8: return launch<8>(p, o, sums, B, out_dim, in_dim, n, bs, t_max,
                                 alpha, bits, symmetric, fits, smem, s);
    }
    return (int)cudaErrorInvalidValue;
}
