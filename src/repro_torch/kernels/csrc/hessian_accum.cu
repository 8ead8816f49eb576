// H += X^T X in fp32: the calibration Gram matrix of one dense linear.
//
// Replaces: src/repro/kernels/hessian_accum.py, hessian_accum_pallas
// (_hessian_kernel), reached from core/hessian.accumulate.
//
// Bound on the H100: operations. The symmetric product needs n*d*(d+1)
// FLOP (d(d+1)/2 sums of n products) against (n*d + 2*d^2)*4 bytes; at the
// main path's n = 512 tokens that is above the fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte) at every d from 256 up. The reference pins the
// Gram at fp32 HIGHEST precision and Hopper's tensor cores take no fp32
// operands, so the work runs as FFMA on the CUDA cores.
//
// What held the first version back: one block per 64 x 64 tile (10 blocks
// at d 256 on 132 SMs), each walking all n tokens alone in slabs loaded
// synchronously (load, barrier, compute, barrier).
//
// Design. Each block owns one 64 x 64 tile of H on or above the diagonal,
// a 4 x 4 register tile per thread (a warp covers 8 x 4 threads, so each
// 16-byte shared load reads at most 8 distinct addresses), and four blocks
// stay resident per SM. 32-token slabs of the tile's two column panels of
// X stream through a 3-stage cp.async ring (16-byte copies, 4-byte where a
// row of X is not 16-byte aligned; tokens past n and columns past d are
// zero-filled), so two slabs are in flight while one is summed; a diagonal
// tile stages one panel. Where tiles are few the token axis is split over
// a thread-block cluster of `split` blocks per tile: each sums its own
// slabs, the partial tiles meet in distributed shared memory, and each
// block sums a share of the rows over the ranks in rank order (16-byte
// loads) and adds them to H; a small share's H values are read before the
// main loop. Every output is thus summed over all tokens first and added
// to H once, the rounding of the plain version `H + X^T X`, and the result
// is bitwise the same from run to run (no atomics). An off-diagonal tile
// is written to (i, j) and, read transposed from shared memory, to (j, i).
// The wrapper (ops.hessian_accum_geometry) picks the split from (n, d).
// On the H100 128 x 128 tiles with 8 x 8 register tiles (two resident
// blocks) were measured too and were no faster at any main-path d.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "smem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int T = 64;          // tile of H
constexpr int RM = 4;          // register tile RM x RM (16 x 16 threads)
constexpr int SLAB = 32;       // tokens per stage
constexpr int STAGES = 3;
constexpr int PANEL = SLAB * T;
constexpr int LDE = T + 4;     // the partial tile's row stride (16 bytes)

// the stage ring, later the partial tile and, with a split, the block's
// summed rows (row stride T + 1)
template <int SPLIT>
constexpr size_t smem_floats() {
    constexpr size_t ring = STAGES * 2 * PANEL;
    constexpr size_t tile =
        T * LDE + (SPLIT > 1 ? (T / SPLIT) * (T + 1) : 0);
    return ring > tile ? ring : tile;
}

template <bool VEC16, int SPLIT>
__global__ void __launch_bounds__(THREADS, 4)
hessian_accum_kernel(const float* __restrict__ x, float* __restrict__ H,
                     int n, int d) {
    extern __shared__ __align__(16) float sm[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int tx = (warp % 2) * 8 + lane % 8, ty = (warp / 2) * 4 + lane / 8;

    // the tile: blockIdx.x / SPLIT-th in row-major order of the upper tiles
    const int nt = (d + T - 1) / T;
    int bi = 0, rem = blockIdx.x / SPLIT;
    while (rem >= nt - bi) {
        rem -= nt - bi;
        ++bi;
    }
    const int bj = bi + rem;
    const bool diag = bi == bj;
    const int i0 = bi * T, j0 = bj * T;
    const int nslab = (n + SLAB - 1) / SLAB;
    const int s_beg = (int)((long)nslab * rank / SPLIT);
    const int ns = (int)((long)nslab * (rank + 1) / SPLIT) - s_beg;
    // this block adds rows [r0, r0 + SHARE) of the tile to H (and their
    // transpose, off the diagonal)
    constexpr int SHARE = T / SPLIT;
    const int r0 = rank * SHARE;
    const bool hvec = VEC16 && j0 + T <= d;
    // a small share (one 16-byte group of a row and at most four
    // transposed values a thread): read those H values now, so their
    // latency hides behind the main loop
    constexpr bool PRE = SHARE * T <= 4 * THREADS;
    float4 hd = make_float4(0.f, 0.f, 0.f, 0.f);
    float hm[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (PRE) {
        const int gi = i0 + r0 + tid / (T / 4);
        if (tid < SHARE * T / 4 && hvec && gi < d)
            hd = *reinterpret_cast<const float4*>(
                H + (long)gi * d + j0 + tid % (T / 4) * 4);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int e = tid + k * THREADS, j = e / SHARE, i = e % SHARE;
            if (!diag && e < SHARE * T && i0 + r0 + i < d && j0 + j < d)
                hm[k] = H[(long)(j0 + j) * d + i0 + r0 + i];
        }
    }

    auto load = [&](int s, int buf) {
        float* a = sm + buf * 2 * PANEL;
        float* b = a + PANEL;
        const int t0 = (s_beg + s) * SLAB;
        constexpr int W = VEC16 ? 4 : 1;
        for (int e = tid; e < SLAB * T / W; e += THREADS) {
            const int r = e / (T / W), c = (e % (T / W)) * W;
            const int t = t0 + r;
            const bool ta = t < n && i0 + c < d, tb = t < n && j0 + c < d;
            const float* ga = ta ? x + (long)t * d + i0 + c : x;
            const float* gb = tb ? x + (long)t * d + j0 + c : x;
            if (VEC16) {
                cp_async16(a + r * T + c, ga, ta ? 16 : 0);
                if (!diag) cp_async16(b + r * T + c, gb, tb ? 16 : 0);
            } else {
                cp_async4(a + r * T + c, ga, ta ? 4 : 0);
                if (!diag) cp_async4(b + r * T + c, gb, tb ? 4 : 0);
            }
        }
    };

    float acc[RM][RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RM; ++j) acc[i][j] = 0.f;

#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) {
        if (p < ns) load(p, p);
        cp_async_commit();
    }
    for (int s = 0; s < ns; ++s) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();     // slab s landed; slab s-1's buffer is free
        if (s + STAGES - 1 < ns)
            load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
        cp_async_commit();
        const float* a = sm + (s % STAGES) * 2 * PANEL;
        const float* b = diag ? a : a + PANEL;
#pragma unroll
        for (int k = 0; k < SLAB; ++k) {
            const float4 u =
                *reinterpret_cast<const float4*>(a + k * T + ty * 4);
            const float4 v =
                *reinterpret_cast<const float4*>(b + k * T + tx * 4);
            const float va[RM] = {u.x, u.y, u.z, u.w};
            const float vb[RM] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < RM; ++j)
                    acc[i][j] = fmaf(va[i], vb[j], acc[i][j]);
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    // the partial tile into shared memory, 16-byte stores
    float* E = sm;
#pragma unroll
    for (int i = 0; i < RM; ++i)
        *reinterpret_cast<float4*>(E + (ty * 4 + i) * LDE + tx * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    cluster.sync();          // every rank's partial tile is ready

    // R: the block's rows of the tile summed over the ranks in rank order
    // (16-byte loads from each peer), added to H[i0 + i][j0 + j]; row
    // stride T + 1, so the transposed reads below are conflict-free.
    // Without a split R is the tile itself.
    constexpr int LDR = SPLIT == 1 ? LDE : T + 1;
    float* R = SPLIT == 1 ? E : E + T * LDE;
    for (int e = tid; e < SHARE * T / 4; e += THREADS) {
        const int i = e / (T / 4), j = (e % (T / 4)) * 4;
        float4 v = *reinterpret_cast<const float4*>(E + (r0 + i) * LDE + j);
        if constexpr (SPLIT > 1) {
            float4 p[SPLIT];
#pragma unroll
            for (int q = 0; q < SPLIT; ++q)
                p[q] = *reinterpret_cast<const float4*>(
                    cluster.map_shared_rank(E, q) + (r0 + i) * LDE + j);
            v = p[0];
#pragma unroll
            for (int q = 1; q < SPLIT; ++q) {
                v.x += p[q].x; v.y += p[q].y; v.z += p[q].z; v.w += p[q].w;
            }
            R[i * LDR + j] = v.x; R[i * LDR + j + 1] = v.y;
            R[i * LDR + j + 2] = v.z; R[i * LDR + j + 3] = v.w;
        }
        const int gi = i0 + r0 + i;
        if (gi >= d) continue;
        float* h = H + (long)gi * d + j0 + j;
        if (hvec) {
            float4 o = PRE ? hd : *reinterpret_cast<float4*>(h);
            o.x += v.x; o.y += v.y; o.z += v.z; o.w += v.w;
            *reinterpret_cast<float4*>(h) = o;
        } else {
            const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int c = 0; c < 4; ++c)
                if (j0 + j + c < d) h[c] += vv[c];
        }
    }
    // an off-diagonal tile also into H[j0 + j][i0 + r0 + i], read
    // transposed from R
    if (!diag) {
        __syncthreads();
        if constexpr (PRE) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int e = tid + k * THREADS, j = e / SHARE, i = e % SHARE;
                if (e < SHARE * T && i0 + r0 + i < d && j0 + j < d)
                    H[(long)(j0 + j) * d + i0 + r0 + i] =
                        hm[k] + R[i * LDR + j];
            }
        } else {
            for (int e = tid; e < SHARE * T; e += THREADS) {
                const int j = e / SHARE, i = e % SHARE;
                if (i0 + r0 + i < d && j0 + j < d)
                    H[(long)(j0 + j) * d + i0 + r0 + i] += R[i * LDR + j];
            }
        }
    }
    cluster.sync();          // no block leaves while a peer reads its tile
}

template <bool VEC16, int SPLIT>
int launch(const float* x, float* H, int n, int d, cudaStream_t stream) {
    if (grant_max_dynamic_smem<hessian_accum_kernel<VEC16, SPLIT>>() < 0)
        return smem_grant_error();
    const long nt = (d + T - 1) / T;
    const long blocks = nt * (nt + 1) / 2 * SPLIT;
    return launch_clustered(hessian_accum_kernel<VEC16, SPLIT>,
                            dim3((unsigned)blocks), THREADS,
                            smem_floats<SPLIT>() * sizeof(float), stream,
                            SPLIT, x, H, n, d);
}

template <bool VEC16>
int launch_split(const float* x, float* H, int n, int d, int split,
                 cudaStream_t stream) {
    switch (split) {
        case 1: return launch<VEC16, 1>(x, H, n, d, stream);
        case 2: return launch<VEC16, 2>(x, H, n, d, stream);
        case 4: return launch<VEC16, 4>(x, H, n, d, stream);
        case 8: return launch<VEC16, 8>(x, H, n, d, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (n, d) and H (d, d) fp32, contiguous; split 1, 2, 4 or 8 (the cluster
// size: blocks that share one tile's tokens).
extern "C" int hessian_accum_launch(const float* x, float* H, int n, int d,
                                    int split, void* stream) {
    if (n < 0 || d < 1) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)H % 16 == 0;
    cudaStream_t s = (cudaStream_t)stream;
    return vec ? launch_split<true>(x, H, n, d, split, s)
               : launch_split<false>(x, H, n, d, split, s);
}
