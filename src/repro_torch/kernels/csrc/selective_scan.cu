// Mamba-1 selective scan with the state in registers: the prefill and
// calibration path of every Mamba layer (models/recurrent.mamba_block).
//
// Replaces: src/repro/kernels/selective_scan.py, selective_scan_pallas
// (_ssm_kernel), reached from kernels/ops.selective_scan.
//
// Computes, per batch row and channel c, with A = -exp(a_log[c]) and the
// state h (n wide, from h0):
//   a_t = exp(dt_t * A);  h <- a_t * h + (dt_t * u_t) * B_t;
//   y_t = sum_j h_j * C_t[j] + d_skip[c] * u_t
// in fp32 (expf, not __expf), y rounded to u's dtype, h_last in fp32. The
// file builds with -fmad=false, so the state update rounds each product
// and the sum as the plain version does; only y's sum over the n states
// is taken in another order than the plain version's product.
//
// Bound on the H100: bytes, then instructions. Per (batch, step, channel)
// u and y (2 bytes each in bf16) and dt (4) move, against ~7 operations for
// each of the n states; at the prefill shape (B 4, S 512, d 8192, n 16)
// that is ~139 MB (0.042 ms at 3.35 TB/s) against ~1.9 GFLOP (0.028 ms at
// 67 TFLOP/s). An accurate expf costs about ten instructions and its exp2
// runs on the quarter-rate special-function unit: 268 M of them at that
// shape take 0.064 ms on the SFUs, and with the state update and y about
// 0.10 ms of issue, the floor in practice.
//
// Design: the TPU kernel's sequential time axis becomes a loop inside the
// block. Grid (d / BD, B): each block owns BD channels of one batch row.
// A channel's NMAX = 16 states are split over LANES = 2 neighbouring
// lanes, 8 states a lane, held in registers with -exp(a_log) for the
// whole sequence; so a block is 2 BD threads and the card holds twice the
// warps of one thread a channel to hide expf's latency (on the H100, 2
// lanes a channel beat 4: each lane's share of the per-step loads,
// shuffles and y term weighs less; PERF.md). Each state's update is the
// same instruction sequence as one thread per channel would run, so
// h_last does not depend on the split; y's per-lane partials are summed by
// a fixed butterfly of shuffles. Time tiles of TS steps of u and dt (BD
// wide) and of B and C (NMAX wide, zero past n) stream through a
// double-buffered cp.async ring, so the next tile's loads overlap the scan
// of this one; y goes through a double-buffered tile in shared memory and
// out with 16-byte stores, one barrier a tile. States beyond n start at 0 with A = 0 and
// B = C = 0, so they stay 0 and add exactly 0 to y: one kernel serves every
// n <= NMAX. Any S >= 1: the last tile is ragged and masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "smem.cuh"

namespace {

constexpr int BD = 64;              // channels per block
constexpr int LANES = 2;            // lanes per channel
constexpr int NMAX = 16;            // states per channel
constexpr int NL = NMAX / LANES;    // states per lane
constexpr int THREADS = BD * LANES;
constexpr int TS = 32;              // time steps per tile
constexpr int STAGES = 2;           // tiles in the ring

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);                 // round to nearest even
}

// Shared memory of one block: the ring of input tiles, then two y tiles.
template <typename T>
struct Smem {
    struct Tile {
        T u[TS][BD];
        float dt[TS][BD];
        float b[TS][NMAX];
        float c[TS][NMAX];
    };
    Tile ring[STAGES];
    T y[2][TS][BD];
};

// four blocks an SM (128 registers a thread, 40 KB of shared memory at
// bf16 u) keep every block of the serving shape (B 4, d 8192: 512 blocks)
// resident at once
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
selective_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a_log,
                      const float* __restrict__ d_skip,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ h_last, int S, int d, int n,
                      bool bc_vec) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
    const int tid = threadIdx.x;
    const int ch = tid / LANES, sub = tid % LANES;
    const int c0 = blockIdx.x * BD;
    const int c = c0 + ch;
    const long row0 = (long)blockIdx.y * S;          // (batch, t = 0)
    const int n_tiles = (S + TS - 1) / TS;
    constexpr int EU = 16 / sizeof(T);               // u values in 16 bytes

    // tile t of u, dt (rows of BD channels, 16-byte pieces), B and C (the
    // tile's TS * n floats are contiguous; 16-byte pieces when n is NMAX
    // and the rows are aligned, else one float at a time); zeros past S
    // and past n
    auto load_tile = [&](int t) {
        typename Smem<T>::Tile& tl = sm.ring[t % STAGES];
        const int t0 = t * TS, steps = min(TS, S - t0);
        for (int e = tid; e < TS * BD / EU; e += THREADS) {
            const int i = e / (BD / EU), j = EU * (e % (BD / EU));
            const bool ok = i < steps;
            cp_async16(&tl.u[i][j], ok ? u + (row0 + t0 + i) * d + c0 + j : u,
                       ok ? 16 : 0);
        }
        for (int e = tid; e < TS * BD / 4; e += THREADS) {
            const int i = e / (BD / 4), j = 4 * (e % (BD / 4));
            const bool ok = i < steps;
            cp_async16(&tl.dt[i][j],
                       ok ? dt + (row0 + t0 + i) * d + c0 + j : dt,
                       ok ? 16 : 0);
        }
        const long bc0 = (row0 + t0) * n;
        if (bc_vec) {                                // n == NMAX
            for (int e = tid; e < TS * NMAX / 4; e += THREADS) {
                const bool ok = 4 * e < steps * NMAX;
                cp_async16(&tl.b[0][0] + 4 * e, ok ? bm + bc0 + 4 * e : bm,
                           ok ? 16 : 0);
                cp_async16(&tl.c[0][0] + 4 * e, ok ? cm + bc0 + 4 * e : cm,
                           ok ? 16 : 0);
            }
        } else {
            for (int e = tid; e < TS * NMAX; e += THREADS) {
                const int i = e / NMAX, j = e % NMAX;
                const bool ok = i < steps && j < n;
                const long off = ok ? bc0 + (long)i * n + j : 0;
                cp_async4(&tl.b[i][j], bm + off, ok ? 4 : 0);
                cp_async4(&tl.c[i][j], cm + off, ok ? 4 : 0);
            }
        }
    };

    // y tile t (in the y buffer of its parity) to device memory
    auto store_y = [&](int t) {
        const int t0 = t * TS, steps = min(TS, S - t0);
        for (int e = tid; e < steps * BD / EU; e += THREADS) {
            const int i = e / (BD / EU), j = EU * (e % (BD / EU));
            *reinterpret_cast<uint4*>(y + (row0 + t0 + i) * d + c0 + j) =
                *reinterpret_cast<const uint4*>(&sm.y[t & 1][i][j]);
        }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_tiles) load_tile(s);
        cp_async_commit();
    }

    const long hbase = ((long)blockIdx.y * d + c) * n;
    float A[NL], h[NL];
#pragma unroll
    for (int q = 0; q < NL; ++q) {
        const int j = NL * sub + q;
        A[q] = j < n ? -expf(a_log[(long)c * n + j]) : 0.f;
        h[q] = j < n ? h0[hbase + j] : 0.f;
    }
    const float dsk = d_skip[c];

    for (int t = 0; t < n_tiles; ++t) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();           // tile t is in; tile t - 1's y is written
        if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
        cp_async_commit();
        if (t > 0) store_y(t - 1);

        const typename Smem<T>::Tile& tl = sm.ring[t % STAGES];
        const int steps = min(TS, S - t * TS);
#pragma unroll 4
        for (int i = 0; i < steps; ++i) {
            const float dtv = tl.dt[i][ch], uv = to_f32(tl.u[i][ch]);
            const float du = dtv * uv;
            float bq[NL], cq[NL];
#pragma unroll
            for (int q = 0; q < NL; q += 4) {
                const float4 bv = *reinterpret_cast<const float4*>(
                    &tl.b[i][NL * sub + q]);
                const float4 cv = *reinterpret_cast<const float4*>(
                    &tl.c[i][NL * sub + q]);
                bq[q] = bv.x; bq[q + 1] = bv.y; bq[q + 2] = bv.z;
                bq[q + 3] = bv.w;
                cq[q] = cv.x; cq[q + 1] = cv.y; cq[q + 2] = cv.z;
                cq[q + 3] = cv.w;
            }
            // the state update rounds as the plain version does (no
            // contraction); y's sum is free to fuse
            float acc = 0.f;
#pragma unroll
            for (int q = 0; q < NL; ++q) {
                const float a = expf(dtv * A[q]);
                h[q] = a * h[q] + du * bq[q];
                acc = fmaf(h[q], cq[q], acc);
            }
#pragma unroll
            for (int off = 1; off < LANES; off <<= 1)
                acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
            if (sub == 0) put(&sm.y[t & 1][i][ch], fmaf(uv, dsk, acc));
        }
    }
    __syncthreads();
    if (n_tiles > 0) store_y(n_tiles - 1);
    cp_async_wait<0>();
#pragma unroll
    for (int q = 0; q < NL; ++q) {
        const int j = NL * sub + q;
        if (j < n) h_last[hbase + j] = h[q];
    }
}

template <typename T>
int launch(const T* u, const float* dt, const float* bm, const float* cm,
           const float* a_log, const float* d_skip, const float* h0, T* y,
           float* h_last, int B, int S, int d, int n, void* stream) {
    if (B < 1 || S < 1 || d < BD || d % BD != 0 || n < 1 || n > NMAX ||
        B > 65535 || ((uintptr_t)u | (uintptr_t)dt | (uintptr_t)y) % 16)
        return (int)cudaErrorInvalidValue;
    const bool bc_vec =
        n == NMAX && ((uintptr_t)bm | (uintptr_t)cm) % 16 == 0;
    constexpr auto kernel = &selective_scan_kernel<T>;
    const size_t smem = sizeof(Smem<T>);
    if (smem > 48 * 1024) {
        const int lim = grant_max_dynamic_smem<kernel>();
        if (lim < 0) return smem_grant_error();
        if (smem > (size_t)lim) return (int)cudaErrorInvalidValue;
    }
    dim3 grid(d / BD, B);
    kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        u, dt, bm, cm, a_log, d_skip, h0, y, h_last, S, d, n, bc_vec);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_channels_per_block() { return BD; }
extern "C" int selective_scan_max_state() { return NMAX; }

extern "C" int selective_scan_f32_launch(
    const float* u, const float* dt, const float* bm, const float* cm,
    const float* a_log, const float* d_skip, const float* h0, float* y,
    float* h_last, int B, int S, int d, int n, void* stream) {
    return launch<float>(u, dt, bm, cm, a_log, d_skip, h0, y, h_last, B, S,
                         d, n, stream);
}

extern "C" int selective_scan_bf16_launch(
    const __nv_bfloat16* u, const float* dt, const float* bm,
    const float* cm, const float* a_log, const float* d_skip,
    const float* h0, __nv_bfloat16* y, float* h_last, int B, int S, int d,
    int n, void* stream) {
    return launch<__nv_bfloat16>(u, dt, bm, cm, a_log, d_skip, h0, y,
                                 h_last, B, S, d, n, stream);
}
