// The backward of the Mamba-1 selective scan: the VJP of selective_scan.cu's
// function, for Mamba training on the card (models/recurrent.mamba_block
// under autograd, through kernels/ops._SelectiveScanFn).
//
// Replaces: no Pallas kernel. The JAX package differentiates its XLA scan
// (src/repro/kernels/ops.py, selective_scan's chunked recurrence) with
// jax.grad; this kernel computes the same VJP.
//
// Computes, per batch row and channel c (A = -exp(a_log[c]), from the
// states h_t of the forward and the cotangents dy of y and dh_last of
// h_last):
//   g_t = dy_t C_t + a_{t+1} g_{t+1}          (g_{S-1} seeded by dh_last)
//   du_t = dt_t sum_j g_t B_t + d_skip dy_t     (rounded to u's dtype)
//   ddt_t = sum_j g_t (A a_t h_{t-1} + u_t B_t)
//   dB_t = sum_c g_t dt_t u_t,   dC_t = sum_c dy_t h_t
//   dA_log = A sum_{b,t} g_t a_t h_{t-1} dt_t,  dD = sum_{b,t} dy_t u_t
//   dh0 = a_0 g_0
// in fp32. The file builds with -fmad=false, as the forward does.
//
// Bound on the H100: operations. At falcon-mamba-7b's training shape (B 4,
// S 512, d 8192, n 16) the inputs and outputs are ~0.27 GB (0.08 ms at
// 3.35 TB/s) against ~7.2 G operations (0.11 ms at 67 TFLOP/s), two
// accurate expf a state among them (kernels/work.py).
//
// Design, simple first: the forward kernel's layout (grid (d / 64, B), a
// block owns 64 channels of one batch row, two lanes a channel, eight
// states a lane in registers) in two passes in one launch.
//   1. The states are recomputed forward from h0 with the forward kernel's
//      instruction sequence (accurate expf, no contraction), so they are
//      bitwise the forward's, and every one but the last is stored to a
//      scratch (B, S-1, d, 16) fp32 (1.07 GB at the training shape): no
//      state is ever recovered by dividing by a_t, which underflows.
//   2. Time runs backwards, tile by tile (TS steps of u, dt, dy, B and C
//      through a double-buffered cp.async ring, the last tile first); the
//      thread that stored a state reads it back, one step ahead of its use.
// No floating-point atomics: du and ddt sum a channel's two lanes with one
// shuffle; dB and dC sum the warp's 16 channels by a fixed tree of
// shuffles (recursive halving: each lane ends with one of the 32 sums) and
// the block's four warps in order in shared memory, into per-block
// partials; dA_log and dD are summed over time in registers into
// per-batch-row partials. A second kernel of the same launch sums the
// partials in a fixed order. So two launches on the same inputs agree
// bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int BD = 64;              // channels per block
constexpr int LANES = 2;            // lanes per channel
constexpr int NMAX = 16;            // states per channel
constexpr int NL = NMAX / LANES;    // states per lane
constexpr int THREADS = BD * LANES;
constexpr int WARPS = THREADS / 32;
constexpr int TS = 16;              // time steps per tile
constexpr int STAGES = 2;           // tiles in the ring
constexpr int RED = 2 * NMAX;       // dB and dC values of one step
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);                 // round to nearest even
}

// Shared memory of one block: the ring of input tiles, the du and ddt
// tiles on their way out, and each warp's dB / dC sums of every step.
template <typename T>
struct Smem {
    struct Tile {
        T u[TS][BD];
        float dt[TS][BD];
        T dy[TS][BD];
        float b[TS][NMAX];
        float c[TS][NMAX];
    };
    Tile ring[STAGES];
    T du[TS][BD];
    float ddt[TS][BD];
    float red[TS][WARPS][32];
};

// v[0..15] of each lane summed over the 16 lanes of its warp that share
// lane bit 0 (the warp's 16 channels of one lane half). Recursive halving:
// in each round a lane keeps one half of its values, adds its partner's
// copy of that half and hands over the other half. Lane l ends with the
// sum of value (l >> 1) in v[0]; every sum is taken in one fixed order.
__device__ __forceinline__ void reduce16(float (&v)[RED / 2], int lane) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int half = 8 >> r, mask = 16 >> r;
        const bool up = (lane & mask) != 0;
#pragma unroll
        for (int k = 0; k < half; ++k) {
            const float send = up ? v[k] : v[k + half];
            const float keep = up ? v[k + half] : v[k];
            v[k] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
        }
    }
}

// The lane whose reduce16 sum is value e of a step (e < 16: dB[j = e],
// else dC[j = e - 16]): value index (kind * 8 + q) of lane half j / 8.
__device__ __forceinline__ int lane_of(int e) {
    const int j = e & 15, kind = e >> 4;
    return ((kind * NL + (j & (NL - 1))) << 1) | (j / NL);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
scan_bwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a_log,
                const float* __restrict__ d_skip,
                const float* __restrict__ h0, const T* __restrict__ dy,
                const float* __restrict__ dh_last, float* __restrict__ hs,
                T* __restrict__ du, float* __restrict__ ddt,
                float* __restrict__ dh0, float* __restrict__ part_bc,
                float* __restrict__ part_a, float* __restrict__ part_d,
                int S, int d, int n, bool bc_vec) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ch = tid / LANES, sub = tid % LANES;
    const int c0 = blockIdx.x * BD;
    const int c = c0 + ch;
    const int bi = blockIdx.y;
    const long row0 = (long)bi * S;                  // (batch, t = 0)
    const int n_tiles = (S + TS - 1) / TS;
    const int rows = S > 1 ? S - 1 : 1;              // stored states a row
    constexpr int EU = 16 / sizeof(T);               // u values in 16 bytes

    // tile t of u, dt (and, backwards, dy) in rows of BD channels, 16-byte
    // pieces; B (and C) as the forward loads them; zeros past S and n
    auto load_tile = [&](int t, bool back) {
        typename Smem<T>::Tile& tl = sm.ring[t % STAGES];
        const int t0 = t * TS, steps = min(TS, S - t0);
        for (int e = tid; e < TS * BD / EU; e += THREADS) {
            const int i = e / (BD / EU), j = EU * (e % (BD / EU));
            const bool ok = i < steps;
            const long off = ok ? (row0 + t0 + i) * d + c0 + j : 0;
            cp_async16(&tl.u[i][j], u + off, ok ? 16 : 0);
            if (back) cp_async16(&tl.dy[i][j], dy + off, ok ? 16 : 0);
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
                if (back)
                    cp_async16(&tl.c[0][0] + 4 * e,
                               ok ? cm + bc0 + 4 * e : cm, ok ? 16 : 0);
            }
        } else {
            for (int e = tid; e < TS * NMAX; e += THREADS) {
                const int i = e / NMAX, j = e % NMAX;
                const bool ok = i < steps && j < n;
                const long off = ok ? bc0 + (long)i * n + j : 0;
                cp_async4(&tl.b[i][j], bm + off, ok ? 4 : 0);
                if (back) cp_async4(&tl.c[i][j], cm + off, ok ? 4 : 0);
            }
        }
    };

    // this lane's stored state after step t (t < S - 1)
    auto state_at = [&](int t) {
        return hs + (((long)bi * rows + t) * d + c) * NMAX + NL * sub;
    };

    const long hbase = ((long)bi * d + c) * n;
    float A[NL], h[NL];
#pragma unroll
    for (int q = 0; q < NL; ++q) {
        const int j = NL * sub + q;
        A[q] = j < n ? -expf(a_log[(long)c * n + j]) : 0.f;
        h[q] = j < n ? h0[hbase + j] : 0.f;
    }

    // -- pass 1: the states, forward, as selective_scan.cu computes them
    load_tile(0, false);
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) {
        cp_async_wait<0>();
        __syncthreads();           // tile t is in; tile t - 1 is consumed
        if (t + 1 < n_tiles) load_tile(t + 1, false);
        cp_async_commit();
        const typename Smem<T>::Tile& tl = sm.ring[t % STAGES];
        const int steps = min(TS, S - t * TS);
        for (int i = 0; i < steps; ++i) {
            const float dtv = tl.dt[i][ch], uv = to_f32(tl.u[i][ch]);
            const float dtu = dtv * uv;
#pragma unroll
            for (int q = 0; q < NL; ++q) {
                const float a = expf(dtv * A[q]);
                h[q] = a * h[q] + dtu * tl.b[i][NL * sub + q];
            }
            const int ts = t * TS + i;
            if (ts < S - 1) {
                float4* p = reinterpret_cast<float4*>(state_at(ts));
                p[0] = make_float4(h[0], h[1], h[2], h[3]);
                p[1] = make_float4(h[4], h[5], h[6], h[7]);
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();               // the ring is free for pass 2

    // -- pass 2: backwards in time. h holds h_t, hp is read for h_{t-1}
    float g[NL], dA[NL], hp[NL];
#pragma unroll
    for (int q = 0; q < NL; ++q) {
        const int j = NL * sub + q;
        g[q] = (dh_last != nullptr && j < n) ? dh_last[hbase + j] : 0.f;
        dA[q] = 0.f;
    }
    float dD = 0.f;
    const float dsk = d_skip[c];
    auto read_prev = [&](int t) {        // h_{t-1} into hp
        if (t > 0) {
            const float4* p = reinterpret_cast<const float4*>(state_at(t - 1));
            const float4 x = p[0], y = p[1];
            hp[0] = x.x; hp[1] = x.y; hp[2] = x.z; hp[3] = x.w;
            hp[4] = y.x; hp[5] = y.y; hp[6] = y.z; hp[7] = y.w;
        } else {
#pragma unroll
            for (int q = 0; q < NL; ++q) {
                const int j = NL * sub + q;
                hp[q] = j < n ? h0[hbase + j] : 0.f;
            }
        }
    };
    read_prev(S - 1);

    load_tile(n_tiles - 1, true);
    cp_async_commit();
    for (int k = 0; k < n_tiles; ++k) {
        const int tile = n_tiles - 1 - k;
        cp_async_wait<0>();
        __syncthreads();           // tile in; the last tile's outputs out
        if (tile > 0) load_tile(tile - 1, true);
        cp_async_commit();
        const typename Smem<T>::Tile& tl = sm.ring[tile % STAGES];
        const int t0 = tile * TS, steps = min(TS, S - t0);
        for (int i = steps - 1; i >= 0; --i) {
            const int t = t0 + i;
            float hq[NL];          // h_{t-1}, this step's; hp gets the next
#pragma unroll
            for (int q = 0; q < NL; ++q) hq[q] = hp[q];
            if (t > 0) read_prev(t - 1);
            const float dtv = tl.dt[i][ch], uv = to_f32(tl.u[i][ch]);
            const float dyv = to_f32(tl.dy[i][ch]);
            const float dtu = dtv * uv;
            float v[RED / 2];
            float sgb = 0.f, sdt = 0.f;
#pragma unroll
            for (int q = 0; q < NL; ++q) {
                const float bq = tl.b[i][NL * sub + q];
                const float cq = tl.c[i][NL * sub + q];
                const float a = expf(dtv * A[q]);
                const float gq = g[q] + dyv * cq;        // dL/dh_t
                const float ah = a * hq[q];              // a_t h_{t-1}
                sgb = sgb + gq * bq;
                sdt = sdt + gq * (A[q] * ah + uv * bq);
                dA[q] = dA[q] + gq * ah * dtv;
                v[q] = gq * dtu;                          // dB's term
                v[NL + q] = dyv * h[q];                   // dC's term
                g[q] = a * gq;                            // to step t - 1
                h[q] = hq[q];
            }
            sgb = sgb + __shfl_xor_sync(0xffffffffu, sgb, 1);
            sdt = sdt + __shfl_xor_sync(0xffffffffu, sdt, 1);
            if (sub == 0) {
                put(&sm.du[i][ch], dtv * sgb + dsk * dyv);
                dD = dD + dyv * uv;
            } else {
                sm.ddt[i][ch] = sdt;
            }
            reduce16(v, lane);
            sm.red[i][warp][lane] = v[0];
        }
        __syncthreads();
        // du and ddt of the tile, then its dB / dC partials (the warps'
        // sums added in warp order)
        for (int e = tid; e < steps * BD / EU; e += THREADS) {
            const int i = e / (BD / EU), j = EU * (e % (BD / EU));
            *reinterpret_cast<uint4*>(du + (row0 + t0 + i) * d + c0 + j) =
                *reinterpret_cast<const uint4*>(&sm.du[i][j]);
        }
        for (int e = tid; e < steps * BD / 4; e += THREADS) {
            const int i = e / (BD / 4), j = 4 * (e % (BD / 4));
            *reinterpret_cast<float4*>(ddt + (row0 + t0 + i) * d + c0 + j) =
                *reinterpret_cast<const float4*>(&sm.ddt[i][j]);
        }
        float* pb = part_bc + (((long)bi * gridDim.x + blockIdx.x) * S + t0)
                                  * RED;
        for (int e = tid; e < steps * RED; e += THREADS) {
            const int i = e / RED, l = lane_of(e % RED);
            float s = sm.red[i][0][l];
#pragma unroll
            for (int w = 1; w < WARPS; ++w) s = s + sm.red[i][w][l];
            pb[e] = s;
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int q = 0; q < NL; ++q) {
        const int j = NL * sub + q;
        if (j < n) dh0[hbase + j] = g[q];            // a_0 g_0
    }
    float4* pa = reinterpret_cast<float4*>(
        part_a + ((long)bi * d + c) * NMAX + NL * sub);
    pa[0] = make_float4(dA[0], dA[1], dA[2], dA[3]);
    pa[1] = make_float4(dA[4], dA[5], dA[6], dA[7]);
    if (sub == 0) part_d[(long)bi * d + c] = dD;
}

// The partials summed in a fixed order: dB and dC over the d / BD blocks
// of a batch row, dA_log (times A) and dD over the batch rows.
__global__ void __launch_bounds__(REDUCE_THREADS)
scan_bwd_reduce_kernel(const float* __restrict__ part_bc,
                       const float* __restrict__ part_a,
                       const float* __restrict__ part_d,
                       const float* __restrict__ a_log,
                       float* __restrict__ dB, float* __restrict__ dC,
                       float* __restrict__ dA, float* __restrict__ dD,
                       int B, int S, int d, int n) {
    long idx = (long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
    const int nblk = d / BD;
    const long n_bc = (long)B * S * RED;
    if (idx < n_bc) {
        const int e = (int)(idx % RED);
        const long bt = idx / RED;                   // b * S + t
        const long bi = bt / S, t = bt % S;
        const int j = e & 15;
        if (j >= n) return;
        const float* p = part_bc + (bi * nblk * S + t) * RED + e;
        float s = 0.f;
        for (int k = 0; k < nblk; ++k) s = s + p[(long)k * S * RED];
        (e < NMAX ? dB : dC)[bt * n + j] = s;
        return;
    }
    idx -= n_bc;
    if (idx < (long)d * NMAX) {
        const int c = (int)(idx / NMAX), j = (int)(idx % NMAX);
        if (j >= n) return;
        float s = 0.f;
        for (int bi = 0; bi < B; ++bi)
            s = s + part_a[((long)bi * d + c) * NMAX + j];
        dA[(long)c * n + j] = s * -expf(a_log[(long)c * n + j]);
        return;
    }
    idx -= (long)d * NMAX;
    if (idx < d) {
        float s = 0.f;
        for (int bi = 0; bi < B; ++bi) s = s + part_d[(long)bi * d + idx];
        dD[idx] = s;
    }
}

template <typename T>
int launch(const T* u, const float* dt, const float* bm, const float* cm,
           const float* a_log, const float* d_skip, const float* h0,
           const T* dy, const float* dh_last, float* hs, T* du, float* ddt,
           float* dB, float* dC, float* dA, float* dD, float* dh0,
           float* part_bc, float* part_a, float* part_d, int B, int S,
           int d, int n, void* stream) {
    if (B < 1 || S < 1 || d < BD || d % BD != 0 || n < 1 || n > NMAX ||
        B > 65535 ||
        ((uintptr_t)u | (uintptr_t)dt | (uintptr_t)dy | (uintptr_t)du |
         (uintptr_t)ddt | (uintptr_t)hs | (uintptr_t)part_a) % 16)
        return (int)cudaErrorInvalidValue;
    const bool bc_vec =
        n == NMAX && ((uintptr_t)bm | (uintptr_t)cm) % 16 == 0;
    const size_t smem = sizeof(Smem<T>);
    static_assert(sizeof(Smem<float>) <= 48 * 1024,
                  "the backward's shared memory needs no opt-in");
    cudaStream_t st = (cudaStream_t)stream;
    scan_bwd_kernel<T><<<dim3(d / BD, B), THREADS, smem, st>>>(
        u, dt, bm, cm, a_log, d_skip, h0, dy, dh_last, hs, du, ddt, dh0,
        part_bc, part_a, part_d, S, d, n, bc_vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long total = (long)B * S * RED + (long)d * NMAX + d;
    scan_bwd_reduce_kernel<<<(unsigned)((total + REDUCE_THREADS - 1) /
                                        REDUCE_THREADS),
                             REDUCE_THREADS, 0, st>>>(
        part_bc, part_a, part_d, a_log, dB, dC, dA, dD, B, S, d, n);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_bwd_channels_per_block() { return BD; }
extern "C" int selective_scan_bwd_max_state() { return NMAX; }

extern "C" int selective_scan_bwd_f32_launch(
    const float* u, const float* dt, const float* bm, const float* cm,
    const float* a_log, const float* d_skip, const float* h0,
    const float* dy, const float* dh_last, float* hs, float* du, float* ddt,
    float* dB, float* dC, float* dA, float* dD, float* dh0, float* part_bc,
    float* part_a, float* part_d, int B, int S, int d, int n, void* stream) {
    return launch<float>(u, dt, bm, cm, a_log, d_skip, h0, dy, dh_last, hs,
                         du, ddt, dB, dC, dA, dD, dh0, part_bc, part_a,
                         part_d, B, S, d, n, stream);
}

extern "C" int selective_scan_bwd_bf16_launch(
    const __nv_bfloat16* u, const float* dt, const float* bm,
    const float* cm, const float* a_log, const float* d_skip,
    const float* h0, const __nv_bfloat16* dy, const float* dh_last,
    float* hs, __nv_bfloat16* du, float* ddt, float* dB, float* dC,
    float* dA, float* dD, float* dh0, float* part_bc, float* part_a,
    float* part_d, int B, int S, int d, int n, void* stream) {
    return launch<__nv_bfloat16>(u, dt, bm, cm, a_log, d_skip, h0, dy,
                                 dh_last, hs, du, ddt, dB, dC, dA, dD, dh0,
                                 part_bc, part_a, part_d, B, S, d, n,
                                 stream);
}
