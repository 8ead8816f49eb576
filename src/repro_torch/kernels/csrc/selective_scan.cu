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
// Bound on the H100: bytes. Per (batch, step, channel) u and y (2 bytes
// each in bf16) and dt (4) move, against ~7 operations for each of the n
// states; at the prefill shape (B 4, S 512, d 8192, n 16) that is ~139 MB
// (0.042 ms at 3.35 TB/s) against ~1.9 GFLOP (0.028 ms at 67 TFLOP/s).
// An accurate expf costs about ten instructions and its exp2 runs on the
// quarter-rate special-function unit, so the instruction count, not the
// bytes, sets a floor near 0.1 ms at that shape.
//
// Design: the TPU kernel's sequential time axis becomes a loop inside the
// block. Grid (d / BD, B): each block owns BD channels of one batch row,
// one thread per channel, and the thread keeps its channel's NMAX states
// and -exp(a_log) in registers for the whole sequence. Time tiles of TS
// steps of u and dt (BD wide; neighbouring threads read neighbouring
// channels, so the loads are coalesced) and of B and C (n wide, read by
// every thread as a broadcast) are staged through shared memory. States
// beyond n start at 0 with A = 0 and B = C = 0, so they stay 0 and add
// exactly 0 to y: one kernel serves every n <= NMAX. Any S >= 1: the last
// tile is ragged and masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BD = 64;       // channels per block, one thread each
constexpr int TS = 32;       // time steps per shared-memory tile
constexpr int NMAX = 16;     // states per channel held in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);                 // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(BD)
selective_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a_log,
                      const float* __restrict__ d_skip,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ h_last, int S, int d, int n) {
    __shared__ float s_u[TS][BD];
    __shared__ float s_dt[TS][BD];
    __shared__ float s_b[TS][NMAX];
    __shared__ float s_c[TS][NMAX];
    const int tid = threadIdx.x;
    const int c = blockIdx.x * BD + tid;
    const long row0 = (long)blockIdx.y * S;          // (batch, t = 0)
    const long hbase = ((long)blockIdx.y * d + c) * n;
    float A[NMAX], h[NMAX];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
        A[j] = j < n ? -expf(a_log[(long)c * n + j]) : 0.f;
        h[j] = j < n ? h0[hbase + j] : 0.f;
    }
    const float dsk = d_skip[c];

    for (int t0 = 0; t0 < S; t0 += TS) {
        const int steps = min(TS, S - t0);
#pragma unroll 8
        for (int i = 0; i < steps; ++i) {
            const long off = (row0 + t0 + i) * d + c;
            s_u[i][tid] = to_f32(u[off]);
            s_dt[i][tid] = dt[off];
        }
        for (int e = tid; e < TS * NMAX; e += BD) {
            const int i = e / NMAX, j = e % NMAX;
            const bool ok = i < steps && j < n;
            const long off = (row0 + t0 + i) * n + j;
            s_b[i][j] = ok ? bm[off] : 0.f;
            s_c[i][j] = ok ? cm[off] : 0.f;
        }
        __syncthreads();
        for (int i = 0; i < steps; ++i) {
            const float dtv = s_dt[i][tid], uv = s_u[i][tid];
            const float du = dtv * uv;
            float acc = 0.f;
#pragma unroll
            for (int j = 0; j < NMAX; ++j) {
                const float a = expf(dtv * A[j]);
                h[j] = a * h[j] + du * s_b[i][j];
                acc = acc + h[j] * s_c[i][j];
            }
            store(y + (row0 + t0 + i) * d + c, acc + uv * dsk);
        }
        __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
        if (j < n) h_last[hbase + j] = h[j];
}

template <typename T>
int launch(const T* u, const float* dt, const float* bm, const float* cm,
           const float* a_log, const float* d_skip, const float* h0, T* y,
           float* h_last, int B, int S, int d, int n, void* stream) {
    if (B < 1 || S < 1 || d < BD || d % BD != 0 || n < 1 || n > NMAX ||
        B > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid(d / BD, B);
    selective_scan_kernel<T><<<grid, BD, 0, (cudaStream_t)stream>>>(
        u, dt, bm, cm, a_log, d_skip, h0, y, h_last, S, d, n);
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
