// All Gauss-Seidel rounds of RPIQ stage 2 for a stacked group of linears.
//
// Replaces: src/repro/kernels/rpiq_block.py, rpiq_block_pallas
// (_rpiq_block_kernel, _project), reached from core/rpiq.rpiq_refine_batched.
//
// Bound on the H100: operations. Per round and column block the closed loop
// does three n x bs x bo products (the stale block output X_i B^T, the
// right-hand side X_i^T D_i, the fresh block output X_i B_new^T) and one
// bs x bs x bo solve against the pre-factored H_i^-1, plus a full X W^T per
// round for the projected loss: ~2*n*in*out*(3*T + T + 1) FLOP per member,
// all fp32 FFMA (the reference pins fp32 and the tensor cores take none).
// The n-long contraction in the right-hand side dominates.
//
// Design: grid (B, out/BO) with BO = 16 rows per block (narrow row tiles
// give the main path's groups 48 to 192 blocks for the 132 SMs). Each block
// runs rounds 0..t_max and every column block of its rows in one launch,
// keeping the Pallas kernel's deferred-bookkeeping split: the trajectory
// does not depend on the early stop or the best-candidate choice, so every
// round runs and emits its per-row-tile Gamma and projected-loss partials
// (a (B, tiles, t_max+1) array: no atomics, the host sums them in a fixed
// order) and its projected candidate into wp_all[b, t]; the host replays
// the stop and the strict-improvement choice (ops._rpiq_select). Round 0
// writes Y_q = X W0^T, the Gamma_0 partial and candidate slot 0 = W0.
// The block's working set is the running (n, BO) Y_q slab, one (n, BO)
// buffer (stale block output, then directed residual in place, then fresh
// block output) and the (bs, BO) right-hand side and solution:
// 4*(2*n*BO + 2*bs*BO) bytes, 80 KB at n = 512 and bs = 128. It lives in
// dynamic shared memory whenever it fits (two blocks still fit one SM at
// n = 512); only above that does it go to a per-block global scratch, with
// Y_q in the y_q output. Y_q is written out once at the end. y_orig stays
// in device memory: it is read once per column block.
// Products run as a block-level tiled FFMA GEMM (128 x 16 output tiles,
// 16-deep k slabs in shared memory, a 2 x 4 register tile per thread, each
// sum taken in ascending k).
// Lanes that stopped early still run their remaining rounds (the
// documented trade of the deferred bookkeeping), and wp_all costs
// 4*B*(t_max+1)*out*in bytes.
//
// Numerics: the grid projection divides (w / s) and rounds half to even
// (rintf). This file is compiled with -fmad=false so that the elementwise
// steps (directed residual, damped update, Y_q update) round each product
// and sum like the plain version; the dot products use explicit fmaf.
// Keeping Y_q - y_qi in place of Y_q between the two halves of a column
// block stores the very value the plain version rounds to in
// y_q - y_qi + X_i B_new^T, so the trajectory is unchanged.
#include <cuda_runtime.h>
#include <math.h>

#include "smem.cuh"

namespace {

constexpr int BO = 16;         // rows per block
constexpr int THREADS = 256;
// block_gemm tiles: TN = BO output columns, RM x 4 outputs per thread
constexpr int TN = BO, RM = 2, TM = THREADS / (TN / 4) * RM, KC = 16;

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

// C(m, n) = sum_k A(m, k) * B(k, n) for m < M, n < N, over ascending k.
// Every thread of the block must call it; it ends with a barrier. Output
// tiles of TM x TN; each thread keeps an RM x 4 block of outputs in
// registers and reads RM values of A and a float4 of B from shared memory
// per k step (A is staged k-major, so both reads are contiguous).
__device__ void block_gemm(const float* A, long sam, long sak,
                           const float* B, long sbk, long sbn,
                           float* C, long scm, long scn,
                           int M, int N, int K) {
    __shared__ __align__(16) float As[KC][TM + 4];
    __shared__ __align__(16) float Bs[KC][TN + 4];
    const int tid = threadIdx.x;
    const int tx = tid % (TN / 4), ty = tid / (TN / 4);
    for (int m0 = 0; m0 < M; m0 += TM) {
        for (int n0 = 0; n0 < N; n0 += TN) {
            float acc[RM][4];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
            for (int k0 = 0; k0 < K; k0 += KC) {
                for (int e = tid; e < TM * KC; e += THREADS) {
                    int i, kk;
                    if (sak == 1) { i = e / KC; kk = e % KC; }
                    else { kk = e / TM; i = e % TM; }
                    const int m = m0 + i, k = k0 + kk;
                    As[kk][i] = (m < M && k < K) ? A[m * sam + k * sak] : 0.f;
                }
                for (int e = tid; e < KC * TN; e += THREADS) {
                    int kk, j;
                    if (sbn == 1) { kk = e / TN; j = e % TN; }
                    else { j = e / KC; kk = e % KC; }
                    const int n = n0 + j, k = k0 + kk;
                    Bs[kk][j] = (n < N && k < K) ? B[k * sbk + n * sbn] : 0.f;
                }
                __syncthreads();
                const int kn = min(KC, K - k0);
                for (int kk = 0; kk < kn; ++kk) {
                    const float4 b = *reinterpret_cast<const float4*>(
                        &Bs[kk][tx * 4]);
                    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                    for (int i = 0; i < RM; ++i) {
                        const float av = As[kk][ty * RM + i];
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            acc[i][j] = fmaf(av, bv[j], acc[i][j]);
                    }
                }
                __syncthreads();
            }
#pragma unroll
            for (int i = 0; i < RM; ++i) {
                const int m = m0 + ty * RM + i;
                if (m >= M) continue;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int n = n0 + tx * 4 + j;
                    if (n < N) C[m * scm + n * scn] = acc[i][j];
                }
            }
        }
    }
    __syncthreads();
}

// sum over (m < M, n < BO) of (P[m, n] - Q[m, n])^2, valid in thread 0.
__device__ float block_sq_diff(const float* P, long sp, const float* Q,
                               long sq, int M) {
    __shared__ float red[THREADS / 32];
    float acc = 0.f;
    for (int e = threadIdx.x; e < M * BO; e += THREADS) {
        const int m = e / BO, n = e % BO;
        const float d = P[m * sp + n] - Q[m * sq + n];
        acc += d * d;
    }
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = acc;
    __syncthreads();
    float tot = 0.f;
    if (threadIdx.x == 0)
        for (int w = 0; w < THREADS / 32; ++w) tot += red[w];
    __syncthreads();
    return tot;
}

__global__ void __launch_bounds__(THREADS)
rpiq_block_kernel(const float* __restrict__ w0, const float* __restrict__ yo_all,
                  const float* __restrict__ x_all,
                  const float* __restrict__ hinv_all,
                  const float* __restrict__ s_all,
                  const float* __restrict__ z_all, float* __restrict__ wc_all,
                  float* __restrict__ wp_all, float* __restrict__ yq_all,
                  float* __restrict__ hist, float* __restrict__ pls,
                  float* __restrict__ scratch, int in_smem, int out_dim,
                  int in_dim, int n, int bs, int t_max, float alpha, int bits,
                  int symmetric) {
    extern __shared__ __align__(16) float slab[];
    const int b = blockIdx.x, tile = blockIdx.y, tiles = gridDim.y;
    const int o0 = tile * BO;
    const int tid = threadIdx.x;
    const float qmax = exp2f((float)bits) - 1.f;
    const float half = exp2f((float)(bits - 1));
    const long wofs = ((long)b * out_dim + o0) * in_dim;
    const float* W0 = w0 + wofs;
    const float* S = s_all + wofs;
    const float* Z = z_all + wofs;
    float* Wc = wc_all + wofs;
    const float* X = x_all + (long)b * n * in_dim;
    const float* Yo = yo_all + (long)b * n * out_dim + o0;
    float* Yout = yq_all + (long)b * n * out_dim + o0;
    const float* Hv = hinv_all + (long)b * in_dim * bs;
    const long cand = (long)out_dim * in_dim;
    float* WP = wp_all + (long)b * (t_max + 1) * cand + (long)o0 * in_dim;
    // running Y_q (row stride ldq), the (n, BO) buffer, rhs, B*^T
    float *Yq, *buf;
    long ldq;
    if (in_smem) {
        Yq = slab;
        buf = Yq + (long)n * BO;
        ldq = BO;
    } else {
        Yq = Yout;
        buf = scratch + ((long)b * tiles + tile) * ((long)n * BO + 2L * bs * BO);
        ldq = out_dim;
    }
    float* rhs = buf + (long)n * BO;
    float* bst = rhs + (long)bs * BO;
    float* hrow = hist + ((long)b * tiles + tile) * (t_max + 1);
    float* prow = pls + ((long)b * tiles + tile) * (t_max + 1);

    // round 0: W = W0, candidate slot 0 = W0, Y_q = X W0^T, Gamma_0
    for (long e = tid; e < (long)BO * in_dim; e += THREADS) {
        Wc[e] = W0[e];
        WP[e] = W0[e];
    }
    block_gemm(X, in_dim, 1, W0, 1, in_dim, Yq, ldq, 1, n, BO, in_dim);
    const float g0 = block_sq_diff(Yo, out_dim, Yq, ldq, n);
    if (tid == 0) { hrow[0] = g0; prow[0] = g0; }

    for (int t = 1; t <= t_max; ++t) {
        for (int c1 = 0; c1 < in_dim; c1 += bs) {
            const float* Xi = X + c1;
            // stale block output  y_qi = X_i B_old^T
            block_gemm(Xi, in_dim, 1, Wc + c1, 1, in_dim, buf, BO, 1,
                       n, BO, bs);
            // Y_q <- Y_q - y_qi, directed residual d = y_orig - that
            // (eq. 4/20), written over y_qi
            for (int e = tid; e < n * BO; e += THREADS) {
                const int m = e / BO, o = e % BO;
                const float rest = Yq[(long)m * ldq + o] - buf[e];
                Yq[(long)m * ldq + o] = rest;
                buf[e] = Yo[(long)m * out_dim + o] - rest;
            }
            __syncthreads();
            // rhs = X_i^T d  (bs, BO)
            block_gemm(Xi, 1, in_dim, buf, BO, 1, rhs, BO, 1, bs, BO, n);
            // B*^T = H_i^-1 rhs  (eq. 13-14)
            block_gemm(Hv + (long)c1 * bs, bs, 1, rhs, BO, 1, bst, BO, 1,
                       bs, BO, bs);
            // projection (eq. 7) and damped update (eq. 8)
            for (int e = tid; e < bs * BO; e += THREADS) {
                const int c = e / BO, o = e % BO;
                const long wi = (long)o * in_dim + c1 + c;
                const float bp = project(bst[e], S[wi], Z[wi], qmax, half,
                                         symmetric);
                const float bo = Wc[wi];
                Wc[wi] = bo + alpha * (bp - bo);
            }
            __syncthreads();
            // fresh block output, then y_q = (y_q - y_qi) + X_i B_new^T
            block_gemm(Xi, in_dim, 1, Wc + c1, 1, in_dim, buf, BO, 1,
                       n, BO, bs);
            for (int e = tid; e < n * BO; e += THREADS) {
                const int m = e / BO, o = e % BO;
                Yq[(long)m * ldq + o] += buf[e];
            }
            __syncthreads();
        }
        const float gam = block_sq_diff(Yo, out_dim, Yq, ldq, n);
        if (tid == 0) hrow[t] = gam;
        float* WPt = WP + (long)t * cand;
        for (long e = tid; e < (long)BO * in_dim; e += THREADS)
            WPt[e] = project(Wc[e], S[e], Z[e], qmax, half, symmetric);
        __syncthreads();
        block_gemm(X, in_dim, 1, WPt, 1, in_dim, buf, BO, 1, n, BO, in_dim);
        const float pl = block_sq_diff(Yo, out_dim, buf, BO, n);
        if (tid == 0) prow[t] = pl;
    }
    if (in_smem)
        for (int e = tid; e < n * BO; e += THREADS)
            Yout[(long)(e / BO) * out_dim + e % BO] = Yq[e];
}

size_t slab_bytes(int n, int bs) {
    return sizeof(float) * (2 * (size_t)n * BO + 2 * (size_t)bs * BO);
}

}  // namespace

// Floats of global scratch one block needs: 0 when its working set fits
// shared memory, -1 on a CUDA error.
extern "C" long rpiq_block_scratch_floats(int n, int bs) {
    const int lim = grant_max_dynamic_smem<rpiq_block_kernel>();
    if (lim < 0) return -1;
    if (slab_bytes(n, bs) <= (size_t)lim) return 0;
    return (long)n * BO + 2L * bs * BO;
}

// Shapes: w0/s/z/w_cont (B, out, in), y_orig/y_q (B, n, out), x (B, n, in),
// hinv (B, in, bs), wp_all (B, t_max+1, out, in), hist/pls
// (B, out/16, t_max+1), scratch (B, out/16, rpiq_block_scratch_floats) or
// unused when that is 0; out % 16 == 0.
extern "C" int rpiq_block_launch(const float* w0, const float* y_orig,
                                 const float* x, const float* hinv,
                                 const float* s_full, const float* z_full,
                                 float* w_cont, float* wp_all, float* y_q,
                                 float* hist, float* pls, float* scratch,
                                 int B, int out_dim, int in_dim, int n,
                                 int bs, int t_max, float alpha, int bits,
                                 int symmetric, void* stream) {
    const long need = rpiq_block_scratch_floats(n, bs);
    if (need < 0) return smem_grant_error();
    const int in_smem = need == 0;
    const size_t smem = in_smem ? slab_bytes(n, bs) : 0;
    dim3 grid(B, out_dim / BO);
    rpiq_block_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        w0, y_orig, x, hinv, s_full, z_full, w_cont, wp_all, y_q, hist, pls,
        scratch, in_smem, out_dim, in_dim, n, bs, t_max, alpha, bits,
        symmetric);
    return (int)cudaGetLastError();
}

extern "C" int rpiq_block_rows_per_block() { return BO; }
