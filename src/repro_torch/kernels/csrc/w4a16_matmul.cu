// y = x @ dequant(W)^T with int4-packed W: the serve-time dense of every
// quantized linear (decode GEMV at m = batch, prefill at m = batch*prompt).
//
// Replaces: src/repro/kernels/w4a16_matmul.py, w4a16_matmul_pallas
// (_w4a16_kernel), reached from models/linear.dense.
//
// Bound on the H100: bytes at decode, operations at prefill. A decode GEMV
// (m 4) reads n*k/2 packed bytes plus the (row, group) scales and zeros and
// does 2*m*n*k FLOP, ~16 FLOP a byte: the packed weight stream sets the
// time, and only enough bytes in flight on every SM reach it. Prefill (m
// 2048) does 512x the work on the same bytes; on bf16 tensor cores (989
// TFLOP/s) it stays operation-bound above m ~ 600.
//
// Exact products on bf16 tensor cores. Every zero of the packed artifact is
// an integer in [0, 15] (asym zeros are rounded and clipped, sym zeros are
// 0 + 8: core/quant.py), so c - z is an integer in [-15, 15], exact in
// bf16, and x * (c - z) is exact in fp32 for bf16 x. The kernel computes
//     y[i, r] = sum_g s[r, g] * ( sum_{k in g} x[i, k] * (c[r, k] - z[r, g]) )
// with the inner sum on mma.sync.m16n8k16 (bf16 in, fp32 accumulate) and,
// after each quant group, s * partial added into a second set of fp32
// accumulators: the reference's sum in another order, with one fp32
// rounding of s per group instead of one per element. (Rounding (c - z)*s
// to bf16, as a bf16 dequantize-then-multiply does, would not hold the
// plain version's one-ulp pin.)
//
// Design. yT tiles = W * xT: the weight tile is the A operand (16 n-rows of
// an MMA), x the B operand (8 x-rows), so m 4 wastes half of the narrow
// side, not 12 of 16 rows. A 32-column k-block gives each of a quad's four
// lanes one 32-bit word of packed codes per row (8 columns) and serves two
// MMA k-steps; the k order inside a step is free as long as A and B use
// the same one, so a lane turns its word into the bf16 pairs (n0,n4),
// (n1,n5), (n2,n6), (n3,n7) with one lop3 each (the codes or'ed into the
// mantissa of 128.0) and one bf16x2 fma that subtracts 128 + z, both exact,
// and permutes its 16 bytes of x to the same pairs with byte_perm.
// Packed weights, x (as bf16, never fp32, so k has no limit) and the
// stage's scales and zeros stream through a cp.async ring of 128-column
// stages; the row strides are padded so that every shared-memory read of a
// warp is free of bank conflicts. Two tile shapes share this code:
// - decode (m <= 64): 64 weight rows x 8 or 16 x-rows a block, four warps
//   of 16 rows, a 4-stage ring; a block streams 4 KB of weights a stage,
//   so where the tiles give the SMs fewer than four blocks each the k
//   range is split over blocks (whole quant groups each,
//   ops.w4a16_matmul_geometry);
// - prefill: 128 weight rows x 64 x-rows a block, four warps of 64 x 32,
//   so each dequantized weight fragment feeds four MMAs and each x
//   fragment four, through a 3-stage ring.
// Split-K is deterministic: each split writes its fp32 partials and a
// second kernel sums them in split order and rounds to bf16; no atomics,
// so two launches are bitwise equal.
//
// fp32 x (the quality checks' fp32 compute) keeps the CUDA-core kernel:
// one warp per weight row, the x tile staged as fp32, FFMA in fp32 with the
// reference's per-element dequantization (its 1e-5 pin).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "smem.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 x: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int KT = 128;            // k columns per pipeline stage
constexpr int W_STRIDE = 80;       // bytes per weight row in a stage (64 + 16)
constexpr int X_STRIDE = 320;      // bytes per x row in a stage (256 + 64)
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t lop3_and_or(uint32_t a, uint32_t b,
                                                uint32_t c) {
    uint32_t r;
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(r) : "r"(a), "r"(b),
        "r"(c));
    return r;
}

// (a * 1 + c) per bf16 half; exact here (integers below 2^8)
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t c) {
    uint32_t r;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a),
        "r"(0x3F803F80u), "r"(c));
    return r;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16x2 bits of -(128 + z), the bias that maps 128 + c to c - z
__device__ __forceinline__ uint32_t neg_bias(float z) {
    const uint32_t h =
        (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(-(128.f + z)));
    return h | (h << 16);
}

// the four bf16 pairs (c_i - z, c_{i+4} - z), i = 0..3, of a packed word
__device__ __forceinline__ void dequant_word(uint32_t q, uint32_t nb,
                                             uint32_t* p) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
        p[i] = bf16x2_add(lop3_and_or(q >> (4 * i), 0x000F000Fu,
                                      0x43004300u), nb);
}

// FN m16 tiles of weight rows x FM m8 tiles of x rows per warp; the block
// is WN x WM warps
template <int FN, int FM, int WN, int WM, int STAGES>
__global__ void __launch_bounds__(THREADS)
w4a16_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ packed,
                 const float* __restrict__ scales,
                 const float* __restrict__ zeros,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                 int m, int n, int k, int group_size, int split_cols) {
    static_assert(WN * WM * 32 == THREADS, "four warps");
    constexpr int BN = 16 * FN * WN, BM = 8 * FM * WM;
    const int gps = group_size < KT ? KT / group_size : 1;
    const int n_groups = k / group_size;
    const int w_bytes = BN * W_STRIDE, x_bytes = BM * X_STRIDE;
    const int sz_bytes = BN * gps * 8;
    const int stage_bytes = w_bytes + x_bytes + sz_bytes;
    extern __shared__ __align__(16) unsigned char smem[];

    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int kb = blockIdx.z * split_cols;
    const int ke = min(k, kb + split_cols);
    const int n_stages = (ke - kb + KT - 1) / KT;
    const int tid = threadIdx.x;
    const long kh = k / 2;

    auto load_stage = [&](int st) {
        unsigned char* base = smem + (st % STAGES) * stage_bytes;
        const int k0 = kb + st * KT;
        // packed weights: BN rows x 4 granules of 32 columns
        for (int e = tid; e < BN * 4; e += THREADS) {
            const int r = e >> 2, i = e & 3;
            const bool ok = n0 + r < n && k0 + 32 * i < ke;
            const uint8_t* src =
                ok ? packed + (long)(n0 + r) * kh + k0 / 2 + 16 * i : packed;
            cp_async16(base + r * W_STRIDE + 16 * i, src, ok ? 16 : 0);
        }
        // x: BM rows x 16 granules of 8 columns (zeros past m and ke)
        unsigned char* xs = base + w_bytes;
        for (int e = tid; e < BM * 16; e += THREADS) {
            const int r = e >> 4, i = e & 15;
            const bool ok = m0 + r < m && k0 + 8 * i < ke;
            const __nv_bfloat16* src =
                ok ? x + (long)(m0 + r) * k + k0 + 8 * i : x;
            cp_async16(xs + r * X_STRIDE + 16 * i, src, ok ? 16 : 0);
        }
        // the stage's groups: scales then zeros, gps a row
        float* sz = reinterpret_cast<float*>(base + w_bytes + x_bytes);
        const int g0 = k0 / group_size;
        for (int e = tid; e < BN * gps; e += THREADS) {
            const int r = e / gps, j = e % gps;
            const bool ok = n0 + r < n && g0 + j < n_groups;
            const long off = ok ? (long)(n0 + r) * n_groups + g0 + j : 0;
            cp_async4(sz + e, scales + off, ok ? 4 : 0);
            cp_async4(sz + BN * gps + e, zeros + off, ok ? 4 : 0);
        }
    };

    const int warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int wr = (warp % WN) * 16 * FN;      // the warp's first weight row
    const int wc = (warp / WN) * 8 * FM;       // the warp's first x row

    float acc[FN][FM][4], out[FN][FM][4];
#pragma unroll
    for (int f = 0; f < FN; ++f)
#pragma unroll
        for (int j = 0; j < FM; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[f][j][c] = out[f][j][c] = 0.f;
    uint32_t nb[FN][2];

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_stages) load_stage(s);
        cp_async_commit();
    }
    for (int st = 0; st < n_stages; ++st) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (st + STAGES - 1 < n_stages) load_stage(st + STAGES - 1);
        cp_async_commit();

        const unsigned char* base = smem + (st % STAGES) * stage_bytes;
        const unsigned char* xs = base + w_bytes;
        const float* ss =
            reinterpret_cast<const float*>(base + w_bytes + x_bytes);
        const float* zs = ss + BN * gps;
        const int k0 = kb + st * KT;
#pragma unroll
        for (int b = 0; b < KT / 32; ++b) {
            const int kc = k0 + 32 * b;
            if (kc >= ke) break;
            const int lg = (32 * b) / group_size;   // group within the stage
            if (b == 0 || kc % group_size == 0) {
#pragma unroll
                for (int f = 0; f < FN; ++f)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        nb[f][h] = neg_bias(
                            zs[(wr + 16 * f + gq + 8 * h) * gps + lg]);
            }
            // B fragments of both k-steps: this lane's 8 columns of x
            uint32_t bfr[FM][4];
#pragma unroll
            for (int j = 0; j < FM; ++j) {
                const uint4 v = *reinterpret_cast<const uint4*>(
                    xs + (wc + 8 * j + gq) * X_STRIDE + 64 * b + 16 * tq);
                bfr[j][0] = __byte_perm(v.x, v.z, 0x5410);   // (x0, x4)
                bfr[j][1] = __byte_perm(v.x, v.z, 0x7632);   // (x1, x5)
                bfr[j][2] = __byte_perm(v.y, v.w, 0x5410);   // (x2, x6)
                bfr[j][3] = __byte_perm(v.y, v.w, 0x7632);   // (x3, x7)
            }
#pragma unroll
            for (int f = 0; f < FN; ++f) {
                uint32_t p[2][4];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const uint32_t q = *reinterpret_cast<const uint32_t*>(
                        base + (wr + 16 * f + gq + 8 * h) * W_STRIDE
                        + 16 * b + 4 * tq);
                    dequant_word(q, nb[f][h], p[h]);
                }
                // k-step 0: columns (c0,c4) and (c1,c5); 1: (c2,c6), (c3,c7)
                const uint32_t a0[4] = {p[0][0], p[1][0], p[0][1], p[1][1]};
                const uint32_t a1[4] = {p[0][2], p[1][2], p[0][3], p[1][3]};
#pragma unroll
                for (int j = 0; j < FM; ++j) {
                    mma_bf16(acc[f][j], a0, bfr[j][0], bfr[j][1]);
                    mma_bf16(acc[f][j], a1, bfr[j][2], bfr[j][3]);
                }
            }
            if ((kc + 32) % group_size == 0) {      // the group ends here
#pragma unroll
                for (int f = 0; f < FN; ++f) {
                    const float s0 = ss[(wr + 16 * f + gq) * gps + lg];
                    const float s1 = ss[(wr + 16 * f + gq + 8) * gps + lg];
#pragma unroll
                    for (int j = 0; j < FM; ++j) {
                        out[f][j][0] = fmaf(s0, acc[f][j][0], out[f][j][0]);
                        out[f][j][1] = fmaf(s0, acc[f][j][1], out[f][j][1]);
                        out[f][j][2] = fmaf(s1, acc[f][j][2], out[f][j][2]);
                        out[f][j][3] = fmaf(s1, acc[f][j][3], out[f][j][3]);
#pragma unroll
                        for (int c = 0; c < 4; ++c) acc[f][j][c] = 0.f;
                    }
                }
            }
        }
    }
    cp_async_wait<0>();

    // C fragment: c0, c1 at (weight row gq, x rows 2tq, 2tq+1); c2, c3 at
    // weight row gq + 8
#pragma unroll
    for (int f = 0; f < FN; ++f)
#pragma unroll
        for (int j = 0; j < FM; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int r = n0 + wr + 16 * f + gq + 8 * (c >> 1);
                const int i = m0 + wc + 8 * j + 2 * tq + (c & 1);
                if (r < n && i < m) {
                    if (part)
                        part[((long)blockIdx.z * m + i) * n + r] =
                            out[f][j][c];
                    else
                        y[(long)i * n + r] = __float2bfloat16_rn(out[f][j][c]);
                }
            }
}

// y = bf16(sum over the splits, in split order)
__global__ void __launch_bounds__(256)
w4a16_split_reduce(const float* __restrict__ part,
                   __nv_bfloat16* __restrict__ y, long count, int splits) {
    for (long e = blockIdx.x * 256L + threadIdx.x; e < count;
         e += (long)gridDim.x * 256) {
        float v = part[e];
        for (int s = 1; s < splits; ++s) v += part[(long)s * count + e];
        y[e] = __float2bfloat16_rn(v);
    }
}

template <int FN, int FM, int WN, int WM, int STAGES>
int launch_mma(const __nv_bfloat16* x, const uint8_t* packed,
               const float* scales, const float* zeros, __nv_bfloat16* y,
               float* part, int m, int n, int k, int group_size, int splits,
               int split_cols, cudaStream_t stream) {
    constexpr int BN = 16 * FN * WN, BM = 8 * FM * WM;
    constexpr auto kernel = &w4a16_mma_kernel<FN, FM, WN, WM, STAGES>;
    const int gps = group_size < KT ? KT / group_size : 1;
    const size_t smem =
        (size_t)STAGES * (BN * W_STRIDE + BM * X_STRIDE + BN * gps * 8);
    const int limit = grant_max_dynamic_smem<kernel>();
    if (limit < 0) return smem_grant_error();
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
    kernel<<<grid, THREADS, smem, stream>>>(
        x, packed, scales, zeros, y, splits > 1 ? part : nullptr, m, n, k,
        group_size, split_cols);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    const long count = (long)m * n;
    const long want = (count + 255) / 256;
    const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
    w4a16_split_reduce<<<blocks, 256, 0, stream>>>(part, y, count, splits);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 x: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int MT = 4;          // x rows per tile
constexpr int ROWS = 8;        // weight rows (warps) per block

__global__ void __launch_bounds__(256)
w4a16_f32_kernel(const float* __restrict__ x,
                 const uint8_t* __restrict__ packed,
                 const float* __restrict__ scales,
                 const float* __restrict__ zeros, float* __restrict__ y,
                 int m, int n, int k, int group_size) {
    // [MT][k + k/32]: one pad float after every 32 columns, so the 32
    // lanes (32 columns apart) read 32 different banks
    extern __shared__ float xs[];
    const int kp = k + k / 32;
    const int m0 = blockIdx.y * MT;
    const int mt = min(MT, m - m0);
    for (int e = threadIdx.x; e < mt * k; e += blockDim.x) {
        const int i = e / k, c = e % k;
        xs[i * kp + c + (c >> 5)] = x[(long)m0 * k + e];
    }
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int row = blockIdx.x * ROWS + warp;
    if (row >= n) return;
    const int kh = k / 2;
    const int n_groups = k / group_size;
    const uint8_t* prow = packed + (long)row * kh;
    const float* srow = scales + (long)row * n_groups;
    const float* zrow = zeros + (long)row * n_groups;
    float acc[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[i] = 0.f;

    for (int b0 = lane * 16; b0 < kh; b0 += 32 * 16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(prow + b0);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi) {
#pragma unroll
            for (int bi = 0; bi < 4; ++bi) {
                const uint32_t byte = (words[wi] >> (8 * bi)) & 0xFFu;
                const int c = 2 * (b0 + wi * 4 + bi);     // even column
                const int cs = c + (c >> 5);             // c, c+1 same pad
                const int g = c / group_size;            // c, c+1 share it
                const float s = srow[g], z = zrow[g];
                const float w_lo = ((float)(byte & 0xFu) - z) * s;
                const float w_hi = ((float)(byte >> 4) - z) * s;
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    if (i < mt) {
                        acc[i] = fmaf(xs[i * kp + cs], w_lo, acc[i]);
                        acc[i] = fmaf(xs[i * kp + cs + 1], w_hi, acc[i]);
                    }
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        float v = acc[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && i < mt) y[(long)(m0 + i) * n + row] = v;
    }
}

}  // namespace

// x (m, k) f32; k <= 8192 (the x tile is staged whole in shared memory)
extern "C" int w4a16_matmul_f32_launch(const float* x, const uint8_t* packed,
                                       const float* scales,
                                       const float* zeros, float* y, int m,
                                       int n, int k, int group_size,
                                       void* stream) {
    const size_t smem = sizeof(float) * MT * (size_t)(k + k / 32);
    if (grant_max_dynamic_smem<w4a16_f32_kernel>() < 0)
        return smem_grant_error();
    dim3 grid((n + ROWS - 1) / ROWS, (m + MT - 1) / MT);
    w4a16_f32_kernel<<<grid, 32 * ROWS, smem, (cudaStream_t)stream>>>(
        x, packed, scales, zeros, y, m, n, k, group_size);
    return (int)cudaGetLastError();
}

// x (m, k) bf16; group_size a multiple of 32 that divides 128 or that 128
// divides; k a multiple of group_size. tile_m is the x rows of a block
// (8 or 16: the decode tiles of 64 weight rows; 64: the prefill tile of
// 128 weight rows); splits blocks share the k range, split_cols columns (whole
// groups) each, and write fp32 partials (splits, m, n) to part (unused when
// splits is 1), summed in split order by a second kernel.
extern "C" int w4a16_matmul_bf16_launch(const __nv_bfloat16* x,
                                        const uint8_t* packed,
                                        const float* scales,
                                        const float* zeros, __nv_bfloat16* y,
                                        float* part, int m, int n, int k,
                                        int group_size, int tile_m,
                                        int splits, int split_cols,
                                        void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (group_size % 32 || (group_size < KT ? KT % group_size
                                            : group_size % KT) ||
        k % group_size || split_cols % group_size || splits < 1 ||
        (long)split_cols * (splits - 1) >= k)
        return (int)cudaErrorInvalidValue;
    switch (tile_m) {
    case 8:
        return launch_mma<1, 1, 4, 1, 4>(x, packed, scales, zeros, y, part,
                                         m, n, k, group_size, splits,
                                         split_cols, s);
    case 16:
        return launch_mma<1, 2, 4, 1, 4>(x, packed, scales, zeros, y, part,
                                         m, n, k, group_size, splits,
                                         split_cols, s);
    case 64:
        return launch_mma<4, 4, 2, 2, 3>(x, packed, scales, zeros, y, part,
                                         m, n, k, group_size, splits,
                                         split_cols, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
