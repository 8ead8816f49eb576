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
// with the inner sum on mma.sync (bf16 in, fp32 accumulate) and, after each
// quant group, s * partial added into a second set of fp32 accumulators:
// the reference's sum in another order, with one fp32 rounding of s per
// group instead of one per element. (Rounding (c - z)*s to bf16, as a bf16
// dequantize-then-multiply does, would not hold the plain version's one-ulp
// pin.)
//
// Design. yT tiles = W * xT: the weight tile is the A operand (16 n-rows of
// an MMA), x the B operand (8 x-rows), so m 4 wastes half of the narrow
// side, not 12 of 16 rows. A 32-column k-block gives each of a quad's four
// lanes one 32-bit word of packed codes per row (8 columns) and serves two
// m16n8k16 k-steps; the k order inside a step is free as long as A and B
// use the same one, so a lane turns its word into the bf16 pairs (n0,n4),
// (n1,n5), (n2,n6), (n3,n7) with one lop3 each (the codes or'ed into the
// mantissa of 128.0) and one bf16x2 fma that subtracts 128 + z, both exact,
// and permutes its 16 bytes of x to the same pairs with byte_perm. Such a
// step mixes the columns of the whole 32-column block, so the per-group
// flush needs groups of 32 columns or more. Groups of 8 and 16 take
// m16n8k8 steps instead, one 8-column word each: lane t of a quad takes
// the pair (n_t, n_t+4) of every word of the block (the same lop3 and fma,
// shifted by 4t) and the x pair of the same two columns, so a step holds
// exactly one 8-column group and the flush follows every step (group 8) or
// every second one (group 16).
// Packed weights, x (as bf16, never fp32, so k has no limit) and the
// stage's scales and zeros stream through a cp.async ring of 128-column
// stages; the row strides are padded so that every shared-memory read of a
// warp is free of bank conflicts. Two tile shapes share this code:
// - decode (m <= 64): 64 weight rows x 8 or 16 x-rows a block, four warps
//   of 16 rows, a 4-stage ring; a block streams 4 KB of weights a stage,
//   so where the tiles give the SMs fewer than four blocks each the k
//   range is split over blocks (whole quant groups and 32-column blocks
//   each, ops.w4a16_matmul_geometry);
// - prefill: 128 weight rows x 64 x-rows a block, four warps of 64 x 32,
//   so each dequantized weight fragment feeds four MMAs and each x
//   fragment four, through a 3-stage ring.
// Split-K is deterministic: each split writes its fp32 partials and a
// second kernel sums them in split order and rounds to bf16; no atomics,
// so two launches are bitwise equal.
//
// The CUDA-core kernel serves fp32 x (the quality checks' fp32 compute) and
// bf16 x at the even group sizes the tensor-core kernel does not take (not
// a multiple of 8 that divides 128, nor a multiple of 128): one warp per
// weight row, x staged as fp32 in chunks of up to 8192 columns (any k),
// FFMA in fp32 with the reference's per-element dequantization (its 1e-5
// pin), the output rounded to x's dtype.
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

// one 8-column step (groups of 8 and 16): A rows (gq, gq + 8) x k-slots
// (2tq, 2tq + 1), B k-slots (2tq, 2tq + 1) x column gq
__device__ __forceinline__ void mma_bf16_k8(float* c, uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(b0));
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

__device__ __forceinline__ uint32_t word_of(const uint4& v, int w) {
    return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// One 32-column block b of a stage at group size SG (8 or 16): four
// m16n8k8 steps, one 8-column word each. Lane tq holds columns (tq, tq + 4)
// of every word: of the weights the nibbles tq and tq + 4 (the 16 bytes of
// a row, shifted by 4 tq), of x the two bf16 values picked from the word's
// 16 bytes. A step then holds exactly one group of 8.
template <int FN, int FM, int SG>
__device__ __forceinline__ void small_group_block(
        const unsigned char* base, const unsigned char* xs, const float* ss,
        const float* zs, int szs, int b, int wr, int wc, int gq, int tq,
        float (&acc)[FN][FM][4], float (&out)[FN][FM][4]) {
    static_assert(SG == 8 || SG == 16, "groups of 8 or 16");
    uint32_t bfr[FM][4];
#pragma unroll
    for (int j = 0; j < FM; ++j)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                xs + (wc + 8 * j + gq) * X_STRIDE + 64 * b + 16 * w);
            // the bf16 pairs holding columns tq and tq + 4, then the
            // lane's half of each: (x_tq, x_tq+4)
            const uint32_t lo = (tq & 2) ? v.y : v.x;
            const uint32_t hi = (tq & 2) ? v.w : v.z;
            bfr[j][w] = __byte_perm(lo, hi, (tq & 1) ? 0x7632 : 0x5410);
        }
#pragma unroll
    for (int f = 0; f < FN; ++f) {
        const int r0 = wr + 16 * f + gq;          // rows r0 and r0 + 8
        uint4 q[2];
        uint32_t nb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
            q[h] = *reinterpret_cast<const uint4*>(
                base + (r0 + 8 * h) * W_STRIDE + 16 * b);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const int lg = (32 * b + 8 * w) / SG;   // group within the stage
            uint32_t a[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if ((8 * w) % SG == 0)
                    nb[h] = neg_bias(zs[(r0 + 8 * h) * szs + lg]);
                a[h] = bf16x2_add(lop3_and_or(word_of(q[h], w) >> (4 * tq),
                                              0x000F000Fu, 0x43004300u),
                                  nb[h]);
            }
#pragma unroll
            for (int j = 0; j < FM; ++j)
                mma_bf16_k8(acc[f][j], a[0], a[1], bfr[j][w]);
            if ((8 * w + 8) % SG == 0) {          // the group ends here
                const float s0 = ss[r0 * szs + lg];
                const float s1 = ss[(r0 + 8) * szs + lg];
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

// One 32-column block b of a stage (global column kc) at a group size of 32
// or more: two m16n8k16 steps over the lane's word of 8 columns, paired
// (c_i, c_i+4); the flush at a group's last block.
template <int FN, int FM>
__device__ __forceinline__ void large_group_block(
        const unsigned char* base, const unsigned char* xs, const float* ss,
        const float* zs, int szs, int b, int kc, int group_size, int wr,
        int wc, int gq, int tq, uint32_t (&nb)[FN][2],
        float (&acc)[FN][FM][4], float (&out)[FN][FM][4]) {
    const int lg = (32 * b) / group_size;   // group within the stage
    if (b == 0 || kc % group_size == 0) {
#pragma unroll
        for (int f = 0; f < FN; ++f)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                nb[f][h] = neg_bias(zs[(wr + 16 * f + gq + 8 * h) * szs + lg]);
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
                base + (wr + 16 * f + gq + 8 * h) * W_STRIDE + 16 * b
                + 4 * tq);
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
            const float s0 = ss[(wr + 16 * f + gq) * szs + lg];
            const float s1 = ss[(wr + 16 * f + gq + 8) * szs + lg];
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

// FN m16 tiles of weight rows x FM m8 tiles of x rows per warp; the block
// is WN x WM warps. SG 0: groups of 32 or more (m16n8k16 steps); SG 8 or
// 16: that group size (m16n8k8 steps, one 8-column word each)
template <int FN, int FM, int WN, int WM, int STAGES, int SG>
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
    // a row's scales (then zeros) in a stage: odd at small groups, so that
    // the eight rows a warp reads at once fall in different banks
    const int szs = SG ? gps + 1 : gps;
    const int n_groups = k / group_size;
    const int w_bytes = BN * W_STRIDE, x_bytes = BM * X_STRIDE;
    const int sz_bytes = BN * szs * 8;
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
            cp_async4(sz + r * szs + j, scales + off, ok ? 4 : 0);
            cp_async4(sz + BN * szs + r * szs + j, zeros + off, ok ? 4 : 0);
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
    uint32_t nb[FN][2];      // the current group's zero bias, per row

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
        const float* zs = ss + BN * szs;
        const int k0 = kb + st * KT;
#pragma unroll
        for (int b = 0; b < KT / 32; ++b) {
            const int kc = k0 + 32 * b;
            if (kc >= ke) break;
            if constexpr (SG != 0) {
                small_group_block<FN, FM, SG>(base, xs, ss, zs, szs, b, wr,
                                              wc, gq, tq, acc, out);
            } else {
                large_group_block<FN, FM>(base, xs, ss, zs, szs, b, kc,
                                          group_size, wr, wc, gq, tq, nb,
                                          acc, out);
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

template <int FN, int FM, int WN, int WM, int STAGES, int SG>
int launch_mma(const __nv_bfloat16* x, const uint8_t* packed,
               const float* scales, const float* zeros, __nv_bfloat16* y,
               float* part, int m, int n, int k, int group_size, int splits,
               int split_cols, cudaStream_t stream) {
    constexpr int BN = 16 * FN * WN, BM = 8 * FM * WM;
    constexpr auto kernel = &w4a16_mma_kernel<FN, FM, WN, WM, STAGES, SG>;
    const int gps = group_size < KT ? KT / group_size : 1;
    const int szs = SG ? gps + 1 : gps;
    const size_t smem =
        (size_t)STAGES * (BN * W_STRIDE + BM * X_STRIDE + BN * szs * 8);
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

// one tile shape at the kernel variant of the group size
template <int FN, int FM, int WN, int WM, int STAGES>
int launch_tile(const __nv_bfloat16* x, const uint8_t* packed,
                const float* scales, const float* zeros, __nv_bfloat16* y,
                float* part, int m, int n, int k, int group_size, int splits,
                int split_cols, cudaStream_t stream) {
    switch (group_size) {
    case 8:
        return launch_mma<FN, FM, WN, WM, STAGES, 8>(
            x, packed, scales, zeros, y, part, m, n, k, group_size, splits,
            split_cols, stream);
    case 16:
        return launch_mma<FN, FM, WN, WM, STAGES, 16>(
            x, packed, scales, zeros, y, part, m, n, k, group_size, splits,
            split_cols, stream);
    default:
        return launch_mma<FN, FM, WN, WM, STAGES, 0>(
            x, packed, scales, zeros, y, part, m, n, k, group_size, splits,
            split_cols, stream);
    }
}

// ---------------------------------------------------------------------------
// CUDA-core kernel: fp32 x, and bf16 x at the other even group sizes
// ---------------------------------------------------------------------------

constexpr int MT = 4;          // x rows per tile
constexpr int ROWS = 8;        // weight rows (warps) per block
constexpr int KC = 8192;       // x columns staged in shared memory at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(256)
w4a16_cc_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                const float* __restrict__ scales,
                const float* __restrict__ zeros, T* __restrict__ y, int m,
                int n, int k, int group_size) {
    // [MT][kc + kc/32]: one pad float after every 32 columns, so the 32
    // lanes (32 columns apart) read 32 different banks. A chunk of 8192
    // columns is 4096 bytes, a whole number of the warp's 512-byte sweeps,
    // so each lane visits its bytes in the order of an unchunked sweep.
    extern __shared__ float xs[];
    const int kc = min(k, KC);
    const int kp = kc + kc / 32;
    const int m0 = blockIdx.y * MT;
    const int mt = min(MT, m - m0);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int row = blockIdx.x * ROWS + warp;
    const int kh = k / 2;
    const int n_groups = k / group_size;
    const uint8_t* prow = packed + (long)row * kh;
    const float* srow = scales + (long)row * n_groups;
    const float* zrow = zeros + (long)row * n_groups;
    float acc[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[i] = 0.f;

    for (int c0 = 0; c0 < k; c0 += kc) {
        const int w = min(kc, k - c0);
        if (c0 > 0) __syncthreads();      // every warp is done with the last
        for (int e = threadIdx.x; e < mt * w; e += blockDim.x) {
            const int i = e / w, c = e % w;
            xs[i * kp + c + (c >> 5)] = to_f32(x[(long)(m0 + i) * k + c0 + c]);
        }
        __syncthreads();
        if (row >= n) continue;
        for (int b0 = c0 / 2 + lane * 16; b0 < (c0 + w) / 2; b0 += 32 * 16) {
            const uint4 raw = *reinterpret_cast<const uint4*>(prow + b0);
            const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int wi = 0; wi < 4; ++wi) {
#pragma unroll
                for (int bi = 0; bi < 4; ++bi) {
                    const uint32_t byte = (words[wi] >> (8 * bi)) & 0xFFu;
                    const int c = 2 * (b0 + wi * 4 + bi);     // even column
                    const int cl = c - c0;
                    const int cs = cl + (cl >> 5);           // c, c+1 same pad
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
    }
    if (row >= n) return;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        float v = acc[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && i < mt) store_y(y + (long)(m0 + i) * n + row, v);
    }
}

template <typename T>
int launch_cc(const T* x, const uint8_t* packed, const float* scales,
              const float* zeros, T* y, int m, int n, int k, int group_size,
              void* stream) {
    if (k % 32 || group_size % 2 || k % group_size)
        return (int)cudaErrorInvalidValue;
    const int kc = k < KC ? k : KC;
    const size_t smem = sizeof(float) * MT * (size_t)(kc + kc / 32);
    const int limit = grant_max_dynamic_smem<w4a16_cc_kernel<T>>();
    if (limit < 0) return smem_grant_error();
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    dim3 grid((n + ROWS - 1) / ROWS, (m + MT - 1) / MT);
    w4a16_cc_kernel<T><<<grid, 32 * ROWS, smem, (cudaStream_t)stream>>>(
        x, packed, scales, zeros, y, m, n, k, group_size);
    return (int)cudaGetLastError();
}

}  // namespace

// x (m, k) f32, any k (a multiple of 32), any even group size dividing k
extern "C" int w4a16_matmul_f32_launch(const float* x, const uint8_t* packed,
                                       const float* scales,
                                       const float* zeros, float* y, int m,
                                       int n, int k, int group_size,
                                       void* stream) {
    return launch_cc<float>(x, packed, scales, zeros, y, m, n, k, group_size,
                            stream);
}

// x (m, k) bf16 on the CUDA cores: the even group sizes the tensor-core
// kernel does not take
extern "C" int w4a16_matmul_bf16_cc_launch(const __nv_bfloat16* x,
                                           const uint8_t* packed,
                                           const float* scales,
                                           const float* zeros,
                                           __nv_bfloat16* y, int m, int n,
                                           int k, int group_size,
                                           void* stream) {
    return launch_cc<__nv_bfloat16>(x, packed, scales, zeros, y, m, n, k,
                                    group_size, stream);
}

// x (m, k) bf16 on the tensor cores; group_size 8, 16, 32, 64 or a multiple
// of 128, dividing k. tile_m is the x rows of a block (8 or 16: the decode
// tiles of 64 weight rows; 64: the prefill tile of 128 weight rows); splits
// blocks share the k range, split_cols columns (whole groups and whole
// 32-column blocks) each, and write fp32 partials (splits, m, n) to part
// (unused when splits is 1), summed in split order by a second kernel.
extern "C" int w4a16_matmul_bf16_launch(const __nv_bfloat16* x,
                                        const uint8_t* packed,
                                        const float* scales,
                                        const float* zeros, __nv_bfloat16* y,
                                        float* part, int m, int n, int k,
                                        int group_size, int tile_m,
                                        int splits, int split_cols,
                                        void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const bool small = group_size == 8 || group_size == 16;
    const bool large = group_size % 32 == 0 &&
                       (group_size < KT ? KT % group_size == 0
                                        : group_size % KT == 0);
    if (!(small || large) || k % group_size || k % 32 ||
        split_cols % group_size || split_cols % 32 || splits < 1 ||
        (long)split_cols * (splits - 1) >= k)
        return (int)cudaErrorInvalidValue;
    switch (tile_m) {
    case 8:
        return launch_tile<1, 1, 4, 1, 4>(x, packed, scales, zeros, y, part,
                                          m, n, k, group_size, splits,
                                          split_cols, s);
    case 16:
        return launch_tile<1, 2, 4, 1, 4>(x, packed, scales, zeros, y, part,
                                          m, n, k, group_size, splits,
                                          split_cols, s);
    case 64:
        return launch_tile<4, 4, 2, 2, 3>(x, packed, scales, zeros, y, part,
                                          m, n, k, group_size, splits,
                                          split_cols, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
