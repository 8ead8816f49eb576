// y = x @ dequant(W)^T with int4-packed W: the serve-time dense of every
// quantized linear (decode GEMV at m = batch, prefill at m = batch*prompt).
//
// Replaces: src/repro/kernels/w4a16_matmul.py, w4a16_matmul_pallas
// (_w4a16_kernel), reached from models/linear.dense.
//
// Bound on the H100: bytes at decode. A GEMV reads n*k/2 packed bytes plus
// the (row, group) scales and zeros and does 2*m*n*k FLOP: at m = 4 that is
// ~16 FLOP per byte, under the fp32 ridge, so the packed weight stream sets
// the time. Prefill at m = 64 does 16x more work on the same bytes and
// turns operation-bound on the CUDA cores.
//
// Design: one warp per weight row, eight rows per 256-thread block, and a
// tile of up to MT = 4 rows of x staged in shared memory as fp32 (grid.y
// walks the m tiles). Each lane reads 16 contiguous packed bytes at a time
// (a coalesced 512-byte warp load), unpacks the 32 nibbles (low nibble =
// even column), dequantizes (code - z) * s in fp32 with its (row, group)
// scale and zero exactly as the reference does, and accumulates the
// products with FFMA. The warp then reduces over k with shuffles and
// rounds the fp32 sum to x's dtype (round-to-nearest-even for bf16).
// Tensor cores would round the dequantized weight to bf16 and leave the
// reference's fp32 arithmetic; that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int MT = 4;          // x rows per tile
constexpr int ROWS = 8;        // weight rows (warps) per block

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(256)
w4a16_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
             const float* __restrict__ scales,
             const float* __restrict__ zeros, T* __restrict__ y,
             int m, int n, int k, int group_size) {
    // [MT][k + k/32]: one pad float after every 32 columns, so the 32
    // lanes (32 columns apart) read 32 different banks
    extern __shared__ float xs[];
    const int kp = k + k / 32;
    const int m0 = blockIdx.y * MT;
    const int mt = min(MT, m - m0);
    for (int e = threadIdx.x; e < mt * k; e += blockDim.x) {
        const int i = e / k, c = e % k;
        xs[i * kp + c + (c >> 5)] = load_x(x + (long)m0 * k + e);
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
        if (lane == 0 && i < mt) store_y(y + (long)(m0 + i) * n + row, v);
    }
}

template <typename T>
int launch(const T* x, const uint8_t* packed, const float* scales,
           const float* zeros, T* y, int m, int n, int k, int group_size,
           void* stream) {
    const size_t smem = sizeof(float) * MT * (size_t)(k + k / 32);
    if (grant_max_dynamic_smem<w4a16_kernel<T>>() < 0)
        return smem_grant_error();
    dim3 grid((n + ROWS - 1) / ROWS, (m + MT - 1) / MT);
    w4a16_kernel<T><<<grid, 32 * ROWS, smem, (cudaStream_t)stream>>>(
        x, packed, scales, zeros, y, m, n, k, group_size);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int w4a16_matmul_f32_launch(const float* x, const uint8_t* packed,
                                       const float* scales,
                                       const float* zeros, float* y, int m,
                                       int n, int k, int group_size,
                                       void* stream) {
    return launch<float>(x, packed, scales, zeros, y, m, n, k, group_size,
                         stream);
}

extern "C" int w4a16_matmul_bf16_launch(const __nv_bfloat16* x,
                                        const uint8_t* packed,
                                        const float* scales,
                                        const float* zeros, __nv_bfloat16* y,
                                        int m, int n, int k, int group_size,
                                        void* stream) {
    return launch<__nv_bfloat16>(x, packed, scales, zeros, y, m, n, k,
                                 group_size, stream);
}
