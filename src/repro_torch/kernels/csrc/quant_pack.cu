// Quantize onto a fixed asymmetric 4-bit grid and pack two codes to a byte:
// the int4 serving artifact of every quantized linear (pack_for_serving).
//
// Replaces: src/repro/kernels/quant_pack.py, quant_pack_pallas
// (_quant_pack_kernel).
//
// Bound on the H100: bytes. Each weight is read once (4 bytes in fp32, 2 in
// bf16) and leaves as half a byte, with one scale and zero per (row, group);
// the handful of operations per weight are far under the ridge.
//
// Design: the threads walk the flattened (row, 8-column span) index, so
// short rows (32 spans at k 256) fill every block as long ones do. A
// thread takes one span at a time: one 16-byte load (bf16) or two (fp32),
// the (row, group) scale and zero (once when the 8 columns share a group),
// code = clamp(rint(w / s) + z, 0, 15) with IEEE division and
// round-half-to-even (no fast math: the result is bitwise the plain
// version's), and one 4-byte store of the four packed bytes, the even
// column in the low nibble. Neighbouring threads take neighbouring spans,
// so loads and stores are coalesced across row ends. The grid is sized to
// the card (every SM full), each thread striding over the spans, and no
// larger than the spans.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&w)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        w[2 * i] = __uint_as_float(words[i] << 16);
        w[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_pack_kernel(const T* __restrict__ w, const float* __restrict__ scales,
                  const float* __restrict__ zeros, uint32_t* __restrict__ out,
                  int spans, int k, int group_size) {
    const int per_row = k / 8;
    const int n_groups = k / group_size;
    // one (scale, zero) for all 8 columns unless a group boundary falls
    // inside them
    const bool shared = group_size % 8 == 0;
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < spans;
         i += gridDim.x * THREADS) {
        const int row = i / per_row, c0 = 8 * (i - row * per_row);
        const long gbase = (long)row * n_groups;
        float v[8];
        load8(w + (long)row * k + c0, v);
        float s = 0.f, z = 0.f;
        if (shared) {
            s = scales[gbase + c0 / group_size];
            z = zeros[gbase + c0 / group_size];
        }
        uint32_t packed = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (!shared) {
                s = scales[gbase + (c0 + j) / group_size];
                z = zeros[gbase + (c0 + j) / group_size];
            }
            float q = rintf(__fdiv_rn(v[j], s)) + z;
            q = fminf(fmaxf(q, 0.f), 15.f);
            packed |= (uint32_t)q << (4 * j);
        }
        out[i] = packed;
    }
}

// resident blocks of THREADS an SM (2048 threads) times the H100's SMs
constexpr int MAX_BLOCKS = 132 * (2048 / THREADS);

template <typename T>
int launch(const T* w, const float* scales, const float* zeros,
           uint8_t* out, int n, int k, int group_size, void* stream) {
    if (k % 8 != 0 || group_size < 1 || k % group_size != 0 ||
        (long)n * (k / 8) > 0x7fffffffL)
        return (int)cudaErrorInvalidValue;
    if (n == 0 || k == 0) return (int)cudaSuccess;
    const int spans = n * (k / 8);
    const int need = (spans + THREADS - 1) / THREADS;
    const int blocks = need < MAX_BLOCKS ? need : MAX_BLOCKS;
    quant_pack_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        w, scales, zeros, reinterpret_cast<uint32_t*>(out), spans, k,
        group_size);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int quant_pack_f32_launch(const float* w, const float* scales,
                                     const float* zeros, uint8_t* out, int n,
                                     int k, int group_size, void* stream) {
    return launch<float>(w, scales, zeros, out, n, k, group_size, stream);
}

extern "C" int quant_pack_bf16_launch(const __nv_bfloat16* w,
                                      const float* scales,
                                      const float* zeros, uint8_t* out,
                                      int n, int k, int group_size,
                                      void* stream) {
    return launch<__nv_bfloat16>(w, scales, zeros, out, n, k, group_size,
                                 stream);
}
