// One-token GQA flash-decode against the int8 KV cache: the decode
// attention of every layer when serve.kv_cache = "int8".
//
// Replaces: src/repro/kernels/kv_attention.py, int8_kv_attention_pallas
// (_kv_attn_kernel), reached from models/attention.attention_decode.
//
// Bound on the H100: bytes. The call reads the int8 K and V codes, their
// per-(slot, kv-head, block) f32 scales and kpos once, and does about
// 4*B*KV*R*S*hd FLOP: at R = 2 that is ~2 FLOP per byte, far under the
// ridge, so the cache stream sets the time (B 4, S 4096, KV 8, hd 128:
// ~35 MB, ~10 us at 3.35 TB/s).
//
// Design: one block of 256 threads per (batch, kv-head) cell walks the
// history in tiles of TS = 128 slots. While a tile is computed, the next
// tile's codes, scales and kpos are already on their way into registers
// (16-byte loads; slots past S read as zero codes, zero scales, kpos -1).
// Per tile:
//   1. the registers go to shared memory; a K row is padded by 4 bytes so
//      that the threads reading neighbouring rows hit different banks;
//   2. scores, two threads per slot (each half a row, combined with one
//      shuffle), every query row at once so that each code is converted
//      once; a kv_block segment's sum of q * code is scaled by its block
//      scale; kpos < 0 is masked to -1e30;
//   3. the online softmax, one warp per query row: the running max m,
//      denominator l and rescale factor alpha, with p set back to 0 on
//      masked slots after the exp (a fully masked tile would otherwise
//      add exp(0) = 1 per slot);
//   4. acc = alpha * acc + p @ dequant(V): a thread owns four columns of
//      every query row over one of G interleaved slot groups, and takes
//      p * scale once per slot and row.
// The G partial accumulators are summed in a fixed order at the end and
// the result is acc / max(l, 1e-30), so a lane with no valid slot returns
// 0; it is rounded to q's dtype (round-to-nearest-even for bf16). Codes
// become floats by a byte permute into 2^23 + (code + 128) and one exact
// subtraction: the int-to-float instruction runs at an eighth of the FMA
// rate. expf, and sums that differ from the plain version's only in their
// order and in where the block scale is applied. With B * KV blocks (32 at
// the serving shape) the kernel fills a quarter of the 132 SMs: splitting
// the history across blocks (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TS = 128;                  // history slots per tile
constexpr int SPLIT = THREADS / TS;      // score phase: threads per slot
constexpr int MAX_R = 8;                 // query rows per kv-head
constexpr int MAX_HD = 256;
constexpr int MAX_CHUNKS = TS * MAX_HD / 16 / THREADS;  // 16-byte loads
constexpr int MAX_SCALES = 4;            // per thread and operand
constexpr float NEG = -1e30f;

__device__ __forceinline__ float load_q(const float* p) { return *p; }
__device__ __forceinline__ float load_q(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store_o(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_o(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// The four int8 codes of a word as floats: byte i ^ 0x80 = code + 128 goes
// into the low mantissa of 2^23, and 2^23 + 128 comes off exactly.
__device__ __forceinline__ void codes4(uint32_t word, float (&f)[4]) {
    const uint32_t u = word ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i))
               - 8388736.f;
}

// The next tile's codes, scales and kpos, held in registers.
struct TileRegs {
    uint4 k[MAX_CHUNKS], v[MAX_CHUNKS];
    float ks[MAX_SCALES], vs[MAX_SCALES];
    int kpos;
};

__device__ __forceinline__ void load_tile(
        TileRegs& t, const int8_t* kc, const float* ks, const int8_t* vc,
        const float* vs, const int* kpos, int b, int g, int s0, int S,
        int KV, int hd, int nb) {
    const int tid = threadIdx.x, chunks = hd / 16;
    const long base = ((long)b * S + s0) * KV + g;
#pragma unroll
    for (int i = 0; i < MAX_CHUNKS; ++i) {
        const int c = tid + THREADS * i;
        const int slot = c / chunks, j = c % chunks;
        t.k[i] = t.v[i] = make_uint4(0, 0, 0, 0);
        if (slot < TS && s0 + slot < S) {
            const long off = (base + (long)slot * KV) * hd + 16 * j;
            t.k[i] = *reinterpret_cast<const uint4*>(kc + off);
            t.v[i] = *reinterpret_cast<const uint4*>(vc + off);
        }
    }
#pragma unroll
    for (int i = 0; i < MAX_SCALES; ++i) {
        const int e = tid + THREADS * i;
        const int slot = e / nb, j = e % nb;
        t.ks[i] = t.vs[i] = 0.f;
        if (slot < TS && s0 + slot < S) {
            const long off = (base + (long)slot * KV) * nb + j;
            t.ks[i] = ks[off];
            t.vs[i] = vs[off];
        }
    }
    t.kpos = -1;
    if (tid < TS && s0 + tid < S) t.kpos = kpos[(long)b * S + s0 + tid];
}

// R, the query rows per kv-head, is a template parameter: the per-row
// loops then issue no work for rows that do not exist.
template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
kv_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
               const float* __restrict__ ks, const int8_t* __restrict__ vc,
               const float* __restrict__ vs, const int* __restrict__ kpos,
               T* __restrict__ out, int S, int KV, int hd, int kv_block) {
    const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int nb = hd / kv_block;
    const int kwords = hd / 4 + 1;       // words per padded K row
    const int quads = hd / 4;            // 4-column groups of a row
    const int groups = THREADS / quads;  // value phase: slot groups

    extern __shared__ float4 smem_f4[];
    float* qs = reinterpret_cast<float*>(smem_f4);      // [R][hd]
    float* sp = qs + R * hd;                            // [R][TS] s, then p
    float* kss = sp + R * TS;                           // [TS][nb]
    float* vss = kss + TS * nb;                         // [TS][nb]
    float* ml = vss + TS * nb;                          // m, l, alpha [R]
    int* kp = reinterpret_cast<int*>(ml + 3 * MAX_R);   // [TS]
    uint32_t* vt = reinterpret_cast<uint32_t*>(kp + TS);  // [TS][quads]
    uint32_t* kt = vt + TS * quads;                     // [TS][kwords]
    float* part = reinterpret_cast<float*>(vt);  // [groups][R][hd], at end

    const long cell = (long)b * KV + g;
    for (int e = tid; e < R * hd; e += THREADS)
        qs[e] = load_q(q + cell * R * hd + e);
    if (tid < R) {
        ml[tid] = NEG;
        ml[MAX_R + tid] = 0.f;
    }

    const int c4 = tid % quads, grp = tid / quads;
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;

    TileRegs regs;
    load_tile(regs, kc, ks, vc, vs, kpos, b, g, 0, S, KV, hd, nb);
    const int chunks = hd / 16;
    for (int s0 = 0; s0 < S; s0 += TS) {
        // 1. registers to shared memory, then the next tile's loads
#pragma unroll
        for (int i = 0; i < MAX_CHUNKS; ++i) {
            const int c = tid + THREADS * i;
            const int slot = c / chunks, j = c % chunks;
            if (slot < TS) {
                uint32_t* kd = kt + slot * kwords + 4 * j;
                kd[0] = regs.k[i].x; kd[1] = regs.k[i].y;
                kd[2] = regs.k[i].z; kd[3] = regs.k[i].w;
                *reinterpret_cast<uint4*>(vt + slot * quads + 4 * j) =
                    regs.v[i];
            }
        }
#pragma unroll
        for (int i = 0; i < MAX_SCALES; ++i) {
            const int e = tid + THREADS * i;
            if (e < TS * nb) {
                kss[e] = regs.ks[i];
                vss[e] = regs.vs[i];
            }
        }
        if (tid < TS) kp[tid] = regs.kpos;
        __syncthreads();
        if (s0 + TS < S)
            load_tile(regs, kc, ks, vc, vs, kpos, b, g, s0 + TS, S, KV, hd,
                      nb);

        // 2. scores: two threads per slot, each over half of the row
        {
            const int slot = tid / SPLIT, h = tid % SPLIT;
            const int w0 = h * (quads / SPLIT), w1 = w0 + quads / SPLIT;
            const uint32_t* krow = kt + slot * kwords;
            float sc[R], seg[R];
#pragma unroll
            for (int r = 0; r < R; ++r) sc[r] = seg[r] = 0.f;
            int blk = (4 * w0) / kv_block;
            for (int w = w0; w < w1; ++w) {
                if ((4 * w) / kv_block != blk) {
                    const float scale = kss[slot * nb + blk];
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        sc[r] = fmaf(seg[r], scale, sc[r]);
                        seg[r] = 0.f;
                    }
                    blk = (4 * w) / kv_block;
                }
                float f[4];
                codes4(krow[w], f);
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const float4 qv = *reinterpret_cast<const float4*>(
                        qs + r * hd + 4 * w);
                    float a = seg[r];
                    a = fmaf(qv.x, f[0], a);
                    a = fmaf(qv.y, f[1], a);
                    a = fmaf(qv.z, f[2], a);
                    a = fmaf(qv.w, f[3], a);
                    seg[r] = a;
                }
            }
            const float scale = kss[slot * nb + blk];
            const bool valid = kp[slot] >= 0;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                float v = fmaf(seg[r], scale, sc[r]);
#pragma unroll
                for (int off = 1; off < SPLIT; off <<= 1)
                    v += __shfl_xor_sync(0xffffffffu, v, off);
                if (h == 0) sp[r * TS + slot] = valid ? v : NEG;
            }
        }
        __syncthreads();

        // 3. online softmax: warp r folds row r's tile
        {
            const int r = tid / 32, lane = tid % 32;
            if (r < R) {
                float sv[TS / 32];
                float tmax = NEG;
#pragma unroll
                for (int j = 0; j < TS / 32; ++j) {
                    sv[j] = sp[r * TS + lane + 32 * j];
                    tmax = fmaxf(tmax, sv[j]);
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    tmax = fmaxf(tmax,
                                 __shfl_xor_sync(0xffffffffu, tmax, off));
                const float m_old = ml[r];
                const float m_new = fmaxf(m_old, tmax);
                float psum = 0.f;
#pragma unroll
                for (int j = 0; j < TS / 32; ++j) {
                    const int slot = lane + 32 * j;
                    const float p =
                        kp[slot] >= 0 ? expf(sv[j] - m_new) : 0.f;
                    sp[r * TS + slot] = p;
                    psum += p;
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    psum += __shfl_xor_sync(0xffffffffu, psum, off);
                __syncwarp();
                if (lane == 0) {
                    const float alpha = expf(m_old - m_new);
                    ml[r] = m_new;
                    ml[MAX_R + r] = alpha * ml[MAX_R + r] + psum;
                    ml[2 * MAX_R + r] = alpha;
                }
            }
        }
        __syncthreads();

        // 4. acc = alpha * acc + p @ dequant(V) over this thread's slots
        if (grp < groups) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float alpha = ml[2 * MAX_R + r];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[r][i] *= alpha;
            }
            const int blk = (4 * c4) / kv_block;
            for (int j = grp; j < TS; j += groups) {
                float f[4];
                codes4(vt[j * quads + c4], f);
                const float scale = vss[j * nb + blk];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const float pv = sp[r * TS + j] * scale;
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[r][i] = fmaf(pv, f[i], acc[r][i]);
                }
            }
        }
        __syncthreads();
    }

    // the slot groups' partial sums, added in group order
    if (grp < groups) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                part[(grp * R + r) * hd + 4 * c4 + i] = acc[r][i];
    }
    __syncthreads();
    for (int e = tid; e < R * hd; e += THREADS) {
        float a = 0.f;
        for (int gi = 0; gi < groups; ++gi) a += part[gi * R * hd + e];
        const int r = e / hd;
        store_o(out + cell * R * hd + e, a / fmaxf(ml[MAX_R + r], 1e-30f));
    }
}

size_t smem_bytes(int R, int hd, int nb) {
    const size_t head = sizeof(float) * ((size_t)R * hd + (size_t)R * TS
                                         + 2 * (size_t)TS * nb + 3 * MAX_R)
                        + sizeof(int) * TS;
    const size_t tiles = (size_t)TS * hd + (size_t)TS * (hd + 4);
    const size_t part = sizeof(float) * (THREADS / (hd / 4)) * R * hd;
    return head + (tiles > part ? tiles : part);
}

template <typename T, int R>
int launch_r(const T* q, const int8_t* kc, const float* ks, const int8_t* vc,
             const float* vs, const int* kpos, T* out, int B, int S, int KV,
             int hd, int kv_block, void* stream) {
    const size_t smem = smem_bytes(R, hd, hd / kv_block);
    if (smem > 48 * 1024) {
        const int lim = grant_max_dynamic_smem<kv_attn_kernel<T, R>>();
        if (lim < 0) return smem_grant_error();
        if (smem > (size_t)lim) return (int)cudaErrorInvalidValue;
    }
    dim3 grid(KV, B);
    kv_attn_kernel<T, R><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        q, kc, ks, vc, vs, kpos, out, S, KV, hd, kv_block);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const int8_t* kc, const float* ks, const int8_t* vc,
           const float* vs, const int* kpos, T* out, int B, int S, int KV,
           int R, int hd, int kv_block, void* stream) {
    if (hd % 16 != 0 || hd > MAX_HD || kv_block % 4 != 0
        || hd % kv_block != 0 || TS * (hd / kv_block) > THREADS * MAX_SCALES)
        return (int)cudaErrorInvalidValue;
    switch (R) {
#define KV_ATTN_R(n)                                                       \
    case n:                                                                \
        return launch_r<T, n>(q, kc, ks, vc, vs, kpos, out, B, S, KV, hd,  \
                              kv_block, stream);
        KV_ATTN_R(1) KV_ATTN_R(2) KV_ATTN_R(3) KV_ATTN_R(4)
        KV_ATTN_R(5) KV_ATTN_R(6) KV_ATTN_R(7) KV_ATTN_R(8)
#undef KV_ATTN_R
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" int int8_kv_attention_f32_launch(
        const float* q, const int8_t* kc, const float* ks, const int8_t* vc,
        const float* vs, const int* kpos, float* out, int B, int S, int KV,
        int R, int hd, int kv_block, void* stream) {
    return launch<float>(q, kc, ks, vc, vs, kpos, out, B, S, KV, R, hd,
                         kv_block, stream);
}

extern "C" int int8_kv_attention_bf16_launch(
        const __nv_bfloat16* q, const int8_t* kc, const float* ks,
        const int8_t* vc, const float* vs, const int* kpos,
        __nv_bfloat16* out, int B, int S, int KV, int R, int hd,
        int kv_block, void* stream) {
    return launch<__nv_bfloat16>(q, kc, ks, vc, vs, kpos, out, B, S, KV, R,
                                 hd, kv_block, stream);
}
