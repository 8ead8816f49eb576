// One-token GQA flash-decode against the int8 KV cache: the decode
// attention of every layer when serve.kv_cache = "int8".
//
// The kernel, shared by two sources that nvcc compiles in parallel:
// int8_kv_attention.cu instantiates R 1 to 8, int8_kv_attention_r16.cu
// R 16. In one source the R-16 instantiations took the build of all
// kernels from 98.6 s to 133.0 s (the H100 machine's host; every R from
// 9 to 16 in it, to 237.5 s).
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
// Design (flash-decoding): the history of each (batch, kv-head) cell is
// cut into whole tiles of TS = 128 slots, and the tiles into `splits`
// ranges over a third grid axis (ops.int8_kv_attention_geometry: about two
// blocks an SM at the serving shape, no empty range, one range at S <=
// 128). A block of 8 warps walks its range tile by tile through a
// two-stage cp.async ring in shared memory, one barrier a tile: while a
// tile is computed, the next tile's codes, scales and kpos are on their
// way (slots past the range land as zero codes, zero scales, kpos -1). K
// rows land padded by 4 bytes (4-byte copies), so that lanes reading
// neighbouring rows hit different banks; V rows land whole (16-byte
// copies). A head width that is no multiple of 16 (hd / 4 words that are
// not whole 16-byte pieces: minicpm smoke's 12) takes the NARROW
// instantiation, whose V rows land 4 bytes at a time and whose first score
// lane of a slot takes the larger half of an odd count of words; every
// other width runs the code it ran before. Within a tile each warp owns 16 slots and keeps its own online
// softmax, so the warps never wait for each other inside a tile:
//   1. scores: two lanes a slot, each over half of the row, every query
//      row at once so that each code is converted once (q is staged with
//      its halves 16 bytes apart, so the two halves' reads hit different
//      banks); a kv_block segment's sum of q * code is scaled by its block
//      scale; the halves meet by one shuffle; with a soft cap c the score
//      becomes tanhf(s / c) * c; kpos < 0 is masked to -1e30;
//   2. the warp's running max m, denominator l and rescale factor alpha
//      per query row, by shuffles over its 16 slots, with p set to 0 on
//      masked slots after the exp (a fully masked tile would otherwise add
//      exp(0) = 1 per slot);
//   3. acc = alpha * acc + p @ dequant(V): a lane owns four columns (eight
//      at hd 256) of every query row and takes p * scale once per slot and
//      row; a masked slot is skipped by the whole warp.
// At the end of its range a block folds its 8 warps in warp order, and the
// ranges fold in range order, both as M = max m_i, l = sum l_i exp(m_i -
// M), acc = sum acc_i exp(m_i - M). With one range the result is acc /
// max(l, 1e-30). With several, each block writes its range's fp32
// partials (acc, m, l) to a workspace and takes a ticket from the cell's
// counter; the block that draws the last ticket resets the counter to 0
// (so the next launch, or a CUDA-graph replay, finds it zeroed) and folds
// the ranges. No float atomics, so a launch is bitwise repeatable. A warp
// or a range with no valid slot keeps m = -1e30 and l = 0 and adds
// nothing; a lane with no valid slot at all ends with l = 0 and returns 0.
// The result is rounded to q's dtype (round-to-nearest-even for bf16).
// Codes become floats by a byte permute into 2^23 + (code + 128) and one
// exact subtraction: the int-to-float instruction runs at an eighth of the
// FMA rate. expf, and sums that differ from the plain version's only in
// their order and in where the block scale is applied.
//
// The soft cap (the score of models with attn_logits_softcap, applied
// before the mask as the TPU kernel does) is a template flag: the uncapped
// instantiation is the code of the kernel before the cap existed, so a
// call with softcap 0 keeps its results bit for bit; c is a launch
// argument, so a captured graph replays it. It uses tanhf and a true
// division, not tanh.approx.f32 (about 2^-11 relative error): near the cap
// that error times c would exceed the fp32 pin of 1e-5 of the largest
// output, and the plain version's tanh is accurate to an ulp or two.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "smem.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TS = 128;                  // history slots per tile
constexpr int WS = TS / WARPS;           // slots a warp owns in a tile
constexpr int MAX_R = 16;                // query rows per kv-head
constexpr int MAX_HD = 256;
constexpr int MAX_NB = 8;                // scale blocks per row
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

// floats of a q row in shared memory: two halves of hd / 2, the second
// 4 floats further on
__host__ __device__ inline int q_stride(int hd) { return hd + 8; }

// q, then the ticket flag, in front of the ring (16-byte aligned)
__host__ __device__ inline size_t head_bytes(int R, int hd) {
    const size_t b = 4 * ((size_t)R * q_stride(hd) + 4);
    return (b + 15) / 16 * 16;
}

// One stage of the ring: [TS][quads] V words, [TS][quads + 1] K words
// (rows padded by one word), [TS][nb] K and V scales, [TS] kpos.
struct Stage {
    uint32_t* vt;
    uint32_t* kt;
    float* kss;
    float* vss;
    int* kp;
};

__device__ __forceinline__ Stage stage_at(unsigned char* base, int quads,
                                          int nb) {
    Stage st;
    st.vt = reinterpret_cast<uint32_t*>(base);
    st.kt = st.vt + TS * quads;
    st.kss = reinterpret_cast<float*>(st.kt + TS * (quads + 1));
    st.vss = st.kss + TS * nb;
    st.kp = reinterpret_cast<int*>(st.vss + TS * nb);
    return st;
}

__host__ __device__ inline size_t stage_bytes(int hd, int nb) {
    const size_t b = 4 * ((size_t)TS * (hd / 4) + (size_t)TS * (hd / 4 + 1)
                          + 2 * (size_t)TS * nb + TS);
    return (b + 15) / 16 * 16;
}

// A thread's share of a tile's copies of rows of `width` pieces: piece
// `col` of rows row0, row0 + step, ... (whole rows of `width` threads at a
// time; the threads past the last whole row copy nothing)
struct Share {
    int col, row0, step;
    __device__ Share(int width) {
        step = THREADS / width;
        col = threadIdx.x % width;
        row0 = threadIdx.x < step * width ? threadIdx.x / width : TS;
    }
};

// Issue the copies of the tile at s0 into st: K words (4-byte copies into
// the padded rows), V 16-byte pieces (NARROW: V words), the scales, kpos;
// slots at or past s_end (the block's range) are zero-filled, kpos -1.
template <bool NARROW>
__device__ __forceinline__ void load_tile(
        const Stage& st, const int8_t* kc, const float* ks, const int8_t* vc,
        const float* vs, const int* kpos, int b, int g, int s0, int S,
        int s_end, int KV, int hd, int nb, const Share& kw, const Share& vw,
        const Share& sw) {
    const int tid = threadIdx.x, quads = hd / 4;
    const long base = ((long)b * S + s0) * KV + g;
    for (int slot = kw.row0; slot < TS; slot += kw.step) {
        const bool ok = s0 + slot < s_end;
        const int8_t* src =
            ok ? kc + (base + (long)slot * KV) * hd + 4 * kw.col : kc;
        cp_async4(st.kt + slot * (quads + 1) + kw.col, src, ok ? 4 : 0);
    }
    for (int slot = vw.row0; slot < TS; slot += vw.step) {
        const bool ok = s0 + slot < s_end;
        if (NARROW) {
            const int8_t* src =
                ok ? vc + (base + (long)slot * KV) * hd + 4 * vw.col : vc;
            cp_async4(st.vt + slot * quads + vw.col, src, ok ? 4 : 0);
        } else {
            const int8_t* src =
                ok ? vc + (base + (long)slot * KV) * hd + 16 * vw.col : vc;
            cp_async16(st.vt + slot * quads + 4 * vw.col, src, ok ? 16 : 0);
        }
    }
    for (int slot = sw.row0; slot < TS; slot += sw.step) {
        const bool ok = s0 + slot < s_end;
        const long off = ok ? (base + (long)slot * KV) * nb + sw.col : 0;
        cp_async4(st.kss + slot * nb + sw.col, ks + off, ok ? 4 : 0);
        cp_async4(st.vss + slot * nb + sw.col, vs + off, ok ? 4 : 0);
    }
    if (tid < TS) {
        // kpos -1 past the range: a 0 copy writes 0, so write -1 directly
        if (s0 + tid < s_end)
            cp_async4(st.kp + tid, kpos + (long)b * S + s0 + tid, 4);
        else
            st.kp[tid] = -1;
    }
}

// The fold, in order, of n (acc, m, l) partials `stride` floats apart
// (acc at 0, m at mo, l at mo + R): element e of row r; ld reads a float
template <int R, typename Ld>
__device__ __forceinline__ void fold(const float* base, int n, int stride,
                                     int mo, int e, int r, Ld ld, float& m,
                                     float& l, float& a) {
    m = NEG;
    for (int z = 0; z < n; ++z) m = fmaxf(m, ld(base + z * stride + mo + r));
    l = 0.f;
    a = 0.f;
    for (int z = 0; z < n; ++z) {
        const float* p = base + z * stride;
        const float w = expf(ld(p + mo + r) - m);
        l = fmaf(ld(p + mo + R + r), w, l);
        a = fmaf(ld(p + e), w, a);
    }
}

// R, the query rows per kv-head, and QPL, the 4-column quads a lane owns
// in the value phase (1 up to hd 128, 2 up to 256), are template
// parameters: the per-row loops then issue no work for rows that do not
// exist, and no lane holds accumulators it never uses. Block (g, b, z)
// takes tiles [z * per, (z + 1) * per) of cell (b, g); with splits > 1,
// work holds (splits, R * hd + 2 R) fp32 partials a cell and tickets one
// counter a cell. CAP: scores are soft-capped at softcap. R is 1 to 8, or
// 16 (recurrentgemma's MQA: 16 heads over one kv-head at hd 256; the
// wrapper pads a group of 9 to 15 rows with zero rows to 16): one block
// still carries the whole query group, so the int8 history is read once.
// At R 16 a thread's accumulators (R * 4 * QPL floats, 128 at hd 256)
// outgrow the 128 registers that two blocks an SM leave, so that
// instantiation asks for one block an SM (255 registers; at hd 256 ptxas
// still spills 188 bytes, as the R-8 instantiation spills 184 under its
// 128); at hd 256 the ring and the fold already hold one block an SM at
// any R. The R <= 8 instantiations are compiled as before.
template <typename T, int R, int QPL, bool CAP, bool NARROW>
__global__ void __launch_bounds__(THREADS, R > 8 ? 1 : 2)
kv_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
               const float* __restrict__ ks, const int8_t* __restrict__ vc,
               const float* __restrict__ vs, const int* __restrict__ kpos,
               T* __restrict__ out, int S, int KV, int hd, int kv_block,
               int splits, int per, float* __restrict__ work,
               int* __restrict__ tickets, float softcap) {
    const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int s_begin = blockIdx.z * per * TS;
    const int s_end = min(S, s_begin + per * TS);
    const int nb = hd / kv_block;
    const int quads = hd / 4;            // 4-column groups of a row
    // words of a score lane (NARROW, an odd count of words: the first
    // lane takes the larger half)
    const int half = NARROW ? (quads + 1) / 2 : quads / 2;
    const int qst = q_stride(hd);
    const int ps = R * hd + 2 * R;       // floats of one (acc, m, l)

    extern __shared__ float4 smem_f4[];
    float* qs = reinterpret_cast<float*>(smem_f4);      // [R][qst]
    int* flag = reinterpret_cast<int*>(qs + R * qst);   // the last ticket
    unsigned char* ring = reinterpret_cast<unsigned char*>(smem_f4)
                          + head_bytes(R, hd);
    const size_t sb = stage_bytes(hd, nb);
    float* comb = reinterpret_cast<float*>(ring);  // [WARPS][ps], at end

    const long cell = (long)b * KV + g;
    for (int e = tid; e < R * hd; e += THREADS) {
        const int r = e / hd, c = e - r * hd;
        qs[r * qst + c + (c >= (NARROW ? 4 * half : hd / 2) ? 4 : 0)] =
            load_q(q + cell * R * hd + e);
    }

    float m[R], l[R], acc[R][4 * QPL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        m[r] = NEG;
        l[r] = 0.f;
#pragma unroll
        for (int i = 0; i < 4 * QPL; ++i) acc[r][i] = 0.f;
    }

    // this thread's share of the copies: K words, V pieces, scales
    const Share kw(quads), vw(NARROW ? quads : hd / 16), sw(nb);
    load_tile<NARROW>(stage_at(ring, quads, nb), kc, ks, vc, vs, kpos, b, g,
              s_begin, S, s_end, KV, hd, nb, kw, vw, sw);
    cp_async_commit();
    const int h = lane & 1;              // the score lane's half of a row
    const int w0 = h * half;
    const int w_end = NARROW && h ? quads : w0 + half;
    const float* qh = qs + h * (4 * half + 4);
    const int ws0 = warp * WS;           // the warp's first slot of a tile
    const int slot = ws0 + lane / 2;     // the score lane's slot
    // the score lane's first kv_block segment and the word that ends it;
    // the scale block of each of the lane's value quads
    const int kvw = kv_block / 4;
    const int blk0 = w0 / kvw, next0 = (blk0 + 1) * kvw;
    int vblk[QPL];
#pragma unroll
    for (int i = 0; i < QPL; ++i) vblk[i] = (lane + 32 * i) / kvw;
    for (int s0 = s_begin, t = 0; s0 < s_end; s0 += TS, ++t) {
        // this tile in and visible, every warp done with the last one; then
        // the next tile's copies into the stage the last one used
        cp_async_wait<0>();
        __syncthreads();
        const Stage st = stage_at(ring + (t & 1) * sb, quads, nb);
        if (s0 + TS < s_end) {
            load_tile<NARROW>(stage_at(ring + ((t + 1) & 1) * sb, quads, nb), kc,
                      ks, vc, vs, kpos, b, g, s0 + TS, S, s_end, KV, hd, nb,
                      kw, vw, sw);
            cp_async_commit();
        }

        // 1. scores: half h of the slot's row
        const uint32_t* krow = st.kt + slot * (quads + 1);
        float sc[R], seg[R];
#pragma unroll
        for (int r = 0; r < R; ++r) sc[r] = seg[r] = 0.f;
        int blk = blk0, next = next0;
#pragma unroll 4
        for (int w = w0; w < w_end; ++w) {
            if (w == next) {                 // a kv_block segment ends
                const float scale = st.kss[slot * nb + blk];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    sc[r] = fmaf(seg[r], scale, sc[r]);
                    seg[r] = 0.f;
                }
                ++blk;
                next += kvw;
            }
            float f[4];
            codes4(krow[w], f);
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float4 qv = *reinterpret_cast<const float4*>(
                    qh + r * qst + 4 * (w - w0));
                float a = seg[r];
                a = fmaf(qv.x, f[0], a);
                a = fmaf(qv.y, f[1], a);
                a = fmaf(qv.z, f[2], a);
                a = fmaf(qv.w, f[3], a);
                seg[r] = a;
            }
        }
        const bool valid = st.kp[slot] >= 0;
        const float kscale = st.kss[slot * nb + blk];
        float p[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            float v = fmaf(seg[r], kscale, sc[r]);
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            if (CAP) v = tanhf(v / softcap) * softcap;
            v = valid ? v : NEG;
            // 2. the warp's online softmax over its 16 slots (each value is
            //    held by the slot's two lanes)
            float tmax = v;
#pragma unroll
            for (int off = 2; off < 32; off <<= 1)
                tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
            const float m_new = fmaxf(m[r], tmax);
            p[r] = valid ? expf(v - m_new) : 0.f;
            float psum = p[r];
#pragma unroll
            for (int off = 2; off < 32; off <<= 1)
                psum += __shfl_xor_sync(0xffffffffu, psum, off);
            const float alpha = expf(m[r] - m_new);
            m[r] = m_new;
            l[r] = alpha * l[r] + psum;
#pragma unroll
            for (int i = 0; i < 4 * QPL; ++i) acc[r][i] *= alpha;
        }

        // 3. acc += p @ dequant(V) over the warp's valid slots
#pragma unroll 4
        for (int j = 0; j < WS; ++j) {
            const int sj = ws0 + j;
            if (st.kp[sj] < 0) continue;             // the same in every lane
            float pj[R];
#pragma unroll
            for (int r = 0; r < R; ++r)
                pj[r] = __shfl_sync(0xffffffffu, p[r], 2 * j);
#pragma unroll
            for (int i = 0; i < QPL; ++i) {
                const int c4 = lane + 32 * i;
                if (c4 < quads) {
                    float f[4];
                    codes4(st.vt[sj * quads + c4], f);
                    const float scale = st.vss[sj * nb + vblk[i]];
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const float pv = pj[r] * scale;
#pragma unroll
                        for (int k = 0; k < 4; ++k)
                            acc[r][4 * i + k] = fmaf(pv, f[k],
                                                     acc[r][4 * i + k]);
                    }
                }
            }
        }
    }

    // the warps' (acc, m, l), then their fold in warp order
    __syncthreads();
    float* mine = comb + warp * ps;
#pragma unroll
    for (int i = 0; i < QPL; ++i) {
        const int c4 = lane + 32 * i;
        if (c4 < quads)
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    mine[r * hd + 4 * c4 + k] = acc[r][4 * i + k];
    }
    if (lane == 0)
#pragma unroll
        for (int r = 0; r < R; ++r) {
            mine[R * hd + r] = m[r];
            mine[R * hd + R + r] = l[r];
        }
    __syncthreads();
    auto lds = [](const float* x) { return *x; };
    float* part = splits == 1 ? nullptr
                              : work + (cell * splits + blockIdx.z) * ps;
    for (int e = tid; e < R * hd; e += THREADS) {
        float mf, lf, af;
        fold<R>(comb, WARPS, ps, R * hd, e, e / hd, lds, mf, lf, af);
        if (part == nullptr) {
            store_o(out + cell * R * hd + e, af / fmaxf(lf, 1e-30f));
            continue;
        }
        // this range's partials
        part[e] = af;
        if (e % hd == 0) {
            part[R * hd + e / hd] = mf;
            part[R * hd + R + e / hd] = lf;
        }
    }
    if (part == nullptr) return;

    // a ticket; the block that draws the last one folds the ranges
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        const int ticket = atomicAdd(tickets + cell, 1);
        *flag = ticket == splits - 1;
        if (*flag) tickets[cell] = 0;
    }
    __syncthreads();
    if (!*flag) return;
    __threadfence();
    const float* all = work + cell * splits * ps;
    auto ldg = [](const float* x) { return __ldcg(x); };
    for (int e = tid; e < R * hd; e += THREADS) {
        float mf, lf, af;
        fold<R>(all, splits, ps, R * hd, e, e / hd, ldg, mf, lf, af);
        store_o(out + cell * R * hd + e, af / fmaxf(lf, 1e-30f));
    }
}

size_t smem_bytes(int R, int hd, int nb) {
    const size_t ring = 2 * stage_bytes(hd, nb);
    const size_t comb = sizeof(float) * WARPS * (R * hd + 2 * R);
    return head_bytes(R, hd) + (ring > comb ? ring : comb);
}

template <typename T, int R, int QPL, bool CAP, bool NARROW>
int launch_q(const T* q, const int8_t* kc, const float* ks, const int8_t* vc,
             const float* vs, const int* kpos, T* out, int B, int S, int KV,
             int hd, int kv_block, int splits, int per, float* work,
             int* tickets, float softcap, void* stream) {
    constexpr auto kernel = &kv_attn_kernel<T, R, QPL, CAP, NARROW>;
    const size_t smem = smem_bytes(R, hd, hd / kv_block);
    if (smem > 48 * 1024) {
        const int lim = grant_max_dynamic_smem<kernel>();
        if (lim < 0) return smem_grant_error();
        if (smem > (size_t)lim) return (int)cudaErrorInvalidValue;
    }
    dim3 grid(KV, B, splits);
    kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        q, kc, ks, vc, vs, kpos, out, S, KV, hd, kv_block, splits, per, work,
        tickets, softcap);
    return (int)cudaGetLastError();
}

template <typename T, int R, bool CAP, bool NARROW>
int launch_n(const T* q, const int8_t* kc, const float* ks, const int8_t* vc,
             const float* vs, const int* kpos, T* out, int B, int S, int KV,
             int hd, int kv_block, int splits, int per, float* work,
             int* tickets, float softcap, void* stream) {
    return hd > 128
        ? launch_q<T, R, 2, CAP, NARROW>(q, kc, ks, vc, vs, kpos, out, B, S,
                                         KV, hd, kv_block, splits, per, work,
                                         tickets, softcap, stream)
        : launch_q<T, R, 1, CAP, NARROW>(q, kc, ks, vc, vs, kpos, out, B, S,
                                         KV, hd, kv_block, splits, per, work,
                                         tickets, softcap, stream);
}

// rows of whole 16-byte pieces take the kernel as it was before other head
// widths were taken (bit for bit); the others copy V 4 bytes at a time
template <typename T, int R, bool CAP>
int launch_c(const T* q, const int8_t* kc, const float* ks, const int8_t* vc,
             const float* vs, const int* kpos, T* out, int B, int S, int KV,
             int hd, int kv_block, int splits, int per, float* work,
             int* tickets, float softcap, void* stream) {
    return hd % 16 != 0
        ? launch_n<T, R, CAP, true>(q, kc, ks, vc, vs, kpos, out, B, S, KV,
                                    hd, kv_block, splits, per, work, tickets,
                                    softcap, stream)
        : launch_n<T, R, CAP, false>(q, kc, ks, vc, vs, kpos, out, B, S, KV,
                                     hd, kv_block, splits, per, work,
                                     tickets, softcap, stream);
}

template <typename T, int R>
int launch_r(const T* q, const int8_t* kc, const float* ks, const int8_t* vc,
             const float* vs, const int* kpos, T* out, int B, int S, int KV,
             int hd, int kv_block, int splits, int per, float* work,
             int* tickets, float softcap, void* stream) {
    return softcap > 0.f
        ? launch_c<T, R, true>(q, kc, ks, vc, vs, kpos, out, B, S, KV, hd,
                               kv_block, splits, per, work, tickets, softcap,
                               stream)
        : launch_c<T, R, false>(q, kc, ks, vc, vs, kpos, out, B, S, KV, hd,
                                kv_block, splits, per, work, tickets,
                                softcap, stream);
}

// The launch arguments every instantiation takes (R aside).
inline bool args_ok(int S, int hd, int kv_block, int splits, int per,
                    const float* work, const int* tickets, float softcap) {
    return !(hd % 4 != 0 || hd > MAX_HD || kv_block % 4 != 0
             || hd % kv_block != 0 || hd / kv_block > MAX_NB
             || splits < 1 || per < 1 || splits > 65535
             || (long)(splits - 1) * per * TS >= S
             || (splits > 1 && (work == nullptr || tickets == nullptr))
             || !(softcap >= 0.f));
}

}  // namespace
