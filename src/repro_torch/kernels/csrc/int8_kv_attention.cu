// int8_kv_attention at R 1 to 8 query rows a kv-head (the kernel and its
// design: int8_kv_attention.cuh; R 16: int8_kv_attention_r16.cu).
//
// Replaces: src/repro/kernels/kv_attention.py, int8_kv_attention_pallas
// (_kv_attn_kernel), reached from models/attention.attention_decode.
#include "int8_kv_attention.cuh"

namespace {

template <typename T>
int launch(const T* q, const int8_t* kc, const float* ks, const int8_t* vc,
           const float* vs, const int* kpos, T* out, int B, int S, int KV,
           int R, int hd, int kv_block, int splits, int per, float* work,
           int* tickets, float softcap, void* stream) {
    if (!args_ok(S, hd, kv_block, splits, per, work, tickets, softcap))
        return (int)cudaErrorInvalidValue;
    switch (R) {
#define KV_ATTN_R(n)                                                       \
    case n:                                                                \
        return launch_r<T, n>(q, kc, ks, vc, vs, kpos, out, B, S, KV, hd,  \
                              kv_block, splits, per, work, tickets,        \
                              softcap, stream);
        KV_ATTN_R(1) KV_ATTN_R(2) KV_ATTN_R(3) KV_ATTN_R(4)
        KV_ATTN_R(5) KV_ATTN_R(6) KV_ATTN_R(7) KV_ATTN_R(8)
#undef KV_ATTN_R
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// splits ranges of per tiles (of TS slots) a cell, none empty; with splits
// > 1, work holds B * KV * splits * (R * hd + 2 R) floats and tickets B * KV
// counters, zero before the launch and zero again after it; softcap >= 0
// (0: no cap)
extern "C" int int8_kv_attention_f32_launch(
        const float* q, const int8_t* kc, const float* ks, const int8_t* vc,
        const float* vs, const int* kpos, float* out, int B, int S, int KV,
        int R, int hd, int kv_block, int splits, int per, float* work,
        int* tickets, float softcap, void* stream) {
    return launch<float>(q, kc, ks, vc, vs, kpos, out, B, S, KV, R, hd,
                         kv_block, splits, per, work, tickets, softcap,
                         stream);
}

extern "C" int int8_kv_attention_bf16_launch(
        const __nv_bfloat16* q, const int8_t* kc, const float* ks,
        const int8_t* vc, const float* vs, const int* kpos,
        __nv_bfloat16* out, int B, int S, int KV, int R, int hd,
        int kv_block, int splits, int per, float* work, int* tickets,
        float softcap, void* stream) {
    return launch<__nv_bfloat16>(q, kc, ks, vc, vs, kpos, out, B, S, KV, R,
                                 hd, kv_block, splits, per, work, tickets,
                                 softcap, stream);
}
