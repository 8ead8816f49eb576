// int8_kv_attention at R 16 query rows a kv-head (recurrentgemma-9b's
// local layers: 16 heads over one kv-head); the kernel and its design:
// int8_kv_attention.cuh. A source of its own so that nvcc compiles it in
// parallel with the R 1 to 8 instantiations of int8_kv_attention.cu.
//
// Replaces: src/repro/kernels/kv_attention.py, int8_kv_attention_pallas
// (_kv_attn_kernel) at R 16, reached from models/attention.attention_decode.
#include "int8_kv_attention.cuh"

namespace {

template <typename T>
int launch16(const T* q, const int8_t* kc, const float* ks, const int8_t* vc,
             const float* vs, const int* kpos, T* out, int B, int S, int KV,
             int hd, int kv_block, int splits, int per, float* work,
             int* tickets, float softcap, void* stream) {
    if (!args_ok(S, hd, kv_block, splits, per, work, tickets, softcap))
        return (int)cudaErrorInvalidValue;
    return launch_r<T, MAX_R>(q, kc, ks, vc, vs, kpos, out, B, S, KV, hd,
                              kv_block, splits, per, work, tickets, softcap,
                              stream);
}

}  // namespace

// as int8_kv_attention_{f32,bf16}_launch with R = 16: work holds B * KV *
// splits * (16 hd + 32) floats where splits > 1
extern "C" int int8_kv_attention_r16_f32_launch(
        const float* q, const int8_t* kc, const float* ks, const int8_t* vc,
        const float* vs, const int* kpos, float* out, int B, int S, int KV,
        int hd, int kv_block, int splits, int per, float* work,
        int* tickets, float softcap, void* stream) {
    return launch16<float>(q, kc, ks, vc, vs, kpos, out, B, S, KV, hd,
                           kv_block, splits, per, work, tickets, softcap,
                           stream);
}

extern "C" int int8_kv_attention_r16_bf16_launch(
        const __nv_bfloat16* q, const int8_t* kc, const float* ks,
        const int8_t* vc, const float* vs, const int* kpos,
        __nv_bfloat16* out, int B, int S, int KV, int hd, int kv_block,
        int splits, int per, float* work, int* tickets, float softcap,
        void* stream) {
    return launch16<__nv_bfloat16>(q, kc, ks, vc, vs, kpos, out, B, S, KV,
                                   hd, kv_block, splits, per, work, tickets,
                                   softcap, stream);
}
