// Kernels B and C: the Swin attention sublayer, x + proj(MHA(LN(x))).
//
// B replaces scp_tpu/ops/pallas_swin.py::_self_kernel (pallas_call in
// _self_impl): fused (C, 3C) QKV projection of LN(x).
// C replaces scp_tpu/ops/pallas_swin.py::_cross_kernel (pallas_call in
// _cross_impl): Q from LN(query stream), K|V from LN(key stream) through a
// fused (C, 2C) projection; the residual is the key stream.
//
// Each op launches: the LN-prologue GEMM(s) for the projections (bf16 out),
// the window attention (relative-position bias (H, W, W) + additive mask
// (n_masks, W, W) indexed by window % n_masks, online softmax in f32), and
// the output-projection GEMM with bias and residual.  Numerics follow the
// Pallas kernels: LN, softmax and residual in f32, bf16 matmul operands.
#include "common.cuh"

extern "C" int scp_attn_self(const void* x, const float* ln_scale, const float* ln_bias,
                             const void* wqkv, const float* bqkv, const float* rel_bias,
                             const float* mask, int n_masks, const void* wp, const float* bp,
                             void* qkv, void* att, void* out, int BN, int W, int C, int H,
                             float eps, float scale, void* stream) {
    using scp::bf16;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int M = BN * W;
    bf16* qkv_b = static_cast<bf16*>(qkv);
    cudaError_t e = scp::launch_gemm(true, static_cast<const bf16*>(x), C, ln_scale, ln_bias,
                                     eps, static_cast<const bf16*>(wqkv), bqkv, nullptr, 0,
                                     qkv_b, 3 * C, M, 3 * C, C, scp::ACT_NONE, s);
    if (e != cudaSuccess) return (int)e;
    e = scp::launch_attn(qkv_b, 3 * C, qkv_b + C, qkv_b + 2 * C, 3 * C, rel_bias, mask,
                         n_masks, static_cast<bf16*>(att), BN, W, H, scale, s);
    if (e != cudaSuccess) return (int)e;
    e = scp::launch_gemm(false, static_cast<const bf16*>(att), C, nullptr, nullptr, 0.0f,
                         static_cast<const bf16*>(wp), bp, static_cast<const bf16*>(x), C,
                         static_cast<bf16*>(out), C, M, C, C, scp::ACT_NONE, s);
    return (int)e;
}

extern "C" int scp_attn_cross(const void* x, const void* qs, const float* ln_scale,
                              const float* ln_bias, const void* wq, const float* bq,
                              const void* wkv, const float* bkv, const float* rel_bias,
                              const float* mask, int n_masks, const void* wp, const float* bp,
                              void* qbuf, void* kvbuf, void* att, void* out, int BN, int W,
                              int C, int H, float eps, float scale, void* stream) {
    using scp::bf16;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int M = BN * W;
    bf16* q_b = static_cast<bf16*>(qbuf);
    bf16* kv_b = static_cast<bf16*>(kvbuf);
    cudaError_t e = scp::launch_gemm(true, static_cast<const bf16*>(qs), C, ln_scale, ln_bias,
                                     eps, static_cast<const bf16*>(wq), bq, nullptr, 0, q_b, C,
                                     M, C, C, scp::ACT_NONE, s);
    if (e != cudaSuccess) return (int)e;
    e = scp::launch_gemm(true, static_cast<const bf16*>(x), C, ln_scale, ln_bias, eps,
                         static_cast<const bf16*>(wkv), bkv, nullptr, 0, kv_b, 2 * C, M, 2 * C,
                         C, scp::ACT_NONE, s);
    if (e != cudaSuccess) return (int)e;
    e = scp::launch_attn(q_b, C, kv_b, kv_b + C, 2 * C, rel_bias, mask, n_masks,
                         static_cast<bf16*>(att), BN, W, H, scale, s);
    if (e != cudaSuccess) return (int)e;
    e = scp::launch_gemm(false, static_cast<const bf16*>(att), C, nullptr, nullptr, 0.0f,
                         static_cast<const bf16*>(wp), bp, static_cast<const bf16*>(x), C,
                         static_cast<bf16*>(out), C, M, C, C, scp::ACT_NONE, s);
    return (int)e;
}

extern "C" const char* scp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
