// Kernels B and C: the Swin attention sublayer, x + proj(MHA(LN(x))).
//
// B replaces scp_tpu/ops/pallas_swin.py::_self_kernel (pallas_call in
// _self_impl): fused (C, 3C) QKV projection of LN(x).
// C replaces scp_tpu/ops/pallas_swin.py::_cross_kernel (pallas_call in
// _cross_impl): Q from LN(query stream), K|V from LN(key stream) through a
// fused (C, 2C) projection; the residual is the key stream.
//
// Each op launches: the LN-prologue GEMM(s) for the projections, the
// window-attention core shared with kernel E (attn_core.cuh: one exact
// pass, weights normalized and rounded before P.V as Pallas does; it reads
// each head as column h*hd of the projection buffer, so no head transpose
// is made), and the output-projection GEMM with bias and residual.  The
// GEMMs: bf16 at C <= 256 the Hopper wgmma + TMA GEMM of gemm_sm90.cuh,
// bf16 at C > 256 the WMMA GEMM of common.cuh, f32 its CUDA-core GEMM.
// Numerics follow the Pallas kernels: LN, softmax and residual in f32,
// matmul operands in the compute dtype (bf16 on the tensor cores, or f32
// on the CUDA cores without TF32).
#include "attn_core.cuh"
#include "gemm_sm90.cuh"

namespace {

// the core over one (BN*W, ld) projection buffer per operand, head h at
// column h*hd; att (BN*W, C)
template <typename T>
cudaError_t attend(const T* q, int q_ld, const T* k, const T* v, int kv_ld, const float* bias,
                   const float* mask, int n_masks, T* att, int BN, int W, int C, int H,
                   float scale, cudaStream_t s) {
    scp::AttnArgs a;
    const int hd = C / H;
    a.q = {q, (long long)W * q_ld, hd, q_ld};
    a.k = {k, (long long)W * kv_ld, hd, kv_ld};
    a.v = {v, (long long)W * kv_ld, hd, kv_ld};
    a.out = att;
    a.o_win = (long long)W * C;
    a.o_head = hd;
    a.o_row = C;
    a.bias = bias;
    a.mask = mask;
    a.n_masks = n_masks;
    a.BN = BN;
    a.H = H;
    a.W = W;
    a.hd = hd;
    a.scale = scale;
    return scp::launch_attn_core<T>(a, s);
}

template <typename T>
int attn_self(const void* x, const float* ln_scale, const float* ln_bias, const void* wqkv,
              const float* bqkv, const float* rel_bias, const float* mask, int n_masks,
              const void* wp, const float* bp, void* qkv, void* att, void* out, int BN, int W,
              int C, int H, float eps, float scale, int sm90, cudaStream_t s) {
    const int M = BN * W;
    const T* xt = static_cast<const T*>(x);
    T* qkv_b = static_cast<T*>(qkv);
    cudaError_t e = scp::launch_proj_gemm(sm90, true, xt, C, ln_scale, ln_bias, eps,
                                          static_cast<const T*>(wqkv), bqkv, nullptr, 0, qkv_b,
                                          3 * C, M, 3 * C, C, scp::ACT_NONE, s);
    if (e != cudaSuccess) return (int)e;
    e = attend<T>(qkv_b, 3 * C, qkv_b + C, qkv_b + 2 * C, 3 * C, rel_bias, mask, n_masks,
                  static_cast<T*>(att), BN, W, C, H, scale, s);
    if (e != cudaSuccess) return (int)e;
    e = scp::launch_proj_gemm(sm90, false, static_cast<const T*>(att), C, nullptr, nullptr, 0.0f,
                              static_cast<const T*>(wp), bp, xt, C, static_cast<T*>(out), C, M,
                              C, C, scp::ACT_NONE, s);
    return (int)e;
}

template <typename T>
int attn_cross(const void* x, const void* qs, const float* ln_scale, const float* ln_bias,
               const void* wq, const float* bq, const void* wkv, const float* bkv,
               const float* rel_bias, const float* mask, int n_masks, const void* wp,
               const float* bp, void* qbuf, void* kvbuf, void* att, void* out, int BN, int W,
               int C, int H, float eps, float scale, int sm90, cudaStream_t s) {
    const int M = BN * W;
    const T* xt = static_cast<const T*>(x);
    T* q_b = static_cast<T*>(qbuf);
    T* kv_b = static_cast<T*>(kvbuf);
    cudaError_t e = scp::launch_proj_gemm(sm90, true, static_cast<const T*>(qs), C, ln_scale,
                                          ln_bias, eps, static_cast<const T*>(wq), bq, nullptr,
                                          0, q_b, C, M, C, C, scp::ACT_NONE, s);
    if (e != cudaSuccess) return (int)e;
    e = scp::launch_proj_gemm(sm90, true, xt, C, ln_scale, ln_bias, eps,
                              static_cast<const T*>(wkv), bkv, nullptr, 0, kv_b, 2 * C, M, 2 * C,
                              C, scp::ACT_NONE, s);
    if (e != cudaSuccess) return (int)e;
    e = attend<T>(q_b, C, kv_b, kv_b + C, 2 * C, rel_bias, mask, n_masks, static_cast<T*>(att),
                  BN, W, C, H, scale, s);
    if (e != cudaSuccess) return (int)e;
    e = scp::launch_proj_gemm(sm90, false, static_cast<const T*>(att), C, nullptr, nullptr, 0.0f,
                              static_cast<const T*>(wp), bp, xt, C, static_cast<T*>(out), C, M,
                              C, C, scp::ACT_NONE, s);
    return (int)e;
}

}  // namespace

// Activations, weights and buffers in bf16 (is_f32 == 0) or f32 (is_f32 ==
// 1); LN parameters, biases, rel_bias and mask f32; mask may be null.
// sm90 != 0 (bf16, C <= 256): the projections on the Hopper GEMM.
extern "C" int scp_attn_self(const void* x, const float* ln_scale, const float* ln_bias,
                             const void* wqkv, const float* bqkv, const float* rel_bias,
                             const float* mask, int n_masks, const void* wp, const float* bp,
                             void* qkv, void* att, void* out, int BN, int W, int C, int H,
                             float eps, float scale, int is_f32, int sm90, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (is_f32)
        return attn_self<float>(x, ln_scale, ln_bias, wqkv, bqkv, rel_bias, mask, n_masks, wp,
                                bp, qkv, att, out, BN, W, C, H, eps, scale, sm90, s);
    return attn_self<scp::bf16>(x, ln_scale, ln_bias, wqkv, bqkv, rel_bias, mask, n_masks, wp,
                                bp, qkv, att, out, BN, W, C, H, eps, scale, sm90, s);
}

extern "C" int scp_attn_cross(const void* x, const void* qs, const float* ln_scale,
                              const float* ln_bias, const void* wq, const float* bq,
                              const void* wkv, const float* bkv, const float* rel_bias,
                              const float* mask, int n_masks, const void* wp, const float* bp,
                              void* qbuf, void* kvbuf, void* att, void* out, int BN, int W,
                              int C, int H, float eps, float scale, int is_f32, int sm90,
                              void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (is_f32)
        return attn_cross<float>(x, qs, ln_scale, ln_bias, wq, bq, wkv, bkv, rel_bias, mask,
                                 n_masks, wp, bp, qbuf, kvbuf, att, out, BN, W, C, H, eps,
                                 scale, sm90, s);
    return attn_cross<scp::bf16>(x, qs, ln_scale, ln_bias, wq, bq, wkv, bkv, rel_bias, mask,
                                 n_masks, wp, bp, qbuf, kvbuf, att, out, BN, W, C, H, eps, scale,
                                 sm90, s);
}

// The bf16 projection GEMM alone (ops/proj_gemm.py): out (M, N) at row
// stride ldo = act(prologue(A) W^T + bias) (+ resid at ldr, or null);
// prologue LN when ln_scale is not null; sm90 picks the arm.
extern "C" int scp_proj_gemm(const void* A, int lda, const float* ln_scale, const float* ln_bias,
                             float eps, const void* W, const float* bias, const void* resid,
                             int ldr, void* out, int ldo, int M, int N, int K, int act, int sm90,
                             void* stream) {
    return (int)scp::launch_proj_gemm(
        sm90, ln_scale != nullptr, static_cast<const scp::bf16*>(A), lda, ln_scale, ln_bias, eps,
        static_cast<const scp::bf16*>(W), bias, static_cast<const scp::bf16*>(resid), ldr,
        static_cast<scp::bf16*>(out), ldo, M, N, K, act, reinterpret_cast<cudaStream_t>(stream));
}

extern "C" const char* scp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
