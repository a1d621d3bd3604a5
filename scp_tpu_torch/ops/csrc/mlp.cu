// Kernel A: the Swin MLP sublayer, out = x + W2 act(W1 LN(x) + b1) + b2.
//
// Replaces scp_tpu/ops/pallas_mlp.py::_kernel (pallas_call in _fused_impl).
// Two launches of the shared GEMM (common.cuh): LN prologue + bias + act
// into an (M, F) intermediate, then bias + residual.  Numerics follow the
// Pallas kernel: LN, activation and residual in f32, operands rounded to
// the compute dtype before the products, f32 accumulation.  bf16 runs on
// the tensor cores, f32 on the CUDA cores (no TF32).  Unlike the Pallas
// kernel the (M, F) intermediate round-trips through device memory;
// keeping it on chip is later work.
#include "common.cuh"

namespace {

template <typename T>
int ln_mlp_residual(const void* x, const float* ln_scale, const float* ln_bias, const void* w1,
                    const float* b1, const void* w2, const float* b2, void* mid, void* out,
                    int M, int C, int F, float eps, int act, cudaStream_t s) {
    cudaError_t e = scp::launch_gemm(true, static_cast<const T*>(x), C, ln_scale, ln_bias, eps,
                                     static_cast<const T*>(w1), b1, nullptr, 0,
                                     static_cast<T*>(mid), F, M, F, C, act, s);
    if (e != cudaSuccess) return (int)e;
    e = scp::launch_gemm(false, static_cast<const T*>(mid), F, nullptr, nullptr, 0.0f,
                         static_cast<const T*>(w2), b2, static_cast<const T*>(x), C,
                         static_cast<T*>(out), C, M, C, F, scp::ACT_NONE, s);
    return (int)e;
}

}  // namespace

// x, w1, w2, mid, out in bf16 (is_f32 == 0) or f32 (is_f32 == 1)
extern "C" int scp_ln_mlp_residual(const void* x, const float* ln_scale, const float* ln_bias,
                                   const void* w1, const float* b1, const void* w2,
                                   const float* b2, void* mid, void* out, int M, int C, int F,
                                   float eps, int act, int is_f32, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (is_f32)
        return ln_mlp_residual<float>(x, ln_scale, ln_bias, w1, b1, w2, b2, mid, out, M, C, F,
                                      eps, act, s);
    return ln_mlp_residual<scp::bf16>(x, ln_scale, ln_bias, w1, b1, w2, b2, mid, out, M, C, F,
                                      eps, act, s);
}

extern "C" const char* scp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
