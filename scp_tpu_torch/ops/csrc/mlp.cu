// Kernel A: the Swin MLP sublayer, out = x + W2 act(W1 LN(x) + b1) + b2.
//
// Replaces scp_tpu/ops/pallas_mlp.py::_kernel (pallas_call in _fused_impl).
// Two launches of the shared tensor-core GEMM: LN prologue + bias + act
// into a bf16 (M, F) intermediate, then bias + residual.  Numerics follow
// the Pallas kernel: LN, activation and residual in f32, bf16 operands into
// the products, f32 accumulation.  Unlike the Pallas kernel the (M, F)
// intermediate round-trips through device memory; keeping it on chip is
// later work.
#include "common.cuh"

extern "C" int scp_ln_mlp_residual(const void* x, const float* ln_scale, const float* ln_bias,
                                   const void* w1, const float* b1, const void* w2,
                                   const float* b2, void* mid, void* out, int M, int C, int F,
                                   float eps, int act, void* stream) {
    using scp::bf16;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    cudaError_t e = scp::launch_gemm(true, static_cast<const bf16*>(x), C, ln_scale, ln_bias,
                                     eps, static_cast<const bf16*>(w1), b1, nullptr, 0,
                                     static_cast<bf16*>(mid), F, M, F, C, act, s);
    if (e != cudaSuccess) return (int)e;
    e = scp::launch_gemm(false, static_cast<const bf16*>(mid), F, nullptr, nullptr, 0.0f,
                         static_cast<const bf16*>(w2), b2, static_cast<const bf16*>(x), C,
                         static_cast<bf16*>(out), C, M, C, F, scp::ACT_NONE, s);
    return (int)e;
}

extern "C" const char* scp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
