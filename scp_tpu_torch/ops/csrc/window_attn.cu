// Kernel E: window attention, out = softmax(q k^T * scale + bias[h] + mask) v
// per (window, head), mask (n_masks, W, W) indexed by window % n_masks or
// absent.
//
// Replaces scp_tpu/ops/pallas_attn.py::_kernel (pallas_call in
// _fused_fwd_impl, entry window_attention_fused).  The kernel is the core
// of attn_core.cuh, which B and C launch too: one exact pass (the score
// rows stay in registers, weights normalized and rounded to the compute
// dtype before P.V, as the Pallas kernel computes them), bf16 on the
// tensor cores (mma.sync) or f32 on the CUDA cores.  q, k, v and out are
// strided views, so the caller's (B, nW, W, H, hd) projections go in and
// out without a head transpose.
#include "attn_core.cuh"

// Each operand: base pointer and element strides (window, head, row); its
// hd columns contiguous.  bias (H, W, W) f32; mask (n_masks, W, W) f32 or
// null.  bf16 (is_f32 == 0) or f32 (is_f32 == 1).
extern "C" int scp_window_attn(const void* q, long long q_win, long long q_head, long long q_row,
                               const void* k, long long k_win, long long k_head, long long k_row,
                               const void* v, long long v_win, long long v_head, long long v_row,
                               void* out, long long o_win, long long o_head, long long o_row,
                               const float* bias, const float* mask, int n_masks, int BN, int H,
                               int W, int hd, float scale, int is_f32, void* stream) {
    scp::AttnArgs a;
    a.q = {q, q_win, q_head, q_row};
    a.k = {k, k_win, k_head, k_row};
    a.v = {v, v_win, v_head, v_row};
    a.out = out;
    a.o_win = o_win;
    a.o_head = o_head;
    a.o_row = o_row;
    a.bias = bias;
    a.mask = mask;
    a.n_masks = n_masks;
    a.BN = BN;
    a.H = H;
    a.W = W;
    a.hd = hd;
    a.scale = scale;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (is_f32) return (int)scp::launch_attn_core<float>(a, s);
    return (int)scp::launch_attn_core<scp::bf16>(a, s);
}

extern "C" const char* scp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
