// Kernel E: window attention, out = softmax(q k^T * scale + bias[h] + mask) v
// per (window, head), with q, k, v and out laid out (BN, H, W, hd) and
// mask (n_masks, W, W) indexed by window % n_masks.
//
// Replaces scp_tpu/ops/pallas_attn.py::_kernel (pallas_call in
// _fused_fwd_impl, entry window_attention_fused).  Numerics follow it: the
// logits ((q.k) * scale + bias) + mask and the softmax in f32, the weights
// exp(s - max) / sum rounded to bf16 before the product with v, which
// accumulates in f32 and is rounded to bf16.
//
// Design.  The Pallas kernel holds a whole (W, W) f32 score block in VMEM
// (1 MB at W = 512); an SM has 228 KB.  One block here owns (window, head,
// 64 queries); each of its 4 warps owns 16 query rows.  Keys stream
// through shared memory in 64-row tiles twice: the first pass keeps each
// row's running max and sum of exponentials, the second recomputes the
// logits, forms the normalized weights exactly as the Pallas kernel does
// (so no rescaling of the output is needed) and accumulates P.V in WMMA
// fragments.  Both products are bf16 WMMA 16x16x16 with f32 accumulation.
//
// Bound.  4*W*W*hd operations over 8*W*hd bytes of q, k, v and out per
// (window, head), W/2 = 256 operations a byte at W = 512: near the card's
// bf16 ridge of ~295 (bias and mask are shared by all windows).  This
// first kernel computes q.k twice, reads bias and mask rows twice and uses
// WMMA without TMA or wgmma; tuning is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 128;    // 4 warps x 16 query rows
constexpr int PLD = BK + 8;     // bf16 leading dim of the weight tile
constexpr int SLD = BK + 4;     // f32 leading dim of the score / output tile
constexpr unsigned FULL = 0xffffffffu;

template <int HD>
constexpr size_t smem_bytes() {
    return sizeof(bf16) * ((size_t)BQ * (HD + 8) + 2 * (size_t)BK * (HD + 8) + (size_t)BQ * PLD)
           + sizeof(float) * (size_t)BQ * SLD;
}

template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int tid) {
    constexpr int LD = HD + 8;
    for (int c = tid; c < 64 * (HD / 8); c += THREADS) {
        const int r = c / (HD / 8);
        const int col = (c % (HD / 8)) * 8;
        *reinterpret_cast<uint4*>(dst + r * LD + col) =
            *reinterpret_cast<const uint4*>(src + (size_t)r * HD + col);
    }
}

// The 32 logits of one lane (row r of the warp's 16, columns half*32 ..
// half*32+31 of the key tile at kt): S_w = Q_w K^T on the tensor cores,
// then ((s * scale) + bias) + mask, each step rounded as written.
template <int HD>
__device__ __forceinline__ void tile_logits(const bf16* Q_w, const bf16* Ks, float* S_w,
                                            const float* bias_row, const float* mask_row,
                                            int kt, int r, int half, float scale,
                                            float (&x)[32]) {
    constexpr int LD = HD + 8;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
        wmma::fill_fragment(s, 0.0f);
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
            wmma::load_matrix_sync(fa, Q_w + kk, LD);
            wmma::load_matrix_sync(fb, Ks + (j * 16) * LD + kk, LD);
            wmma::mma_sync(s, fa, fb, s);
        }
        wmma::store_matrix_sync(S_w + j * 16, s, SLD, wmma::mem_row_major);
    }
    __syncwarp();
    const float4* b4 = reinterpret_cast<const float4*>(bias_row + kt + half * 32);
    const float4* m4 = reinterpret_cast<const float4*>(mask_row + kt + half * 32);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
        const float4 bv = b4[t];
        const float4 mv = m4[t];
        const float* sp = S_w + r * SLD + half * 32 + 4 * t;
        x[4 * t + 0] = __fadd_rn(__fadd_rn(__fmul_rn(sp[0], scale), bv.x), mv.x);
        x[4 * t + 1] = __fadd_rn(__fadd_rn(__fmul_rn(sp[1], scale), bv.y), mv.y);
        x[4 * t + 2] = __fadd_rn(__fadd_rn(__fmul_rn(sp[2], scale), bv.z), mv.z);
        x[4 * t + 3] = __fadd_rn(__fadd_rn(__fmul_rn(sp[3], scale), bv.w), mv.w);
    }
    __syncwarp();  // S_w is overwritten by the next tile
}

// grid (BN * W/BQ, H); requires W % 64 == 0 and 16-byte aligned rows.
template <int HD>
__global__ void __launch_bounds__(THREADS)
window_attn_heads(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bias,
                  const float* __restrict__ mask, int n_masks, bf16* __restrict__ out, int W,
                  int H, float scale) {
    constexpr int LD = HD + 8;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Ks = Qs + BQ * LD;
    bf16* Vs = Ks + BK * LD;
    bf16* Ps = Vs + BK * LD;
    float* Ss = reinterpret_cast<float*>(Ps + BQ * PLD);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int q_tiles = W / BQ;
    const int bw = blockIdx.x / q_tiles;
    const int q0 = (blockIdx.x % q_tiles) * BQ;
    const int h = blockIdx.y;
    const size_t head0 = ((size_t)bw * H + h) * W * HD;  // (window, head) slab
    const bf16* qh = q + head0;
    const bf16* kh = k + head0;
    const bf16* vh = v + head0;

    load_rows<HD>(Qs, qh + (size_t)q0 * HD, tid);

    const int r = lane >> 1;  // each lane owns half of one query row
    const int half = lane & 1;
    const int qi = q0 + warp * 16 + r;
    const float* bias_row = bias + ((size_t)h * W + qi) * W;
    const float* mask_row = mask + ((size_t)(bw % n_masks) * W + qi) * W;
    const bf16* Q_w = Qs + warp * 16 * LD;
    float* S_w = Ss + warp * 16 * SLD;
    bf16* P_w = Ps + warp * 16 * PLD;
    float x[32];

    // pass 1: row max and sum of exp(logit - max), online over key tiles
    float m_run = -CUDART_INF_F;
    float l_run = 0.0f;
    for (int kt = 0; kt < W; kt += BK) {
        __syncthreads();  // Q is staged; the previous K tile is no longer read
        load_rows<HD>(Ks, kh + (size_t)kt * HD, tid);
        __syncthreads();
        tile_logits<HD>(Q_w, Ks, S_w, bias_row, mask_row, kt, r, half, scale, x);
        float tmax = x[0];
#pragma unroll
        for (int t = 1; t < 32; ++t) tmax = fmaxf(tmax, x[t]);
        tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 1));
        const float m_new = fmaxf(m_run, tmax);
        float tsum = 0.0f;
#pragma unroll
        for (int t = 0; t < 32; ++t) tsum += expf(x[t] - m_new);
        tsum += __shfl_xor_sync(FULL, tsum, 1);
        l_run = l_run * expf(m_run - m_new) + tsum;
        m_run = m_new;
    }

    // pass 2: weights exp(logit - max) / sum rounded to bf16, O += P V
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
    for (int kt = 0; kt < W; kt += BK) {
        __syncthreads();
        load_rows<HD>(Ks, kh + (size_t)kt * HD, tid);
        load_rows<HD>(Vs, vh + (size_t)kt * HD, tid);
        __syncthreads();
        tile_logits<HD>(Q_w, Ks, S_w, bias_row, mask_row, kt, r, half, scale, x);
#pragma unroll
        for (int t = 0; t < 32; ++t)
            P_w[r * PLD + half * 32 + t] = __float2bfloat16(expf(x[t] - m_run) / l_run);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
#pragma unroll
            for (int kk = 0; kk < BK; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
                wmma::load_matrix_sync(fa, P_w + kk, PLD);
                wmma::load_matrix_sync(fb, Vs + kk * LD + j * 16, LD);
                wmma::mma_sync(o[j], fa, fb, o[j]);
            }
        }
        __syncwarp();  // P_w is overwritten by the next tile
    }

#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
        wmma::store_matrix_sync(S_w + j * 16, o[j], SLD, wmma::mem_row_major);
    __syncwarp();
    bf16* orow = out + head0 + (size_t)qi * HD + half * (HD / 2);
    const float* srow = S_w + r * SLD + half * (HD / 2);
#pragma unroll
    for (int t0 = 0; t0 < HD / 2; t0 += 8) {
        uint4 pk;
        bf16* e = reinterpret_cast<bf16*>(&pk);
#pragma unroll
        for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(srow[t0 + u]);
        *reinterpret_cast<uint4*>(orow + t0) = pk;
    }
}

template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                   const float* mask, int n_masks, bf16* out, int BN, int H, int W, float scale,
                   cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<HD>();
    cudaError_t e = cudaFuncSetAttribute(window_attn_heads<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    dim3 grid(BN * (W / BQ), H);
    window_attn_heads<HD><<<grid, THREADS, smem, stream>>>(q, k, v, bias, mask, n_masks, out,
                                                           W, H, scale);
    return cudaGetLastError();
}

}  // namespace

// q, k, v, out (BN, H, W, HD) bf16; bias (H, W, W) f32; mask (n_masks, W, W)
// f32.  Requires HD in {32, 64}, W a positive multiple of 128, n_masks >= 1.
extern "C" int scp_window_attn(const void* q, const void* k, const void* v, const float* bias,
                               const float* mask, int n_masks, void* out, int BN, int H, int W,
                               int HD, float scale, void* stream) {
    if (BN <= 0) return (int)cudaSuccess;
    if (W < 128 || W % 128 != 0 || n_masks < 1 || H < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k);
    const bf16* vb = static_cast<const bf16*>(v);
    bf16* ob = static_cast<bf16*>(out);
    if (HD == 64)
        return (int)launch<64>(qb, kb, vb, bias, mask, n_masks, ob, BN, H, W, scale, s);
    if (HD == 32)
        return (int)launch<32>(qb, kb, vb, bias, mask, n_masks, ob, BN, H, W, scale, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* scp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
