// Building blocks shared by the port's Swin-sublayer kernels (sm_90a).
//
// Two device programs:
//   * gemm_bf16: out = epilogue(prologue(A) @ W^T) with bf16 operands on
//     the tensor cores (WMMA 16x16x16, f32 accumulation).  The optional
//     prologue is a LayerNorm of each A row (statistics in f32, normalized
//     value rounded to bf16 before the product); the epilogue adds an f32
//     bias, applies GELU (exact erf) or LeakyReLU(0.01), adds the bf16
//     residual in f32 and rounds to bf16.
//   * window_attn_bf16: softmax(q k^T * scale + bias + mask) v per
//     (window, head, 64-query tile), the 512 keys streamed in 64-key
//     tiles with an online softmax in f32 (a 512x512 f32 score tile is
//     1 MB, far over an SM's 228 KB of shared memory).
//
// Bound on this card: at C=256 the sublayer GEMMs do 256..1024 FLOPs per
// byte of A they read, above the H100's ~295 bf16 FLOPs/byte ridge, so a
// tuned kernel would be tensor-core bound.  These first kernels use WMMA
// without TMA/wgmma pipelining; making them fast is later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace scp {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_LEAKY = 2 };

// ---- GEMM -----------------------------------------------------------------

constexpr int GBM = 64;   // rows of A per block
constexpr int GBN = 64;   // output columns per block
constexpr int GBK = 32;   // depth per shared-memory stage
constexpr int GLD = GBK + 8;   // bf16 leading dim of the A/W tiles (80 B rows)
constexpr int GCLD = GBN + 4;  // f32 leading dim of the epilogue tile
constexpr int GTHREADS = 128;  // 4 warps, each a 32x32 quadrant

__device__ __forceinline__ float act_apply(float v, int act) {
    if (act == ACT_GELU) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
    if (act == ACT_LEAKY) return v >= 0.0f ? v : 0.01f * v;
    return v;
}

// A (M, K) bf16, row stride lda; W (N, K) bf16 row-major (nn.Linear layout);
// out (M, N) bf16, row stride ldo; resid (M, N) bf16, row stride ldr, or null.
// Requires K % GBK == 0, N % GBN == 0, lda/ldo/ldr % 8 == 0 (16-byte rows).
template <bool LN>
__global__ void __launch_bounds__(GTHREADS)
gemm_bf16(const bf16* __restrict__ A, int lda,
          const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
          float eps, const bf16* __restrict__ W, const float* __restrict__ bias,
          const bf16* __restrict__ resid, int ldr, bf16* __restrict__ out,
          int ldo, int M, int N, int K, int act) {
    __shared__ __align__(128) bf16 As[GBM * GLD];
    __shared__ __align__(128) bf16 Ws[GBN * GLD];
    __shared__ __align__(128) float Cs[GBM * GCLD];
    __shared__ float mu_s[GBM];
    __shared__ float rs_s[GBM];

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int m0 = blockIdx.y * GBM;
    const int n0 = blockIdx.x * GBN;

    if (LN) {
        // two-pass row statistics in f32: each warp owns 16 rows
        for (int r = warp; r < GBM; r += GTHREADS / 32) {
            const int m = m0 + r;
            float mu = 0.0f, var = 0.0f;
            if (m < M) {
                const bf16* row = A + (size_t)m * lda;
                float s = 0.0f;
                for (int k = lane; k < K; k += 32) s += __bfloat162float(row[k]);
                for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
                mu = s / (float)K;
                float q = 0.0f;
                for (int k = lane; k < K; k += 32) {
                    const float d = __bfloat162float(row[k]) - mu;
                    q += d * d;
                }
                for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
                var = q / (float)K;
            }
            if (lane == 0) {
                mu_s[r] = mu;
                rs_s[r] = rsqrtf(var + eps);
            }
        }
        __syncthreads();
    }

    const int wm = (warp >> 1) * 32;  // warp quadrant
    const int wn = (warp & 1) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < K; k0 += GBK) {
        // A and W tiles: 64 rows x 32 cols = 256 chunks of 8 bf16 each
        for (int c = tid; c < GBM * (GBK / 8); c += GTHREADS) {
            const int r = c / (GBK / 8);
            const int col = (c % (GBK / 8)) * 8;
            const int m = m0 + r;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (m < M) {
                v = *reinterpret_cast<const uint4*>(A + (size_t)m * lda + k0 + col);
                if (LN) {
                    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
                    for (int t = 0; t < 8; ++t) {
                        const int k = k0 + col + t;
                        const float h = (__bfloat162float(e[t]) - mu_s[r]) * rs_s[r]
                                        * ln_scale[k] + ln_bias[k];
                        e[t] = __float2bfloat16(h);
                    }
                }
            }
            *reinterpret_cast<uint4*>(As + r * GLD + col) = v;
            const uint4 w = *reinterpret_cast<const uint4*>(
                W + (size_t)(n0 + r) * K + k0 + col);
            *reinterpret_cast<uint4*>(Ws + r * GLD + col) = w;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < GBK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * GLD + kk, GLD);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(fb[j], Ws + (wn + j * 16) * GLD + kk, GLD);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(Cs + (wm + i * 16) * GCLD + wn + j * 16, acc[i][j],
                                    GCLD, wmma::mem_row_major);
    __syncthreads();

    for (int e = tid; e < GBM * GBN; e += GTHREADS) {
        const int r = e / GBN;
        const int c = e % GBN;
        const int m = m0 + r;
        if (m >= M) continue;
        const int n = n0 + c;
        float v = Cs[r * GCLD + c] + bias[n];
        v = act_apply(v, act);
        if (resid != nullptr) v = __bfloat162float(resid[(size_t)m * ldr + n]) + v;
        out[(size_t)m * ldo + n] = __float2bfloat16(v);
    }
}

inline cudaError_t launch_gemm(bool ln, const bf16* A, int lda, const float* ln_scale,
                               const float* ln_bias, float eps, const bf16* W,
                               const float* bias, const bf16* resid, int ldr, bf16* out,
                               int ldo, int M, int N, int K, int act, cudaStream_t stream) {
    if (M <= 0) return cudaSuccess;
    dim3 grid(N / GBN, (M + GBM - 1) / GBM);
    if (ln)
        gemm_bf16<true><<<grid, GTHREADS, 0, stream>>>(A, lda, ln_scale, ln_bias, eps, W,
                                                       bias, resid, ldr, out, ldo, M, N, K,
                                                       act);
    else
        gemm_bf16<false><<<grid, GTHREADS, 0, stream>>>(A, lda, ln_scale, ln_bias, eps, W,
                                                        bias, resid, ldr, out, ldo, M, N, K,
                                                        act);
    return cudaGetLastError();
}

// ---- window attention -----------------------------------------------------

constexpr int AQ = 64;       // queries per block
constexpr int AKT = 64;      // keys per tile
constexpr int HD = 64;       // head dim
constexpr int ALD = HD + 8;  // bf16 leading dim of Q/K/V/P tiles (144 B rows)
constexpr int SLD = AKT + 4; // f32 leading dim of the score / output tiles
constexpr int ATHREADS = 128;  // 4 warps x 16 query rows

constexpr size_t ATTN_SMEM =
    sizeof(bf16) * (3 * AQ * ALD + AQ * ALD)  // Q, K, V tiles + P
    + sizeof(float) * (2 * AQ * SLD);         // S and O tiles

// q: rows (bw*W + i) with row stride q_ld, head h at column h*HD;
// k, v: same with kv_ld; bias (H, W, W) f32; mask (n_masks, W, W) f32,
// window bw uses mask[bw % n_masks]; out (BN*W, H*HD) bf16.
// grid (W/AQ, H, BN).  Requires W % 64 == 0, head dim 64, 16-byte rows.
__global__ void __launch_bounds__(ATHREADS)
window_attn_bf16(const bf16* __restrict__ q, int q_ld, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, int kv_ld, const float* __restrict__ bias,
                 const float* __restrict__ mask, int n_masks, bf16* __restrict__ out,
                 int W, int H, float scale) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Ks = Qs + AQ * ALD;
    bf16* Vs = Ks + AKT * ALD;
    bf16* Ps = Vs + AKT * ALD;
    float* Ss = reinterpret_cast<float*>(Ps + AQ * ALD);
    float* Os = Ss + AQ * SLD;

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int q0 = blockIdx.x * AQ;
    const int h = blockIdx.y;
    const int bw = blockIdx.z;
    const size_t row0 = (size_t)bw * W;
    const int C = H * HD;

    for (int c = tid; c < AQ * (HD / 8); c += ATHREADS) {
        const int r = c / (HD / 8);
        const int col = (c % (HD / 8)) * 8;
        *reinterpret_cast<uint4*>(Qs + r * ALD + col) = *reinterpret_cast<const uint4*>(
            q + (row0 + q0 + r) * q_ld + h * HD + col);
    }
    for (int e = tid; e < AQ * HD; e += ATHREADS) Os[(e / HD) * SLD + e % HD] = 0.0f;

    // each lane owns half of one query row: row r, columns [half*32, half*32+32)
    const int r = lane >> 1;
    const int half = lane & 1;
    const int qi = q0 + warp * 16 + r;  // query index within the window
    float m_run = -CUDART_INF_F;
    float l_run = 0.0f;
    const float* bias_row = bias + ((size_t)h * W + qi) * W;
    const float* mask_row = mask + ((size_t)(bw % n_masks) * W + qi) * W;
    float* S_w = Ss + warp * 16 * SLD;
    float* O_w = Os + warp * 16 * SLD;
    bf16* P_w = Ps + warp * 16 * ALD;
    const bf16* Q_w = Qs + warp * 16 * ALD;

    for (int kt = 0; kt < W; kt += AKT) {
        __syncthreads();  // previous tile's K/V reads are done
        for (int c = tid; c < AKT * (HD / 8); c += ATHREADS) {
            const int rr = c / (HD / 8);
            const int col = (c % (HD / 8)) * 8;
            const size_t g = (row0 + kt + rr) * kv_ld + h * HD + col;
            *reinterpret_cast<uint4*>(Ks + rr * ALD + col) =
                *reinterpret_cast<const uint4*>(k + g);
            *reinterpret_cast<uint4*>(Vs + rr * ALD + col) =
                *reinterpret_cast<const uint4*>(v + g);
        }
        __syncthreads();

        // S = Q_w K^T  (16 x 64 per warp)
#pragma unroll
        for (int j = 0; j < AKT / 16; ++j) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
            wmma::fill_fragment(s, 0.0f);
#pragma unroll
            for (int kk = 0; kk < HD; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
                wmma::load_matrix_sync(fa, Q_w + kk, ALD);
                wmma::load_matrix_sync(fb, Ks + (j * 16) * ALD + kk, ALD);
                wmma::mma_sync(s, fa, fb, s);
            }
            wmma::store_matrix_sync(S_w + j * 16, s, SLD, wmma::mem_row_major);
        }
        __syncwarp();

        // online softmax over this tile's 64 keys, in f32
        float sv[32];
        float tmax = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < 32; ++t) {
            const int c = half * 32 + t;
            const float x = S_w[r * SLD + c] * scale + bias_row[kt + c] + mask_row[kt + c];
            sv[t] = x;
            tmax = fmaxf(tmax, x);
        }
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        const float m_new = fmaxf(m_run, tmax);
        const float alpha = expf(m_run - m_new);
        float tsum = 0.0f;
#pragma unroll
        for (int t = 0; t < 32; ++t) {
            const float p = expf(sv[t] - m_new);
            tsum += p;
            P_w[r * ALD + half * 32 + t] = __float2bfloat16(p);
        }
        tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
        l_run = l_run * alpha + tsum;
        m_run = m_new;
#pragma unroll
        for (int t = 0; t < 32; ++t) O_w[r * SLD + half * 32 + t] *= alpha;
        __syncwarp();

        // O_w += P_w V  (16 x 64 per warp)
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
            wmma::load_matrix_sync(o, O_w + j * 16, SLD, wmma::mem_row_major);
#pragma unroll
            for (int kk = 0; kk < AKT; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
                wmma::load_matrix_sync(fa, P_w + kk, ALD);
                wmma::load_matrix_sync(fb, Vs + kk * ALD + j * 16, ALD);
                wmma::mma_sync(o, fa, fb, o);
            }
            wmma::store_matrix_sync(O_w + j * 16, o, SLD, wmma::mem_row_major);
        }
        __syncwarp();
    }

    const float inv = 1.0f / l_run;
    bf16* orow = out + (row0 + qi) * C + h * HD + half * 32;
#pragma unroll
    for (int t = 0; t < 32; ++t) orow[t] = __float2bfloat16(O_w[r * SLD + half * 32 + t] * inv);
}

inline cudaError_t launch_attn(const bf16* q, int q_ld, const bf16* k, const bf16* v,
                               int kv_ld, const float* bias, const float* mask, int n_masks,
                               bf16* out, int BN, int W, int H, float scale,
                               cudaStream_t stream) {
    static bool attr_set = false;
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            window_attn_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ATTN_SMEM);
        if (e != cudaSuccess) return e;
        attr_set = true;
    }
    if (BN <= 0) return cudaSuccess;
    dim3 grid(W / AQ, H, BN);
    window_attn_bf16<<<grid, ATHREADS, ATTN_SMEM, stream>>>(q, q_ld, k, v, kv_ld, bias, mask,
                                                            n_masks, out, W, H, scale);
    return cudaGetLastError();
}

}  // namespace scp
