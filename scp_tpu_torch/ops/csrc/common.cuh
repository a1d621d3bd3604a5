// The GEMM of the port's Swin-sublayer kernels A, B and C at the shapes
// the Hopper kernels (gemm_sm90.cuh, mlp.cu) do not take, and in f32
// (sm_90a): out = epilogue(prologue(A) @ W^T), in two element types.
//
//   * gemm_bf16: bf16 operands on the tensor cores (WMMA 16x16x16, f32
//     accumulation).  The optional prologue is a LayerNorm of each A row
//     (statistics in f32, normalized value rounded to bf16 before the
//     product); the epilogue adds an f32 bias, applies GELU (exact erf) or
//     LeakyReLU(0.01), adds the bf16 residual in f32 and rounds to bf16.
//   * gemm_f32: the same prologue and epilogue in full f32 on the CUDA
//     cores (FMAs, no TF32): a plain 64x64-tile kernel for f32 models.
//
// Bound on this card: at C=256 the sublayer GEMMs do 256..1024 FLOPs per
// byte of A they read, above the H100's ~295 bf16 FLOPs/byte ridge, so a
// tuned kernel would be tensor-core bound (f32: CUDA-core bound, 67
// TFLOP/s).  These kernels use WMMA / FMAs without TMA or wgmma
// pipelining: bf16 reaches them only at K > 256 (B, C and A's fc1 at
// C > 256, A's fc2 there).  The window attention between the
// projections is attn_core.cuh.
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

// erf in f32 without branches, for the Hopper kernels (gemm_sm90.cuh,
// mlp.cu): Eigen's generic float rational approximation on the argument
// clamped to [-4, 4] (an odd degree-13 numerator over an even degree-8
// denominator) and a fast division; max abs error 4.2e-7, against 2.9e-7
// for JAX's f32 erf on the CPU (tests/test_torch_proj_gemm.py reads these
// coefficients and checks both).  libdevice's erff branches on |x|, and a
// warp holding both sides of the branch pays for both.
__device__ __forceinline__ float erf_rational(float a) {
    const float x = fminf(fmaxf(a, -4.0f), 4.0f);
    const float x2 = x * x;
    float p = fmaf(x2, -2.72614225801306e-10f, 2.77068142495902e-08f);
    p = fmaf(x2, p, -2.10102402082508e-06f);
    p = fmaf(x2, p, -5.69250639462346e-05f);
    p = fmaf(x2, p, -7.34990630326855e-04f);
    p = fmaf(x2, p, -2.95459980854025e-03f);
    p = fmaf(x2, p, -1.60960333262415e-02f);
    float q = fmaf(x2, -1.45660718464996e-05f, -2.13374055278905e-04f);
    q = fmaf(x2, q, -1.68282697438203e-03f);
    q = fmaf(x2, q, -7.37332916720468e-03f);
    q = fmaf(x2, q, -1.42647390514189e-02f);
    return __fdividef(x * p, q);
}

// act_apply with GELU through erf_rational: the Hopper kernels' epilogues
__device__ __forceinline__ float act_sm90(float v, int act) {
    if (act == ACT_GELU) return 0.5f * v * (1.0f + erf_rational(v * 0.70710678118654752f));
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

// ---- f32 GEMM (CUDA cores, no TF32) -------------------------------------------

constexpr int FBM = 64;   // rows of A per block
constexpr int FBN = 64;   // output columns per block
constexpr int FBK = 16;   // depth per shared-memory stage
constexpr int FGT = 256;  // 16 x 16 threads, each a 4 x 4 output patch

// A (M, K) f32, row stride lda; W (N, K) f32; out (M, N) f32, row stride
// ldo; resid (M, N) f32 or null.  Requires K % FBK == 0, N % FBN == 0,
// lda % 4 == 0 (16-byte rows).
template <bool LN>
__global__ void __launch_bounds__(FGT)
gemm_f32(const float* __restrict__ A, int lda, const float* __restrict__ ln_scale,
         const float* __restrict__ ln_bias, float eps, const float* __restrict__ W,
         const float* __restrict__ bias, const float* __restrict__ resid, int ldr,
         float* __restrict__ out, int ldo, int M, int N, int K, int act) {
    __shared__ __align__(16) float As[FBK][FBM + 4];  // A tile, transposed
    __shared__ __align__(16) float Ws[FBK][FBN + 4];  // W tile, transposed
    __shared__ float mu_s[FBM];
    __shared__ float rs_s[FBM];

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int m0 = blockIdx.y * FBM;
    const int n0 = blockIdx.x * FBN;

    if (LN) {  // two-pass row statistics in f32: each warp owns 8 rows
        for (int r = warp; r < FBM; r += FGT / 32) {
            const int m = m0 + r;
            float mu = 0.0f, var = 0.0f;
            if (m < M) {
                const float* row = A + (size_t)m * lda;
                float s = 0.0f;
                for (int k = lane; k < K; k += 32) s += row[k];
                for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
                mu = s / (float)K;
                float q = 0.0f;
                for (int k = lane; k < K; k += 32) {
                    const float d = row[k] - mu;
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

    const int tx = tid % 16;  // output columns n0 + tx*4 .. +3
    const int ty = tid / 16;  // output rows m0 + ty*4 .. +3
    const int lr = tid >> 2;  // loader: row of the A / W tile
    const int lk = (tid & 3) * 4;  // loader: 4 depth columns
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += FBK) {
        const int m = m0 + lr;
        float4 av = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (m < M) {
            av = *reinterpret_cast<const float4*>(A + (size_t)m * lda + k0 + lk);
            if (LN) {
                const int k = k0 + lk;
                const float mu = mu_s[lr], rs = rs_s[lr];
                av.x = (av.x - mu) * rs * ln_scale[k + 0] + ln_bias[k + 0];
                av.y = (av.y - mu) * rs * ln_scale[k + 1] + ln_bias[k + 1];
                av.z = (av.z - mu) * rs * ln_scale[k + 2] + ln_bias[k + 2];
                av.w = (av.w - mu) * rs * ln_scale[k + 3] + ln_bias[k + 3];
            }
        }
        As[lk + 0][lr] = av.x;
        As[lk + 1][lr] = av.y;
        As[lk + 2][lr] = av.z;
        As[lk + 3][lr] = av.w;
        const float4 wv = *reinterpret_cast<const float4*>(W + (size_t)(n0 + lr) * K + k0 + lk);
        Ws[lk + 0][lr] = wv.x;
        Ws[lk + 1][lr] = wv.y;
        Ws[lk + 2][lr] = wv.z;
        Ws[lk + 3][lr] = wv.w;
        __syncthreads();
#pragma unroll
        for (int k = 0; k < FBK; ++k) {
            const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
            const float4 b4 = *reinterpret_cast<const float4*>(&Ws[k][tx * 4]);
            const float av4[4] = {a4.x, a4.y, a4.z, a4.w};
            const float bv4[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av4[i], bv4[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty * 4 + i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx * 4 + j;
            float v = act_apply(acc[i][j] + bias[n], act);
            if (resid != nullptr) v = resid[(size_t)m * ldr + n] + v;
            out[(size_t)m * ldo + n] = v;
        }
    }
}

inline cudaError_t launch_gemm(bool ln, const float* A, int lda, const float* ln_scale,
                               const float* ln_bias, float eps, const float* W,
                               const float* bias, const float* resid, int ldr, float* out,
                               int ldo, int M, int N, int K, int act, cudaStream_t stream) {
    if (M <= 0) return cudaSuccess;
    dim3 grid(N / FBN, (M + FBM - 1) / FBM);
    if (ln)
        gemm_f32<true><<<grid, FGT, 0, stream>>>(A, lda, ln_scale, ln_bias, eps, W, bias, resid,
                                                  ldr, out, ldo, M, N, K, act);
    else
        gemm_f32<false><<<grid, FGT, 0, stream>>>(A, lda, ln_scale, ln_bias, eps, W, bias,
                                                   resid, ldr, out, ldo, M, N, K, act);
    return cudaGetLastError();
}

}  // namespace scp
