// Kernel D: fused pairwise score + top-k (KNN), out[b, i] = the k columns j
// of largest  2 q_i.k_j - |q_i|^2 - |k_j|^2  (negated squared distance),
// in descending order, ties to the lowest column.
//
// Replaces scp_tpu/ops/pallas_knn.py::_knn_kernel (pallas_call in
// _knn_single, entry knn_pallas).  Features are read as f32 whatever their
// type, as the Pallas kernel casts its input; the dot product and the
// squared norms are chains of f32 fused multiply-adds over the columns in
// order, and the score ((2 dot - |q|^2) - |k|^2) rounds at each step.
//
// Design.  One block per (batch row, 64 queries); 8 warps, each owning 8
// queries.  Keys stream through shared memory in 64-row tiles.  A warp
// scores 32 keys at a time (lane = key) against its 8 queries, so each key
// row it loads feeds 8 dot products.  Each query's running top-k is one
// sorted list spread over the warp (lane j holds slot j, k <= 32) as a
// 64-bit key: order-preserving bits of the f32 score above (2^32-1 - col),
// so a larger key is a larger score and, on equal scores, a lower column.
// A key that beats slot k-1 is inserted with one ballot (its rank), one
// shuffle (the shift) and one broadcast (the new threshold).  No (N, N)
// score matrix exists, nothing is atomic, and the result does not depend
// on the order blocks run in: two launches give identical indices.
//
// Bound.  2*N*C operations per query, N*C*2 bytes in and N*k*8 bytes out
// per batch row: on the card's bf16 tensor peak the work is operation
// bound from C ~ 3 up.  This first kernel scores on the CUDA cores in f32
// (the products of bf16 inputs are exact there as on the tensor cores);
// at C = 3 its cost is the compare-and-insert per (query, key) pair, not
// the arithmetic.  Tensor-core scoring for wide C is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int QPW = 8;             // queries per warp
constexpr int TQ = WARPS * QPW;    // queries per block
constexpr int TK = 64;             // keys per shared-memory tile
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

// Row stride in floats: a multiple of 4 whose count of 16-byte chunks is
// odd, so 8 lanes reading 8 rows with one 16-byte load hit 8 distinct
// bank groups.
__host__ __device__ inline int row_stride(int c) {
    int cp = (c + 3) / 4 * 4;
    if ((cp / 4) % 2 == 0) cp += 4;
    return cp;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint64_t order_key(float s, int col) {
    uint32_t u = __float_as_uint(s);
    if ((u & 0x7fffffffu) == 0u) u = 0u;  // -0 and +0 tie
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((uint64_t)u << 32) | (uint64_t)(0xffffffffu - (uint32_t)col);
}

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
    uint32_t lo = __shfl_sync(FULL, (uint32_t)v, src);
    uint32_t hi = __shfl_sync(FULL, (uint32_t)(v >> 32), src);
    return ((uint64_t)hi << 32) | lo;
}

__device__ __forceinline__ uint64_t shfl_up64(uint64_t v) {
    uint32_t lo = __shfl_up_sync(FULL, (uint32_t)v, 1);
    uint32_t hi = __shfl_up_sync(FULL, (uint32_t)(v >> 32), 1);
    return ((uint64_t)hi << 32) | lo;
}

// |x_i|^2 per row in f32: a chain of fused multiply-adds over the columns
// in order, the rounding of the Pallas kernel's compiled norm (and of the
// plain version's fma_sqnorm).
template <typename T>
__global__ void row_sqnorm(const T* __restrict__ x, float* __restrict__ sq, int rows, int C) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= rows) return;
    const T* row = x + (size_t)r * C;
    float s = 0.0f;
    for (int c = 0; c < C; ++c) {
        const float v = to_f32(row[c]);
        s = fmaf(v, v, s);
    }
    sq[r] = s;
}

// C4 > 0: the padded row is exactly C4 16-byte chunks, and each warp keeps
// its queries in registers; C4 == 0: any width, queries read from shared
// memory.
template <typename T, int C4>
__global__ void __launch_bounds__(THREADS)
knn_topk(const T* __restrict__ feats, const float* __restrict__ sq, int N, int C, int k,
         int64_t* __restrict__ out) {
    extern __shared__ float4 smem4[];
    const int cp = row_stride(C);
    const int n4 = C4 > 0 ? C4 : cp / 4;
    float* qs = reinterpret_cast<float*>(smem4);  // TQ x cp
    float* ks = qs + TQ * cp;                     // TK x cp
    float* ksq = ks + TK * cp;                    // TK

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int b = blockIdx.y;
    const int q0 = blockIdx.x * TQ;
    const T* fb = feats + (size_t)b * N * C;
    const float* sqb = sq + (size_t)b * N;

    for (int e = tid; e < TQ * cp; e += THREADS) {
        const int r = e / cp, c = e % cp;
        const int qi = q0 + r;
        qs[e] = (qi < N && c < C) ? to_f32(fb[(size_t)qi * C + c]) : 0.0f;
    }
    __syncthreads();

    const float4* qw = reinterpret_cast<const float4*>(qs + warp * QPW * cp);
    float4 qreg[QPW][C4 > 0 ? C4 : 1];
    if (C4 > 0) {
#pragma unroll
        for (int j = 0; j < QPW; ++j)
#pragma unroll
            for (int c = 0; c < (C4 > 0 ? C4 : 1); ++c) qreg[j][c] = qw[j * (cp / 4) + c];
    }
    float qsq[QPW];
    uint64_t list[QPW], thr[QPW];
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
        const int qi = q0 + warp * QPW + j;
        qsq[j] = qi < N ? sqb[qi] : 0.0f;
        list[j] = 0;  // below every real key
        thr[j] = 0;
    }

    for (int k0 = 0; k0 < N; k0 += TK) {
        __syncthreads();  // the previous tile is no longer read
        for (int e = tid; e < TK * cp; e += THREADS) {
            const int r = e / cp, c = e % cp;
            const int kj = k0 + r;
            ks[e] = (kj < N && c < C) ? to_f32(fb[(size_t)kj * C + c]) : 0.0f;
        }
        for (int r = tid; r < TK; r += THREADS) ksq[r] = k0 + r < N ? sqb[k0 + r] : 0.0f;
        __syncthreads();

#pragma unroll 1
        for (int sub = 0; sub < TK; sub += 32) {
            const int col = k0 + sub + lane;
            const float4* krow = reinterpret_cast<const float4*>(ks + (sub + lane) * cp);
            float acc[QPW];
#pragma unroll
            for (int j = 0; j < QPW; ++j) acc[j] = 0.0f;
            if (C4 > 0) {
#pragma unroll
                for (int c = 0; c < (C4 > 0 ? C4 : 1); ++c) {
                    const float4 kv = krow[c];
#pragma unroll
                    for (int j = 0; j < QPW; ++j) {
                        acc[j] = fmaf(qreg[j][c].x, kv.x, acc[j]);
                        acc[j] = fmaf(qreg[j][c].y, kv.y, acc[j]);
                        acc[j] = fmaf(qreg[j][c].z, kv.z, acc[j]);
                        acc[j] = fmaf(qreg[j][c].w, kv.w, acc[j]);
                    }
                }
            } else {
                for (int c = 0; c < n4; ++c) {
                    const float4 kv = krow[c];
#pragma unroll
                    for (int j = 0; j < QPW; ++j) {
                        const float4 qv = qw[j * (cp / 4) + c];
                        acc[j] = fmaf(qv.x, kv.x, acc[j]);
                        acc[j] = fmaf(qv.y, kv.y, acc[j]);
                        acc[j] = fmaf(qv.z, kv.z, acc[j]);
                        acc[j] = fmaf(qv.w, kv.w, acc[j]);
                    }
                }
            }
            const bool valid = col < N;
            const float kn = ksq[sub + lane];
#pragma unroll
            for (int j = 0; j < QPW; ++j) {
                const float s = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, acc[j]), qsq[j]), kn);
                const uint64_t cand = valid ? order_key(s, col) : 0;
                unsigned m = __ballot_sync(FULL, cand > thr[j]);
                while (m) {
                    const int src = __ffs(m) - 1;
                    const uint64_t c = shfl64(cand, src);
                    const int p = __popc(__ballot_sync(FULL, list[j] > c));
                    const uint64_t up = shfl_up64(list[j]);
                    if (lane == p) list[j] = c;
                    else if (lane > p) list[j] = up;
                    thr[j] = shfl64(list[j], k - 1);
                    m &= ~(1u << src);
                    m &= __ballot_sync(FULL, cand > thr[j]);
                }
            }
        }
    }

#pragma unroll
    for (int j = 0; j < QPW; ++j) {
        const int qi = q0 + warp * QPW + j;
        if (qi < N && lane < k)
            out[((size_t)b * N + qi) * k + lane] =
                (int64_t)(0xffffffffu - (uint32_t)(list[j] & 0xffffffffu));
    }
}

size_t smem_bytes(int C) { return sizeof(float) * ((size_t)(TQ + TK) * row_stride(C) + TK); }

template <typename T, int C4>
cudaError_t launch(const T* feats, float* sq, int64_t* out, int B, int N, int C, int k,
                   cudaStream_t stream) {
    const size_t smem = smem_bytes(C);
    cudaError_t e = cudaFuncSetAttribute(knn_topk<T, C4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const int rows = B * N;
    row_sqnorm<T><<<(rows + 255) / 256, 256, 0, stream>>>(feats, sq, rows, C);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dim3 grid((N + TQ - 1) / TQ, B);
    knn_topk<T, C4><<<grid, THREADS, smem, stream>>>(feats, sq, N, C, k, out);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const T* feats, float* sq, int64_t* out, int B, int N, int C, int k,
                     cudaStream_t stream) {
    // positions (C <= 4, the static graph's) keep the queries in registers
    return row_stride(C) == 4 ? launch<T, 1>(feats, sq, out, B, N, C, k, stream)
                              : launch<T, 0>(feats, sq, out, B, N, C, k, stream);
}

}  // namespace

// feats (B, N, C) bf16 (is_bf16 = 1) or f32, contiguous; sq (B*N) f32
// scratch; out (B, N, k) int64.  Requires 1 <= k <= 32, k <= N, C <= 256.
extern "C" int scp_knn_topk(const void* feats, int is_bf16, void* sq, void* out, int B, int N,
                            int C, int k, void* stream) {
    if (B <= 0 || N <= 0) return (int)cudaSuccess;
    if (k < 1 || k > 32 || k > N || C < 1 || C > 256) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    float* sq_f = static_cast<float*>(sq);
    int64_t* o = static_cast<int64_t*>(out);
    cudaError_t e = is_bf16
        ? dispatch(static_cast<const bf16*>(feats), sq_f, o, B, N, C, k, s)
        : dispatch(static_cast<const float*>(feats), sq_f, o, B, N, C, k, s);
    return (int)e;
}

extern "C" const char* scp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
