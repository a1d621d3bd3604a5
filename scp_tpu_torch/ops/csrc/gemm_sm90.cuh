// The bf16 projection GEMM of kernels B and C for Hopper (sm_90a):
// out = epilogue(prologue(A) @ W^T), the function of common.cuh's
// gemm_bf16 (LN statistics in f32, two passes; the normalized value
// rounded to bf16 before the product; f32 accumulation; the epilogue adds
// the f32 bias, applies the activation, adds the bf16 residual in f32 and
// rounds to bf16).
//
// Replaces, inside B and C (scp_tpu/ops/pallas_swin.py::_self_kernel and
// _cross_kernel), the WMMA GEMM of common.cuh for K <= 256; K > 256 keeps
// it (the launcher picks by shape alone).
//
// Bound on this card: at K = 256 the products do 2 N / (1 + N / K) FLOPs
// per byte of A and out, above the H100's ~295 bf16 FLOPs/byte ridge for
// N >= 256, so the kernel should be tensor-core bound.  The design:
//   * a block owns 128 rows and keeps them resident in shared memory as
//     one bf16 tile of up to 128 x 256 (64 KB) in the 128-byte swizzle
//     wgmma reads: loaded once with 16-byte loads (each consumer warpgroup
//     loads 64 rows), LN statistics computed once per row (the WMMA
//     kernel recomputed them in every N-tile block);
//   * the two consumer warpgroups take alternate BN-wide N tiles over all
//     128 rows (two wgmma m64nBNk16 per k step, A and W from shared
//     memory, one group in flight while the next stage is awaited);
//   * each warpgroup's W tiles stream through its own 3-stage ring of
//     BN x 64 tiles, filled by its own producer thread with TMA
//     (cp.async.bulk.tensor) and mbarriers; the producer warpgroup gives
//     its registers to the consumers (setmaxnreg);
//   * the epilogue (bias, activation, residual, rounding) runs from the
//     accumulator registers into a swizzled shared-memory staging tile,
//     into which the residual was TMA-loaded during the products, and one
//     thread stores the tile with TMA, asynchronously.  Writing 4-byte
//     pairs from the accumulator layout straight to global memory cost
//     more than the products at the main path's shapes;
//   * ping-pong: the warpgroups take turns issuing their tiles' products
//     (named barriers), so one warpgroup's epilogue runs while the
//     other's products do;
//   * where M / 128 rows leave SMs idle, BN narrows to 64 and N is split
//     across blocks (each recomputes LN for its rows).  Each output
//     element sums K in one fixed order: no split-K, no atomics, two
//     launches give identical bits.
// Limits: K % 64 == 0 and K <= 256 (the resident tile), N % 64 == 0, row
// strides of A, out and the residual multiples of 8 elements (16 bytes),
// ragged M (rows past M are zero on load and clipped by the store's map).
// The output may be a column slice of a wider buffer (row stride ldo).
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace scp {

constexpr int SM90_STAGES = 3;  // each consumer warpgroup's W ring: BN x 64 tiles
constexpr int SM90_MAXK = 256;  // the resident A tile: 128 x 256 bf16

// The epilogue of one warpgroup's 64 rows x BN columns into its staging
// tile (BN / 64 boxes of 64 rows x 128 bytes in the 128-byte swizzle: the
// layout the output's TMA store reads and the residual's TMA load
// writes): act(acc + bias), plus the residual read in place, rounded to
// bf16.  Conflict-free: the 8 rows a warp writes at once sit in 8
// different 16-byte chunk columns.
template <int BN, int ACT>
__device__ __forceinline__ void stage_tile(const float (&acc)[BN / 2], uint8_t* stage,
                                           const float* __restrict__ bias, int n0,
                                           bool resid) {
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int r0 = (tid >> 5) * 16 + (lane >> 2);
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(bias + n0 + 8 * j + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
                stage + (j >> 3) * 8192 + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * t);
            float v0 = act_sm90(acc[4 * j + 2 * h] + b.x, ACT);
            float v1 = act_sm90(acc[4 * j + 2 * h + 1] + b.y, ACT);
            if (resid) {
                const __nv_bfloat162 rv = *p;
                v0 = __bfloat162float(rv.x) + v0;
                v1 = __bfloat162float(rv.y) + v1;
            }
            *p = __floats2bfloat162_rn(v0, v1);
        }
    }
}

// W (N, K) through `w_map` (boxes of BN rows x 64); the output (M, N) and
// the residual (M, N, when has_resid) through `o_map` and `r_map` (boxes
// of 64 rows x 64).  Block (x, y): rows 128 y.., N tiles
// [x tiles_per_block, ..); consumer warpgroup w takes the block's tiles
// w, w + 2, .. over all 128 rows, from its own W ring, which producer
// thread w fills.
template <int BN, bool LN>
__global__ void __launch_bounds__(SM90_THREADS, 1)
gemm_sm90(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap o_map,
          const __grid_constant__ CUtensorMap r_map, const bf16* __restrict__ A, int lda,
          const float* __restrict__ ln_scale, const float* __restrict__ ln_bias, float eps,
          const float* __restrict__ bias, int has_resid, int M, int K, int n_tiles,
          int tiles_per_block, int act) {
    using namespace sm90;
    constexpr int TILE = BN * 128;   // a ring stage: BN rows of W x 64
    constexpr int HALF = BN * 128;   // 64 output rows x BN: BN / 64 boxes of 8 KB
    extern __shared__ __align__(1024) uint8_t sm90_smem[];
    uint8_t* smem = sm90_smem + ((1024 - (smem_u32(sm90_smem) & 1023)) & 1023);
    const int kblocks = K / 64;
    uint8_t* a_tile = smem;
    uint8_t* rings = smem + kblocks * 16384;              // 2 rings of SM90_STAGES stages
    uint8_t* staging = rings + 2 * SM90_STAGES * TILE;    // 2 tiles of 128 rows x BN
    const uint32_t bars = smem_u32(staging + 4 * HALF);   // mbarriers, 8 bytes each
    const int wg = threadIdx.x >> 7;
    const int m0 = blockIdx.y * SM90_BM;
    const int nt0 = blockIdx.x * tiles_per_block;
    const int tiles = min(nt0 + tiles_per_block, n_tiles) - nt0;

    // ring w: full barriers bars + 8 (w * ST + s), empty ones after all full
    // ones; the residual barriers of the two staging tiles last
    auto full = [&](int w, int s) { return bars + 8 * (w * SM90_STAGES + s); };
    auto empty = [&](int w, int s) { return bars + 8 * (2 * SM90_STAGES + w * SM90_STAGES + s); };
    const uint32_t resid_bar0 = bars + 8 * 4 * SM90_STAGES;
    if (threadIdx.x == 0) {
        for (int w = 0; w < 2; ++w)
            for (int s = 0; s < SM90_STAGES; ++s) {
                mbar_init(full(w, s), 1);   // the producer's expect_tx
                mbar_init(empty(w, s), 1);  // the consumer warpgroup's release
            }
        mbar_init(resid_bar0, 1);
        mbar_init(resid_bar0 + 8, 1);
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == 2) {  // producers: thread 32 w fills ring w with its warpgroup's tiles
        reg_dealloc<SM90_PRODUCER_REGS>();
        const int p = threadIdx.x - 256;
        if (p == 0 || p == 32) {
            const int w = p >> 5;
            tma_prefetch_map(&w_map);
            const uint32_t ring = smem_u32(rings) + w * SM90_STAGES * TILE;
            int s = 0;
            uint32_t ph = 0;
            for (int i = w; i < tiles; i += 2)
                for (int kb = 0; kb < kblocks; ++kb) {
                    mbar_wait(empty(w, s), ph ^ 1);
                    mbar_expect_tx(full(w, s), TILE);
                    tma_load_2d(ring + s * TILE, &w_map, full(w, s), kb * 64, (nt0 + i) * BN);
                    if (++s == SM90_STAGES) {
                        s = 0;
                        ph ^= 1;
                    }
                }
        }
    } else {  // consumers: all 128 rows, alternate N tiles
        reg_alloc<SM90_CONSUMER_REGS>();
        load_rows_sw128<LN>(a_tile, A, lda, M, m0, wg, K, ln_scale, ln_bias, eps);
        fence_proxy_async();
        named_bar_sync(1, 256);  // both halves of the row tile are in place
        const uint32_t a0 = smem_u32(a_tile);
        const uint32_t ring = smem_u32(rings) + wg * SM90_STAGES * TILE;
        const int tid = threadIdx.x & 127;
        const bool resid = has_resid != 0;
        uint8_t* stage = staging + wg * 2 * HALF;
        const uint32_t rbar = resid_bar0 + 8 * wg;
        uint32_t rph = 0;
        int s = 0;
        uint32_t ph = 0;
        // ping-pong: the warpgroups take turns issuing a tile's products
        // (barrier 3 + wg is this warpgroup's turn), so one's epilogue runs
        // while the other's products do; turn i is tile i's, warpgroup 1
        // hands warpgroup 0 the first turn, the last turn hands over none
        const int my_turn = 3 + wg, other_turn = 4 - wg;
        if (wg == 1) named_bar_arrive(3, 256);
        float acc0[BN / 2], acc1[BN / 2];  // rows 0-63 and 64-127
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0.0f;
        for (int i = wg; i < tiles; i += 2) {
            const int nt = nt0 + i;
            if (tid == 0) {  // free the staging tile, then fetch the residual into it
                bulk_wait_read();
                if (resid) {
                    mbar_expect_tx(rbar, 2 * HALF);
                    for (int h = 0; h < 2; ++h)
                        for (int b = 0; b < BN / 64; ++b)
                            tma_load_2d(smem_u32(stage) + h * HALF + b * 8192, &r_map, rbar,
                                        nt * BN + b * 64, m0 + 64 * h);
                }
            }
            named_bar_sync(my_turn, 256);
            int prev = 0;
            for (int kb = 0; kb < kblocks; ++kb) {
                mbar_wait(full(wg, s), ph);
                wgmma_fence();
#pragma unroll
                for (int ks = 0; ks < 4; ++ks) {
                    const uint64_t wd = desc_sw128(ring + s * TILE + ks * 32);
                    Wgmma<BN>::ss(acc0, desc_sw128(a0 + kb * 16384 + ks * 32), wd,
                                  (kb | ks) != 0);
                    Wgmma<BN>::ss(acc1, desc_sw128(a0 + kb * 16384 + 8192 + ks * 32), wd,
                                  (kb | ks) != 0);
                }
                wgmma_commit();
                if (kb > 0) {  // the previous stage's products are done: release it
                    wgmma_wait<1>();
                    if (tid == 0) mbar_arrive(empty(wg, prev));
                }
                prev = s;
                if (++s == SM90_STAGES) {
                    s = 0;
                    ph ^= 1;
                }
            }
            if (i + 1 < tiles) named_bar_arrive(other_turn, 256);
            wgmma_wait<0>();
            reg_fence(acc0);
            reg_fence(acc1);
            if (tid == 0) mbar_arrive(empty(wg, prev));

            named_bar_sync(5 + wg, 128);  // the leader has freed the staging tile
            if (resid) {
                mbar_wait(rbar, rph);
                rph ^= 1;
            }
            if (act == ACT_GELU) {
                stage_tile<BN, ACT_GELU>(acc0, stage, bias, nt * BN, resid);
                stage_tile<BN, ACT_GELU>(acc1, stage + HALF, bias, nt * BN, resid);
            } else if (act == ACT_LEAKY) {
                stage_tile<BN, ACT_LEAKY>(acc0, stage, bias, nt * BN, resid);
                stage_tile<BN, ACT_LEAKY>(acc1, stage + HALF, bias, nt * BN, resid);
            } else {
                stage_tile<BN, ACT_NONE>(acc0, stage, bias, nt * BN, resid);
                stage_tile<BN, ACT_NONE>(acc1, stage + HALF, bias, nt * BN, resid);
            }
            fence_proxy_async();
            named_bar_sync(5 + wg, 128);
            if (tid == 0) {  // rows past M are clipped by the map
                for (int h = 0; h < 2 && m0 + 64 * h < M; ++h)
                    for (int b = 0; b < BN / 64; ++b)
                        tma_store_2d(&o_map, smem_u32(stage) + h * HALF + b * 8192,
                                     nt * BN + b * 64, m0 + 64 * h);
                bulk_commit();
            }
        }
        if (tid == 0) bulk_wait();
    }
}

inline int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            n = 132;
    }
    return n;
}

// the shapes gemm_sm90 takes; the Python seam's rule (ops/proj_gemm.py::arm)
inline bool gemm_sm90_fits(int N, int K, int lda, int ldo, int ldr) {
    return K > 0 && K % 64 == 0 && K <= SM90_MAXK && N > 0 && N % 64 == 0 && lda % 8 == 0 &&
           ldo % 8 == 0 && ldr % 8 == 0;
}

template <int BN, bool LN>
cudaError_t launch_gemm_sm90_bn(const bf16* A, int lda, const float* ln_scale,
                                const float* ln_bias, float eps, const bf16* W, const float* bias,
                                const bf16* resid, int ldr, bf16* out, int ldo, int M, int N,
                                int K, int act, cudaStream_t stream) {
    CUtensorMap w_map, o_map, r_map;
    cudaError_t e = sm90::make_map_bf16(&w_map, W, N, K, K, BN);
    if (e == cudaSuccess) e = sm90::make_map_bf16(&o_map, out, M, N, ldo, 64);
    if (e == cudaSuccess)
        e = resid != nullptr ? sm90::make_map_bf16(&r_map, resid, M, N, ldr, 64)
                             : sm90::make_map_bf16(&r_map, out, M, N, ldo, 64);
    if (e != cudaSuccess) return e;
    const size_t smem = 1024 + (size_t)(K / 64) * 16384 + (size_t)(2 * SM90_STAGES + 4) * BN * 128 +
                        8 * (4 * SM90_STAGES + 2);
    e = cudaFuncSetAttribute(gemm_sm90<BN, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    const int m_tiles = (M + SM90_BM - 1) / SM90_BM;
    const int n_tiles = N / BN;
    int per_block = n_tiles;
    if (m_tiles < sm_count()) {  // split N so the grid covers the SMs
        const int split = min(n_tiles, (sm_count() + m_tiles - 1) / m_tiles);
        per_block = (n_tiles + split - 1) / split;
    }
    const dim3 grid((n_tiles + per_block - 1) / per_block, m_tiles);
    gemm_sm90<BN, LN><<<grid, SM90_THREADS, smem, stream>>>(
        w_map, o_map, r_map, A, lda, ln_scale, ln_bias, eps, bias, resid != nullptr, M, K,
        n_tiles, per_block, act);
    return cudaGetLastError();
}

// BN = 128 where N allows; 64 where 128-row blocks alone would leave SMs
// idle
inline cudaError_t launch_gemm_sm90(bool ln, const bf16* A, int lda, const float* ln_scale,
                                    const float* ln_bias, float eps, const bf16* W,
                                    const float* bias, const bf16* resid, int ldr, bf16* out,
                                    int ldo, int M, int N, int K, int act, cudaStream_t stream) {
    if (!gemm_sm90_fits(N, K, lda, ldo, resid != nullptr ? ldr : 8)) return cudaErrorInvalidValue;
    if (M <= 0) return cudaSuccess;
    const int m_tiles = (M + SM90_BM - 1) / SM90_BM;
    const int bn = N % 128 == 0 && m_tiles * (N / 128) >= sm_count() ? 128 : 64;
#define SCP_GEMM_SM90(BN)                                                                     \
    return ln ? launch_gemm_sm90_bn<BN, true>(A, lda, ln_scale, ln_bias, eps, W, bias, resid,  \
                                              ldr, out, ldo, M, N, K, act, stream)             \
              : launch_gemm_sm90_bn<BN, false>(A, lda, ln_scale, ln_bias, eps, W, bias, resid, \
                                               ldr, out, ldo, M, N, K, act, stream)
    if (bn == 128) SCP_GEMM_SM90(128);
    SCP_GEMM_SM90(64);
#undef SCP_GEMM_SM90
}

// the bf16 projection GEMM of B and C: gemm_sm90 (sm90 != 0) or the WMMA
// kernel of common.cuh (K > 256)
inline cudaError_t launch_proj_gemm(int sm90, bool ln, const bf16* A, int lda,
                                    const float* ln_scale, const float* ln_bias, float eps,
                                    const bf16* W, const float* bias, const bf16* resid, int ldr,
                                    bf16* out, int ldo, int M, int N, int K, int act,
                                    cudaStream_t stream) {
    if (sm90)
        return launch_gemm_sm90(ln, A, lda, ln_scale, ln_bias, eps, W, bias, resid, ldr, out, ldo,
                                M, N, K, act, stream);
    return launch_gemm(ln, A, lda, ln_scale, ln_bias, eps, W, bias, resid, ldr, out, ldo, M, N, K,
                       act, stream);
}

// f32 has one arm, the CUDA-core GEMM of common.cuh
inline cudaError_t launch_proj_gemm(int sm90, bool ln, const float* A, int lda,
                                    const float* ln_scale, const float* ln_bias, float eps,
                                    const float* W, const float* bias, const float* resid,
                                    int ldr, float* out, int ldo, int M, int N, int K, int act,
                                    cudaStream_t stream) {
    if (sm90) return cudaErrorInvalidValue;
    return launch_gemm(ln, A, lda, ln_scale, ln_bias, eps, W, bias, resid, ldr, out, ldo, M, N, K,
                       act, stream);
}

}  // namespace scp
