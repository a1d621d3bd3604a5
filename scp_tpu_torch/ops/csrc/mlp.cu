// Kernel A: the Swin MLP sublayer, out = x + W2 act(W1 LN(x) + b1) + b2.
//
// Replaces scp_tpu/ops/pallas_mlp.py::_kernel (pallas_call in _fused_impl).
// Numerics follow the Pallas kernel: LN in f32, rounded to bf16; fc1 with
// f32 accumulation, plus b1; the activation (GELU with erf, or LeakyReLU
// 0.01) in f32, rounded to bf16 as fc2's operand; fc2 with f32
// accumulation, plus b2; the residual added in f32, rounded to bf16.
//
// bf16 at C <= 256: one fused Hopper kernel, mlp_sm90.  Bound on this card:
// 4 M C F FLOPs against 4 M C bytes of x and out, tensor-core bound; the
// (M, F) intermediate never leaves the SM, as the Pallas kernel keeps it
// in VMEM (through device memory it would cost 4 M F bytes, more than the
// whole bound at F = 4 C).  Per 128-row block:
//   * the rows' LN(x) stay resident in shared memory (64 KB at C = 256,
//     loaded as the projection GEMM loads them, sm90.cuh's
//     load_rows_sw128: statistics once per row);
//   * a producer thread streams, per chunk of 64 hidden units, W1's
//     64 x C rows and W2's C x 64 columns through a 2-stage TMA ring
//     (64 KB a stage at C = 256);
//   * each consumer warpgroup (64 rows) runs fc1 of a chunk as wgmma
//     m64n64k16 from shared memory into 32 f32 registers, adds b1 and
//     applies the activation in registers, rounds to bf16 and feeds the
//     result as the register A operand of fc2's wgmma m64nCk16 (the
//     FlashAttention-3 reuse of an accumulator as an operand), which
//     accumulates the chunk into 64 x C f32 registers;
//   * fc2 of chunk j and fc1 of chunk j + 1 are issued back to back, and
//     the two warpgroups take turns issuing them (named barriers, the
//     FlashAttention-3 ping-pong), so one warpgroup's activation (erf, as
//     costly as the products at F = 4 C) runs while the other's products
//     do;
//   * erf is common.cuh's branch-free erf_rational (f32 erf to 4.2e-7):
//     the ping-pong hides the activation only as far as it is no costlier
//     than the other warpgroup's products;
//   * the residual re-reads x (just read, still in L2).
// F is summed in one fixed order per row: no split, no atomics.
// bf16 at C > 256 and f32 take two launches of the GEMMs of common.cuh
// (WMMA, or CUDA-core FMAs for f32) through an (M, F) buffer.
#include "common.cuh"
#include "sm90.cuh"

namespace scp {

constexpr int MLP_STAGES = 2;
constexpr int MLP_MAXC = 256;  // the resident tile and fc2's 64 x C accumulator

// fc1 of one chunk, issued and committed: this warpgroup's 64 LN(x) rows
// (KB blocks of 64 columns) times the stage's 64 W1 rows into acc1
template <int KB>
__device__ __forceinline__ void mlp_fc1(float (&acc1)[32], uint32_t xa, uint32_t stage) {
    using namespace sm90;
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
            Wgmma<64>::ss(acc1, desc_sw128(xa + kb * 16384 + ks * 32),
                          desc_sw128(stage + kb * 8192 + ks * 32), (kb | ks) != 0);
    wgmma_commit();
}

template <int C>
__global__ void __launch_bounds__(SM90_THREADS, 1)
mlp_sm90(const __grid_constant__ CUtensorMap w1_map, const __grid_constant__ CUtensorMap w2_map,
         const bf16* __restrict__ x, const float* __restrict__ ln_scale,
         const float* __restrict__ ln_bias, float eps, const float* __restrict__ b1,
         const float* __restrict__ b2, bf16* __restrict__ out, int M, int F, int act) {
    using namespace sm90;
    constexpr int KB = C / 64;
    constexpr int W1_BYTES = KB * 8192;  // 64 rows of W1 (F, C): KB boxes of 64 x 64
    constexpr int W2_BYTES = C * 128;    // all C rows of W2 (C, F) x 64 columns
    constexpr int STAGE = W1_BYTES + W2_BYTES;
    extern __shared__ __align__(1024) uint8_t sm90_smem[];
    uint8_t* smem = sm90_smem + ((1024 - (smem_u32(sm90_smem) & 1023)) & 1023);
    uint8_t* x_tile = smem;
    const uint32_t ring0 = smem_u32(smem + KB * 16384);
    const uint32_t full0 = ring0 + MLP_STAGES * STAGE;
    const uint32_t empty0 = full0 + 8 * MLP_STAGES;
    const int wg = threadIdx.x >> 7;
    const int m0 = blockIdx.x * SM90_BM;
    const int chunks = F / 64;

    if (threadIdx.x == 0) {
        for (int s = 0; s < MLP_STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, 2);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == 2) {  // producer
        reg_dealloc<SM90_PRODUCER_REGS>();
        if (threadIdx.x == 256) {
            tma_prefetch_map(&w1_map);
            tma_prefetch_map(&w2_map);
            int s = 0;
            uint32_t ph = 0;
            for (int j = 0; j < chunks; ++j) {
                mbar_wait(empty0 + 8 * s, ph ^ 1);
                mbar_expect_tx(full0 + 8 * s, STAGE);
                const uint32_t st = ring0 + s * STAGE;
                for (int kb = 0; kb < KB; ++kb)
                    tma_load_2d(st + kb * 8192, &w1_map, full0 + 8 * s, kb * 64, j * 64);
                tma_load_2d(st + W1_BYTES, &w2_map, full0 + 8 * s, j * 64, 0);
                if (++s == MLP_STAGES) {
                    s = 0;
                    ph ^= 1;
                }
            }
        }
    } else {  // consumers: 64 rows each
        reg_alloc<SM90_CONSUMER_REGS>();
        load_rows_sw128<true>(x_tile, x, C, M, m0, wg, C, ln_scale, ln_bias, eps);
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
        const uint32_t xa = smem_u32(x_tile) + wg * 8192;
        const int tid = threadIdx.x & 127;
        const int lane = tid & 31;
        float acc1[32], acc2[C / 2];
        uint32_t a[16];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc1[i] = 0.0f;
#pragma unroll
        for (int i = 0; i < C / 2; ++i) acc2[i] = 0.0f;

        // ping-pong: the warpgroups take turns issuing their products
        // (barrier 3 + wg is this warpgroup's turn), so one's activation
        // runs while the other's products do; warpgroup 1 hands warpgroup 0
        // the first turn and skips handing back its last
        const int my_turn = 3 + wg, other_turn = 4 - wg;
        if (wg == 1) named_bar_arrive(3, 256);
        int s = 0;
        uint32_t ph = 0;
        mbar_wait(full0, 0);
        named_bar_sync(my_turn, 256);
        mlp_fc1<KB>(acc1, xa, ring0);
        named_bar_arrive(other_turn, 256);
        wgmma_wait<0>();
        reg_fence(acc1);
        for (int j = 0; j < chunks; ++j) {
            // b1 and the activation in f32, rounded to bf16 as fc2's A fragments:
            // n8 block jj of the fc1 accumulator is k columns 8 (jj % 2).. of
            // fc2's k16 step jj / 2
            const int f = j * 64 + 2 * (lane & 3);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                const float2 b = *reinterpret_cast<const float2*>(b1 + f + 8 * jj);
                const int q = (jj >> 1) * 4 + (jj & 1) * 2;
                a[q] = pack_bf16(act_sm90(acc1[4 * jj] + b.x, act),
                                 act_sm90(acc1[4 * jj + 1] + b.y, act));
                a[q + 1] = pack_bf16(act_sm90(acc1[4 * jj + 2] + b.x, act),
                                     act_sm90(acc1[4 * jj + 3] + b.y, act));
            }
            const int cur = s;
            if (++s == MLP_STAGES) {
                s = 0;
                ph ^= 1;
            }
            if (j + 1 < chunks) mbar_wait(full0 + 8 * s, ph);
            named_bar_sync(my_turn, 256);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
                Wgmma<C>::rs(acc2, a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3],
                             desc_sw128(ring0 + cur * STAGE + W1_BYTES + ks * 32), 1);
            wgmma_commit();
            if (j + 1 < chunks) mlp_fc1<KB>(acc1, xa, ring0 + s * STAGE);
            if (wg == 0 || j + 1 < chunks) named_bar_arrive(other_turn, 256);
            wgmma_wait<0>();
            reg_fence(acc1);
            reg_fence(acc2);
            if (tid == 0) mbar_arrive(empty0 + 8 * cur);
        }

        const int row = m0 + wg * 64 + (tid >> 5) * 16 + (lane >> 2);
        const int col = 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
            const float2 b = *reinterpret_cast<const float2*>(b2 + col + 8 * j);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = row + 8 * h;
                if (m >= M) continue;
                const __nv_bfloat162 r =
                    *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)m * C + col + 8 * j);
                const float v0 = __bfloat162float(r.x) + (acc2[4 * j + 2 * h] + b.x);
                const float v1 = __bfloat162float(r.y) + (acc2[4 * j + 2 * h + 1] + b.y);
                *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * C + col + 8 * j) =
                    __floats2bfloat162_rn(v0, v1);
            }
        }
    }
}

template <int C>
cudaError_t launch_mlp_sm90_c(const bf16* x, const float* ln_scale, const float* ln_bias,
                              const bf16* w1, const float* b1, const bf16* w2, const float* b2,
                              bf16* out, int M, int F, float eps, int act, cudaStream_t stream) {
    CUtensorMap m1, m2;
    cudaError_t e = sm90::make_map_bf16(&m1, w1, F, C, C, 64);  // W1 (F, C): 64 x 64 boxes
    if (e != cudaSuccess) return e;
    e = sm90::make_map_bf16(&m2, w2, C, F, F, C);  // W2 (C, F): C x 64 boxes
    if (e != cudaSuccess) return e;
    const size_t smem = 1024 + (size_t)(C / 64) * 16384 +
                        (size_t)MLP_STAGES * ((C / 64) * 8192 + C * 128) + 16 * MLP_STAGES;
    e = cudaFuncSetAttribute(mlp_sm90<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const int blocks = (M + SM90_BM - 1) / SM90_BM;
    mlp_sm90<C><<<blocks, SM90_THREADS, smem, stream>>>(m1, m2, x, ln_scale, ln_bias, eps, b1, b2,
                                                        out, M, F, act);
    return cudaGetLastError();
}

// the shapes mlp_sm90 takes; the Python seam's rule (ops/mlp.py::kernel_arm)
inline bool mlp_sm90_fits(int C, int F) {
    return C >= 64 && C % 64 == 0 && C <= MLP_MAXC && F > 0 && F % 64 == 0;
}

inline cudaError_t launch_mlp_sm90(const bf16* x, const float* ln_scale, const float* ln_bias,
                                   const bf16* w1, const float* b1, const bf16* w2,
                                   const float* b2, bf16* out, int M, int C, int F, float eps,
                                   int act, cudaStream_t s) {
    if (!mlp_sm90_fits(C, F)) return cudaErrorInvalidValue;
    if (M <= 0) return cudaSuccess;
    switch (C) {
        case 64:
            return launch_mlp_sm90_c<64>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, M, F, eps,
                                         act, s);
        case 128:
            return launch_mlp_sm90_c<128>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, M, F, eps,
                                          act, s);
        case 192:
            return launch_mlp_sm90_c<192>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, M, F, eps,
                                          act, s);
        default:
            return launch_mlp_sm90_c<256>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, M, F, eps,
                                          act, s);
    }
}

}  // namespace scp

namespace {

// two launches of the GEMMs of common.cuh through the (M, F) buffer `mid`
template <typename T>
int ln_mlp_two_gemms(const void* x, const float* ln_scale, const float* ln_bias, const void* w1,
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

// x, w1, w2, out in bf16 (is_f32 == 0) or f32 (is_f32 == 1).  fused != 0:
// the fused bf16 kernel (mid unused); else two GEMM launches through mid.
extern "C" int scp_ln_mlp_residual(const void* x, const float* ln_scale, const float* ln_bias,
                                   const void* w1, const float* b1, const void* w2,
                                   const float* b2, void* mid, void* out, int M, int C, int F,
                                   float eps, int act, int is_f32, int fused, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (is_f32)
        return ln_mlp_two_gemms<float>(x, ln_scale, ln_bias, w1, b1, w2, b2, mid, out, M, C, F,
                                       eps, act, s);
    if (fused)
        return (int)scp::launch_mlp_sm90(
            static_cast<const scp::bf16*>(x), ln_scale, ln_bias, static_cast<const scp::bf16*>(w1),
            b1, static_cast<const scp::bf16*>(w2), b2, static_cast<scp::bf16*>(out), M, C, F, eps,
            act, s);
    return ln_mlp_two_gemms<scp::bf16>(x, ln_scale, ln_bias, w1, b1, w2, b2, mid, out, M, C, F,
                                       eps, act, s);
}

extern "C" const char* scp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
