// The window-attention core shared by kernels B, C and E (sm_90a):
//
//   out = softmax(q k^T * scale + bias[h] + mask[n % n_masks]) v
//
// per (window n, head h).  It replaces the attention of
// scp_tpu/ops/pallas_attn.py::_kernel (kernel E) and the per-head
// `_heads_attend` inside scp_tpu/ops/pallas_swin.py::_self_kernel and
// _cross_kernel (kernels B and C).  Numerics follow the Pallas kernels:
// logits ((q.k) * scale + bias) + mask and the softmax in f32, the
// weights exp(s - max) / sum rounded to the compute dtype BEFORE the
// product with v, which accumulates in f32.
//
// Layout.  q, k, v and out are each a base pointer plus element strides
// for window, head and row (the head's hd columns are contiguous).  One
// launch therefore takes E's head-major (BN, H, W, hd) tensors and B/C's
// column-strided (BN*W, kC) projection buffers (head h at column h*hd).
// bias (H, W, W) f32; mask (n_masks, W, W) f32, or null for no mask (the
// read is skipped).  W % 64 == 0, W <= 512; hd % 8 == 0, hd <= 256.
//
// bf16 design (mma.sync m16n8k16 + ldmatrix, FlashAttention-2 style
// register tiles, but ONE exact pass): a block owns one (window, head)
// and walks its query tiles of 32 rows.  Sixteen warps = 2 row groups of
// 16 queries x 8 key splits of W/8 keys (the window rounded up to 128,
// the keys past W padding), so each warp keeps its 16 x W/8 scores in
// registers (32 f32 a thread at W = 512) within a 128-register budget
// that lets 16 warps hide each other's latency.  q.k^T is computed once;
// the 8 warps of a row group exchange each row's max and sum through
// shared memory, normalize their own slice, round P to bf16 in registers
// and feed it as the A operand of P.V.  The 8 partial O tiles are summed
// through shared memory in a fixed order (deterministic) and stored as
// bf16.  Head dims up to 64 (padded to a multiple of 16) keep the
// window's K and V resident in shared memory for the whole block (loaded
// once with cp.async, V behind the first tile's scores); wider heads
// stream K and V in 64-column chunks per query tile.  The next tile's Q
// is fetched behind the current tile.  With K and V resident the two row
// groups share nothing a tile writes, so each synchronizes only its own 8
// warps (named barriers) and one group's bias + mask reads overlap the
// other's arithmetic.
//
// Bound on this card.  Per (window, head) at W = 512, hd = 64: 4 W^2 hd =
// 67 MFLOP on the tensor cores against 2 MB of f32 bias + mask rows read
// from L2 (q, k, v, out are 256 KB).  Past those, the softmax's per-score
// work (scale, bias, mask, max, exp, sum, normalize: ~20 CUDA-core
// operations a score, 0.2 ms at 240 windows x 4 heads) is what a tile
// waits on; the f32 logits and weights are what the Pallas numerics ask.
//
// f32 design: a plain CUDA-core kernel (no TF32): a block owns 16 query
// rows of one (window, head); scores in shared memory, full-f32 FMAs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace scp {

typedef __nv_bfloat16 bf16;

struct StridedHeads {
    const void* p;
    long long win, head, row;  // element strides
};

struct AttnArgs {
    StridedHeads q, k, v;
    void* out;
    long long o_win, o_head, o_row;
    const float* bias;  // (H, W, W)
    const float* mask;  // (n_masks, W, W) or null
    int n_masks;
    int BN, H, W, hd;
    float scale;
};

constexpr int CORE_MAX_W = 512;
constexpr int CORE_MAX_HD = 256;

// ---- bf16 tensor-core core -------------------------------------------------

constexpr int CQT = 32;              // query rows per tile
constexpr int CKS = 8;               // key splits (warps of one row group)
constexpr int CRG = CQT / 16;        // row groups of 16 queries
constexpr int CTHREADS = 32 * CKS * CRG;
constexpr int CNT_MAX = CORE_MAX_W / CKS / 8;  // n8 score tiles a warp holds at most
constexpr int CNG = CNT_MAX / 4;               // groups of 4 tiles for the bias + mask loads

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// barrier of the 8 warps of one row group (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int rg) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "n"(CTHREADS / CRG) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// The key each shared row of K and V holds, within each 16-key step:
// rows 0-7 hold keys 0,1,4,5,8,9,12,13 and rows 8-15 keys 2,3,6,7,...
// The score columns follow the rows, so a lane's values of two adjacent
// n8 tiles (columns 2t, 2t+1 of each) are the 4 consecutive keys 4t..4t+3
// and its bias and mask reads are 16-byte vectors.  P.V sums over the
// same order, so only the order of the sum changes.
__device__ __forceinline__ int key_of_row(int r) {
    const int i = r & 15;
    return (r & ~15) + 4 * ((i & 7) >> 1) + (i & 1) + (i & 8 ? 2 : 0);
}

// rows [0, nrows) of a strided bf16 matrix, columns [c0, c0 + DC), into a
// (nrows, DC + 8) shared tile; columns at or past hd are zero.  Thread
// `tid` of `nthreads` takes every nthreads-th 16-byte chunk.  `keys`:
// shared row r holds source row key_of_row(r) (K and V).
template <int DC>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int nrows, int c0, int hd, int tid, int nthreads,
                                          bool keys) {
    constexpr int LD = DC + 8;
    constexpr int CPR = DC / 8;  // 16-byte chunks per row
    for (int i = tid; i < nrows * CPR; i += nthreads) {
        const int r = i / CPR;
        const int c = (i % CPR) * 8;
        bf16* d = dst + r * LD + c;
        if (c0 + c < hd)
            cp_async16(d, src + (long long)(keys ? key_of_row(r) : r) * row_stride + c0 + c);
        else
            *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
}

// The f32 bias and mask values of 4 n8 score tiles (two 16-key steps) at
// this lane's two rows: one 16-byte vector per step and row (keys 4t..4t+3
// of the step, see key_of_row).  Steps past the warp's last valid one
// re-read that step (in bounds, never used), so the loads carry no branch
// and a group is in flight at once: the bias + mask stream is the kernel's
// largest read.  (Loading a group ahead of its use needs 32 more
// registers; past the 128-register budget of 16 warps it spilled and ran
// slower.)
struct BiasMask4 {
    float4 b0[2], b1[2], m0[2], m1[2];
};

__device__ __forceinline__ void load_bias_mask(BiasMask4& x, const float* bias_row,
                                               const float* mask_row, int W, int grp,
                                               int nvalid) {
    if (nvalid == 0) return;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        const int k = min(2 * grp + u, nvalid / 2 - 1) * 16;
        x.b0[u] = __ldg(reinterpret_cast<const float4*>(bias_row + k));
        x.b1[u] = __ldg(reinterpret_cast<const float4*>(bias_row + 8 * W + k));
        if (mask_row) {
            x.m0[u] = __ldg(reinterpret_cast<const float4*>(mask_row + k));
            x.m1[u] = __ldg(reinterpret_cast<const float4*>(mask_row + 8 * W + k));
        }
    }
}

// K and V (W rows each), Q, and the partial-O and statistics exchange
inline size_t core_smem_bf16(int DC, int ND, int W) {
    const size_t LD = DC + 8;
    return sizeof(bf16) * (2 * (size_t)W * LD + (size_t)ND * CQT * LD)
           + sizeof(float) * ((size_t)(CKS / 2) * CQT * LD + 2 * (size_t)CKS * CQT);
}

// DC: head-dim columns per chunk (a multiple of 16, <= 64); ND: chunks.
// grid (BN * H, query-tile groups); block CTHREADS.
//
// Warp (rg, ks) owns query rows rg*16 .. +15 of each 32-row tile and the
// keys ks*kpw .. +kpw-1, kpw = Wk / 8 with Wk = W rounded up to 128, so a
// split is whole 16-key steps; keys at or past W are padding (left out of
// the max and sum, weight 0; K, V, bias and mask rows there are never read).
template <int DC, int ND>
__global__ void __launch_bounds__(CTHREADS, 1) attn_core_bf16(const AttnArgs a) {
    constexpr int LD = DC + 8;
    constexpr bool RESIDENT = ND == 1;  // K and V of the window stay in shared memory
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int W = a.W;
    const int hd = a.hd;
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
    bf16* Vs = Ks + W * LD;
    bf16* Qs = Vs + W * LD;
    float* Op = reinterpret_cast<float*>(Qs + ND * CQT * LD);  // (CKS/2, CQT, LD) partial O
    float* st_max = Op + (CKS / 2) * CQT * LD;                  // (CKS, CQT)
    float* st_sum = st_max + CKS * CQT;

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int rg = warp / CKS;  // row group
    const int ks = warp % CKS;  // key split
    const int g = lane >> 2;
    const int t = lane & 3;
    const int mi = lane >> 3;   // ldmatrix: which 8x8 matrix this lane addresses
    const int mr = lane & 7;

    const int bw = blockIdx.x / a.H;
    const int h = blockIdx.x % a.H;
    const bf16* qb = static_cast<const bf16*>(a.q.p) + bw * a.q.win + h * a.q.head;
    const bf16* kb = static_cast<const bf16*>(a.k.p) + bw * a.k.win + h * a.k.head;
    const bf16* vb = static_cast<const bf16*>(a.v.p) + bw * a.v.win + h * a.v.head;
    bf16* ob = static_cast<bf16*>(a.out) + bw * a.o_win + h * a.o_head;

    const int kpw = (W + 127) / 128 * 16;  // keys of this warp's split (padded window / 8)
    const int ntv = kpw / 8;               // its n8 score tiles (even)
    const int key0 = ks * kpw;
    const int nvalid = max(0, min(ntv, (W - key0) / 8));  // tiles before the padding (even)
    const int tiles = W / CQT;

    // this lane's bias and mask rows (r0 and r0 + 8 of the tile, at its
    // split's keys)
    const int r0 = rg * 16 + g;
    const size_t row_step = (size_t)gridDim.y * CQT * W;
    const size_t row_off = (size_t)(blockIdx.y * CQT + r0) * W + key0 + 4 * t;
    const float* bias_row = a.bias + (size_t)h * W * W + row_off;
    const float* mask_row =
        a.mask ? a.mask + (size_t)(bw % a.n_masks) * W * W + row_off : nullptr;

    if (RESIDENT) {
        load_tile<DC>(Ks, kb, a.k.row, W, 0, hd, threadIdx.x, CTHREADS, true);
        cp_async_commit();
    }
    // each row group loads, and waits for, its own 16 query rows
    const int gtid = threadIdx.x % (CTHREADS / CRG);
    bf16* Qg = Qs + rg * 16 * LD;
#pragma unroll
    for (int c = 0; c < ND; ++c)
        load_tile<DC>(Qg + c * CQT * LD, qb + (long long)(blockIdx.y * CQT + rg * 16) * a.q.row,
                      a.q.row, 16, c * DC, hd, gtid, CTHREADS / CRG, false);
    cp_async_commit();
    if (RESIDENT) {
        // V lands behind the first tile's scores
        load_tile<DC>(Vs, vb, a.v.row, W, 0, hd, threadIdx.x, CTHREADS, true);
        cp_async_commit();
    }
    // With K and V resident, the two row groups share nothing in shared
    // memory that a tile writes, so each waits only for its own 8 warps and
    // one group's bias + mask reads overlap the other's arithmetic.
    auto tile_sync = [rg]() {
        if (RESIDENT)
            group_sync(rg);
        else
            __syncthreads();
    };
    bool first = true;
    for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
        const int q0 = tile * CQT;
        const bool more = tile + (int)gridDim.y < tiles;
        if (RESIDENT && first) {
            cp_async_wait<1>();  // K and Q; V may still be in flight
            __syncthreads();     // K came from every thread
        } else {
            cp_async_wait<0>();  // this tile's Q
            tile_sync();
        }

        // ---- S = Q K^T for this warp's 16 rows x kpw keys, in registers
        float s[CNT_MAX][4];
#pragma unroll
        for (int j = 0; j < CNT_MAX; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
        for (int c = 0; c < ND; ++c) {
            if (!RESIDENT) {
                if (c > 0) __syncthreads();  // every warp is done with the previous K chunk
                load_tile<DC>(Ks, kb, a.k.row, W, c * DC, hd, threadIdx.x, CTHREADS, true);
                cp_async_commit();
                cp_async_wait<0>();
                __syncthreads();
            }
            const bf16* Qw = Qs + c * CQT * LD + rg * 16 * LD;
#pragma unroll
            for (int kk = 0; kk < DC; kk += 16) {
                uint32_t af[4];
                ldsm_x4(af, Qw + (mr + (mi & 1) * 8) * LD + kk + (mi >> 1) * 8);
#pragma unroll
                for (int j = 0; j < CNT_MAX; j += 2) {
                    if (j < nvalid) {
                        uint32_t bfr[4];
                        ldsm_x4(bfr, Ks + (key0 + j * 8 + mr + (mi >> 1) * 8) * LD + kk
                                         + (mi & 1) * 8);
                        mma_16816(s[j], af, bfr[0], bfr[1]);
                        mma_16816(s[j + 1], af, bfr[2], bfr[3]);
                    }
                }
            }
        }

        // ---- logits ((s * scale) + bias) + mask, each step rounded as written
        float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
        for (int grp = 0; grp < CNG; ++grp) {
            BiasMask4 bm;
            load_bias_mask(bm, bias_row, mask_row, W, grp, nvalid);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int j = 4 * grp + 2 * u;  // tiles j, j + 1: keys 4t..4t+3 of a step
                if (j < nvalid) {
                    float* x[8] = {&s[j][0], &s[j][1], &s[j + 1][0], &s[j + 1][1],
                                   &s[j][2], &s[j][3], &s[j + 1][2], &s[j + 1][3]};
                    const float b[8] = {bm.b0[u].x, bm.b0[u].y, bm.b0[u].z, bm.b0[u].w,
                                        bm.b1[u].x, bm.b1[u].y, bm.b1[u].z, bm.b1[u].w};
#pragma unroll
                    for (int e = 0; e < 8; ++e) *x[e] = __fadd_rn(__fmul_rn(*x[e], a.scale), b[e]);
                    if (mask_row) {
                        const float m[8] = {bm.m0[u].x, bm.m0[u].y, bm.m0[u].z, bm.m0[u].w,
                                            bm.m1[u].x, bm.m1[u].y, bm.m1[u].z, bm.m1[u].w};
#pragma unroll
                        for (int e = 0; e < 8; ++e) *x[e] = __fadd_rn(*x[e], m[e]);
                    }
                    mx0 = fmaxf(mx0, fmaxf(fmaxf(*x[0], *x[1]), fmaxf(*x[2], *x[3])));
                    mx1 = fmaxf(mx1, fmaxf(fmaxf(*x[4], *x[5]), fmaxf(*x[6], *x[7])));
                }
            }
        }
        // ---- row max over the key splits
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        if (t == 0) {
            st_max[ks * CQT + r0] = mx0;
            st_max[ks * CQT + r0 + 8] = mx1;
        }
        tile_sync();  // also: the group is done reading its Q rows
        if (more) {  // the next tile's Q lands behind this tile's softmax and P.V
#pragma unroll
            for (int c = 0; c < ND; ++c)
                load_tile<DC>(Qg + c * CQT * LD,
                              qb + (long long)(q0 + (int)gridDim.y * CQT + rg * 16) * a.q.row,
                              a.q.row, 16, c * DC, hd, gtid, CTHREADS / CRG, false);
            cp_async_commit();
        }
        mx0 = st_max[r0];
        mx1 = st_max[r0 + 8];
#pragma unroll
        for (int p = 1; p < CKS; ++p) {
            mx0 = fmaxf(mx0, st_max[p * CQT + r0]);
            mx1 = fmaxf(mx1, st_max[p * CQT + r0 + 8]);
        }
        // ---- exp(s - max) and the row sum over the key splits (fixed order)
        float sm0 = 0.0f, sm1 = 0.0f;
#pragma unroll
        for (int j = 0; j < CNT_MAX; ++j) {
            if (j < nvalid) {
                s[j][0] = expf(s[j][0] - mx0);
                s[j][1] = expf(s[j][1] - mx0);
                s[j][2] = expf(s[j][2] - mx1);
                s[j][3] = expf(s[j][3] - mx1);
                sm0 += s[j][0] + s[j][1];
                sm1 += s[j][2] + s[j][3];
            }
        }
        sm0 += __shfl_xor_sync(0xffffffffu, sm0, 1);
        sm0 += __shfl_xor_sync(0xffffffffu, sm0, 2);
        sm1 += __shfl_xor_sync(0xffffffffu, sm1, 1);
        sm1 += __shfl_xor_sync(0xffffffffu, sm1, 2);
        if (t == 0) {
            st_sum[ks * CQT + r0] = sm0;
            st_sum[ks * CQT + r0 + 8] = sm1;
        }
        tile_sync();
        sm0 = st_sum[r0];
        sm1 = st_sum[r0 + 8];
#pragma unroll
        for (int p = 1; p < CKS; ++p) {
            sm0 += st_sum[p * CQT + r0];
            sm1 += st_sum[p * CQT + r0 + 8];
        }
        // ---- P = exp / sum rounded to bf16: the A fragments of P.V.  The
        // sum's reciprocal (rounded once) times each exp; it differs from a
        // division by at most one f32 ulp before the bf16 rounding, and it
        // keeps subnormal weights (logits 87 below the max) off the
        // division's slow path.
        const float inv0 = __frcp_rn(sm0);
        const float inv1 = __frcp_rn(sm1);
        uint32_t pf[CNT_MAX][2];
#pragma unroll
        for (int j = 0; j < CNT_MAX; ++j) {
            pf[j][0] = pack_bf16(__fmul_rn(s[j][0], inv0), __fmul_rn(s[j][1], inv0));
            pf[j][1] = pack_bf16(__fmul_rn(s[j][2], inv1), __fmul_rn(s[j][3], inv1));
        }
        if (more) {
            bias_row += row_step;
            if (mask_row) mask_row += row_step;
        }
        if (RESIDENT && first) {  // V
            if (more)
                cp_async_wait<1>();
            else
                cp_async_wait<0>();
            __syncthreads();
        }
        first = false;

        // ---- O = P V per head-dim chunk; the partial O of the key splits
        // summed in a fixed order: ((o0 + o4) + (o1 + o5)) + ...
#pragma unroll
        for (int c = 0; c < ND; ++c) {
            if (!RESIDENT) {
                __syncthreads();  // every warp is done with the previous V chunk and Op
                load_tile<DC>(Vs, vb, a.v.row, W, c * DC, hd, threadIdx.x, CTHREADS, true);
                cp_async_commit();
                cp_async_wait<0>();
                __syncthreads();
            }
            float o[DC / 8][4];
#pragma unroll
            for (int n = 0; n < DC / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
            for (int kq = 0; kq < CNT_MAX / 2; ++kq) {
                if (2 * kq < nvalid) {
                    const uint32_t af[4] = {pf[2 * kq][0], pf[2 * kq][1], pf[2 * kq + 1][0],
                                            pf[2 * kq + 1][1]};
                    const bf16* vrow = Vs + (key0 + kq * 16 + mr + (mi & 1) * 8) * LD;
#pragma unroll
                    for (int n = 0; n < DC / 8; n += 2) {
                        uint32_t bfr[4];
                        ldsm_x4_trans(bfr, vrow + n * 8 + (mi >> 1) * 8);
                        mma_16816(o[n], af, bfr[0], bfr[1]);
                        mma_16816(o[n + 1], af, bfr[2], bfr[3]);
                    }
                }
            }
            float* opw = Op + ((ks % (CKS / 2)) * CQT + r0) * LD + 2 * t;
            if (ks < CKS / 2) {
#pragma unroll
                for (int n = 0; n < DC / 8; ++n) {
                    *reinterpret_cast<float2*>(opw + n * 8) = make_float2(o[n][0], o[n][1]);
                    *reinterpret_cast<float2*>(opw + 8 * LD + n * 8) =
                        make_float2(o[n][2], o[n][3]);
                }
            }
            tile_sync();
            if (ks >= CKS / 2) {
#pragma unroll
                for (int n = 0; n < DC / 8; ++n) {
                    float2* p0 = reinterpret_cast<float2*>(opw + n * 8);
                    float2* p1 = reinterpret_cast<float2*>(opw + 8 * LD + n * 8);
                    const float2 v0 = *p0, v1 = *p1;
                    *p0 = make_float2(v0.x + o[n][0], v0.y + o[n][1]);
                    *p1 = make_float2(v1.x + o[n][2], v1.y + o[n][3]);
                }
            }
            tile_sync();
            for (int i = gtid; i < 16 * (DC / 8); i += CTHREADS / CRG) {  // the group's rows
                const int r = rg * 16 + i / (DC / 8);
                const int c8 = (i % (DC / 8)) * 8;
                if (c * DC + c8 >= hd) continue;
                float acc[8];
                const float* src = Op + r * LD + c8;
#pragma unroll
                for (int u = 0; u < 8; ++u) acc[u] = src[u];
#pragma unroll
                for (int p = 1; p < CKS / 2; ++p) {
#pragma unroll
                    for (int u = 0; u < 8; ++u) acc[u] += src[p * CQT * LD + u];
                }
                uint4 pk;
                pk.x = pack_bf16(acc[0], acc[1]);
                pk.y = pack_bf16(acc[2], acc[3]);
                pk.z = pack_bf16(acc[4], acc[5]);
                pk.w = pack_bf16(acc[6], acc[7]);
                *reinterpret_cast<uint4*>(ob + (long long)(q0 + r) * a.o_row + c * DC + c8) = pk;
            }
        }
    }
}

// ---- f32 CUDA-core core ------------------------------------------------------

constexpr int FQT = 16;        // query rows per block
constexpr int FKC = 32;        // keys per staged chunk
constexpr int FTHREADS = 128;

inline size_t core_smem_f32(int W, int hd) {
    return sizeof(float) * ((size_t)FQT * W + 2 * (size_t)FQT * hd + (size_t)FKC * (hd + 1));
}

// grid (BN * H, W / FQT); block FTHREADS
__global__ void __launch_bounds__(FTHREADS) attn_core_f32(const AttnArgs a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int W = a.W;
    const int hd = a.hd;
    const int KLD = hd + 1;
    float* Sf = reinterpret_cast<float*>(smem_raw);  // (FQT, W) logits, then weights
    float* Qf = Sf + FQT * W;                          // (FQT, hd)
    float* Of = Qf + FQT * hd;                         // (FQT, hd) accumulators
    float* Kc = Of + FQT * hd;                         // (FKC, hd + 1) K or V chunk

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int bw = blockIdx.x / a.H;
    const int h = blockIdx.x % a.H;
    const int q0 = blockIdx.y * FQT;
    const float* qb = static_cast<const float*>(a.q.p) + bw * a.q.win + h * a.q.head;
    const float* kb = static_cast<const float*>(a.k.p) + bw * a.k.win + h * a.k.head;
    const float* vb = static_cast<const float*>(a.v.p) + bw * a.v.win + h * a.v.head;
    float* ob = static_cast<float*>(a.out) + bw * a.o_win + h * a.o_head;
    const float* bias_h = a.bias + (size_t)h * W * W;
    const float* mask_n = a.mask ? a.mask + (size_t)(bw % a.n_masks) * W * W : nullptr;

    for (int i = tid; i < FQT * hd; i += FTHREADS) {
        Qf[i] = qb[(long long)(q0 + i / hd) * a.q.row + i % hd];
        Of[i] = 0.0f;
    }
    for (int kc = 0; kc < W; kc += FKC) {
        __syncthreads();
        for (int i = tid; i < FKC * hd; i += FTHREADS)
            Kc[(i / hd) * KLD + i % hd] = kb[(long long)(kc + i / hd) * a.k.row + i % hd];
        __syncthreads();
        for (int p = tid; p < FQT * FKC; p += FTHREADS) {
            const int r = p / FKC;
            const int j = p % FKC;
            float acc = 0.0f;
            for (int d = 0; d < hd; ++d) acc = fmaf(Qf[r * hd + d], Kc[j * KLD + d], acc);
            const size_t idx = (size_t)(q0 + r) * W + kc + j;
            float x = __fadd_rn(__fmul_rn(acc, a.scale), bias_h[idx]);
            if (mask_n) x = __fadd_rn(x, mask_n[idx]);
            Sf[r * W + kc + j] = x;
        }
    }
    __syncthreads();
    for (int r = warp; r < FQT; r += FTHREADS / 32) {
        float* row = Sf + r * W;
        float m = -CUDART_INF_F;
        for (int j = lane; j < W; j += 32) m = fmaxf(m, row[j]);
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float l = 0.0f;
        for (int j = lane; j < W; j += 32) {
            const float e = expf(row[j] - m);
            row[j] = e;
            l += e;
        }
        for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
        for (int j = lane; j < W; j += 32) row[j] = __fdiv_rn(row[j], l);
    }
    for (int kc = 0; kc < W; kc += FKC) {
        __syncthreads();
        for (int i = tid; i < FKC * hd; i += FTHREADS)
            Kc[(i / hd) * KLD + i % hd] = vb[(long long)(kc + i / hd) * a.v.row + i % hd];
        __syncthreads();
        for (int o = tid; o < FQT * hd; o += FTHREADS) {
            const int r = o / hd;
            const int d = o % hd;
            float acc = Of[o];
            const float* pr = Sf + r * W + kc;
            for (int j = 0; j < FKC; ++j) acc = fmaf(pr[j], Kc[j * KLD + d], acc);
            Of[o] = acc;
        }
    }
    __syncthreads();
    for (int i = tid; i < FQT * hd; i += FTHREADS)
        ob[(long long)(q0 + i / hd) * a.o_row + i % hd] = Of[i];
}

// ---- launch ------------------------------------------------------------------

inline bool core_shape_ok(const AttnArgs& a) {
    return a.W >= 64 && a.W % 64 == 0 && a.W <= CORE_MAX_W && a.hd >= 8 && a.hd % 8 == 0
           && a.hd <= CORE_MAX_HD && a.H >= 1 && (a.mask == nullptr || a.n_masks >= 1);
}

template <int DC, int ND>
cudaError_t launch_core_bf16(const AttnArgs& a, cudaStream_t stream) {
    const size_t smem = core_smem_bf16(DC, ND, a.W);
    cudaError_t e = cudaFuncSetAttribute(attn_core_bf16<DC, ND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // one block an SM: a window's query tiles split over at least two
    // blocks (a shorter last wave, for loading K and V twice), more when
    // the (window, head) pairs alone would leave SMs idle
    const int bh = a.BN * a.H;
    const int tiles = a.W / CQT;
    int split = (2 * sms + bh - 1) / bh;
    split = split < 2 ? 2 : (split > tiles ? tiles : split);
    attn_core_bf16<DC, ND><<<dim3(bh, split), CTHREADS, smem, stream>>>(a);
    return cudaGetLastError();
}

// out = attention(q, k, v) with T the element type of q, k, v and out
template <typename T>
cudaError_t launch_attn_core(const AttnArgs& a, cudaStream_t stream);

template <>
inline cudaError_t launch_attn_core<bf16>(const AttnArgs& a, cudaStream_t stream) {
    if (a.BN <= 0) return cudaSuccess;
    if (!core_shape_ok(a)) return cudaErrorInvalidValue;
    const int hdp = (a.hd + 15) / 16 * 16;  // head dim padded to a multiple of 16
    switch (hdp) {
        case 16: return launch_core_bf16<16, 1>(a, stream);
        case 32: return launch_core_bf16<32, 1>(a, stream);
        case 48: return launch_core_bf16<48, 1>(a, stream);
        case 64: return launch_core_bf16<64, 1>(a, stream);
        default: break;
    }
    switch ((hdp + 63) / 64) {  // wider heads: 64-column chunks
        case 2: return launch_core_bf16<64, 2>(a, stream);
        case 3: return launch_core_bf16<64, 3>(a, stream);
        case 4: return launch_core_bf16<64, 4>(a, stream);
        default: return cudaErrorInvalidValue;
    }
}

template <>
inline cudaError_t launch_attn_core<float>(const AttnArgs& a, cudaStream_t stream) {
    if (a.BN <= 0) return cudaSuccess;
    if (!core_shape_ok(a)) return cudaErrorInvalidValue;
    const size_t smem = core_smem_f32(a.W, a.hd);
    cudaError_t e = cudaFuncSetAttribute(attn_core_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attn_core_f32<<<dim3(a.BN * a.H, a.W / FQT), FTHREADS, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace scp
