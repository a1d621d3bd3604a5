// Kernel D: fused pairwise score + top-k (KNN), out[b, i] = the k columns j
// of largest  2 q_i.k_j - |q_i|^2 - |k_j|^2  (negated squared distance),
// in descending order, ties to the lowest column; 1 <= k <= 64, any C.
//
// Replaces scp_tpu/ops/pallas_knn.py::_knn_kernel (pallas_call in
// _knn_single, entry knn_pallas; its buffer holds 2k <= 128 lanes).  The
// squared norms are chains of f32 fused multiply-adds over the columns in
// order (the Pallas kernel's compiled rounding) and the score ((2 dot -
// |q|^2) - |k|^2) rounds at each step.  The dot product: an f32 fma chain
// (positions, and f32 features), or bf16 tensor-core products with f32
// accumulation (bf16 features of the wide arm: each product is exact in
// f32, only the order of the sum differs).
//
// Both arms keep each query's running top-k as one sorted list spread over
// a warp (lane j holds slot j, and slot 32 + j when k > 32) of 64-bit keys:
// order-preserving bits of the f32 score above (2^32-1 - col), so a larger
// key is a larger score and, on equal scores, a lower column.  A key that
// beats slot k-1 is inserted with one ballot per half (its rank), shuffles
// (the shift) and one broadcast (the new threshold).  The keys are unique,
// so the lists do not depend on the order keys arrive in; no (N, N) score
// matrix exists and nothing but the optional work counter is atomic: two
// launches give identical indices.
//
// Bound.  2*N*C operations per query, N*C*2 bytes in and N*k*8 bytes out
// per batch row.  At C = 3 the arithmetic is tiny; what costs is visiting
// (query, key) pairs and the compare-and-insert of those that beat a list.
// At C = 144 / 192 the products bound it (2 B N^2 C at the bf16 peak).
//
// Positions (C <= 4, k <= 32; the static graph's C = 3): the pruned arm.
//   * A pre-pass (knn_topk_boxes, one warp per 32-row group) writes a key
//     table, one 16-byte row per key (coordinates, |k|^2 in the last slot;
//     32 bytes at C = 4), padded to whole groups, and per group its box
//     (min and max of each coordinate over the rows < N) and its largest
//     |k|^2.
//   * The search (knn_topk_pruned) runs one warp per 8 consecutive queries,
//     warps independent: no shared memory, no block barrier.  Within a lane
//     the rows are in Morton order, so a query's neighbors sit mostly in
//     its own group and the next few.  A warp visits its own group first,
//     then outward (g0+1, g0-1, g0+2, ... clipped to the lane), which
//     tightens the lists early.  It takes that order 32 groups at a time,
//     one per lane: each lane bounds, for each of the 8 queries, the score
//     any key of its group can reach (the box gap, see MARGIN_REL), and a
//     ballot keeps the groups where some query's bound is not strictly
//     below that query's k-th score.  Each kept group is tested again with
//     the current thresholds just before it is scored (thresholds only
//     rise, so the older test is the looser).  A list that holds fewer than
//     k keys has threshold 0, below every key, so nothing is skipped until
//     all 8 lists are full.  Scoring a group: lane = key, one 16-byte load.
//   * Merging a scored group: the own group fills all 8 lists at once, and
//     one-by-one inserts of its keys would be ~30 dependent shuffle chains
//     per query.  A group whose keys beat the lists more than SORT_MIN
//     times is merged by bitonic networks, the 8 queries' side by side; a
//     group with fewer takes the inserts (most groups after the first few:
//     the median visited group beats the 8 lists once).
//   * Work then depends on the data: sorted positions visit about a tenth of
//     the groups; shuffled rows visit all of them (every box spans the
//     lane) and cost a brute-force pass without block barriers.
//
// Features (C > 4, the dynamic graph's C = 144 / 192; and any C at k > 32):
// the wide arm (knn_topk_wide), brute force on the tensor cores.
//   * One block per (batch row, 64 queries), 4 warps of 16 queries (the
//     rows of an m16n8k16 tile).  Keys stream through a 3-stage cp.async
//     ring in 64-key tiles, each in slabs of 128 bytes of columns (64 bf16),
//     with zeros past N and past C, so C has no bound; the queries' rows
//     stay resident in shared memory while they fit (C <= 1536 in bf16),
//     else they stream beside the keys.  Tiles are visited from the block's
//     own rows outward.
//   * Each warp scores its 16 x 64 tile with ldmatrix + mma.sync (f32
//     accumulators in registers, the C fragment layout); f32 features take
//     a CUDA-core front end (fma chains) into the same tile layout.  Those
//     scores only filter: the lists hold exact scores, the exact dot
//     product (f64 sum of exact products) rounded once to f32, so they do
//     not depend on any summation order and equal the plain version's
//     (which computes the same) on every row, exact ties included.
//   * Filter, then insert: a score that, with its error bound (MARGIN_STEP),
//     reaches its row's k-th score (a float per row, in registers) sets a
//     bit; the bits join the warp's queue in shared memory, and a round
//     takes 32 of them, one per lane: each is scored exactly on its lane
//     and offered to its query's sorted list.  About k ln(N / k) keys per
//     query are scored exactly (each that enters a list in the visiting
//     order, and a few within the bound of the k-th).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int QPW = 8;             // queries per warp of the pruned arm
constexpr int THREADS = WARPS * 32;
constexpr int GROUP = 32;          // key rows per group of the pruned arm
constexpr unsigned FULL = 0xffffffffu;

// The pruned arm's skip bound for query q and a group with box [lo, hi]
// and largest key norm K = max |k|^2:  bound = m - gap^2,  gap^2 the fma
// chain over the coordinates of max(lo - q, q - hi, 0), m = 2^-19 (sqrt|q|^2
// + sqrt K)^2 + 2^-126.  Derivation, with u = 2^-24, C <= 4, and P = (|q| +
// |k|max)^2 for the group:
//   * the computed score s~ of any key k of the group differs from the
//     exact -|q - k|^2 by at most  gamma_C (2|q||k| + |q|^2 + |k|^2)  (the
//     three fma chains, gamma_C = C u / (1 - C u) <= 4.0000003 u) plus
//     u |2d - |q|^2| + u |s|  (the two subtractions; 2 dot is exact):
//     at most 6.0001 u P;
//   * -|q - k|^2 <= -gap^2 (the box holds every key of the group), and
//     gap^2 <= |q - k|^2 <= P;
//   * the computed gap^2 is at most gap^2 (1 + u)^2 (1 + gamma_C) (one
//     rounding per difference, the chain), so it overshoots by at most
//     6.0001 u P, and the last subtraction m - gap^2 loses at most
//     u (m + gap^2), about 1.0001 u P;
//   * the norms and the square roots of the margin are themselves rounded
//     (relative error ~10 u, on the margin only).
// So every key's computed score is at most -gap^2 + 6.0001 u P while the
// computed bound is at least m (1 - u) - gap^2 - 7.0002 u P: a margin of
// 13.01 u P suffices and 2^-19 = 32 u P keeps 2.4x of room.  FLT_MIN covers
// the absolute error of results that fall below the normal range.  The
// skip is strict (bound below the k-th score), so a key whose score equals
// the k-th, and might win on its lower column, is never skipped.  The
// same bound in plain PyTorch: ops/knn_topk.py::group_score_bound.
constexpr float MARGIN_REL = 0x1p-19f;
constexpr float MARGIN_ABS = 0x1p-126f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// the high half of order_key: monotone in the score, -0 and +0 tie
__device__ __forceinline__ uint32_t order_hi(float s) {
    uint32_t u = __float_as_uint(s);
    if ((u & 0x7fffffffu) == 0u) u = 0u;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint64_t order_key(float s, int col) {
    return ((uint64_t)order_hi(s) << 32) | (uint64_t)(0xffffffffu - (uint32_t)col);
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

// ---- the pruned arm (C <= 4) --------------------------------------------

// A visited group whose keys beat the 8 lists more than SORT_MIN times in
// all (the own group, and the nearest ones while the lists are loose) is
// merged by sorting networks: the one-by-one inserts are a chain of
// dependent shuffles per key, the networks of the 8 queries run side by
// side.  Either way each list ends as the top 32 of its keys so far.
constexpr int SORT_MIN = 16;

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int mask) {
    uint32_t lo = __shfl_xor_sync(FULL, (uint32_t)v, mask);
    uint32_t hi = __shfl_xor_sync(FULL, (uint32_t)(v >> 32), mask);
    return ((uint64_t)hi << 32) | lo;
}

// Each list (descending over the lanes) becomes the top 32 of itself and
// its 32 candidates: the candidates are sorted ascending by a bitonic
// network, the lanewise max of the two is a bitonic sequence holding the
// top 32, and a bitonic merge sorts it descending.
__device__ __forceinline__ void merge_group(uint64_t (&list)[QPW], uint64_t (&cand)[QPW],
                                            int lane) {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            const bool take_min = ((lane & size) == 0) == ((lane & stride) == 0);
#pragma unroll
            for (int j = 0; j < QPW; ++j) {
                const uint64_t o = shfl_xor64(cand[j], stride);
                cand[j] = take_min == (o < cand[j]) ? o : cand[j];
            }
        }
    }
#pragma unroll
    for (int j = 0; j < QPW; ++j) list[j] = list[j] > cand[j] ? list[j] : cand[j];
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
        const bool take_max = (lane & stride) == 0;
#pragma unroll
        for (int j = 0; j < QPW; ++j) {
            const uint64_t o = shfl_xor64(list[j], stride);
            list[j] = take_max == (o > list[j]) ? o : list[j];
        }
    }
}

// Inserts each lane's nonzero candidate into the sorted list, one key at a
// time (ballot for the rank, shuffle for the shift).  The caller zeroed the
// candidates below slot k-1 before the first insert; one that a previous
// insert pushed below it lands past slot k-1, where it does no harm.
__device__ __forceinline__ void insert_some(uint64_t& list, uint64_t cand) {
    const int lane = threadIdx.x & 31;
    unsigned m = __ballot_sync(FULL, cand != 0);
    while (m) {
        const int src = __ffs(m) - 1;
        const uint64_t c = shfl64(cand, src);
        const int p = __popc(__ballot_sync(FULL, list > c));
        const uint64_t up = shfl_up64(list);
        if (lane == p) list = c;
        else if (lane > p) list = up;
        m &= m - 1;
    }
}

// Floats per key-table row: KS = 4 holds 3 coordinates and |k|^2, KS = 8
// holds 4 and |k|^2 in its last slot.  Widths C < 3 are stored with zero
// coordinates up to 3: a zero column adds fma(0, 0, acc) = acc to every
// chain (a -0 may become +0, and both tie), so scores, norms and box gaps
// are those of the C columns.
__host__ __device__ constexpr int row_floats(int C) { return C < 4 ? 4 : 8; }
__host__ __device__ constexpr int row_coords(int KS) { return KS == 4 ? 3 : 4; }

// One warp per (batch row, group), lane = row: the key table's rows of the
// group and its box.  The box row is 2 KS floats: lo (|k|^2 max in its last
// slot), then hi.  Rows >= N are written as zeros and stay out of the box.
template <typename T, int C>
__global__ void knn_topk_boxes(const T* __restrict__ feats, float* __restrict__ table,
                               float* __restrict__ boxes, int B, int N, int G) {
    constexpr int KS = row_floats(C), CS = row_coords(KS);
    const int lane = threadIdx.x & 31;
    const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (gw >= B * G) return;  // whole warps
    const int b = gw / G, g = gw - b * G;
    const int r = g * GROUP + lane;
    const bool valid = r < N;
    float v[KS];
#pragma unroll
    for (int c = 0; c < KS; ++c) v[c] = 0.0f;
    float sq = 0.0f;
    if (valid) {
        const T* row = feats + ((size_t)b * N + r) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            v[c] = to_f32(row[c]);
            sq = fmaf(v[c], v[c], sq);
        }
    }
    v[KS - 1] = sq;
    float4* dst = reinterpret_cast<float4*>(table + ((size_t)b * G * GROUP + r) * KS);
#pragma unroll
    for (int c = 0; c < KS / 4; ++c)
        dst[c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);

    float lo[CS], hi[CS];
#pragma unroll
    for (int c = 0; c < CS; ++c) {
        lo[c] = valid ? v[c] : CUDART_INF_F;
        hi[c] = valid ? v[c] : -CUDART_INF_F;
    }
    float km = valid ? sq : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int c = 0; c < CS; ++c) {
            lo[c] = fminf(lo[c], __shfl_xor_sync(FULL, lo[c], off));
            hi[c] = fmaxf(hi[c], __shfl_xor_sync(FULL, hi[c], off));
        }
        km = fmaxf(km, __shfl_xor_sync(FULL, km, off));
    }
    if (lane == 0) {
        float w[2 * KS];
#pragma unroll
        for (int c = 0; c < 2 * KS; ++c) w[c] = 0.0f;
#pragma unroll
        for (int c = 0; c < CS; ++c) {
            w[c] = lo[c];
            w[KS + c] = hi[c];
        }
        w[KS - 1] = km;
        float4* bd = reinterpret_cast<float4*>(boxes + ((size_t)b * G + g) * 2 * KS);
#pragma unroll
        for (int c = 0; c < KS / 2; ++c)
            bd[c] = make_float4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
    }
}

// The t-th group a warp whose first query lies in group g0 visits: g0, then
// g0+1, g0-1, g0+2, ... clipped to [0, G), each group once (t < G).
__device__ __forceinline__ int visit_group(int t, int g0, int G) {
    const int left = g0, right = G - 1 - g0;
    const int m = min(left, right);
    if (t == 0) return g0;
    if (t <= 2 * m) {
        const int d = (t + 1) >> 1;
        return (t & 1) ? g0 + d : g0 - d;
    }
    return right > left ? g0 + (t - m) : g0 - (t - m);
}

// A group is kept when some query of `live` (a bit per query) has a bound
// (bk, high halves of order keys) not below its k-th key (thr).
__device__ __forceinline__ bool keep(const uint32_t (&bk)[QPW], const uint64_t (&thr)[QPW],
                                     unsigned live) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < QPW; ++j)
        any |= ((live >> j) & 1u) && bk[j] >= (uint32_t)(thr[j] >> 32);
    return any;
}

// One warp per 8 consecutive queries of one batch row (blockIdx.y).
template <int KS>
__global__ void __launch_bounds__(THREADS)
knn_topk_pruned(const float* __restrict__ table, const float* __restrict__ boxes, int N, int G,
                int k, int64_t* __restrict__ out, unsigned long long* __restrict__ stats) {
    constexpr int C = row_coords(KS);
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.y;
    const int q0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * QPW;
    if (q0 >= N) return;  // whole warps
    const float* tb = table + (size_t)b * G * GROUP * KS;
    const float* bb = boxes + (size_t)b * G * 2 * KS;

    // the queries (rows < G * 32 exist in the table), their norms and lists
    float q[QPW][C], qsq[QPW], qn[QPW];
    uint64_t list[QPW], thr[QPW];
    unsigned qvalid = 0;
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
        float r[KS];
        const float4* src = reinterpret_cast<const float4*>(tb + (size_t)(q0 + j) * KS);
#pragma unroll
        for (int c = 0; c < KS / 4; ++c) {
            const float4 x = __ldg(src + c);
            r[4 * c] = x.x, r[4 * c + 1] = x.y, r[4 * c + 2] = x.z, r[4 * c + 3] = x.w;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) q[j][c] = r[c];
        qsq[j] = r[KS - 1];
        qn[j] = __fsqrt_rn(qsq[j]);
        if (q0 + j < N) qvalid |= 1u << j;
        list[j] = 0;  // below every real key
        thr[j] = 0;
    }

    const int g0 = q0 / GROUP;
    int visited = 0;
#pragma unroll 1
    for (int t0 = 0; t0 < G; t0 += 32) {
        // lane = one group of this chunk of the visit order: its bound for
        // each query, as the high half of an order key
        const int t = t0 + lane;
        const int g = t < G ? visit_group(t, g0, G) : 0;
        const unsigned live = t < G ? qvalid : 0u;  // a lane past the order keeps nothing
        uint32_t bk[QPW];
        {
            float lo[KS], hi[KS];
            const float4* src = reinterpret_cast<const float4*>(bb + (size_t)g * 2 * KS);
#pragma unroll
            for (int c = 0; c < KS / 4; ++c) {
                const float4 x = __ldg(src + c), y = __ldg(src + KS / 4 + c);
                lo[4 * c] = x.x, lo[4 * c + 1] = x.y, lo[4 * c + 2] = x.z, lo[4 * c + 3] = x.w;
                hi[4 * c] = y.x, hi[4 * c + 1] = y.y, hi[4 * c + 2] = y.z, hi[4 * c + 3] = y.w;
            }
            const float kn = __fsqrt_rn(lo[KS - 1]);
#pragma unroll
            for (int j = 0; j < QPW; ++j) {
                float gap = 0.0f;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const float d = fmaxf(fmaxf(__fsub_rn(lo[c], q[j][c]),
                                                __fsub_rn(q[j][c], hi[c])), 0.0f);
                    gap = fmaf(d, d, gap);
                }
                const float s = __fadd_rn(qn[j], kn);
                const float m = __fadd_rn(__fmul_rn(__fmul_rn(s, s), MARGIN_REL), MARGIN_ABS);
                bk[j] = order_hi(__fsub_rn(m, gap));
            }
        }
        unsigned mask = __ballot_sync(FULL, keep(bk, thr, live));
        while (mask) {
            const int src = __ffs(mask) - 1;
            const int col = __shfl_sync(FULL, g, src) * GROUP + lane;
            float kr[KS];
            const float4* krow = reinterpret_cast<const float4*>(tb + (size_t)col * KS);
#pragma unroll
            for (int c = 0; c < KS / 4; ++c) {
                const float4 x = __ldg(krow + c);
                kr[4 * c] = x.x, kr[4 * c + 1] = x.y, kr[4 * c + 2] = x.z, kr[4 * c + 3] = x.w;
            }
            const bool valid = col < N;
            // the group's keys that beat each query's k-th; zero otherwise
            uint64_t cand[QPW];
            int beats = 0;
#pragma unroll
            for (int j = 0; j < QPW; ++j) {
                float acc = 0.0f;
#pragma unroll
                for (int c = 0; c < C; ++c) acc = fmaf(q[j][c], kr[c], acc);
                const float s = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, acc), qsq[j]), kr[KS - 1]);
                cand[j] = valid && ((qvalid >> j) & 1u) ? order_key(s, col) : 0;
                if (cand[j] <= thr[j]) cand[j] = 0;
                beats += __popc(__ballot_sync(FULL, cand[j] != 0));
            }
            if (beats > SORT_MIN) {
                merge_group(list, cand, lane);
            } else {
#pragma unroll
                for (int j = 0; j < QPW; ++j) insert_some(list[j], cand[j]);
            }
#pragma unroll
            for (int j = 0; j < QPW; ++j) thr[j] = shfl64(list[j], k - 1);
            ++visited;
            mask &= ~(1u << src);
            mask &= __ballot_sync(FULL, keep(bk, thr, live));  // the risen thresholds
        }
    }

#pragma unroll
    for (int j = 0; j < QPW; ++j) {
        const int qi = q0 + j;
        if (qi < N && lane < k)
            out[((size_t)b * N + qi) * k + lane] =
                (int64_t)(0xffffffffu - (uint32_t)(list[j] & 0xffffffffu));
    }
    if (stats != nullptr && lane == 0) atomicAdd(stats, (unsigned long long)visited);
}

template <typename T, int C>
cudaError_t launch_pruned(const T* feats, float* table, float* boxes, unsigned long long* stats,
                          int64_t* out, int B, int N, int k, cudaStream_t stream) {
    const int G = (N + GROUP - 1) / GROUP;
    const long long threads = (long long)B * G * 32;
    knn_topk_boxes<T, C><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
        feats, table, boxes, B, N, G);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int warps = (N + QPW - 1) / QPW;
    dim3 grid((warps + WARPS - 1) / WARPS, B);
    knn_topk_pruned<row_floats(C)><<<grid, THREADS, 0, stream>>>(table, boxes, N, G, k, out,
                                                                 stats);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_pruned(const T* feats, float* table, float* boxes,
                            unsigned long long* stats, int64_t* out, int B, int N, int C, int k,
                            cudaStream_t s) {
    switch (C) {
        case 1: return launch_pruned<T, 1>(feats, table, boxes, stats, out, B, N, k, s);
        case 2: return launch_pruned<T, 2>(feats, table, boxes, stats, out, B, N, k, s);
        case 3: return launch_pruned<T, 3>(feats, table, boxes, stats, out, B, N, k, s);
        default: return launch_pruned<T, 4>(feats, table, boxes, stats, out, B, N, k, s);
    }
}

// ---- the wide arm (C > 4, or k > 32) -------------------------------------

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

constexpr int W_WARPS = 4;
constexpr int W_QPW = 16;                 // queries per warp: the 16 rows of one mma tile
constexpr int W_TQ = W_WARPS * W_QPW;     // queries per block
constexpr int W_TK = 64;                  // keys per tile: 8 n8 column blocks
constexpr int W_THREADS = W_WARPS * 32;
constexpr int W_NSTAGE = 3;               // cp.async ring depth
constexpr int SLAB = 128;                 // bytes of one row of a slab: 64 bf16 or 32 f32
constexpr int SROW = SLAB + 16;           // its shared-memory pitch: ldmatrix conflict-free
constexpr int SMEM_MAX = 232448;          // dynamic shared memory a block may take on sm_90

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
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

// The score of an order key (its high half), -inf for an empty slot.
__device__ __forceinline__ float key_score(uint64_t key) {
    if (key == 0) return -CUDART_INF_F;
    const uint32_t h = (uint32_t)(key >> 32);
    return __uint_as_float((h & 0x80000000u) ? (h & 0x7fffffffu) : ~h);
}

// Slot s (warp-uniform) of a list of SLOTS x 32 slots: lane j holds slots j
// and 32 + j.
template <int SLOTS>
__device__ __forceinline__ uint64_t slot_at(const uint64_t (&l)[SLOTS], int s) {
    if (SLOTS == 1 || s < 32) return shfl64(l[0], s & 31);
    return shfl64(l[SLOTS - 1], s - 32);
}

// Inserts each lane's candidate key that beats slot k-1 into the sorted list:
// a ballot for its rank over both halves, shuffles for the shift (slot 31
// carries into slot 32).  Slots past k-1 may keep keys pushed out; nothing
// reads them.
template <int SLOTS>
__device__ __forceinline__ void insert_list(uint64_t (&l)[SLOTS], uint64_t cand, int k,
                                            int lane) {
    uint64_t thr = slot_at<SLOTS>(l, k - 1);
    unsigned m = __ballot_sync(FULL, cand > thr);
    while (m) {
        const int src = __ffs(m) - 1;
        const uint64_t c = shfl64(cand, src);
        int p = __popc(__ballot_sync(FULL, l[0] > c));
        if (SLOTS == 2) {
            p += __popc(__ballot_sync(FULL, l[SLOTS - 1] > c));
            const uint64_t carry = shfl64(l[0], 31);
            const uint64_t up = shfl_up64(l[SLOTS - 1]);
            if (32 + lane == p) l[SLOTS - 1] = c;
            else if (32 + lane > p) l[SLOTS - 1] = lane == 0 ? carry : up;
        }
        const uint64_t up = shfl_up64(l[0]);
        if (lane == p) l[0] = c;
        else if (lane > p) l[0] = up;
        thr = slot_at<SLOTS>(l, k - 1);
        m &= ~(1u << src);
        m &= __ballot_sync(FULL, cand > thr);
    }
}

// The filter's margin per unit of |q|^2 + |k|^2, for S = ceil(C / 16)
// steps of 16 columns:  MARGIN_STEP (S + 4).  The filter scores may differ
// from the scores the lists hold (the exact dot rounded once, below) by:
//   * bf16 on the tensor cores: each mma adds 16 exact products to the f32
//     accumulator with the addends aligned to the largest and truncated
//     past 24 bits (the published model of NVIDIA's f32-accumulate
//     mma), so each step errs by at most 17 * 2^-23 * max(|acc|, sum |p|)
//     <= 2^-18.9 |q||k| <= 2^-19.9 (|q|^2 + |k|^2); S steps S times that;
//   * f32 on the CUDA cores: a chain of C fmas, at most C 2^-24 |q||k|,
//     below S 2^-20 (|q|^2 + |k|^2);
//   * both: the epilogue's two roundings on either side, below 2^-22
//     (|q|^2 + |k|^2), and the dot's one rounding, 2^-24 |dot|.
// MARGIN_STEP = 2^-17 keeps 7x of room on the first and 4 * 2^-17 the
// last two.  A key is scored exactly when its filter score plus the
// margin reaches the k-th score, so no key that enters is filtered out.
constexpr float MARGIN_STEP = 0x1p-17f;

// The exact dot product of rows q and r (C elements, C * sizeof(T) a
// multiple of 16, both 16-byte aligned, in shared or global memory),
// rounded once to f32: each product is exact (bf16: in f32, unless it
// falls out of f32's normal range; f32: in f64), and the sum of bf16
// products (16 significant bits each) is exact in f64 whatever its order;
// f32 rows round at 2^-53 first.  Two accumulators and two chunks per
// step keep four loads in flight (more cost registers, which bound the
// blocks an SM holds).
__device__ __forceinline__ double dot4(const uint4& x, const uint4& y, double acc) {
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        // a product of two bf16 values has 16 significant bits: exact in f32
        acc += (double)__fmul_rn(__uint_as_float(xs[w] << 16), __uint_as_float(ys[w] << 16));
        acc += (double)__fmul_rn(__uint_as_float(xs[w] & 0xffff0000u),
                                 __uint_as_float(ys[w] & 0xffff0000u));
    }
    return acc;
}
__device__ __forceinline__ double dot4(const float4& x, const float4& y, double acc) {
    acc = fma((double)x.x, (double)y.x, acc);
    acc = fma((double)x.y, (double)y.y, acc);
    acc = fma((double)x.z, (double)y.z, acc);
    return fma((double)x.w, (double)y.w, acc);
}
template <typename T>
__device__ __forceinline__ float exact_dot(const T* q, const T* r, int C) {
    typedef typename std::conditional<sizeof(T) == 2, uint4, float4>::type V;
    const V* q4 = reinterpret_cast<const V*>(q);
    const V* r4 = reinterpret_cast<const V*>(r);
    const int n = C * (int)sizeof(T) / 16;
    double a[2] = {0.0, 0.0};
    int ch = 0;
    for (; ch + 2 <= n; ch += 2) {
        V x[2], y[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            x[u] = q4[ch + u];
            y[u] = r4[ch + u];
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) a[u] = dot4(x[u], y[u], a[u]);
    }
    if (ch < n) a[0] = dot4(q4[ch], r4[ch], a[0]);
    return __double2float_rn(a[0] + a[1]);
}

// One slab of dot products into the warp's 16 x 64 score tile.  The
// accumulator layout is mma.sync's m16n8 C fragment for each of the 8
// column blocks: acc[nb][2h + e] is query row g + 8h (g = lane / 4) against
// key nb * 8 + 2 (lane % 4) + e of the tile.
// bf16: tensor cores, 4 k16 steps of ldmatrix + mma (f32 accumulation, each
// bf16 product exact in f32: only the order of the sum differs from a chain).
__device__ __forceinline__ void score_slab(float (&acc)[8][4], const unsigned char* qa,
                                           int qpitch, const unsigned char* ks, int cvalid,
                                           int lane, const bf16*) {
    const int lm = lane >> 3, lr = lane & 7;
    const unsigned char* a_ptr = qa + (lr + (lm & 1) * 8) * qpitch + (lm >> 1) * 16;
    const unsigned char* b_ptr = ks + (lr + (lm >> 1) * 8) * SROW + (lm & 1) * 16;
#pragma unroll
    for (int st = 0; st < SLAB / 32; ++st) {
        if (st * 16 >= cvalid) break;  // the slab's zero columns past C
        uint32_t a[4];
        ldsm_x4(a, a_ptr + st * 32);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            ldsm_x4(b, b_ptr + np * 16 * SROW + st * 32);
            mma_16816(acc[2 * np], a, b[0], b[1]);
            mma_16816(acc[2 * np + 1], a, b[2], b[3]);
        }
    }
}

// f32: CUDA cores, the same tile layout; each dot product a chain of fused
// multiply-adds over the columns in order (the Pallas kernel's rounding).
__device__ __forceinline__ void score_slab(float (&acc)[8][4], const unsigned char* qa,
                                           int qpitch, const unsigned char* ks, int cvalid,
                                           int lane, const float*) {
    const int g = lane >> 2, t = lane & 3;
    const float* q0 = reinterpret_cast<const float*>(qa + g * qpitch);
    const float* q1 = reinterpret_cast<const float*>(qa + (g + 8) * qpitch);
    const float* kr = reinterpret_cast<const float*>(ks + 2 * t * SROW);
#pragma unroll 1
    for (int c = 0; c < cvalid; ++c) {
        const float x0 = q0[c], x1 = q1[c];
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
            const float y0 = kr[nb * 8 * (SROW / 4) + c];
            const float y1 = kr[(nb * 8 + 1) * (SROW / 4) + c];
            acc[nb][0] = fmaf(x0, y0, acc[nb][0]);
            acc[nb][1] = fmaf(x0, y1, acc[nb][1]);
            acc[nb][2] = fmaf(x1, y0, acc[nb][2]);
            acc[nb][3] = fmaf(x1, y1, acc[nb][3]);
        }
    }
}

// Shared memory of a block: the queries' rows resident for every slab
// (qres) when they fit, then a ring of W_NSTAGE stages, each a key tile's
// slab, the tile's key norms and, without qres, the queries' slab; last,
// each warp's queue of candidates and its queries' k-th scores.
__host__ __device__ inline long long wide_qpitch(int C, int elem, bool qres) {
    return qres ? ((long long)C * elem + SLAB - 1) / SLAB * SLAB + 16 : SROW;
}
__host__ __device__ inline int wide_stage_bytes(bool qres) {
    return W_TK * SROW + W_TK * 4 + (qres ? 0 : W_TQ * SROW);
}
constexpr int W_QCAP = 64;  // candidates a warp's queue holds
constexpr int W_QUEUE_BYTES = 9 * W_QCAP + 4 * W_QPW;
__host__ __device__ inline long long wide_smem(int C, int elem, bool qres) {
    return (qres ? W_TQ * wide_qpitch(C, elem, qres) : 0) + W_NSTAGE * wide_stage_bytes(qres) +
           W_WARPS * W_QUEUE_BYTES;
}

// One block per (batch row, 128 queries); warp w owns queries 16w..16w+15.
// Keys stream through the ring in 64-key tiles, each in slabs of SLAB bytes
// of columns (cp.async, zeros past N and C), so any C works; the tiles are
// visited from the block's own rows outward (visit_group), which fills the
// lists with near keys first.  After a tile's last slab each lane holds 32
// scores; those not below their query's k-th score (a float threshold per
// row, kept in registers) set a bit, and only the set bits reach the
// warp's sorted lists, one candidate per lane per round.
// bf16: three blocks an SM (170 registers a thread); f32 takes what it needs
template <typename T, int SLOTS>
__global__ void __launch_bounds__(W_THREADS, sizeof(T) == 2 ? 3 : 1)
knn_topk_wide(const T* __restrict__ feats, const float* __restrict__ sq, int N, int C, int k,
              int qres, int64_t* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int b = blockIdx.y;
    const int q0 = blockIdx.x * W_TQ;
    const T* fb = feats + (size_t)b * N * C;
    const float* sqb = sq + (size_t)b * N;
    const int nslab = (C * (int)sizeof(T) + SLAB - 1) / SLAB;
    const int n_kt = (N + W_TK - 1) / W_TK;
    const int total = n_kt * nslab;
    const int kt0 = q0 / W_TK;
    const int qpitch = (int)wide_qpitch(C, sizeof(T), qres);
    const int stage_bytes = wide_stage_bytes(qres);
    unsigned char* stages = smem + (qres ? W_TQ * qpitch : 0);
    // this warp's queue of candidates (key column, query, filter bound)
    // and its queries' k-th scores, kept across tiles
    unsigned char* wq = stages + W_NSTAGE * stage_bytes + warp * W_QUEUE_BYTES;
    int* qcol = reinterpret_cast<int*>(wq);
    float* qbound = reinterpret_cast<float*>(wq + 4 * W_QCAP);
    float* thr_s = reinterpret_cast<float*>(wq + 8 * W_QCAP);
    unsigned char* qrow = wq + 8 * W_QCAP + 4 * W_QPW;
    constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
    constexpr int CS = SLAB / sizeof(T);  // columns per slab

    // rows [row0, row0 + rows) of the features, chunks [ch0, ch0 + chunks)
    // of each, into dst at `pitch` bytes per row
    auto load_rows = [&](unsigned char* dst, int pitch, int row0, int rows, int ch0, int chunks) {
        for (int e = tid; e < rows * chunks; e += W_THREADS) {
            const int r = e / chunks, ch = e - r * chunks;
            const int row = row0 + r, col = (ch0 + ch) * EPC;
            const bool ok = row < N && col < C;
            cp_async16(dst + r * pitch + ch * 16, ok ? fb + (size_t)row * C + col : fb,
                       ok ? 16 : 0);
        }
    };
    auto issue = [&](int i) {
        if (i < total) {
            unsigned char* st = stages + (i % W_NSTAGE) * stage_bytes;
            const int tt = i / nslab, s = i - tt * nslab;
            const int kb = visit_group(tt, kt0, n_kt) * W_TK;
            load_rows(st, SROW, kb, W_TK, s * (SLAB / 16), SLAB / 16);
            if (tid < W_TK) {
                const bool ok = kb + tid < N;
                cp_async4(st + W_TK * SROW + tid * 4, ok ? sqb + kb + tid : sqb, ok ? 4 : 0);
            }
            if (!qres)
                load_rows(st + W_TK * SROW + W_TK * 4, SROW, q0, W_TQ, s * (SLAB / 16),
                          SLAB / 16);
        }
        cp_async_commit();
    };

    if (qres) load_rows(smem, qpitch, q0, W_TQ, 0, nslab * (SLAB / 16));
    issue(0);
    issue(1);

    const int r0 = q0 + warp * W_QPW + g, r1 = r0 + 8;
    const float qsq0 = r0 < N ? sqb[r0] : 0.0f, qsq1 = r1 < N ? sqb[r1] : 0.0f;
    float thr0 = -CUDART_INF_F, thr1 = -CUDART_INF_F;  // each row's k-th score
    const float margin = MARGIN_STEP * (float)((C + 15) / 16 + 4);
    uint64_t list[W_QPW][SLOTS];
#pragma unroll
    for (int j = 0; j < W_QPW; ++j)
#pragma unroll
        for (int h = 0; h < SLOTS; ++h) list[j][h] = 0;  // below every real key
    float acc[8][4];
    int qn = 0;  // candidates in the queue (the same on every lane)
    if (lane < W_QPW) thr_s[lane] = -CUDART_INF_F;
    __syncwarp();

    // Takes the queue's last min(32, qn) candidates, one per lane: each
    // whose bound still reaches its query's k-th score is scored exactly
    // (the exact dot rounded once, then the epilogue's two roundings) and
    // offered to its query's list; the thresholds follow the lists.
    auto score_round = [&]() {
        const int take = min(32, qn);
        uint64_t cand = 0;
        int jq = -1;
        if (lane < take) {
            const int at = qn - 1 - lane, col = qcol[at], j = qrow[at];
            if (qbound[at] >= thr_s[j]) {
                const int row = warp * W_QPW + j;
                const T* qr = qres ? reinterpret_cast<const T*>(smem + row * qpitch)
                                   : fb + (size_t)(q0 + row) * C;
                const float d = exact_dot(qr, fb + (size_t)col * C, C);
                cand = order_key(__fsub_rn(__fsub_rn(__fmul_rn(2.0f, d), sqb[q0 + row]), sqb[col]),
                                 col);
                jq = j;
            }
        }
        qn -= take;
        const unsigned qm = __reduce_or_sync(FULL, jq >= 0 ? 1u << jq : 0u);
#pragma unroll
        for (int j = 0; j < W_QPW; ++j) {
            if (!((qm >> j) & 1u)) continue;
            insert_list<SLOTS>(list[j], jq == j ? cand : 0, k, lane);
            const float tf = key_score(slot_at<SLOTS>(list[j], k - 1));
            if (lane == 0) thr_s[j] = tf;
            if (g == (j & 7)) {
                if (j >> 3) thr1 = tf;
                else thr0 = tf;
            }
        }
        __syncwarp();
    };

#pragma unroll 1
    for (int i = 0; i < total; ++i) {
        cp_async_wait<W_NSTAGE - 2>();
        __syncthreads();  // stage i has landed; stage i - 1's buffer is free
        issue(i + W_NSTAGE - 1);
        const unsigned char* st = stages + (i % W_NSTAGE) * stage_bytes;
        const int tt = i / nslab, s = i - tt * nslab;
        if (s == 0) {
#pragma unroll
            for (int nb = 0; nb < 8; ++nb)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[nb][e] = 0.0f;
        }
        const unsigned char* qa = qres ? smem + warp * W_QPW * qpitch + s * SLAB
                                       : st + W_TK * SROW + W_TK * 4 + warp * W_QPW * SROW;
        score_slab(acc, qa, qpitch, st, min(CS, C - s * CS), lane, (const T*)nullptr);
        if (s != nslab - 1) continue;

        // the filter: the tile's tensor-core scores ((2 dot - |q|^2) - |k|^2,
        // kept in acc); bit 2 nb + e (+ 16 for row g + 8) is each valid one
        const int kb = visit_group(tt, kt0, n_kt) * W_TK;
        const float* ksq = reinterpret_cast<const float*>(st + W_TK * SROW);
        const uint32_t rows_ok = (uint32_t)(r0 < N) | (uint32_t)(r1 < N) << 16;
        float kmax = 0.0f;
        uint32_t pend = 0;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int kc = nb * 8 + 2 * t4 + e;
                const float kn = ksq[kc];
                kmax = fmaxf(kmax, kn);
                acc[nb][e] = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, acc[nb][e]), qsq0), kn);
                acc[nb][2 + e] =
                    __fsub_rn(__fsub_rn(__fmul_rn(2.0f, acc[nb][2 + e]), qsq1), kn);
                if (kb + kc < N) pend |= rows_ok << (2 * nb + e);
            }
        }
        kmax = fmaxf(kmax, __shfl_xor_sync(FULL, kmax, 1));
        kmax = fmaxf(kmax, __shfl_xor_sync(FULL, kmax, 2));  // over the tile's 64 keys
        const float m0 = margin * (qsq0 + kmax), m1 = margin * (qsq1 + kmax);

        // the set bits join the warp's queue; whenever it holds 32 (or the
        // bits overflow it) a round takes 32
        while (true) {
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    if (acc[nb][e] + m0 < thr0) pend &= ~(1u << (2 * nb + e));
                    if (acc[nb][2 + e] + m1 < thr1) pend &= ~(1u << (16 + 2 * nb + e));
                }
            }
            const int cnt = __popc(pend);
            int incl = cnt;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(FULL, incl, o);
                if (lane >= o) incl += y;
            }
            const int nbits = __shfl_sync(FULL, incl, 31);
            int slot = qn + incl - cnt;
#pragma unroll
            for (int u = 0; u < 32; ++u) {
                if (((pend >> u) & 1u) && slot < W_QCAP) {
                    const int h = u >> 4, nb = (u & 15) >> 1, e = u & 1;
                    qcol[slot] = kb + nb * 8 + 2 * t4 + e;
                    qrow[slot] = (unsigned char)(g + 8 * h);
                    qbound[slot] = acc[nb][2 * h + e] + (h ? m1 : m0);
                    pend &= ~(1u << u);
                    ++slot;
                }
            }
            __syncwarp();
            const bool more = qn + nbits > W_QCAP;
            qn = min(W_QCAP, qn + nbits);
            if (qn < 32 && !more) break;
            score_round();
        }
    }
    while (qn > 0) score_round();

#pragma unroll
    for (int j = 0; j < W_QPW; ++j) {
        const int qi = q0 + warp * W_QPW + j;
        if (qi >= N) continue;
        int64_t* o = out + ((size_t)b * N + qi) * k;
#pragma unroll
        for (int h = 0; h < SLOTS; ++h)
            if (32 * h + lane < k)
                o[32 * h + lane] = (int64_t)(0xffffffffu - (uint32_t)(list[j][h] & 0xffffffffu));
    }
}

template <typename T, int SLOTS>
cudaError_t launch_wide(const T* feats, float* sq, int64_t* out, int B, int N, int C, int k,
                        cudaStream_t stream) {
    const bool qres = wide_smem(C, sizeof(T), true) <= SMEM_MAX;
    const int smem = (int)wide_smem(C, sizeof(T), qres);
    cudaError_t e = cudaFuncSetAttribute(knn_topk_wide<T, SLOTS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const int rows = B * N;
    row_sqnorm<T><<<(rows + 255) / 256, 256, 0, stream>>>(feats, sq, rows, C);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dim3 grid((N + W_TQ - 1) / W_TQ, B);
    knn_topk_wide<T, SLOTS><<<grid, W_THREADS, smem, stream>>>(feats, sq, N, C, k, (int)qres,
                                                               out);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const T* feats, float* sq, float* table, float* boxes,
                     unsigned long long* stats, int64_t* out, int B, int N, int C, int k,
                     cudaStream_t stream) {
    if (C <= 4 && k <= 32) {
        if (table == nullptr || boxes == nullptr) return cudaErrorInvalidValue;
        return dispatch_pruned(feats, table, boxes, stats, out, B, N, C, k, stream);
    }
    // the wide arm reads whole 16-byte chunks of 16-byte aligned rows
    if (sq == nullptr || (C * sizeof(T)) % 16 != 0 || (uintptr_t)feats % 16 != 0)
        return cudaErrorInvalidValue;
    return k <= 32 ? launch_wide<T, 1>(feats, sq, out, B, N, C, k, stream)
                   : launch_wide<T, 2>(feats, sq, out, B, N, C, k, stream);
}

}  // namespace

// feats (B, N, C) bf16 (is_bf16 = 1) or f32, contiguous; out (B, N, k)
// int64; 1 <= k <= min(64, N).  C <= 4 with k <= 32 (the pruned arm):
// table (B, ceil(N/32)*32, C < 4 ? 4 : 8) and boxes (B, ceil(N/32), 2 *
// that) f32 scratch, 16-byte aligned; stats null or one uint64 that gains
// the count of (warp, group) pairs scored.  Otherwise (the wide arm): sq
// (B*N) f32 scratch, rows of a multiple of 16 bytes, feats 16-byte aligned.
extern "C" int scp_knn_topk(const void* feats, int is_bf16, void* sq, void* table, void* boxes,
                            void* stats, void* out, int B, int N, int C, int k, void* stream) {
    if (B <= 0 || N <= 0) return (int)cudaSuccess;
    if (k < 1 || k > 64 || k > N || C < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    float* sq_f = static_cast<float*>(sq);
    float* tab = static_cast<float*>(table);
    float* box = static_cast<float*>(boxes);
    unsigned long long* st = static_cast<unsigned long long*>(stats);
    int64_t* o = static_cast<int64_t*>(out);
    cudaError_t e = is_bf16
        ? dispatch(static_cast<const bf16*>(feats), sq_f, tab, box, st, o, B, N, C, k, s)
        : dispatch(static_cast<const float*>(feats), sq_f, tab, box, st, o, B, N, C, k, s);
    return (int)e;
}

extern "C" const char* scp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
