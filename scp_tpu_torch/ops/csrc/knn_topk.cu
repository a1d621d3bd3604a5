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
// Both arms keep each query's running top-k as one sorted list spread over
// a warp (lane j holds slot j, k <= 32) of 64-bit keys: order-preserving
// bits of the f32 score above (2^32-1 - col), so a larger key is a larger
// score and, on equal scores, a lower column.  A key that beats slot k-1
// is inserted with one ballot (its rank), one shuffle (the shift) and one
// broadcast (the new threshold).  The keys are unique, so the lists do not
// depend on the order keys arrive in; no (N, N) score matrix exists and
// nothing but the optional work counter is atomic: two launches give
// identical indices.
//
// Bound.  2*N*C operations per query, N*C*2 bytes in and N*k*8 bytes out
// per batch row.  At C = 3 the arithmetic is tiny; what costs is visiting
// (query, key) pairs and the compare-and-insert of those that beat a list.
//
// Positions (C <= 4, the static graph's C = 3): the pruned arm.
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
// Features (C > 4, the dynamic graph's C = 144/192): the brute-force arm.
// One block per (batch row, 64 queries); 8 warps, each owning 8 queries.
// Keys stream through shared memory in 64-row tiles; a warp scores 32 keys
// at a time (lane = key) against its 8 queries.  Tensor-core scoring for
// wide C is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int QPW = 8;             // queries per warp
constexpr int TQ = WARPS * QPW;    // queries per block
constexpr int TK = 64;             // keys per shared-memory tile
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

// Inserts each lane's candidate key that beats the query's threshold (slot
// k-1) into its warp-wide sorted list; thr stays the (broadcast) slot k-1.
__device__ __forceinline__ void insert(uint64_t& list, uint64_t& thr, uint64_t cand, int k,
                                       int lane) {
    unsigned m = __ballot_sync(FULL, cand > thr);
    while (m) {
        const int src = __ffs(m) - 1;
        const uint64_t c = shfl64(cand, src);
        const int p = __popc(__ballot_sync(FULL, list > c));
        const uint64_t up = shfl_up64(list);
        if (lane == p) list = c;
        else if (lane > p) list = up;
        thr = shfl64(list, k - 1);
        m &= ~(1u << src);
        m &= __ballot_sync(FULL, cand > thr);
    }
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

// ---- the brute-force arm (C > 4) ----------------------------------------

// Row stride in floats: a multiple of 4 whose count of 16-byte chunks is
// odd, so 8 lanes reading 8 rows with one 16-byte load hit 8 distinct
// bank groups.
__host__ __device__ inline int row_stride(int c) {
    int cp = (c + 3) / 4 * 4;
    if ((cp / 4) % 2 == 0) cp += 4;
    return cp;
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

// Any width; queries read from shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS)
knn_topk(const T* __restrict__ feats, const float* __restrict__ sq, int N, int C, int k,
         int64_t* __restrict__ out) {
    extern __shared__ float4 smem4[];
    const int cp = row_stride(C);
    const int n4 = cp / 4;
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
            const bool valid = col < N;
            const float kn = ksq[sub + lane];
#pragma unroll
            for (int j = 0; j < QPW; ++j) {
                const float s = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, acc[j]), qsq[j]), kn);
                insert(list[j], thr[j], valid ? order_key(s, col) : 0, k, lane);
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

template <typename T>
cudaError_t launch_wide(const T* feats, float* sq, int64_t* out, int B, int N, int C, int k,
                        cudaStream_t stream) {
    const size_t smem = smem_bytes(C);
    cudaError_t e = cudaFuncSetAttribute(knn_topk<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const int rows = B * N;
    row_sqnorm<T><<<(rows + 255) / 256, 256, 0, stream>>>(feats, sq, rows, C);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dim3 grid((N + TQ - 1) / TQ, B);
    knn_topk<T><<<grid, THREADS, smem, stream>>>(feats, sq, N, C, k, out);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const T* feats, float* sq, float* table, float* boxes,
                     unsigned long long* stats, int64_t* out, int B, int N, int C, int k,
                     cudaStream_t stream) {
    if (C <= 4) {
        if (table == nullptr || boxes == nullptr) return cudaErrorInvalidValue;
        return dispatch_pruned(feats, table, boxes, stats, out, B, N, C, k, stream);
    }
    if (sq == nullptr) return cudaErrorInvalidValue;
    return launch_wide(feats, sq, out, B, N, C, k, stream);
}

}  // namespace

// feats (B, N, C) bf16 (is_bf16 = 1) or f32, contiguous; out (B, N, k)
// int64.  C <= 4 (the pruned arm): table (B, ceil(N/32)*32, C < 4 ? 4 : 8)
// and boxes (B, ceil(N/32), 2 * that) f32 scratch, 16-byte aligned; stats
// null or one uint64 that gains the count of (warp, group) pairs scored.
// C > 4: sq (B*N) f32 scratch.  Requires 1 <= k <= 32, k <= N, C <= 256.
extern "C" int scp_knn_topk(const void* feats, int is_bf16, void* sq, void* table, void* boxes,
                            void* stats, void* out, int B, int N, int C, int k, void* stream) {
    if (B <= 0 || N <= 0) return (int)cudaSuccess;
    if (k < 1 || k > 32 || k > N || C < 1 || C > 256) return (int)cudaErrorInvalidValue;
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
