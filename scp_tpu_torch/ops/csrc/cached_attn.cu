// The cached attention of OctAttention's KV-cache step
// (models/octattention.py, DualStreamLayer._attend_cached): for each
// (lane, head) row,
//   s_r    = q . K[r] / sqrt(hd)   for the first `length` cached rows r,
//   s_self = q . k_self / sqrt(hd),
//   w      = softmax([s_0 .. s_{length-1}, s_self]) in f32,
//   out    = sum_r w_r V[r] + w_self v_self, rounded once to the cache dtype.
//
// Replaces no pallas_call: scp_tpu computes this step with einsums.  It was
// added so that one launch pair serves every position: `length` is read
// from device memory (or given as an argument), so a CUDA graph captured
// once replays the step at every cache length, and only the `length`
// cached rows are read.  f32 or bf16 operands, f32 sums.
//
// Bound on this card: bytes.  A call reads 2 x rows x length x hd cache
// elements and does 4 FLOPs per element, far below the f32 ridge (at 128
// lanes, 4 heads, length 1023, hd 150, f32: 629 MB, 0.19 ms at 3.35 TB/s).
// The design:
//   * rows (lane x head) are few at small lane counts (4-128 below 32
//     lanes, against 132 SMs), so the length is split across blocks, as in
//     flash-decoding: block (split, row) handles `chunk` cached rows;
//   * the chunk's K and V rows are one contiguous byte span each; a chunk
//     whose first row is a multiple of `group` (the rows that make a
//     16-byte multiple: 2 at hd 150 in f32, 4 in bf16) starts 16-byte
//     aligned, whatever hd is, so both spans go to shared memory as 16-byte
//     cp.async copies, V's in flight behind K's scores;
//   * scores a warp per row, then the chunk's max m, p_r = exp(s_r - m),
//     l = sum p_r and acc = sum p_r V[r] (a thread per column); (m, l, acc)
//     go to a workspace, and a second launch combines each row's splits
//     with the self slot;
//   * every sum runs in a fixed order (no atomics): the encoder and the
//     decoder must compute the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

struct Args {
    const void* q;        // (rows, hd): (lanes, heads * hd) row-major
    const void* k_self;   // (rows, hd)
    const void* v_self;   // (rows, hd)
    const void* k_cache;  // (rows, W, hd)
    const void* v_cache;  // (rows, W, hd)
    void* out;            // (rows, hd)
    float* ws_acc;        // (rows, nsplit, hd)
    float* ws_ml;         // (rows, nsplit, 2): (m, l)
    const long long* len_ptr;  // device scalar, or null: len_host
    long long len_host;
    int rows, W, hd, chunk, group, nsplit;
    float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ int cache_length(const Args& a) {
    const long long n = a.len_ptr ? *a.len_ptr : a.len_host;
    return (int)(n < 0 ? 0 : (n > a.W ? a.W : n));
}

// Shared memory: K span, V span (chunk * hd elements each), q as f32 (hd),
// then the chunk's scores, turned into weights in place (chunk).
template <typename T>
__global__ void __launch_bounds__(THREADS) cached_attn_split(Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float m_sh, l_sh;
    const int split = blockIdx.x, row = blockIdx.y;
    const int len = cache_length(a);
    const int c0 = split * a.chunk;
    if (c0 >= len) return;  // the combine reads only the splits below `len`
    const int hd = a.hd;
    const int valid = min(a.chunk, len - c0);
    // rows copied: up to `len` rounded up to the group, within the window
    const int loaded = min(a.chunk, (len + a.group - 1) / a.group * a.group - c0);
    const size_t span = (size_t)a.chunk * hd * sizeof(T);
    const T* ks = reinterpret_cast<const T*>(smem);
    const T* vs = reinterpret_cast<const T*>(smem + span);
    float* qf = reinterpret_cast<float*>(smem + 2 * span);
    float* p = qf + hd;

    const size_t base = ((size_t)row * a.W + c0) * hd;
    const char* kg = reinterpret_cast<const char*>(static_cast<const T*>(a.k_cache) + base);
    const char* vg = reinterpret_cast<const char*>(static_cast<const T*>(a.v_cache) + base);
    const int nvec = (int)((size_t)loaded * hd * sizeof(T) / 16);
    for (int i = threadIdx.x; i < nvec; i += THREADS)
        cp_async16(smem + 16 * (size_t)i, kg + 16 * (size_t)i);
    cp_async_commit();
    for (int i = threadIdx.x; i < nvec; i += THREADS)
        cp_async16(smem + span + 16 * (size_t)i, vg + 16 * (size_t)i);
    cp_async_commit();
    const T* qg = static_cast<const T*>(a.q) + (size_t)row * hd;
    for (int c = threadIdx.x; c < hd; c += THREADS) qf[c] = to_f32(qg[c]);
    cp_async_wait<1>();
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < valid; r += WARPS) {
        const T* kr = ks + (size_t)r * hd;
        float s = 0.0f;
        for (int c = lane; c < hd; c += 32) s = fmaf(qf[c], to_f32(kr[c]), s);
        s = warp_sum(s);
        if (lane == 0) p[r] = s / a.scale;
    }
    __syncthreads();
    if (warp == 0) {
        float m = -CUDART_INF_F;
        for (int r = lane; r < valid; r += 32) m = fmaxf(m, p[r]);
        m = warp_max(m);
        float l = 0.0f;
        for (int r = lane; r < valid; r += 32) {
            const float e = expf(p[r] - m);
            p[r] = e;
            l += e;
        }
        l = warp_sum(l);
        if (lane == 0) {
            m_sh = m;
            l_sh = l;
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    float* acc_out = a.ws_acc + ((size_t)row * a.nsplit + split) * hd;
    for (int c = threadIdx.x; c < hd; c += THREADS) {
        float acc = 0.0f;
#pragma unroll 8
        for (int r = 0; r < valid; ++r) acc = fmaf(p[r], to_f32(vs[(size_t)r * hd + c]), acc);
        acc_out[c] = acc;
    }
    if (threadIdx.x == 0) {
        float* ml = a.ws_ml + ((size_t)row * a.nsplit + split) * 2;
        ml[0] = m_sh;
        ml[1] = l_sh;
    }
}

// One block a row: the self slot's score, the global max over it and the
// splits, then out = (sum_s acc_s e^(m_s - M) + e^(s_self - M) v_self) / L.
// The splits' (m, l) come in parallel and warp 0 reduces them (a fixed
// shuffle tree), so a long row costs no chain of dependent loads.
// Shared memory: m, l and the factor of each split.
template <typename T>
__global__ void __launch_bounds__(THREADS) cached_attn_combine(Args a) {
    extern __shared__ float split_sh[];
    __shared__ float red[WARPS];
    __shared__ float self_w, total;
    const int row = blockIdx.x, hd = a.hd;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int len = cache_length(a);
    const int ns = (len + a.chunk - 1) / a.chunk;
    float* ms = split_sh;
    float* ls = ms + a.nsplit;
    float* factor = ls + a.nsplit;
    const T* q = static_cast<const T*>(a.q) + (size_t)row * hd;
    const T* ks = static_cast<const T*>(a.k_self) + (size_t)row * hd;
    const T* vs = static_cast<const T*>(a.v_self) + (size_t)row * hd;
    const float* ml = a.ws_ml + (size_t)row * a.nsplit * 2;
    const float* acc = a.ws_acc + (size_t)row * a.nsplit * hd;

    for (int s = threadIdx.x; s < ns; s += THREADS) {
        ms[s] = ml[2 * s];
        ls[s] = ml[2 * s + 1];
    }
    float d = 0.0f;
    for (int c = threadIdx.x; c < hd; c += THREADS) d = fmaf(to_f32(q[c]), to_f32(ks[c]), d);
    d = warp_sum(d);
    if (lane == 0) red[warp] = d;
    __syncthreads();
    if (warp == 0) {
        float s_self = red[0];
        for (int w = 1; w < WARPS; ++w) s_self += red[w];
        s_self = s_self / a.scale;
        float m = s_self;
        for (int s = lane; s < ns; s += 32) m = fmaxf(m, ms[s]);
        m = warp_max(m);
        float l = 0.0f;
        for (int s = lane; s < ns; s += 32) {
            const float f = expf(ms[s] - m);
            factor[s] = f;
            l = fmaf(ls[s], f, l);
        }
        l = warp_sum(l);
        if (lane == 0) {
            self_w = expf(s_self - m);
            total = l + self_w;
        }
    }
    __syncthreads();
    T* out = static_cast<T*>(a.out) + (size_t)row * hd;
    for (int c = threadIdx.x; c < hd; c += THREADS) {
        float o = 0.0f;
#pragma unroll 8
        for (int s = 0; s < ns; ++s) o = fmaf(acc[(size_t)s * hd + c], factor[s], o);
        o = fmaf(self_w, to_f32(vs[c]), o);
        store(out + c, o / total);
    }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    const size_t smem =
        2 * (size_t)a.chunk * a.hd * sizeof(T) + (size_t)(a.hd + a.chunk) * sizeof(float);
    if (smem > 48 * 1024 || a.rows > 65535 || a.nsplit < 1) return cudaErrorInvalidValue;
    cached_attn_split<T><<<dim3(a.nsplit, a.rows), THREADS, smem, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cached_attn_combine<T><<<a.rows, THREADS, 3 * a.nsplit * sizeof(float), stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

// q, k_self, v_self, out: (rows, hd) contiguous; k_cache, v_cache: (rows, W,
// hd) contiguous and 16-byte aligned with W * hd * element size a multiple
// of 16; ws_acc (rows, nsplit, hd) f32, ws_ml (rows, nsplit, 2) f32;
// nsplit = ceil(W / chunk), chunk a multiple of group.  The length is read
// from len_ptr (an int64 device scalar) when it is not null, else len_host.
// is_f32: 1 for f32 operands, 0 for bf16.
extern "C" int scp_cached_attn(const void* q, const void* k_self, const void* v_self,
                               const void* k_cache, const void* v_cache, void* out, void* ws_acc,
                               void* ws_ml, const void* len_ptr, long long len_host, int rows,
                               int W, int hd, int chunk, int group, int nsplit, float scale,
                               int is_f32, void* stream) {
    Args a;
    a.q = q;
    a.k_self = k_self;
    a.v_self = v_self;
    a.k_cache = k_cache;
    a.v_cache = v_cache;
    a.out = out;
    a.ws_acc = static_cast<float*>(ws_acc);
    a.ws_ml = static_cast<float*>(ws_ml);
    a.len_ptr = static_cast<const long long*>(len_ptr);
    a.len_host = len_host;
    a.rows = rows;
    a.W = W;
    a.hd = hd;
    a.chunk = chunk;
    a.group = group;
    a.nsplit = nsplit;
    a.scale = scale;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (is_f32) return (int)launch<float>(a, s);
    return (int)launch<bf16>(a, s);
}

extern "C" const char* scp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
