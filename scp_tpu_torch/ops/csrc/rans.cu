// The interleaved rANS coder's two chains (codec/rans.py): decode of one
// group, and encode of a whole stream, one thread a lane.
//
// Replaces no pallas_call.  It is the hot path of scp_tpu/codec/rans.py's
// _decode_chunk / _encode_chunk, each a lax.scan over a chunk's 64 steps
// that XLA compiles to one device loop.  The port's plain version of those
// scans (codec/rans.py) issues ~15 PyTorch ops a step, 36 launches a coder
// step, and the host's launches set its pace; these kernels take every
// CUDA tensor instead.
//
// Bound: latency and the serial chain, not bytes or operations.  A sweep
// codes ~840 dependent steps a direction, 1024 lanes a step, and a lane's
// byte offset in a step is the exclusive scan of the lanes below it, so
// every step ends in a block-wide scan; a decode step also searches the
// lane's CDF row in device memory before its count is known.  The design:
//   * one 1024-thread block, lane = thread; states in registers as uint32
//     (states stay below 2^31 and every renormalised value below 2^31),
//     the byte offset in a register of every thread (the block's sum is
//     broadcast by the scan);
//   * decode: one launch per group, over all its chunks.  The symbol search
//     reads the 15 ends of the row's 16-entry segments (independent loads,
//     issued for the next step before this step's scan), then the one
//     segment that holds the slot as four 16-byte loads: two dependent
//     reads a step instead of a binary search's eight.  The rows are
//     non-decreasing (logits_to_cdf makes them strictly increasing; padded
//     rows are all zero), so the entries <= slot are a prefix and the symbol
//     is upper_bound - 1, the plain version's count (r[:255] <= slot) - 1;
//     entry 255 is stored wrapped and read as 65536;
//   * encode: one launch per stream.  The lanes' chains run over every
//     group, step and lane in reverse; the stream's total is not known until
//     the last step, so each step's bytes are laid from the end of the
//     buffer, after the steps that follow it in decode order: the body is
//     the buffer's last `total` bytes, in the decode order of the plain
//     version (each chunk's block cut to its total, chunks concatenated);
//   * the scan: warp shuffles, then one shared-memory pass over the 32 warp
//     sums, from two alternating buffers, so two barriers a step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 1024;  // codec/rans.py K_LANES
constexpr int WARPS = LANES / 32;
constexpr int ROW = 256;  // CDF entries per row
constexpr uint32_t RANS_L = 1u << 23;
constexpr uint32_t HALF_L = 1u << 15;  // RANS_L >> 8

// Exclusive scan of one count a thread in ascending thread order: returns
// the thread's prefix and sets `total` to the block's sum.  `sums` (WARPS +
// 1 ints of shared memory) must alternate between two buffers from call to
// call: a buffer is written again only after both barriers of the call in
// between, which every thread passes after its last read of it.
__device__ __forceinline__ int block_scan(int v, int* sums, int& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        const int w = sums[lane];
        int t = w;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, t, d);
            if (lane >= d) t += y;
        }
        sums[lane] = t - w;
        if (lane == 31) sums[WARPS] = t;
    }
    __syncthreads();
    total = sums[WARPS];
    return sums[warp] + x - v;
}

// The ends r[16 j + 15] of the row's first 15 segments (the 16th ends with
// entry 255, 65536, above every slot).
__device__ __forceinline__ void load_ends(const int32_t* __restrict__ r, uint32_t (&ends)[15]) {
#pragma unroll
    for (int j = 0; j < 15; ++j) ends[j] = static_cast<uint32_t>(__ldg(r + 16 * j + 15));
}

// rows (n_pad, 256) int32, n_pad a multiple of LANES; symbol i is lane
// i % LANES's at step i / LANES.  states (LANES,) and *ptr_io int64 are
// read at the start and written back at the end.  out (n_pad,) gets the
// symbols, 0 on inactive lanes and past the last step.
__global__ void __launch_bounds__(LANES) rans_decode_group(
    const int32_t* __restrict__ rows, long long n, long long n_pad,
    const uint8_t* __restrict__ stream, long long limit, long long* __restrict__ states,
    long long* __restrict__ ptr_io, uint8_t* __restrict__ out) {
    __shared__ int sums[2][WARPS + 1];
    const int lane = threadIdx.x;
    uint32_t x = static_cast<uint32_t>(states[lane]);
    long long ptr = *ptr_io;
    const long long steps = (n + LANES - 1) / LANES;
    uint32_t ends[15];
    if (lane < n) load_ends(rows + static_cast<long long>(lane) * ROW, ends);
    for (long long s = 0; s < steps; ++s) {
        const long long i = s * LANES + lane;
        const bool active = i < n;
        uint32_t sym = 0, x2 = 0;
        int cnt = 0;
        if (active) {
            const uint32_t slot = x & 0xFFFFu;
            int seg = 0;  // segments whose end is <= slot
            uint32_t lo = 0;  // the largest entry <= slot seen so far
#pragma unroll
            for (int j = 0; j < 15; ++j) {
                if (ends[j] <= slot) {
                    ++seg;
                    lo = ends[j];
                }
            }
            const int4* p = reinterpret_cast<const int4*>(rows + i * ROW + 16 * seg);
            const int4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2), d = __ldg(p + 3);
            const int32_t e[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                                   c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
            uint32_t hi = 1u << 16;  // the smallest entry > slot
            int below = 0;
#pragma unroll
            for (int k = 0; k < 16; ++k) {
                const uint32_t v = (k == 15 && seg == 15) ? (1u << 16) : static_cast<uint32_t>(e[k]);
                if (v <= slot) {
                    ++below;
                    lo = v;
                } else {
                    hi = min(hi, v);
                }
            }
            sym = static_cast<uint32_t>(16 * seg + below - 1);
            x2 = (hi - lo) * (x >> 16) + slot - lo;
            cnt = (x2 < RANS_L) + (x2 < HALF_L);
        }
        // the next step's segment ends do not depend on the state
        if (i + LANES < n) load_ends(rows + (i + LANES) * ROW, ends);
        int total;
        const int excl = block_scan(cnt, sums[s & 1], total);
        if (cnt) {
            const long long off = ptr + excl;
            x2 = (x2 << 8) | stream[min(off, limit)];
            if (cnt == 2) x2 = (x2 << 8) | stream[min(off + 1, limit)];
        }
        if (active) x = x2;
        out[i] = static_cast<uint8_t>(sym);
        ptr += total;
    }
    for (long long i = steps * LANES + lane; i < n_pad; i += LANES) out[i] = 0;
    states[lane] = x;
    if (lane == 0) *ptr_io = ptr;
}

// table (n_groups, 2) int64: each group's (cdf_low, freq) rows (n_pad, 2)
// int64 (a device pointer) and its symbol count n.  buf (cap,) gets the
// body in its last info[0] bytes; info[1 + lane] the lane's final state.
__global__ void __launch_bounds__(LANES) rans_encode(
    const long long* __restrict__ table, int n_groups, uint8_t* __restrict__ buf, long long cap,
    long long* __restrict__ info) {
    __shared__ int sums[2][WARPS + 1];
    const int lane = threadIdx.x;
    uint32_t x = RANS_L;
    long long end = cap;  // the steps after this one in decode order fill [end, cap)
    int parity = 0;
    for (int g = n_groups - 1; g >= 0; --g) {
        const longlong2* sf = reinterpret_cast<const longlong2*>(table[2 * g]);
        const long long n = table[2 * g + 1];
        long long s = (n + LANES - 1) / LANES - 1;
        // only a group's last step can be partial
        longlong2 v = make_longlong2(0, 1);
        if (s >= 0 && s * LANES + lane < n) v = __ldg(sf + s * LANES + lane);
        for (; s >= 0; --s) {
            const bool active = s * LANES + lane < n;
            int c = 0;
            uint32_t b0 = 0, b1 = 0;
            if (active) {
                const uint32_t start = static_cast<uint32_t>(v.x);
                const uint32_t freq = static_cast<uint32_t>(v.y);
                const uint32_t x_max = freq << 15;
                c = (x >= x_max) + ((x >> 8) >= x_max);
                const uint32_t e0 = x & 0xFFu, e1 = (x >> 8) & 0xFFu;
                // consume order is the reverse of push order
                b0 = c == 2 ? e1 : e0;
                b1 = e0;
                const uint32_t xr = x >> (8 * c);
                x = ((xr / freq) << 16) + xr % freq + start;
            }
            if (s > 0) v = __ldg(sf + (s - 1) * LANES + lane);
            int total;
            const int excl = block_scan(c, sums[parity], total);
            parity ^= 1;
            end -= total;
            if (c) buf[end + excl] = static_cast<uint8_t>(b0);
            if (c == 2) buf[end + excl + 1] = static_cast<uint8_t>(b1);
        }
    }
    if (lane == 0) info[0] = cap - end;
    info[1 + lane] = x;
}

}  // namespace

// rows, states, ptr, out: device pointers (see rans_decode_group); stream
// (stream_len,) uint8 with stream_len >= 1; reads clamp at its last byte.
extern "C" int scp_rans_decode_group(const void* rows, long long n, long long n_pad,
                                     const void* stream, long long stream_len, void* states,
                                     void* ptr, void* out, void* cuda_stream) {
    if (n < 0 || n > n_pad || n_pad % LANES || stream_len < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(cuda_stream);
    rans_decode_group<<<1, LANES, 0, s>>>(
        static_cast<const int32_t*>(rows), n, n_pad, static_cast<const uint8_t*>(stream),
        stream_len - 1, static_cast<long long*>(states), static_cast<long long*>(ptr),
        static_cast<uint8_t*>(out));
    return (int)cudaGetLastError();
}

// cap >= 2 * LANES * (the groups' steps), the most bytes the stream can take.
extern "C" int scp_rans_encode(const void* table, int n_groups, void* buf, long long cap,
                               void* info, void* cuda_stream) {
    if (n_groups < 0 || cap < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(cuda_stream);
    rans_encode<<<1, LANES, 0, s>>>(static_cast<const long long*>(table), n_groups,
                                    static_cast<uint8_t*>(buf), cap,
                                    static_cast<long long*>(info));
    return (int)cudaGetLastError();
}

extern "C" const char* scp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
