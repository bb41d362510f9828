// Hopper (sm_90a) kernels of the dropless MoE layer's data movement
// (models/layers/moe.py, apply_moe_dropless).  Plain C interface, loaded
// with ctypes by repro_torch/kernels/moe.py; every entry point launches on
// the stream it is given, allocates nothing and returns cudaGetLastError().
//
//   K12 moe_dispatch  a counting sort of the N*k assignments (token t's
//                     j-th expert is assignment a = t*k + j) by expert, in
//                     assignment order within each expert: each expert's
//                     row count, the cumulative ends of the experts' row
//                     ranges (the grouped products' offsets), the row of
//                     every assignment, and the assigned tokens' rows of x
//                     gathered into that order.
//   K13 moe_combine   y[t] = sum_j w[t, j] * out[pos[t, j]] in float32, in
//                     order j = 0 .. k-1 (each product and sum rounded,
//                     no fused multiply-add), then rounded to the rows'
//                     type.
//
// Neither replaces a TPU kernel: the JAX package dispatches by capacity
// (a scatter into E*cap slots, XLA's), which drops assignments past an
// expert's capacity and pads every expert to G*cap rows.  These two are
// the dropless layer's permutation, with no host synchronisation: the
// counts stay on the device and the grouped products read them there.
//
// Bound on an H100 by bytes (3.35 TB/s): at the mixtral-8x7b prefill cell
// (8192 tokens, d 4096, k 2, bf16) K12 reads x once (67 MB) and writes
// 16384 rows (134 MB), K13 reads them back (134 MB) and writes y (67 MB):
// 0.06 ms each.  K12: a block places 128 assignments.  It first counts, per
// expert, all assignments and those before its own (one pass over the
// expert ids, 8 bytes an assignment, from L2; warp-aggregated shared
// atomics on integers, so the counts do not depend on their order), ranks
// its own assignments within their experts, and then copies their rows,
// one warp a row in 16-byte pieces.  Every block makes the same counts,
// so no pass waits on another.  K13: one warp a token, 16 bytes a lane.
// No atomics touch a float: repeats are bit-identical, and the plain
// version (kernels/moe.py) gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dynamic_smem.cuh"

namespace {

constexpr int kDispatchThreads = 256;
constexpr int kChunk = 128;          // assignments a K12 block places
constexpr int kMaxExperts = 1024;
constexpr int kCombineThreads = 256;  // 8 tokens a K13 block
constexpr unsigned kFull = 0xffffffffu;

// Adds 1 to hist[e] for every lane whose e is not negative: one shared
// atomic for each distinct e in the warp.
__device__ __forceinline__ void warp_count(int* hist, int e, int lane) {
    const unsigned peers = __match_any_sync(kFull, e);
    if (e >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[e], __popc(peers));
}

// ids (A,) int64 expert of each assignment; x rows of row_vecs 16-byte
// pieces; xs (A, row); pos (A,) int32; counts, ends (E,) int32.
__global__ void __launch_bounds__(kDispatchThreads)
moe_dispatch_kernel(const int64_t* __restrict__ ids, int A, int E, int k,
                    const int4* __restrict__ x, int row_vecs,
                    int4* __restrict__ xs, int* __restrict__ pos,
                    int* __restrict__ counts, int* __restrict__ ends) {
    extern __shared__ int hist[];    // total[E], before[E], base[E]
    int* total = hist;
    int* before = hist + E;
    int* base = hist + 2 * E;
    __shared__ int s_e[kChunk];
    __shared__ int s_pos[kChunk];
    const int tid = threadIdx.x, lane = tid & 31;
    const int start = blockIdx.x * kChunk;
    const int n = min(kChunk, A - start);
    for (int i = tid; i < 2 * E; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int b = 0; b < A; b += blockDim.x) {
        const int a = b + tid;
        const int e = a < A ? static_cast<int>(ids[a]) : -1;
        warp_count(total, e, lane);
        warp_count(before, a < start ? e : -1, lane);
    }
    __syncthreads();
    if (tid == 0) {
        int run = 0;
        for (int e = 0; e < E; ++e) {
            base[e] = run;
            run += total[e];
        }
    }
    if (tid < n) s_e[tid] = static_cast<int>(ids[start + tid]);
    __syncthreads();
    if (blockIdx.x == 0) {
        for (int e = tid; e < E; e += blockDim.x) {
            counts[e] = total[e];
            ends[e] = base[e] + total[e];
        }
    }
    if (tid < n) {
        const int e = s_e[tid];
        int rank = 0;
        for (int j = 0; j < tid; ++j) rank += s_e[j] == e;
        const int p = base[e] + before[e] + rank;
        s_pos[tid] = p;
        pos[start + tid] = p;
    }
    __syncthreads();
    const int warp = tid >> 5, warps = blockDim.x >> 5;
    for (int r = warp; r < n; r += warps) {
        const int4* src = x + static_cast<size_t>((start + r) / k) * row_vecs;
        int4* dst = xs + static_cast<size_t>(s_pos[r]) * row_vecs;
        int v = lane;
        for (; v + 96 < row_vecs; v += 128) {
            const int4 a0 = src[v], a1 = src[v + 32], a2 = src[v + 64],
                       a3 = src[v + 96];
            dst[v] = a0;
            dst[v + 32] = a1;
            dst[v + 64] = a2;
            dst[v + 96] = a3;
        }
        for (; v < row_vecs; v += 32) dst[v] = src[v];
    }
}

template <typename T> struct Vec;

template <> struct Vec<float> {
    static constexpr int kN = 4;
    __device__ static void load(const float* p, float* f) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    }
    __device__ static void store(float* p, const float* f) {
        *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    }
};

template <> struct Vec<__nv_bfloat16> {
    static constexpr int kN = 8;
    __device__ static void load(const __nv_bfloat16* p, float* f) {
        const int4 v = *reinterpret_cast<const int4*>(p);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int i = 0; i < kN; ++i) f[i] = __bfloat162float(h[i]);
    }
    __device__ static void store(__nv_bfloat16* p, const float* f) {
        int4 v;
        __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int i = 0; i < kN; ++i) h[i] = __float2bfloat16_rn(f[i]);
        *reinterpret_cast<int4*>(p) = v;
    }
};

// out (A, d), pos (N*k,) int32, w (N*k,) float32, y (N, d); d a multiple
// of Vec<T>::kN.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
moe_combine_kernel(const T* __restrict__ out, const int* __restrict__ pos,
                   const float* __restrict__ w, int N, int k, int d,
                   T* __restrict__ y) {
    constexpr int V = Vec<T>::kN;
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * (kCombineThreads / 32) + (threadIdx.x >> 5);
    if (t >= N) return;
    const int* pt = pos + static_cast<size_t>(t) * k;
    const float* wt = w + static_cast<size_t>(t) * k;
    T* yt = y + static_cast<size_t>(t) * d;
    for (int c = lane * V; c < d; c += 32 * V) {
        float acc[V], o[V];
        Vec<T>::load(out + static_cast<size_t>(pt[0]) * d + c, o);
        const float w0 = wt[0];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = __fmul_rn(w0, o[i]);
        for (int j = 1; j < k; ++j) {
            Vec<T>::load(out + static_cast<size_t>(pt[j]) * d + c, o);
            const float wj = wt[j];
#pragma unroll
            for (int i = 0; i < V; ++i)
                acc[i] = __fadd_rn(acc[i], __fmul_rn(wj, o[i]));
        }
        Vec<T>::store(yt + c, acc);
    }
}

}  // namespace

extern "C" {

// ids (A,) int64 in [0, E); x (A / k, row_bytes / 16 pieces) rows;
// xs (A, row) rows in expert order; pos (A,), counts (E,), ends (E,) int32.
int moe_dispatch(const void* ids, int A, int E, int k, const void* x,
                 int row_bytes, void* xs, void* pos, void* counts,
                 void* ends, void* stream) {
    if (A <= 0 || E <= 0 || E > kMaxExperts || k <= 0 || A % k != 0 ||
        row_bytes % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (A + kChunk - 1) / kChunk;
    moe_dispatch_kernel<<<blocks, kDispatchThreads,
                          3 * E * static_cast<int>(sizeof(int)),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(ids), A, E, k,
        static_cast<const int4*>(x), row_bytes / 16, static_cast<int4*>(xs),
        static_cast<int*>(pos), static_cast<int*>(counts),
        static_cast<int*>(ends));
    return static_cast<int>(cudaGetLastError());
}

// out (N * k, d) and y (N, d) of dtype 0 float32 or 1 bfloat16; pos
// (N * k,) int32; w (N * k,) float32.
int moe_combine(const void* out, const void* pos, const void* w, int N,
                int k, int d, int dtype, void* y, void* stream) {
    const int vec = dtype == 0 ? 4 : 8;
    if (N <= 0 || k <= 0 || d <= 0 || d % vec != 0 || dtype < 0 || dtype > 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int per = kCombineThreads / 32;
    const int blocks = (N + per - 1) / per;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        moe_combine_kernel<float><<<blocks, kCombineThreads, 0, s>>>(
            static_cast<const float*>(out), static_cast<const int*>(pos),
            static_cast<const float*>(w), N, k, d, static_cast<float*>(y));
    else
        moe_combine_kernel<__nv_bfloat16><<<blocks, kCombineThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(out),
            static_cast<const int*>(pos), static_cast<const float*>(w), N, k,
            d, static_cast<__nv_bfloat16*>(y));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

namespace {

// The kernels moe_occupancy answers for, by index: the order of
// moe.OCCUPANCY_KERNELS.
const OccupancyQuery kOccupancy[] = {
    occupancy<moe_dispatch_kernel>,
    occupancy<moe_combine_kernel<float>>,
    occupancy<moe_combine_kernel<__nv_bfloat16>>,
};

}  // namespace

extern "C" {

// Blocks an SM holds at once of entry `kernel` of kOccupancy, launched
// with `threads` threads and `smem` bytes of dynamic shared memory, and
// the kernel's registers a thread and static shared memory, as the
// runtime reads them.
int moe_occupancy(int kernel, int threads, int smem, int* blocks,
                  int* registers, int* static_smem) {
    return occupancy_of(kOccupancy, kernel, threads, smem, blocks, registers,
                        static_smem);
}

}  // extern "C"
