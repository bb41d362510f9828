// Hopper (sm_90a) kernel K14: RMSNorm of the serving prefill
// (models/transformer.py: norm1, norm2 and the final norm of
// ``prefill``).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/norm.py; the entry point launches on the stream it
// is given, allocates nothing and returns cudaGetLastError().
//
//   K14 rms_norm   y[r] = (x[r] * rsqrt(mean(x[r]^2) + eps)) * scale, each
//                  row upcast to float32, the mean the float32 sum of
//                  squares times the float32 1/d (as torch.mean's
//                  reduction on the card multiplies by its factor),
//                  rsqrtf, then the two products rounded in float32 in that
//                  order and one rounding to the row's type: the float32
//                  composite of models/layers/common.apply_norm, whose
//                  order of the sum of squares alone is the kernel's own.
//
// It replaces no TPU kernel: the JAX package leaves its norms to XLA.  The
// composite ran about eight kernels a norm (upcast, square, mean, add,
// rsqrt, two products, downcast), each reading and writing the whole
// activation in float32: ~40 bytes an element.
//
// Bound on an H100 by bytes (3.35 TB/s; ~1 operation a byte against the
// card's ~295): one pass reads the row once and writes it once, 4 bytes
// an element in bf16 (qwen2-1.5b's prefill, 8192 rows of 1536: 50 MB,
// 0.015 ms).  So a row is read once, in 16-byte pieces (neighbouring lanes
// on neighbouring pieces), and kept in registers as it came (packed bf16 or
// float32), at most kValues values a thread: one warp a row up to d 1024,
// two, four or eight warps up to 2048, 4096 or 8192, 256 threads a block
// and 8 / warps rows a block.  (Eight bf16 pieces a thread took ~90
// registers, two blocks an SM, and ran 2-8 % slower at the prefill
// cells' shapes on an H100 than four.)  Every piece's load is issued
// before the first is used.  Each thread sums its pieces' squares (a
// fixed tree in a piece, then the pieces in order), the warp by xor
// shuffles (the same bits in every lane), and the row's warps in order
// from shared memory; then each thread scales its pieces and writes them
// once.  scale (at most 32 KB) is read through the read-only cache and
// stays in L1/L2 across rows.  No atomics: repeats are bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dynamic_smem.cuh"

namespace {

constexpr int kThreads = 256;    // 8 warps a block
constexpr int kValues = 32;      // values a thread holds at most
constexpr int kMaxWarps = 8;     // warps a row at most (the whole block)
constexpr int kMaxD = 8192;      // values a row at most
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Piece;

template <> struct Piece<float> {
    static constexpr int kN = 4;
    __device__ static void unpack(const int4& v, float* f) {
        f[0] = __int_as_float(v.x);
        f[1] = __int_as_float(v.y);
        f[2] = __int_as_float(v.z);
        f[3] = __int_as_float(v.w);
    }
    __device__ static int4 pack(const float* f) {
        return make_int4(__float_as_int(f[0]), __float_as_int(f[1]),
                         __float_as_int(f[2]), __float_as_int(f[3]));
    }
};

template <> struct Piece<__nv_bfloat16> {
    static constexpr int kN = 8;
    __device__ static void unpack(const int4& v, float* f) {
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int i = 0; i < kN; ++i) f[i] = __bfloat162float(h[i]);
    }
    __device__ static int4 pack(const float* f) {
        int4 v;
        __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int i = 0; i < kN; ++i) h[i] = __float2bfloat16_rn(f[i]);
        return v;
    }
};

// The squares of a piece's values summed as a fixed tree: halves added
// pairwise, each square and sum rounded (no fused multiply-add).
template <int N>
__device__ __forceinline__ float piece_sumsq(const float* f) {
    float t[N];
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = __fmul_rn(f[i], f[i]);
#pragma unroll
    for (int w = N / 2; w >= 1; w /= 2) {
#pragma unroll
        for (int i = 0; i < w; ++i) t[i] = __fadd_rn(t[i], t[i + w]);
    }
    return t[0];
}

// x, y (rows, row_vecs) 16-byte pieces; scale (row_vecs * kN,) float32.
// kWarps warps a row, kThreads / 32 / kWarps rows a block.
template <typename T, int kWarps>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const int4* __restrict__ x, const float* __restrict__ scale,
                int rows, int row_vecs, float inv_d, float eps,
                int4* __restrict__ y) {
    constexpr int kN = Piece<T>::kN;
    constexpr int kVecs = kValues / kN;   // 16-byte pieces a thread
    constexpr int kRows = kThreads / 32 / kWarps;
    constexpr int kStride = kWarps * 32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int slot = warp / kWarps, rw = warp % kWarps;
    const int t = rw * 32 + lane;
    const int row = blockIdx.x * kRows + slot;
    const bool live = row < rows;
    const size_t base = static_cast<size_t>(live ? row : 0) * row_vecs;
    int4 v[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
        const int c = t + i * kStride;
        if (live && c < row_vecs) v[i] = x[base + c];
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
        const int c = t + i * kStride;
        if (live && c < row_vecs) {
            float f[kN];
            Piece<T>::unpack(v[i], f);
            s = __fadd_rn(s, piece_sumsq<kN>(f));
        }
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(kFull, s, m));
    if constexpr (kWarps > 1) {
        __shared__ float part[kRows * kWarps];   // the row's warps' sums
        if (lane == 0) part[slot * kWarps + rw] = s;
        __syncthreads();
        s = part[slot * kWarps];
#pragma unroll
        for (int w = 1; w < kWarps; ++w)
            s = __fadd_rn(s, part[slot * kWarps + w]);
    }
    if (!live) return;
    const float r = rsqrtf(__fadd_rn(__fmul_rn(s, inv_d), eps));
    const float4* sc = reinterpret_cast<const float4*>(scale);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
        const int c = t + i * kStride;
        if (c < row_vecs) {
            float f[kN], g[kN];
            Piece<T>::unpack(v[i], f);
#pragma unroll
            for (int q = 0; q < kN / 4; ++q) {
                const float4 s4 = __ldg(sc + c * (kN / 4) + q);
                g[4 * q] = s4.x;
                g[4 * q + 1] = s4.y;
                g[4 * q + 2] = s4.z;
                g[4 * q + 3] = s4.w;
            }
#pragma unroll
            for (int j = 0; j < kN; ++j)
                f[j] = __fmul_rn(__fmul_rn(f[j], r), g[j]);
            y[base + c] = Piece<T>::pack(f);
        }
    }
}

// Warps a row: the fewest of 1, 2, 4, 8 whose threads hold the row's d
// values, kValues each (a row of kMaxD takes 8).
int plan_warps(int d) {
    for (int w = 1; w <= kMaxWarps; w *= 2)
        if (d <= w * 32 * kValues) return w;
    return 0;
}

template <typename T, int kWarps>
void launch(const void* x, const void* scale, int rows, int row_vecs,
            float inv_d, float eps, void* y, cudaStream_t s) {
    constexpr int kRows = kThreads / 32 / kWarps;
    const int blocks = (rows + kRows - 1) / kRows;
    rms_norm_kernel<T, kWarps><<<blocks, kThreads, 0, s>>>(
        static_cast<const int4*>(x), static_cast<const float*>(scale), rows,
        row_vecs, inv_d, eps, static_cast<int4*>(y));
}

template <typename T>
void launch_warps(int warps, const void* x, const void* scale, int rows,
                  int row_vecs, float inv_d, float eps, void* y,
                  cudaStream_t s) {
    switch (warps) {
        case 1: return launch<T, 1>(x, scale, rows, row_vecs, inv_d, eps, y, s);
        case 2: return launch<T, 2>(x, scale, rows, row_vecs, inv_d, eps, y, s);
        case 4: return launch<T, 4>(x, scale, rows, row_vecs, inv_d, eps, y, s);
        default: return launch<T, 8>(x, scale, rows, row_vecs, inv_d, eps, y,
                                     s);
    }
}

}  // namespace

extern "C" {

// The launch of rows (rows, d) of dtype 0 float32 or 1 bfloat16: the warps
// a row and the blocks of the grid.
int rms_norm_plan(int rows, int d, int dtype, int* warps, int* blocks) {
    const int es = dtype == 0 ? 4 : 2;
    if (rows < 0 || d <= 0 || d > kMaxD || dtype < 0 || dtype > 1 ||
        (d * es) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int w = plan_warps(d);
    if (w == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int per = kThreads / 32 / w;
    *warps = w;
    *blocks = (rows + per - 1) / per;
    return 0;
}

// x and y (rows, d) of dtype 0 float32 or 1 bfloat16, rows of a multiple
// of 16 bytes from 16-byte boundaries; scale (d,) float32.
int rms_norm(const void* x, const void* scale, int rows, int d, int dtype,
             float eps, void* y, void* stream) {
    int warps = 0, blocks = 0;
    const int rc = rms_norm_plan(rows, d, dtype, &warps, &blocks);
    if (rc != 0) return rc;
    if (rows == 0) return 0;
    const int row_vecs = d * (dtype == 0 ? 4 : 2) / 16;
    const float inv_d = 1.0f / static_cast<float>(d);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        launch_warps<float>(warps, x, scale, rows, row_vecs, inv_d, eps, y, s);
    else
        launch_warps<__nv_bfloat16>(warps, x, scale, rows, row_vecs, inv_d,
                                    eps, y, s);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

namespace {

// The kernels norm_occupancy answers for, by index: the order of
// norm.OCCUPANCY_KERNELS.
const OccupancyQuery kOccupancy[] = {
    occupancy<rms_norm_kernel<float, 1>>,
    occupancy<rms_norm_kernel<float, 2>>,
    occupancy<rms_norm_kernel<float, 4>>,
    occupancy<rms_norm_kernel<float, 8>>,
    occupancy<rms_norm_kernel<__nv_bfloat16, 1>>,
    occupancy<rms_norm_kernel<__nv_bfloat16, 2>>,
    occupancy<rms_norm_kernel<__nv_bfloat16, 4>>,
    occupancy<rms_norm_kernel<__nv_bfloat16, 8>>,
};

}  // namespace

extern "C" {

// Blocks an SM holds at once of entry `kernel` of kOccupancy, launched
// with `threads` threads and `smem` bytes of dynamic shared memory, and
// the kernel's registers a thread and static shared memory, as the
// runtime reads them.
int norm_occupancy(int kernel, int threads, int smem, int* blocks,
                   int* registers, int* static_smem) {
    return occupancy_of(kOccupancy, kernel, threads, smem, blocks, registers,
                        static_smem);
}

}  // extern "C"
