// Hopper (sm_90a) kernel K11: grouped-query attention forward with an
// online softmax (flash attention).  Plain C interface, loaded with ctypes
// by repro_torch/kernels/flash_attention.py; the entry point launches on
// the stream it is given, allocates nothing and returns cudaGetLastError().
//
// Shapes, in the reference's layout, row-major and contiguous:
//   q (B, Tq, H, hd), already scaled by hd^-0.5 in q's dtype by the wrapper;
//   k, v (B, Tk, KV, hd); o (B, Tq, H, hd).
// Query row t sits at absolute position Tk - Tq + t, key j at j.  Query
// head h reads KV head h / (H / KV), the reference's head order, so the
// kernel never materialises the repeat of k and v that the Pallas wrapper
// builds.  T is float or __nv_bfloat16; hd is 16, 32, 64, 112 or 128.
//
// Two routes, chosen by flash_attention_fwd from dtype and hd: bfloat16
// with hd 64, 112 or 128 runs the tensor-core kernel of
// flash_attention_wgmma.cuh (wgmma tiles fed by TMA, softmax in
// registers, 128-key tiles; hd 112, kimi-k2's 7168 / 64, in the tile of
// hd 128 with its columns 112-127 zero-filled by the TMA); float32 (held
// to atol 3e-5, so no TF32) and bfloat16 with hd 16 or 32 run the FMA
// kernel below (64-key tiles).
//
// K11 replaces repro/kernels/flash_attention.py:flash_attention_fwd_pallas
// (_flash_fwd_kernel), with its GQA wrapper flash_attention_gqa_pallas.
// Its arithmetic is the reference's: s = q.k summed in float32, masked to
// -1e30, m_new = max(m, rowmax s), p = exp(s - m_new), alpha = exp(m -
// m_new), l = l*alpha + sum p, acc = acc*alpha + round_T(p).v (p rounded to
// v's dtype before P.V), o = acc / max(l, 1e-30) cast to T.
//
// The TPU grid (BH, Tq/bq, Tk/bk) runs in order and keeps acc, m and l in
// VMEM scratch across the innermost kv axis.  CUDA blocks run in no order,
// so here one block owns one (batch*head, 64-row query block) and loops
// over the key tiles itself: no atomics and no merge pass, so two launches
// on the same inputs give bit-identical results.  Blocks with the most
// causal work are launched first.
//
// Causal skip, exact: the reference visits every kv tile, also those
// wholly above the diagonal.  On such a tile s = -1e30 everywhere, so p =
// exp(-1e30 - m) = 0 and alpha = 1, and the tile changes no bit of acc,
// m or l.  So the loop stops at the last tile that holds a key at or
// before the block's last query position.  Every row sees key 0 in the
// first tile, so no row ends with l = 0.  Keys past Tk (the ragged last
// tile) are masked by bounds, with or without causality.
//
// Bound on an H100 at the serve path's shape (B 4, T 2048, H 12, KV 2,
// hd 128, causal, bf16): 2*B*H*T^2*hd = 5.15e10 flops (0.052 ms at the
// 989 TFLOP/s bf16 tensor-core peak) against 58.7 MB of q, k, v and o
// (0.018 ms): bound by operations.  The FMA kernel is a plain float32
// loop (no tensor cores, no TMA): thread (ty, tx) of a 16 x 16 block
// owns rows ty + 16r (r < 4) of both the 64 x 64 score tile and the
// 64 x hd output tile, so the online-softmax rescale needs no exchange;
// row max and row sum are reduced across the 16 lanes that share a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dynamic_smem.cuh"
#include "flash_attention_wgmma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPStride = kBK + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// Row stride of the q, k and v tiles in shared memory, in elements: one
// 32-bit word of padding, so the 16 rows a half-warp reads at one feature
// fall in 16 different banks.
template <typename T, int HD>
__host__ __device__ constexpr int tile_stride() {
    return HD + 4 / static_cast<int>(sizeof(T));
}

template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes() {
    return static_cast<size_t>(kBQ + 2 * kBK) * tile_stride<T, HD>() *
               sizeof(T) +
           static_cast<size_t>(kBQ) * kPStride * sizeof(float);
}

// Copy rows [t0, t0 + kRowsTile) of one head of a (B, T, heads, HD) tensor
// into a shared tile; rows at or past T are zero.
template <typename T, int HD, int kRowsTile>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int64_t row_stride, int t0, int T_) {
    constexpr int S = tile_stride<T, HD>();
    for (int e = threadIdx.x; e < kRowsTile * HD; e += kThreads) {
        const int r = e / HD, d = e % HD, t = t0 + r;
        dst[r * S + d] = t < T_ ? src[t * row_stride + d] : from_f<T>(0.f);
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Tq, int Tk,
                 int H, int KV, int causal) {
    constexpr int S = tile_stride<T, HD>();
    constexpr int NC = HD / 16;  // output columns per thread
    extern __shared__ __align__(16) unsigned char smem[];
    T* Qs = reinterpret_cast<T*>(smem);
    T* Ks = Qs + kBQ * S;
    T* Vs = Ks + kBK * S;
    float* Ps = reinterpret_cast<float*>(Vs + kBK * S);

    const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int kvh = h / (H / KV);
    const int q_offset = Tk - Tq;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int64_t q_row = static_cast<int64_t>(H) * HD;
    const int64_t kv_row = static_cast<int64_t>(KV) * HD;
    const int64_t q_base = (static_cast<int64_t>(b) * Tq * H + h) * HD;
    const int64_t kv_base = (static_cast<int64_t>(b) * Tk * KV + kvh) * HD;

    load_tile<T, HD, kBQ>(Qs, q + q_base, q_row, q0, Tq);

    float m[4], l[4], acc[4][NC];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        m[r] = kNegInf;
        l[r] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
    }

    // Keys past the block's last query position are masked whole (causal
    // skip, exact: see the header).
    const int kv_end =
        causal ? min(Tk, q_offset + min(q0 + kBQ, Tq)) : Tk;
    for (int j0 = 0; j0 < kv_end; j0 += kBK) {
        __syncthreads();  // the previous tile's reads of Ks, Vs, Ps are done
        load_tile<T, HD, kBK>(Ks, k + kv_base, kv_row, j0, Tk);
        load_tile<T, HD, kBK>(Vs, v + kv_base, kv_row, j0, Tk);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) qv[r] = to_f(Qs[(ty + 16 * r) * S + d]);
#pragma unroll
            for (int c = 0; c < 4; ++c) kv[c] = to_f(Ks[(tx + 16 * c) * S + d]);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        }

        float alpha[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int qpos = q_offset + q0 + ty + 16 * r;
            float mx = kNegInf;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = j0 + tx + 16 * c;
                if (j >= Tk || (causal && j > qpos)) s[r][c] = kNegInf;
                mx = fmaxf(mx, s[r][c]);
            }
            // The 16 lanes of a half-warp share row ty + 16r.
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[r], mx);
            alpha[r] = expf(m[r] - m_new);
            float rs = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float p = expf(s[r][c] - m_new);
                rs += p;
                Ps[(ty + 16 * r) * kPStride + tx + 16 * c] =
                    to_f(from_f<T>(p));  // p in v's dtype for P.V
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[r] = l[r] * alpha[r] + rs;
            m[r] = m_new;
        }
        __syncthreads();

        float pv[4][NC];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < NC; ++c) pv[r][c] = 0.f;
        // Keys past Tk have p = 0 and zero rows in Vs.
#pragma unroll 4
        for (int j = 0; j < kBK; ++j) {
            float pr[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) pr[r] = Ps[(ty + 16 * r) * kPStride + j];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float vv = to_f(Vs[j * S + tx + 16 * c]);
#pragma unroll
                for (int r = 0; r < 4; ++r) pv[r][c] = fmaf(pr[r], vv, pv[r][c]);
            }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < NC; ++c)
                acc[r][c] = acc[r][c] * alpha[r] + pv[r][c];
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int t = q0 + ty + 16 * r;
        if (t >= Tq) continue;
        const float denom = fmaxf(l[r], 1e-30f);
        T* out = o + q_base + t * q_row;
#pragma unroll
        for (int c = 0; c < NC; ++c)
            out[tx + 16 * c] = from_f<T>(acc[r][c] / denom);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int Tk, int H, int KV, int causal, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<T, HD>();
    auto kernel = flash_fwd_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), Tq, Tk, H, KV, causal);
    return static_cast<int>(cudaGetLastError());
}

// The FMA route: float32 at every hd, bfloat16 at hd 16 and 32.
template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int Tq, int Tk, int H, int KV, int hd, int causal,
                cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, o, B, Tq, Tk, H, KV, causal, stream);
        case 32: return launch<T, 32>(q, k, v, o, B, Tq, Tk, H, KV, causal, stream);
    }
    if constexpr (sizeof(T) == 4) {
        switch (hd) {
            case 64: return launch<T, 64>(q, k, v, o, B, Tq, Tk, H, KV, causal, stream);
            case 112: return launch<T, 112>(q, k, v, o, B, Tq, Tk, H, KV, causal, stream);
            case 128: return launch<T, 128>(q, k, v, o, B, Tq, Tk, H, KV, causal, stream);
        }
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it).  bfloat16 with hd
// 64, 112 or 128 takes the tensor-core route (flash_attention_wgmma.cuh),
// whose pointers must be 16-byte aligned; everything else the FMA kernel.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Tq, int Tk, int H, int KV, int hd,
                        int causal, int dtype, void* stream) {
    if (B < 1 || Tq < 1 || Tk < 1 || KV < 1 || H % KV != 0 ||
        (causal && Tq > Tk))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 1 && hd == 64)
        return k11_wgmma::launch<64>(q, k, v, o, B, Tq, Tk, H, KV, causal, s);
    if (dtype == 1 && hd == 112)
        return k11_wgmma::launch<112>(q, k, v, o, B, Tq, Tk, H, KV, causal, s);
    if (dtype == 1 && hd == 128)
        return k11_wgmma::launch<128>(q, k, v, o, B, Tq, Tk, H, KV, causal, s);
    if (B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0)
        return dispatch_hd<float>(q, k, v, o, B, Tq, Tk, H, KV, hd, causal, s);
    if (dtype == 1)
        return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, Tq, Tk, H, KV, hd,
                                          causal, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory (bytes) of one block of the launch that
// flash_attention_fwd makes for head dim hd and dtype; -1 for a pair it
// refuses.
int flash_attention_smem(int hd, int dtype) {
    if (dtype == 1 && hd == 64)
        return static_cast<int>(k11_wgmma::smem_bytes<64>());
    if (dtype == 1 && hd == 112)
        return static_cast<int>(k11_wgmma::smem_bytes<112>());
    if (dtype == 1 && hd == 128)
        return static_cast<int>(k11_wgmma::smem_bytes<128>());
    switch (hd) {
        case 16: return static_cast<int>(dtype ? smem_bytes<__nv_bfloat16, 16>()
                                               : smem_bytes<float, 16>());
        case 32: return static_cast<int>(dtype ? smem_bytes<__nv_bfloat16, 32>()
                                               : smem_bytes<float, 32>());
        case 112: return dtype ? -1 : static_cast<int>(smem_bytes<float, 112>());
        case 64: return dtype ? -1 : static_cast<int>(smem_bytes<float, 64>());
        case 128: return dtype ? -1 : static_cast<int>(smem_bytes<float, 128>());
    }
    return -1;
}

}  // extern "C"

namespace {

// The kernels flash_attention_occupancy answers for, by index: the order of
// flash_attention.OCCUPANCY_KERNELS.
const OccupancyQuery kOccupancy[] = {
    occupancy<flash_fwd_kernel<float, 16>>,
    occupancy<flash_fwd_kernel<float, 32>>,
    occupancy<k11_wgmma::flash_fwd_wgmma_kernel<64>>,
    occupancy<k11_wgmma::flash_fwd_wgmma_kernel<112>>,
    occupancy<k11_wgmma::flash_fwd_wgmma_kernel<128>>,
};

}  // namespace

extern "C" {

// Blocks an SM holds at once of entry `kernel` of kOccupancy, launched
// with `threads` threads and `smem` bytes of dynamic shared memory, and
// the kernel's registers a thread and static shared memory, as the
// runtime reads them.
int flash_attention_occupancy(int kernel, int threads, int smem, int* blocks,
                              int* registers, int* static_smem) {
    return occupancy_of(kOccupancy, kernel, threads, smem, blocks, registers,
                        static_smem);
}

}  // extern "C"
