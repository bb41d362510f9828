// Hopper (sm_90a) kernels for the Eq.-3/4 graph regularizer and its
// analytic backward pass.  Plain C interface, loaded with ctypes by
// repro_torch/kernels/graph_reg.py; every entry point launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
//
// Shapes: k workers (grid z), each with p = exp(logp) and logp (B, C) and
// an affinity block W (B, B), all float32, row-major and contiguous, worker
// stride B*C resp. B*B.  Scalars: gc (cross-term weight), kappa (uniform
// entropy weight), ge (degree-entropy weight); the backward cotangent g is
// a (k,) device array read by pointer.
//
//   K1 graph_reg_fwd      out_z = -gc*sum_ij W_ij (P logP^T)_ij
//                                 - sum_i (kappa + ge*deg_i) H(p_i)
//   K2 graph_reg_bwd_dlogp dlogp = g*[-gc*(P.*(W logP) + W^T P)
//                                     + (kappa + ge*deg) .* P .* (logP + 1)]
//   K3 graph_reg_bwd_dw    dW    = -g*(gc*P logP^T + ge*H(p) 1^T)
//
// Padding is done with masks, never with values: rows, columns and classes
// outside (B, B, C) are loaded as 0 for p, logp and W alike, so they drop
// out of every product (exp() of a padded logp is never taken).
//
// No float atomics: every output element and every partial sum has exactly
// one writer, and every reduction runs in a fixed order, so two launches on
// the same inputs give bit-identical results.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps: ty = warp (0..7), tx = lane
constexpr int kRows = 32;       // row strip of K1/K3 (and K2)
constexpr int kCols = 64;       // column tile of the S = P logP^T tile
constexpr int kChunk = 16;      // class chunk of the S contraction

__device__ __forceinline__ float warp_sum(float v) {
    // Fixed butterfly order: deterministic, every lane ends with the sum.
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// acc[r][c] += sum_k P[i0+ty+8r, k] * logP[j0+tx+32c, k] over all classes.
// Thread (ty, tx) owns rows ty+8r (r<4) and columns tx+32c (c<2) of the
// 32 x 64 tile; a warp reads 32 consecutive columns (conflict-free) and one
// broadcast row from shared memory.
__device__ __forceinline__ void s_tile(
        const float* __restrict__ P, const float* __restrict__ L,
        int B, int C, int i0, int j0,
        float (*Ps)[kRows + 1], float (*Ls)[kCols + 1], float acc[4][2]) {
    const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
    for (int c0 = 0; c0 < C; c0 += kChunk) {
        for (int e = tid; e < kRows * kChunk; e += kThreads) {
            const int i = e / kChunk, k = e % kChunk;
            const bool ok = (i0 + i < B) && (c0 + k < C);
            Ps[k][i] = ok ? P[(int64_t)(i0 + i) * C + c0 + k] : 0.f;
        }
        for (int e = tid; e < kCols * kChunk; e += kThreads) {
            const int j = e / kChunk, k = e % kChunk;
            const bool ok = (j0 + j < B) && (c0 + k < C);
            Ls[k][j] = ok ? L[(int64_t)(j0 + j) * C + c0 + k] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            float a[4], b[2];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = Ps[k][ty + 8 * r];
#pragma unroll
            for (int c = 0; c < 2; ++c) b[c] = Ls[k][tx + 32 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 2; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
        }
        __syncthreads();
    }
}

// H(p_i) = -sum_c p_ic logp_ic for row i, summed by one warp (lane-strided
// classes, butterfly reduction); every lane returns the value.
__device__ __forceinline__ float row_entropy(const float* __restrict__ P,
                                             const float* __restrict__ L,
                                             int C, int i) {
    float h = 0.f;
    for (int c = threadIdx.x & 31; c < C; c += 32)
        h = fmaf(P[(int64_t)i * C + c], L[(int64_t)i * C + c], h);
    return -warp_sum(h);
}

// Fixed-order tree sum of one value per thread; thread 0 gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
    red[threadIdx.x] = v;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
        __syncthreads();
    }
    return red[0];
}

// K1, pass 1: one block per (row strip, worker).  The block loops over all
// column tiles and the class dimension itself, so it holds complete row
// degrees and writes one partial that already includes its strip's
// (kappa + ge*deg_i) H_i term.
__global__ void __launch_bounds__(kThreads)
reg_fwd_partials(const float* __restrict__ P, const float* __restrict__ L,
                 const float* __restrict__ W, int B, int C, float gc,
                 float kappa, float ge, float* __restrict__ partials) {
    __shared__ float Ps[kChunk][kRows + 1];
    __shared__ float Ls[kChunk][kCols + 1];
    __shared__ float red[kThreads];
    const int z = blockIdx.z, i0 = blockIdx.x * kRows;
    const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
    P += (int64_t)z * B * C;
    L += (int64_t)z * B * C;
    W += (int64_t)z * B * B;

    float cross = 0.f, deg[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j0 = 0; j0 < B; j0 += kCols) {
        float acc[4][2] = {};
        s_tile(P, L, B, C, i0, j0, Ps, Ls, acc);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty + 8 * r;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int j = j0 + tx + 32 * c;
                if (i < B && j < B) {
                    const float w = W[(int64_t)i * B + j];   // coalesced row
                    cross = fmaf(w, acc[r][c], cross);
                    deg[r] += w;
                }
            }
        }
    }
    // Row r of this warp: complete degree by warp sum, entropy by warp sum.
    float ent = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 8 * r;
        const float d = warp_sum(deg[r]);
        if (i < B) {
            const float h = row_entropy(P, L, C, i);
            if (tx == 0) ent += (kappa + ge * d) * h;
        }
    }
    const float total = block_sum(-gc * cross - ent, red);
    if (tid == 0) partials[(int64_t)z * gridDim.x + blockIdx.x] = total;
}

// K1, pass 2: out_z = sum of worker z's partials, in strip order.
__global__ void reg_fwd_sum(const float* __restrict__ partials, int n_strips,
                            int k, float* __restrict__ out) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    if (z >= k) return;
    float s = 0.f;
    for (int t = 0; t < n_strips; ++t) s += partials[(int64_t)z * n_strips + t];
    out[z] = s;
}

// K2: one block per (row strip of 32, worker).  Loops over 64-wide class
// chunks and 32-wide j tiles; reads W[i, j] (W logP and the degrees) and
// W[j, i] as a coalesced tile transposed in shared memory (W^T P).
constexpr int kBwdRows = 32, kBwdCols = 32, kClassW = 64;

__global__ void __launch_bounds__(kThreads)
reg_bwd_dlogp(const float* __restrict__ P, const float* __restrict__ L,
              const float* __restrict__ W, const float* __restrict__ g,
              int B, int C, float gc, float kappa, float ge,
              float* __restrict__ dlogp) {
    __shared__ float Ws[kBwdRows][kBwdCols + 1];    // W[i, j]
    __shared__ float WTs[kBwdCols][kBwdRows + 1];   // W[j, i], j-major
    __shared__ float Lj[kBwdCols][kClassW + 1];
    __shared__ float Pj[kBwdCols][kClassW + 1];
    __shared__ float deg_s[kBwdRows];
    const int z = blockIdx.z, i0 = blockIdx.x * kBwdRows;
    const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
    P += (int64_t)z * B * C;
    L += (int64_t)z * B * C;
    W += (int64_t)z * B * B;
    dlogp += (int64_t)z * B * C;
    const float gz = g[z];

    for (int c0 = 0; c0 < C; c0 += kClassW) {
        float A[4][2] = {}, Bt[4][2] = {};
        float degacc = 0.f;
        for (int j0 = 0; j0 < B; j0 += kBwdCols) {
            for (int e = tid; e < kBwdRows * kBwdCols; e += kThreads) {
                const int ii = e / kBwdCols, jj = e % kBwdCols;
                const bool ok = (i0 + ii < B) && (j0 + jj < B);
                Ws[ii][jj] = ok ? W[(int64_t)(i0 + ii) * B + j0 + jj] : 0.f;
            }
            for (int e = tid; e < kBwdCols * kBwdRows; e += kThreads) {
                const int jj = e / kBwdRows, ii = e % kBwdRows;
                const bool ok = (i0 + ii < B) && (j0 + jj < B);
                WTs[jj][ii] = ok ? W[(int64_t)(j0 + jj) * B + i0 + ii] : 0.f;
            }
            for (int e = tid; e < kBwdCols * kClassW; e += kThreads) {
                const int jj = e / kClassW, cc = e % kClassW;
                const bool ok = (j0 + jj < B) && (c0 + cc < C);
                const int64_t at = (int64_t)(j0 + jj) * C + c0 + cc;
                Lj[jj][cc] = ok ? L[at] : 0.f;
                Pj[jj][cc] = ok ? P[at] : 0.f;
            }
            __syncthreads();
            if (tid < kBwdRows)
                for (int jj = 0; jj < kBwdCols; ++jj) degacc += Ws[tid][jj];
#pragma unroll 8
            for (int jj = 0; jj < kBwdCols; ++jj) {
                float w[4], wt[4], l[2], pv[2];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    w[r] = Ws[ty + 8 * r][jj];
                    wt[r] = WTs[jj][ty + 8 * r];
                }
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    l[c] = Lj[jj][tx + 32 * c];
                    pv[c] = Pj[jj][tx + 32 * c];
                }
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        A[r][c] = fmaf(w[r], l[c], A[r][c]);
                        Bt[r][c] = fmaf(wt[r], pv[c], Bt[r][c]);
                    }
            }
            __syncthreads();
        }
        if (tid < kBwdRows) deg_s[tid] = degacc;
        __syncthreads();
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty + 8 * r;
            if (i >= B) continue;
            const float coef = kappa + ge * deg_s[ty + 8 * r];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int cc = c0 + tx + 32 * c;
                if (cc >= C) continue;
                const int64_t at = (int64_t)i * C + cc;
                const float p = P[at];
                dlogp[at] = gz * (-gc * (p * A[r][c] + Bt[r][c])
                                  + coef * p * (L[at] + 1.f));
            }
        }
        __syncthreads();   // deg_s is rewritten by the next class chunk
    }
}

// K3: one block per (32 x 64 output tile, worker); S tile over all classes,
// then dW = -g*(gc*S + ge*H_i), written once, coalesced along j.
__global__ void __launch_bounds__(kThreads)
reg_bwd_dw(const float* __restrict__ P, const float* __restrict__ L,
           const float* __restrict__ g, int B, int C, float gc, float ge,
           float* __restrict__ dW) {
    __shared__ float Ps[kChunk][kRows + 1];
    __shared__ float Ls[kChunk][kCols + 1];
    const int z = blockIdx.z, i0 = blockIdx.y * kRows, j0 = blockIdx.x * kCols;
    const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
    P += (int64_t)z * B * C;
    L += (int64_t)z * B * C;
    dW += (int64_t)z * B * B;
    const float gz = g[z];

    float acc[4][2] = {};
    s_tile(P, L, B, C, i0, j0, Ps, Ls, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 8 * r;
        if (i >= B) continue;
        const float h = row_entropy(P, L, C, i);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int j = j0 + tx + 32 * c;
            if (j < B) dW[(int64_t)i * B + j] = -gz * (gc * acc[r][c] + ge * h);
        }
    }
}

}  // namespace

extern "C" {

// Number of K1 partials a (k, B) launch writes: the caller allocates them.
int graph_reg_fwd_n_partials(int k, int B) {
    return k * ((B + kRows - 1) / kRows);
}

int graph_reg_fwd(const void* p, const void* logp, const void* W, int k,
                  int B, int C, float gc, float kappa, float ge,
                  void* partials, void* out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_strips = (B + kRows - 1) / kRows;
    reg_fwd_partials<<<dim3(n_strips, 1, k), kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(logp),
        static_cast<const float*>(W), B, C, gc, kappa, ge,
        static_cast<float*>(partials));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    reg_fwd_sum<<<(k + 127) / 128, 128, 0, s>>>(
        static_cast<const float*>(partials), n_strips, k,
        static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

int graph_reg_bwd_dlogp(const void* p, const void* logp, const void* W,
                        const void* g, int k, int B, int C, float gc,
                        float kappa, float ge, void* dlogp, void* stream) {
    const int n_strips = (B + kBwdRows - 1) / kBwdRows;
    reg_bwd_dlogp<<<dim3(n_strips, 1, k), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(logp),
        static_cast<const float*>(W), static_cast<const float*>(g), B, C, gc,
        kappa, ge, static_cast<float*>(dlogp));
    return static_cast<int>(cudaGetLastError());
}

int graph_reg_bwd_dw(const void* p, const void* logp, const void* g, int k,
                     int B, int C, float gc, float ge, void* dW,
                     void* stream) {
    const dim3 grid((B + kCols - 1) / kCols, (B + kRows - 1) / kRows, k);
    reg_bwd_dw<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(logp),
        static_cast<const float*>(g), B, C, gc, ge, static_cast<float*>(dW));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
