// Device helpers shared by the graph-regularizer kernels, the dense ones
// (graph_reg.cu, K1-K3 and K10) and the block-sparse ones
// (graph_reg_bsp.cu, K4-K7).  The tile arithmetic fixes the order of the
// sums of K4 (and of K1 before its redesign, which keeps those orders), so
// on a full occupancy mask K4 equals K1 bit for bit.  The graph-
// construction kernels (pairwise.cu, K8 and K9) used xy_tile before their
// redesign; their distance engine (d2_tile.cuh) keeps its sum order.
//
// Padding is done with masks, never with values: rows, columns and classes
// outside (B, B, C) (features outside (N, M, D)) are loaded as 0 for p,
// logp, W, x and y alike, so they drop out of every product (exp() of a
// padded logp is never taken).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps: ty = warp (0..7), tx = lane
constexpr int kRows = 32;       // row strip of K1/K3/K4/K7
constexpr int kCols = 64;       // column tile of the S = P logP^T tile
constexpr int kChunk = 16;      // class chunk of the S contraction
// K2/K5/K6: 32-row strips, 32-wide j tiles, 64-wide class chunks.
constexpr int kBwdRows = 32, kBwdCols = 32, kClassW = 64;

__device__ __forceinline__ float warp_sum(float v) {
    // Fixed butterfly order: deterministic, every lane ends with the sum.
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// acc[r][c] += sum_k X[i0+ty+8r, k] * Y[j0+tx+32c, k] over all k < D, for
// X (N, D) and Y (M, D).  Thread (ty, tx) owns rows ty+8r (r<4) and columns
// tx+32c (c<2) of the 32 x 64 tile; a warp reads 32 consecutive columns
// (conflict-free) and one broadcast row from shared memory.  The k-th term
// of every output is added in increasing k, one fmaf each.
__device__ __forceinline__ void xy_tile(
        const float* __restrict__ X, const float* __restrict__ Y,
        int N, int M, int D, int i0, int j0,
        float (*Xs)[kRows + 1], float (*Ys)[kCols + 1], float acc[4][2]) {
    const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
    for (int c0 = 0; c0 < D; c0 += kChunk) {
        for (int e = tid; e < kRows * kChunk; e += kThreads) {
            const int i = e / kChunk, k = e % kChunk;
            const bool ok = (i0 + i < N) && (c0 + k < D);
            Xs[k][i] = ok ? X[(int64_t)(i0 + i) * D + c0 + k] : 0.f;
        }
        for (int e = tid; e < kCols * kChunk; e += kThreads) {
            const int j = e / kChunk, k = e % kChunk;
            const bool ok = (j0 + j < M) && (c0 + k < D);
            Ys[k][j] = ok ? Y[(int64_t)(j0 + j) * D + c0 + k] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            float a[4], b[2];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = Xs[k][ty + 8 * r];
#pragma unroll
            for (int c = 0; c < 2; ++c) b[c] = Ys[k][tx + 32 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 2; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
        }
        __syncthreads();
    }
}

// The regularizer's S tile: acc[r][c] += sum_k P[i0+ty+8r, k] *
// logP[j0+tx+32c, k] over all C classes, P and logP both (B, C).
__device__ __forceinline__ void s_tile(
        const float* __restrict__ P, const float* __restrict__ L,
        int B, int C, int i0, int j0,
        float (*Ps)[kRows + 1], float (*Ls)[kCols + 1], float acc[4][2]) {
    xy_tile(P, L, B, B, C, i0, j0, Ps, Ls, acc);
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

// Forward, pass 2: out_z = sum of worker z's strip partials, in strip order.
__global__ void reg_fwd_sum(const float* __restrict__ partials, int n_strips,
                            int k, float* __restrict__ out) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    if (z >= k) return;
    float s = 0.f;
    for (int t = 0; t < n_strips; ++t) s += partials[(int64_t)z * n_strips + t];
    out[z] = s;
}

}  // namespace
