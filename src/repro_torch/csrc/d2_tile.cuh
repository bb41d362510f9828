// The distance engine of the graph-construction kernels K8 and K9
// (pairwise.cu): register-tiled products <x_i, y_j> over the feature axis,
// kBM x 128 output tiles, fed from shared memory by a cp.async ring.
//
// Operands are feature-major, padded copies written by pack_t (below):
// XT (Dp, Np) holds x transposed, XT[f][i] = x[i][f], with the rows padded
// to Np (a multiple of kD2Rows) and the features to Dp (a multiple of
// kD2K, at least one slab), both zero-filled; likewise YT (Dp, Mp).  A
// slab of kD2K features of a tile is then kD2K rows of contiguous floats,
// copied with 16-byte cp.async and no masks, whatever D and the inputs'
// alignment (x at D = 351 has 1,404-byte rows, not a multiple of 16).
//
// Each product keeps the bits of the strip kernels K8 and K9 replaced,
// and so does every d2 built from it: one fmaf chain over the features in
// increasing order, from +0; a padded feature adds fmaf(0, 0, acc) ==
// acc.  No TF32, no tensor cores.
//
// Threads: 256 as a 16 x 16 grid, (ty, tx) = (tid / 16, tid % 16).  Thread
// (ty, tx) holds rows 64h + 4ty + e (h < kBM/64, e < 4) and columns 64h +
// 4tx + e (h < 2) of the tile: per feature it reads kBM/32 + 2 float4s of
// shared memory (a warp's A reads are two addresses, broadcast; its B
// reads 256 contiguous bytes) for kBM/2 FMAs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kD2Threads = 256;
constexpr int kD2Rows = 128;     // packed copies' row padding; K8's strip
constexpr int kD2Cols = 128;     // column tile
constexpr int kD2K = 32;         // features per slab
constexpr int kD2Stages = 2;     // slabs in flight

__host__ __device__ __forceinline__ int64_t d2_round_up(int64_t n, int64_t m) {
    return (n + m - 1) / m * m;
}

// Padded feature count Dp of the packed copies: at least one slab.
__host__ __device__ __forceinline__ int d2_features(int D) {
    return static_cast<int>(d2_round_up(D < 1 ? 1 : D, kD2K));
}

// Floats of one ring stage: kD2K rows of the A (x) slab, then of the B (y).
template <int kBM>
__host__ __device__ constexpr int d2_stage_floats() {
    return kD2K * (kBM + kD2Cols);
}

// XT[f][r] = X[r][f] for r < rows, f < D, 0 elsewhere in (Dp, rows_pad):
// 32 x 32 tiles through shared memory, reads and writes coalesced.
__global__ void __launch_bounds__(kD2Threads)
pack_t(const float* __restrict__ X, int rows, int D, int rows_pad, int Dp,
       float* __restrict__ XT) {
    __shared__ float t[32][33];
    const int r0 = blockIdx.x * 32, f0 = blockIdx.y * 32;
    const int lane = threadIdx.x & 31, q0 = threadIdx.x >> 5;
    for (int q = q0; q < 32; q += kD2Threads / 32) {
        const int r = r0 + q, f = f0 + lane;
        t[q][lane] = r < rows && f < D ? X[(int64_t)r * D + f] : 0.f;
    }
    __syncthreads();
    for (int q = q0; q < 32; q += kD2Threads / 32) {
        const int f = f0 + q;
        if (f < Dp) XT[(int64_t)f * rows_pad + r0 + lane] = t[lane][q];
    }
}

// Packs X (rows, D) into XT (Dp, rows_pad).
inline int launch_pack(const float* X, int rows, int D, int rows_pad,
                       float* XT, cudaStream_t s) {
    const int Dp = d2_features(D);
    pack_t<<<dim3(rows_pad / 32, (Dp + 31) / 32), kD2Threads, 0, s>>>(
        X, rows, D, rows_pad, Dp, XT);
    return static_cast<int>(cudaGetLastError());
}

// Issue the copies of features [f0, f0 + kD2K) of rows i0.. and columns
// j0.. into one ring stage (16 bytes each, 3 or 4 a thread).
template <int kBM>
__device__ __forceinline__ void d2_issue_slab(
        float* stage, const float* __restrict__ XT,
        const float* __restrict__ YT, int Np, int Mp, int i0, int j0,
        int f0) {
    constexpr int kA4 = kD2K * kBM / 4, kB4 = kD2K * kD2Cols / 4;
    static_assert(kA4 % kD2Threads == 0 && kB4 % kD2Threads == 0,
                  "whole copies a thread");
#pragma unroll
    for (int q = 0; q < kA4 / kD2Threads; ++q) {
        const int e = threadIdx.x + q * kD2Threads;
        const int f = e / (kBM / 4), c4 = e % (kBM / 4);
        cp_async16(stage + f * kBM + 4 * c4,
                   XT + (int64_t)(f0 + f) * Np + i0 + 4 * c4, 16);
    }
    float* bs = stage + kD2K * kBM;
#pragma unroll
    for (int q = 0; q < kB4 / kD2Threads; ++q) {
        const int e = threadIdx.x + q * kD2Threads;
        const int f = e / (kD2Cols / 4), c4 = e % (kD2Cols / 4);
        cp_async16(bs + f * kD2Cols + 4 * c4,
                   YT + (int64_t)(f0 + f) * Mp + j0 + 4 * c4, 16);
    }
}

// Feature f's operands of the thread: its rows' x (a) and columns' y (b).
template <int kBM>
__device__ __forceinline__ void d2_load_frag(const float* as, const float* bs,
                                             int f, float* a, float* b) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int h = 0; h < kBM / 64; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            as + f * kBM + 64 * h + 4 * ty);
        a[4 * h] = v.x; a[4 * h + 1] = v.y;
        a[4 * h + 2] = v.z; a[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            bs + f * kD2Cols + 64 * h + 4 * tx);
        b[4 * h] = v.x; b[4 * h + 1] = v.y;
        b[4 * h + 2] = v.z; b[4 * h + 3] = v.w;
    }
}

// acc[r][c] = fmaf(a, b, acc[r][c]) over the slab's kD2K features, in
// increasing feature order; feature f + 1's operands load while feature
// f's FMAs run.
template <int kBM>
__device__ __forceinline__ void d2_compute_slab(const float* stage,
                                                float (&acc)[kBM / 16][8]) {
    const float* as = stage;
    const float* bs = stage + kD2K * kBM;
    float a[2][kBM / 16], b[2][8];
    d2_load_frag<kBM>(as, bs, 0, a[0], b[0]);
#pragma unroll
    for (int f = 0; f < kD2K; ++f) {
        if (f + 1 < kD2K)
            d2_load_frag<kBM>(as, bs, f + 1, a[(f + 1) & 1], b[(f + 1) & 1]);
#pragma unroll
        for (int r = 0; r < kBM / 16; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c)
                acc[r][c] = fmaf(a[f & 1][r], b[f & 1][c], acc[r][c]);
    }
}

// Tile row of a thread's r-th row, tile column of its c-th column.
__device__ __forceinline__ int d2_row(int r) {
    return 64 * (r >> 2) + 4 * (threadIdx.x >> 4) + (r & 3);
}
__device__ __forceinline__ int d2_col(int c) {
    return 64 * (c >> 2) + 4 * (threadIdx.x & 15) + (c & 3);
}

// The products of rows i0 .. i0 + kBM - 1 with the columns of tiles jt0,
// jt0 + 1, .., jt0 + n_tiles - 1, in that order: after each tile's last
// slab, epi(jt, acc) runs on every thread with the tile's finished sums
// (it may change acc and may hold block barriers).  All slabs of all
// tiles stream through one kD2Stages-deep ring in `ring` (shared memory,
// kD2Stages * d2_stage_floats<kBM>() floats), one block barrier a slab;
// the next tile's first slabs load while the epilogue runs.
template <int kBM, class Epilogue>
__device__ __forceinline__ void d2_stream(
        const float* __restrict__ XT, const float* __restrict__ YT, int Np,
        int Mp, int n_slabs, int i0, int jt0, int n_tiles, float* ring,
        Epilogue&& epi) {
    constexpr int kStage = d2_stage_floats<kBM>();
    const int G = n_tiles * n_slabs;
    // Slab g's tile and feature block, advanced without a division.
    int it = 0, is = 0;
    auto issue = [&](int g) {
        if (g < G)
            d2_issue_slab<kBM>(ring + (g % kD2Stages) * kStage, XT, YT, Np,
                               Mp, i0, (jt0 + it) * kD2Cols, is * kD2K);
        cp_async_commit();   // an empty group past the end keeps the count
        if (++is == n_slabs) { is = 0; ++it; }
    };
    for (int g = 0; g < kD2Stages - 1; ++g) issue(g);
    float acc[kBM / 16][8];
    int t = 0, s = 0;
    for (int g = 0; g < G; ++g) {
        if (s == 0) {
#pragma unroll
            for (int r = 0; r < kBM / 16; ++r)
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
        }
        cp_async_wait<kD2Stages - 2>();   // slab g has landed
        __syncthreads();   // for every thread; slab g-1's stage is free
        issue(g + kD2Stages - 1);
        d2_compute_slab<kBM>(ring + (g % kD2Stages) * kStage, acc);
        if (++s == n_slabs) {
            epi(jt0 + t, acc);
            s = 0;
            ++t;
        }
    }
    cp_async_wait<0>();
}

}  // namespace
