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
//   K10 graph_reg_pairwise out = -sum_ij W_ij (P logP^T)_ij  (one worker)
//
// K10 replaces repro/kernels/graph_reg.py:graph_reg_pairwise_pallas
// (_graph_reg_kernel), the bare cross term.  It is K1's strip kernel
// compiled without the degree and entropy terms (kFull = false), with
// K1's second pass, so it equals K1 at (gc, kappa, ge) = (1, 0, 0).
//
// Padding is done with masks (graph_reg_tiles.cuh).
//
// No float atomics: every output element and every partial sum has exactly
// one writer, and every reduction runs in a fixed order, so two launches on
// the same inputs give bit-identical results.

#include "cp_async.cuh"
#include "graph_reg_tiles.cuh"

namespace {

// K1, pass 1: one block per (row strip, worker).  The block loops over all
// column tiles and the class dimension itself, so it holds complete row
// degrees and writes one partial that already includes its strip's
// (kappa + ge*deg_i) H_i term.  kFull = false (K10) drops the degrees and
// the entropy term: the partial is -gc times the strip's cross term.
template <bool kFull>
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
                    if (kFull) deg[r] += w;
                }
            }
        }
    }
    // Row r of this warp: complete degree by warp sum, entropy by warp sum.
    float ent = 0.f;
#pragma unroll
    for (int r = 0; r < 4 && kFull; ++r) {
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

// K2: one block per (row strip of 32, worker).  Loops over 64-wide class
// chunks and 32-wide j tiles; reads W[i, j] (W logP and the degrees) and
// W[j, i] as a coalesced tile transposed in shared memory (W^T P).
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

// K3: dW = -g*(gc*P logP^T + ge*H(p) 1^T), (B, B) per worker, written
// once.  Its time goes to staging P and logP, the product loop and the
// B*B stores; the design keeps each small:
//
// * one block per (64 x 128 output tile, worker): 578 blocks at the
//   path's B = 2176, three resident per SM (at most 85 registers a
//   thread); 256 threads, each with a 4 x 8 register tile (rows ty*4..,
//   columns tx*4.. and 64+tx*4..);
// * the tile's P and logP rows (and logP of its columns) are staged once
//   for up to kDwK classes (all of them at C <= 40) with cp.async, every
//   copy of the chunk in flight at once, transposed to class-major in
//   shared memory with an XOR swizzle of 4-float groups, so the
//   transposing stores are conflict-free and every read of the product
//   loop is one 16-byte load (a warp reads 2 row groups, broadcast, and
//   16 column groups);
// * H(p_i) once per row per block, from the staged rows: lane l sums the
//   classes c = l (mod 32) in increasing c and the warp adds the lanes
//   with warp_sum, row_entropy's order, so h has its bits;
// * 16-byte streaming stores (__stcs) along j where B is a multiple of 4
//   and dW is 16-byte aligned, masked scalar stores otherwise; rows and
//   columns past B are masked, never padded in memory.
//
// Each S element starts at +0 and adds fmaf(P[i,c], logP[j,c], acc) in
// increasing c (zero-filled classes past C add exact zeros), then
// -gz*(gc*acc + ge*h) as K7 writes it, so K3 equals K7 bit for bit on a
// full mask.  Bound by bytes (the B*B output) and, about equally, by the
// 2*B*B*C flops; no tensor cores, which would change the sum's order.
constexpr int kDwRows = 64, kDwCols = 128, kDwK = 40;

// Column of element (row, k) in a class-major swizzled tile: 4-float
// groups XORed with k mod 8.
__device__ __forceinline__ int dw_swz(int row, int k) {
    return ((((row >> 2) ^ (k & 7))) << 2) | (row & 3);
}

__global__ void __launch_bounds__(kThreads, 3)
reg_bwd_dw(const float* __restrict__ P, const float* __restrict__ L,
           const float* __restrict__ g, int B, int C, float gc, float ge,
           int vec, float* __restrict__ dW) {
    __shared__ __align__(16) float Ps[kDwK][kDwRows];   // P[i0 + i, c]
    __shared__ __align__(16) float Li[kDwK][kDwRows];   // logP[i0 + i, c]
    __shared__ __align__(16) float Ls[kDwK][kDwCols];   // logP[j0 + j, c]
    __shared__ float Hs[kDwRows];
    const int z = blockIdx.z, i0 = blockIdx.y * kDwRows;
    const int j0 = blockIdx.x * kDwCols;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int warp = tid >> 5, lane = tid & 31;
    P += (int64_t)z * B * C;
    L += (int64_t)z * B * C;
    dW += (int64_t)z * B * B;
    const float gz = g[z];

    float acc[4][8] = {};
    float hpart[kDwRows / 8] = {};   // warp w: rows 8w .. 8w+7
    // Staging lanes: 8 classes x 4 consecutive rows per warp instruction.
    const int kk = lane >> 2, rq = lane & 3;
    for (int c0 = 0; c0 < C; c0 += kDwK) {
        const int kc = min(kDwK, C - c0);
        const int kpad = (kc + 7) & ~7;
        if (c0 > 0) __syncthreads();   // the previous chunk's reads are done
        // Every copy of the chunk in flight at once (cp.async, 4 bytes,
        // zero-filled where masked), then one wait.
        for (int k0 = 0; k0 < kpad; k0 += 8) {
            const int k = k0 + kk;
            for (int rb = warp; rb < kDwRows / 4; rb += 8) {
                const int row = rb * 4 + rq, i = i0 + row;
                const bool ok = i < B && k < kc;
                const int64_t at = ok ? (int64_t)i * C + c0 + k : 0;
                cp_async4(&Ps[k][dw_swz(row, k)], P + at, ok ? 4 : 0);
                cp_async4(&Li[k][dw_swz(row, k)], L + at, ok ? 4 : 0);
            }
            for (int rb = warp; rb < kDwCols / 4; rb += 8) {
                const int col = rb * 4 + rq, j = j0 + col;
                const bool ok = j < B && k < kc;
                cp_async4(&Ls[k][dw_swz(col, k)],
                          L + (ok ? (int64_t)j * C + c0 + k : 0), ok ? 4 : 0);
            }
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        // The entropy terms of this chunk: lane's classes c = lane (mod
        // 32), increasing.
        for (int k = (lane - c0 % 32 + 32) % 32; k < kc; k += 32)
#pragma unroll
            for (int rr = 0; rr < kDwRows / 8; ++rr) {
                const int row = warp * (kDwRows / 8) + rr;
                hpart[rr] = fmaf(Ps[k][dw_swz(row, k)],
                                 Li[k][dw_swz(row, k)], hpart[rr]);
            }
#pragma unroll 8
        for (int k = 0; k < kpad; ++k) {
            const int x = k & 7;
            const float4 a = *reinterpret_cast<const float4*>(
                &Ps[k][(ty ^ x) << 2]);
            const float4 b0 = *reinterpret_cast<const float4*>(
                &Ls[k][(tx ^ x) << 2]);
            const float4 b1 = *reinterpret_cast<const float4*>(
                &Ls[k][((16 + tx) ^ x) << 2]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 8; ++c)
                    acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
    }
#pragma unroll
    for (int rr = 0; rr < kDwRows / 8; ++rr) {
        const float h = -warp_sum(hpart[rr]);
        if (lane == 0) Hs[warp * (kDwRows / 8) + rr] = h;
    }
    __syncthreads();   // Hs written by other warps
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i >= B) continue;
        const float h = Hs[ty * 4 + r];
        float v[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = -gz * (gc * acc[r][c] + ge * h);
        float* row = dW + (int64_t)i * B;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int j = j0 + half * 64 + tx * 4;
            const float* w = v + 4 * half;
            if (vec && j < B) {
                __stcs(reinterpret_cast<float4*>(row + j),
                       make_float4(w[0], w[1], w[2], w[3]));
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (j + e < B) __stcs(row + j + e, w[e]);
            }
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
    reg_fwd_partials<true><<<dim3(n_strips, 1, k), kThreads, 0, s>>>(
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

// K10: logp and p (B, C), W (B, B), no worker axis; out is one float.
// partials holds graph_reg_fwd_n_partials(1, B) floats.
int graph_reg_pairwise(const void* p, const void* logp, const void* W, int B,
                       int C, void* partials, void* out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_strips = (B + kRows - 1) / kRows;
    reg_fwd_partials<false><<<dim3(n_strips, 1, 1), kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(logp),
        static_cast<const float*>(W), B, C, 1.f, 0.f, 0.f,
        static_cast<float*>(partials));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    reg_fwd_sum<<<1, 128, 0, s>>>(static_cast<const float*>(partials),
                                  n_strips, 1, static_cast<float*>(out));
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
    // 16-byte stores need 16-byte rows: B a multiple of 4 and dW aligned.
    const int vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(dW) % 16 == 0;
    const dim3 grid((B + kDwCols - 1) / kDwCols, (B + kDwRows - 1) / kDwRows,
                    k);
    reg_bwd_dw<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(logp),
        static_cast<const float*>(g), B, C, gc, ge, vec,
        static_cast<float*>(dW));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
