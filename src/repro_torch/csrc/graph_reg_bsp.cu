// Hopper (sm_90a) kernels of the block-sparse Eq.-3/4 graph regularizer:
// the dense kernels of graph_reg.cu restricted to the occupied bt x bt
// tiles of W that a BlockLayout lists.  Plain C interface, loaded with
// ctypes by repro_torch/kernels/graph_reg_bsp.py; every entry point
// launches on the stream it is given, allocates nothing and returns
// cudaGetLastError().
//
// Shapes: k workers (grid z), each with p = exp(logp) and logp (B, C) and
// W (B, B), float32, row-major and contiguous; per worker a row-major tile
// list rows/cols/valid (T,) and a column-major list crows/ccols/cvalid (T,),
// int32, and an occupancy mask occ (nt, nt) int32, nt = ceil(B / bt).  Each
// list is sorted by its major coordinate; an empty tile line carries one
// (line, 0, valid=0) sentinel, and tail padding repeats the last entry with
// valid=0 (core/metabatch.py).  The cotangent g is a (k,) device array.
//
//   K4 graph_reg_bsp_fwd    out_z = -gc*sum_listed tiles W.*(P logP^T)
//                                   - sum_listed strips (kappa + ge*deg_i) H_i
//   K5 graph_reg_bsp_bterm  bterm = W^T P over the column-major list, (B, C)
//   K6 graph_reg_bsp_dlogp  dlogp = g*[-gc*(P.*(W logP) + bterm)
//                                      + (kappa + ge*deg) .* P .* (logP + 1)]
//   K7 graph_reg_bsp_dw     dW    = -g*(gc*P logP^T + ge*H(p) 1^T) on tiles
//                                   with occ == 1, exact zeros elsewhere
//
// The TPU kernels walk a list as one ordered grid, find a strip's first and
// last entries from the neighbouring entries, and keep scratch alive from
// one grid step to the next.  CUDA blocks run in no order, so here a block
// owns a 32-row piece of one tile strip (bt must be a multiple of 32),
// binary-searches its strip's range in the sorted major coordinate, and
// loops over those entries in list order; entries with valid=0 (sentinels
// and tail padding) add nothing.  Inside an entry the loops are the dense
// kernels' (64-column pieces and 16-class chunks for K4, 32-row pieces and
// 64-class chunks for K5/K6), so on a full mask with bt a multiple of 64
// every sum runs in the dense kernels' order.  No float atomics: every
// output element and partial has one writer, and repeats are bit-identical.

#include "graph_reg_tiles.cuh"

namespace {

// [lo, hi): the entries of tile line `line` in a list sorted by `major`.
__device__ __forceinline__ void line_range(const int* __restrict__ major,
                                           int T, int line, int& lo, int& hi) {
    int a = 0, b = T;
    while (a < b) {
        const int m = (a + b) >> 1;
        if (major[m] < line) a = m + 1; else b = m;
    }
    lo = a;
    b = T;
    while (a < b) {
        const int m = (a + b) >> 1;
        if (major[m] <= line) a = m + 1; else b = m;
    }
    hi = a;
}

// K4, pass 1: one block per (32-row piece, worker); K1's block restricted
// to the column tiles its strip lists.  A listed strip owes its rows'
// entropy term even when it holds only a sentinel.
__global__ void __launch_bounds__(kThreads)
bsp_fwd_partials(const float* __restrict__ P, const float* __restrict__ L,
                 const float* __restrict__ W, const int* __restrict__ rows,
                 const int* __restrict__ cols, const int* __restrict__ valid,
                 int B, int C, int T, int bt, float gc, float kappa, float ge,
                 float* __restrict__ partials) {
    __shared__ float Ps[kChunk][kRows + 1];
    __shared__ float Ls[kChunk][kCols + 1];
    __shared__ float red[kThreads];
    const int z = blockIdx.z, i0 = blockIdx.x * kRows;
    const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
    const int nt = (B + bt - 1) / bt;
    P += (int64_t)z * B * C;
    L += (int64_t)z * B * C;
    W += (int64_t)z * B * B;
    rows += (int64_t)z * T;
    cols += (int64_t)z * T;
    valid += (int64_t)z * T;
    int lo, hi;
    line_range(rows, T, i0 / bt, lo, hi);

    float cross = 0.f, deg[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = lo; t < hi; ++t) {
        const int ct = cols[t];
        if (valid[t] != 1 || ct < 0 || ct >= nt) continue;
        const int j1 = min((ct + 1) * bt, B);
        for (int j0 = ct * bt; j0 < j1; j0 += kCols) {
            float acc[4][2] = {};
            s_tile(P, L, B, C, i0, j0, Ps, Ls, acc);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = i0 + ty + 8 * r;
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int j = j0 + tx + 32 * c;
                    if (i < B && j < j1) {
                        const float w = W[(int64_t)i * B + j];
                        cross = fmaf(w, acc[r][c], cross);
                        deg[r] += w;
                    }
                }
            }
        }
    }
    float ent = 0.f;
    if (lo < hi) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty + 8 * r;
            const float d = warp_sum(deg[r]);
            if (i < B) {
                const float h = row_entropy(P, L, C, i);
                if (tx == 0) ent += (kappa + ge * d) * h;
            }
        }
    }
    const float total = block_sum(-gc * cross - ent, red);
    if (tid == 0) partials[(int64_t)z * gridDim.x + blockIdx.x] = total;
}

// K5: one block per (32-row piece of the output, worker).  Output rows i
// are W's columns, so the block walks the column-major list of its column
// strip and reads each listed W[j, i] piece coalesced along i, transposed
// in shared memory, as K2 reads W^T.
__global__ void __launch_bounds__(kThreads)
bsp_bwd_bterm(const float* __restrict__ P, const float* __restrict__ W,
              const int* __restrict__ crows, const int* __restrict__ ccols,
              const int* __restrict__ cvalid, int B, int C, int T, int bt,
              float* __restrict__ bterm) {
    __shared__ float WTs[kBwdCols][kBwdRows + 1];   // W[j, i], j-major
    __shared__ float Pj[kBwdCols][kClassW + 1];
    const int z = blockIdx.z, i0 = blockIdx.x * kBwdRows;
    const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
    const int nt = (B + bt - 1) / bt;
    P += (int64_t)z * B * C;
    W += (int64_t)z * B * B;
    bterm += (int64_t)z * B * C;
    crows += (int64_t)z * T;
    ccols += (int64_t)z * T;
    cvalid += (int64_t)z * T;
    int lo, hi;
    line_range(ccols, T, i0 / bt, lo, hi);

    for (int c0 = 0; c0 < C; c0 += kClassW) {
        float Bt[4][2] = {};
        for (int t = lo; t < hi; ++t) {
            const int jt = crows[t];
            if (cvalid[t] != 1 || jt < 0 || jt >= nt) continue;
            const int j1 = min((jt + 1) * bt, B);
            for (int j0 = jt * bt; j0 < j1; j0 += kBwdCols) {
                for (int e = tid; e < kBwdCols * kBwdRows; e += kThreads) {
                    const int jj = e / kBwdRows, ii = e % kBwdRows;
                    const bool ok = (i0 + ii < B) && (j0 + jj < j1);
                    WTs[jj][ii] = ok ? W[(int64_t)(j0 + jj) * B + i0 + ii] : 0.f;
                }
                for (int e = tid; e < kBwdCols * kClassW; e += kThreads) {
                    const int jj = e / kClassW, cc = e % kClassW;
                    const bool ok = (j0 + jj < j1) && (c0 + cc < C);
                    Pj[jj][cc] = ok ? P[(int64_t)(j0 + jj) * C + c0 + cc] : 0.f;
                }
                __syncthreads();
#pragma unroll 8
                for (int jj = 0; jj < kBwdCols; ++jj) {
                    float wt[4], pv[2];
#pragma unroll
                    for (int r = 0; r < 4; ++r) wt[r] = WTs[jj][ty + 8 * r];
#pragma unroll
                    for (int c = 0; c < 2; ++c) pv[c] = Pj[jj][tx + 32 * c];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 2; ++c)
                            Bt[r][c] = fmaf(wt[r], pv[c], Bt[r][c]);
                }
                __syncthreads();
            }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty + 8 * r;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int cc = c0 + tx + 32 * c;
                if (i < B && cc < C) bterm[(int64_t)i * C + cc] = Bt[r][c];
            }
        }
    }
}

// K6: one block per (32-row piece, worker); K2's block restricted to the
// column tiles its strip lists, with K5's bterm in place of its W^T P.
// Degrees are recomputed per class chunk, as in K2.
__global__ void __launch_bounds__(kThreads)
bsp_bwd_dlogp(const float* __restrict__ P, const float* __restrict__ L,
              const float* __restrict__ W, const float* __restrict__ bterm,
              const float* __restrict__ g, const int* __restrict__ rows,
              const int* __restrict__ cols, const int* __restrict__ valid,
              int B, int C, int T, int bt, float gc, float kappa, float ge,
              float* __restrict__ dlogp) {
    __shared__ float Ws[kBwdRows][kBwdCols + 1];    // W[i, j]
    __shared__ float Lj[kBwdCols][kClassW + 1];
    __shared__ float deg_s[kBwdRows];
    const int z = blockIdx.z, i0 = blockIdx.x * kBwdRows;
    const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
    const int nt = (B + bt - 1) / bt;
    P += (int64_t)z * B * C;
    L += (int64_t)z * B * C;
    W += (int64_t)z * B * B;
    bterm += (int64_t)z * B * C;
    dlogp += (int64_t)z * B * C;
    rows += (int64_t)z * T;
    cols += (int64_t)z * T;
    valid += (int64_t)z * T;
    const float gz = g[z];
    int lo, hi;
    line_range(rows, T, i0 / bt, lo, hi);

    for (int c0 = 0; c0 < C; c0 += kClassW) {
        float A[4][2] = {};
        float degacc = 0.f;
        for (int t = lo; t < hi; ++t) {
            const int ct = cols[t];
            if (valid[t] != 1 || ct < 0 || ct >= nt) continue;
            const int j1 = min((ct + 1) * bt, B);
            for (int j0 = ct * bt; j0 < j1; j0 += kBwdCols) {
                for (int e = tid; e < kBwdRows * kBwdCols; e += kThreads) {
                    const int ii = e / kBwdCols, jj = e % kBwdCols;
                    const bool ok = (i0 + ii < B) && (j0 + jj < j1);
                    Ws[ii][jj] = ok ? W[(int64_t)(i0 + ii) * B + j0 + jj] : 0.f;
                }
                for (int e = tid; e < kBwdCols * kClassW; e += kThreads) {
                    const int jj = e / kClassW, cc = e % kClassW;
                    const bool ok = (j0 + jj < j1) && (c0 + cc < C);
                    Lj[jj][cc] = ok ? L[(int64_t)(j0 + jj) * C + c0 + cc] : 0.f;
                }
                __syncthreads();
                if (tid < kBwdRows)
                    for (int jj = 0; jj < kBwdCols; ++jj) degacc += Ws[tid][jj];
#pragma unroll 8
                for (int jj = 0; jj < kBwdCols; ++jj) {
                    float w[4], l[2];
#pragma unroll
                    for (int r = 0; r < 4; ++r) w[r] = Ws[ty + 8 * r][jj];
#pragma unroll
                    for (int c = 0; c < 2; ++c) l[c] = Lj[jj][tx + 32 * c];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 2; ++c)
                            A[r][c] = fmaf(w[r], l[c], A[r][c]);
                }
                __syncthreads();
            }
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
                dlogp[at] = gz * (-gc * (p * A[r][c] + bterm[at])
                                  + coef * p * (L[at] + 1.f));
            }
        }
        __syncthreads();   // deg_s is rewritten by the next class chunk
    }
}

// K7: one block per (32 x 64 output piece, worker), as K3.  A piece that
// touches no occupied tile writes zeros without computing its S tile; an
// occupied one writes K3's value where occ == 1 and zero elsewhere (a
// 64-column piece spans two tiles when bt = 32).
__global__ void __launch_bounds__(kThreads)
bsp_bwd_dw(const float* __restrict__ P, const float* __restrict__ L,
           const int* __restrict__ occ, const float* __restrict__ g,
           int B, int C, int bt, float gc, float ge, float* __restrict__ dW) {
    __shared__ float Ps[kChunk][kRows + 1];
    __shared__ float Ls[kChunk][kCols + 1];
    const int z = blockIdx.z, i0 = blockIdx.y * kRows, j0 = blockIdx.x * kCols;
    const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
    const int nt = (B + bt - 1) / bt;
    P += (int64_t)z * B * C;
    L += (int64_t)z * B * C;
    dW += (int64_t)z * B * B;
    const int* orow = occ + (int64_t)z * nt * nt + (int64_t)(i0 / bt) * nt;
    const float gz = g[z];

    const int jlast = min(j0 + kCols, B) - 1;
    bool live = false;                      // the same in every thread
    for (int tj = j0 / bt; tj <= jlast / bt; ++tj) live |= orow[tj] == 1;
    float acc[4][2] = {};
    if (live) s_tile(P, L, B, C, i0, j0, Ps, Ls, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 8 * r;
        if (i >= B) continue;
        const float h = live ? row_entropy(P, L, C, i) : 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int j = j0 + tx + 32 * c;
            if (j < B)
                dW[(int64_t)i * B + j] = orow[j / bt] == 1
                    ? -gz * (gc * acc[r][c] + ge * h) : 0.f;
        }
    }
}

bool bad_tile_edge(int bt) { return bt <= 0 || bt % kRows != 0; }

}  // namespace

extern "C" {

// Number of K4 partials a (k, B) launch writes: the caller allocates them.
int graph_reg_bsp_fwd_n_partials(int k, int B) {
    return k * ((B + kRows - 1) / kRows);
}

int graph_reg_bsp_fwd(const void* p, const void* logp, const void* W,
                      const void* rows, const void* cols, const void* valid,
                      int k, int B, int C, int T, int bt, float gc,
                      float kappa, float ge, void* partials, void* out,
                      void* stream) {
    if (bad_tile_edge(bt)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_strips = (B + kRows - 1) / kRows;
    bsp_fwd_partials<<<dim3(n_strips, 1, k), kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(logp),
        static_cast<const float*>(W), static_cast<const int*>(rows),
        static_cast<const int*>(cols), static_cast<const int*>(valid),
        B, C, T, bt, gc, kappa, ge, static_cast<float*>(partials));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    reg_fwd_sum<<<(k + 127) / 128, 128, 0, s>>>(
        static_cast<const float*>(partials), n_strips, k,
        static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

int graph_reg_bsp_bterm(const void* p, const void* W, const void* crows,
                        const void* ccols, const void* cvalid, int k, int B,
                        int C, int T, int bt, void* bterm, void* stream) {
    if (bad_tile_edge(bt)) return static_cast<int>(cudaErrorInvalidValue);
    const int n_strips = (B + kBwdRows - 1) / kBwdRows;
    bsp_bwd_bterm<<<dim3(n_strips, 1, k), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(W),
        static_cast<const int*>(crows), static_cast<const int*>(ccols),
        static_cast<const int*>(cvalid), B, C, T, bt,
        static_cast<float*>(bterm));
    return static_cast<int>(cudaGetLastError());
}

int graph_reg_bsp_dlogp(const void* p, const void* logp, const void* W,
                        const void* bterm, const void* g, const void* rows,
                        const void* cols, const void* valid, int k, int B,
                        int C, int T, int bt, float gc, float kappa, float ge,
                        void* dlogp, void* stream) {
    if (bad_tile_edge(bt)) return static_cast<int>(cudaErrorInvalidValue);
    const int n_strips = (B + kBwdRows - 1) / kBwdRows;
    bsp_bwd_dlogp<<<dim3(n_strips, 1, k), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(logp),
        static_cast<const float*>(W), static_cast<const float*>(bterm),
        static_cast<const float*>(g), static_cast<const int*>(rows),
        static_cast<const int*>(cols), static_cast<const int*>(valid),
        B, C, T, bt, gc, kappa, ge, static_cast<float*>(dlogp));
    return static_cast<int>(cudaGetLastError());
}

int graph_reg_bsp_dw(const void* p, const void* logp, const void* occ,
                     const void* g, int k, int B, int C, int bt, float gc,
                     float ge, void* dW, void* stream) {
    if (bad_tile_edge(bt)) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((B + kCols - 1) / kCols, (B + kRows - 1) / kRows, k);
    bsp_bwd_dw<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(logp),
        static_cast<const int*>(occ), static_cast<const float*>(g), B, C, bt,
        gc, ge, static_cast<float*>(dW));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
