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
// owns a piece of one tile strip (32 rows for K4, K6 and K7, 8 for K5; bt
// must be a multiple of 32), binary-searches its strip's range in the
// sorted major coordinate, and loops over those entries in list order;
// entries with valid=0 (sentinels and tail padding) add nothing.  Inside
// an entry the sums run in the dense kernels' order (64-column pieces and
// 16-class chunks for K4, j increasing for K5 and K6), so on a full mask
// with bt a multiple of 64 K4 equals K1 and K5∘K6 equals K2 bit for bit.
// No float atomics: every output element and partial has one writer, and
// repeats are bit-identical.

#include "cp_async.cuh"
#include "dynamic_smem.cuh"
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

// K5: bterm[i, c] = sum_j W[j, i] P[j, c] over the tiles of i's column
// strip, in list order, j increasing inside a tile: each output starts at
// +0 and adds one fmaf per j, the order of K2's W^T P.  Every output is a
// serial chain as long as its strip (up to ~900 j at the path's shape),
// so the kernel is bound by how fast the warps walk their chains and by
// the latency of what feeds them, not by HBM (3.9 MB of listed W tiles
// at the path's shape).  The design:
//
// * one block per (8 output rows, class chunk of up to 128, worker):
//   272 blocks at the path's B = 2176, two per SM, a heavy strip spread
//   over 16 of them.  A thread owns one row and four classes (C = 39
//   pads to 40, not to 64); it reads its steps eight at a time, all the
//   shared-memory reads first, so one read latency covers eight FMAs of
//   each of its four chains;
// * warp 0 finds the strip's [lo, hi) with a pivot per lane a round (two
//   rounds for lists up to ~1,000 entries, where a binary search takes
//   ~20 dependent loads) and compacts the valid entries' tile rows, in
//   list order, into shared memory: the pipeline reads no index from
//   global memory;
// * the strip's (tile, 32-row piece) sequence streams through a ring of
//   kBtStages shared-memory stages filled with cp.async (16-byte copies
//   where rows are 16-byte aligned, 4-byte copies otherwise), so the
//   loads of the next seven pieces are in flight while one is summed;
//   rows past a tile's end and columns and classes past B and C are
//   zero-filled by the copy (src-size 0), with no division in the loops;
// * W is read once per class chunk (once at C <= 128), 32 bytes per W
//   row, a whole sector; P rows come from L2.
//
// No split of j and no atomics: repeats are bit-identical.
constexpr int kBtRows = 8;       // output rows (W columns) per block
constexpr int kBtPiece = 32;     // W rows (j) per pipeline stage
constexpr int kBtStages = 8;     // depth of the cp.async ring
constexpr int kBtMaxQuads = 32;  // class chunk: at most 128 classes

// Floats of one ring stage: the W piece (kBtPiece x kBtRows) and the P
// piece (kBtPiece x 4*quads); a multiple of 4, so every stage and every
// P row is 16-byte aligned.
__host__ __device__ __forceinline__ int bterm_stage_floats(int quads) {
    return kBtPiece * (kBtRows + 4 * quads);
}

// Entries of a strip's compacted tile list: a layout lists each tile at
// most once, so a strip holds at most nt valid entries (and at most T).
__host__ __device__ __forceinline__ int bterm_list_cap(int B, int T, int bt) {
    return min(T, (B + bt - 1) / bt);
}

// Run by the first warp (its `lanes` threads, all of the block's if
// fewer than 32): the entries [lo, hi) of tile line `line` in the list
// sorted by `major`.  Each round probes `lanes` pivots of the remaining
// range for both bounds at once and keeps the interval that holds each.
__device__ __forceinline__ void warp_line_range(const int* __restrict__ major,
                                                int T, int line, int lanes,
                                                unsigned mask, int& lo,
                                                int& hi) {
    const int lane = threadIdx.x & 31;
    int a[2] = {0, 0}, b[2] = {T, T};
    while (b[0] - a[0] > lanes || b[1] - a[1] > lanes) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int n = b[s] - a[s];
            if (n <= lanes) continue;                 // uniform
            auto pivot = [&](int t) {
                return a[s] + static_cast<int>((int64_t)(t + 1) * n /
                                               (lanes + 1));
            };
            const int cnt = __popc(__ballot_sync(
                mask, major[pivot(lane)] < line + s));
            const int na = cnt ? pivot(cnt - 1) + 1 : a[s];
            b[s] = cnt < lanes ? pivot(cnt) : b[s];
            a[s] = na;
        }
    }
    int res[2];
#pragma unroll
    for (int s = 0; s < 2; ++s)
        res[s] = a[s] + __popc(__ballot_sync(
            mask, a[s] + lane < b[s] && major[a[s] + lane] < line + s));
    lo = res[0];
    hi = res[1];
}

__global__ void __launch_bounds__(kBtRows * kBtMaxQuads)
bsp_bwd_bterm(const float* __restrict__ P, const float* __restrict__ W,
              const int* __restrict__ crows, const int* __restrict__ ccols,
              const int* __restrict__ cvalid, int B, int C, int T, int bt,
              int vec_w, int vec_p, float* __restrict__ bterm) {
    extern __shared__ __align__(16) float ring[];
    __shared__ int n_tiles;
    const int quads = blockDim.x / kBtRows;
    const int z = blockIdx.z, i0 = blockIdx.x * kBtRows;
    const int c0 = blockIdx.y * 4 * kBtMaxQuads;
    const int tid = threadIdx.x, r = tid / quads, q = tid - r * quads;
    const int nt = (B + bt - 1) / bt;
    const int stage_floats = bterm_stage_floats(quads);
    // The strip's valid tile rows, in list order.
    const int cap = bterm_list_cap(B, T, bt);
    int* jts = reinterpret_cast<int*>(ring + kBtStages * stage_floats);
    P += (int64_t)z * B * C;
    W += (int64_t)z * B * B;
    bterm += (int64_t)z * B * C;
    crows += (int64_t)z * T;
    ccols += (int64_t)z * T;
    cvalid += (int64_t)z * T;

    if (tid < 32) {
        const int lanes = min(32, static_cast<int>(blockDim.x));
        const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1;
        const int lane = tid;
        int lo, hi, n = 0;
        warp_line_range(ccols, T, i0 / bt, lanes, mask, lo, hi);
        for (int e0 = lo; e0 < hi; e0 += lanes) {
            const int e = e0 + lane;
            const int jt = e < hi ? crows[e] : -1;
            const bool ok = e < hi && cvalid[e] == 1 && jt >= 0 && jt < nt;
            const unsigned m = __ballot_sync(mask, ok);
            const int at = n + __popc(m & ((1u << lane) - 1));
            if (ok && at < cap) jts[at] = jt;   // more: a tile listed twice
            n += __popc(m);
        }
        if (lane == 0) n_tiles = min(n, cap);
    }
    __syncthreads();
    const int n = n_tiles;

    // The strip's pieces in order: rows [j0, j0 + 32) of the tile that
    // ends at j1.  Uniform across the block.
    int u = 0, j0 = 0, j1 = 0;
    auto next_piece = [&](int& pj0, int& pj1) -> bool {
        if (j0 >= j1) {
            if (u >= n) return false;
            j0 = jts[u++] * bt;
            j1 = min(j0 + bt, B);
        }
        pj0 = j0;
        pj1 = j1;
        j0 += kBtPiece;
        return true;
    };
    auto load_piece = [&](int stage, int pj0, int pj1) {
        float* Ws = ring + stage * stage_floats;     // [kBtPiece][kBtRows]
        float* Ps = Ws + kBtPiece * kBtRows;         // [kBtPiece][4*quads]
        if (vec_w) {
            for (int e = tid; e < kBtPiece * 2; e += blockDim.x) {
                const int jj = e >> 1, ii = (e & 1) * 4;
                const bool ok = pj0 + jj < pj1 && i0 + ii < B;
                cp_async16(Ws + jj * kBtRows + ii,
                           ok ? W + (int64_t)(pj0 + jj) * B + i0 + ii : W,
                           ok ? 16 : 0);
            }
        } else {
            for (int e = tid; e < kBtPiece * kBtRows; e += blockDim.x) {
                const int jj = e >> 3, ii = e & (kBtRows - 1);
                const bool ok = pj0 + jj < pj1 && i0 + ii < B;
                cp_async4(Ws + e,
                          ok ? W + (int64_t)(pj0 + jj) * B + i0 + ii : W,
                          ok ? 4 : 0);
            }
        }
        const int cq = c0 + 4 * q;
#pragma unroll
        for (int m = 0; m < kBtPiece / kBtRows; ++m) {
            const int jj = r + m * kBtRows;
            const bool row_ok = pj0 + jj < pj1;
            const float* src = P + (int64_t)(pj0 + jj) * C + cq;
            float* dst = Ps + jj * 4 * quads + 4 * q;
            if (vec_p) {
                const bool ok = row_ok && cq < C;
                cp_async16(dst, ok ? src : P, ok ? 16 : 0);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool ok = row_ok && cq + e < C;
                    cp_async4(dst + e, ok ? src + e : P, ok ? 4 : 0);
                }
            }
        }
    };

    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int issued = 0, pj0, pj1;
    for (int s = 0; s < kBtStages - 1; ++s) {
        if (next_piece(pj0, pj1)) load_piece(issued++ % kBtStages, pj0, pj1);
        cp_async_commit();
    }
    for (int it = 0; it < issued; ++it) {
        cp_async_wait<kBtStages - 2>();
        __syncthreads();   // piece `it` landed; stage (it - 1) % S is free
        if (next_piece(pj0, pj1)) load_piece(issued++ % kBtStages, pj0, pj1);
        cp_async_commit();
        const float* Ws = ring + (it % kBtStages) * stage_floats + r;
        const float4* Ps = reinterpret_cast<const float4*>(
            ring + (it % kBtStages) * stage_floats + kBtPiece * kBtRows) + q;
        // Eight j at a time: every shared-memory read first, into
        // registers of their own, then the FMAs.
#pragma unroll
        for (int j8 = 0; j8 < kBtPiece; j8 += 8) {
            float w[8];
            float4 pv[8];
#pragma unroll
            for (int v = 0; v < 8; ++v) {
                w[v] = Ws[(j8 + v) * kBtRows];
                pv[v] = Ps[(j8 + v) * quads];
            }
#pragma unroll
            for (int v = 0; v < 8; ++v) {
                acc[0] = fmaf(w[v], pv[v].x, acc[0]);
                acc[1] = fmaf(w[v], pv[v].y, acc[1]);
                acc[2] = fmaf(w[v], pv[v].z, acc[2]);
                acc[3] = fmaf(w[v], pv[v].w, acc[3]);
            }
        }
    }
    const int i = i0 + r;
    if (i >= B) return;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int c = c0 + 4 * q + e;
        if (c < C) bterm[(int64_t)i * C + c] = acc[e];
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

// Dynamic shared memory of one K5 launch: the cp.async ring (kBtStages
// stages of 32 W rows x (8 columns + the class chunk)) and the strip's
// compacted tile list.
int graph_reg_bsp_bterm_smem(int B, int C, int T, int bt) {
    const int quads = min((C + 3) / 4, kBtMaxQuads);
    return static_cast<int>(sizeof(float) * kBtStages *
                                bterm_stage_floats(quads) +
                            sizeof(int) * bterm_list_cap(B, T, bt));
}

int graph_reg_bsp_bterm(const void* p, const void* W, const void* crows,
                        const void* ccols, const void* cvalid, int k, int B,
                        int C, int T, int bt, void* bterm, void* stream) {
    if (bad_tile_edge(bt)) return static_cast<int>(cudaErrorInvalidValue);
    const int chunks = (C + 4 * kBtMaxQuads - 1) / (4 * kBtMaxQuads);
    const int quads = min((C + 3) / 4, kBtMaxQuads);
    const size_t smem = graph_reg_bsp_bterm_smem(B, C, T, bt);
    const cudaError_t err = allow_dynamic_smem<bsp_bwd_bterm>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // 16-byte copies need 16-byte rows: B (resp. C) a multiple of 4 and
    // an aligned base; the worker strides B*B and B*C then keep it.
    const int vec_w = B % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
    const int vec_p = C % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    const dim3 grid((B + kBtRows - 1) / kBtRows, chunks, k);
    bsp_bwd_bterm<<<grid, kBtRows * quads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(W),
        static_cast<const int*>(crows), static_cast<const int*>(ccols),
        static_cast<const int*>(cvalid), B, C, T, bt, vec_w, vec_p,
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
