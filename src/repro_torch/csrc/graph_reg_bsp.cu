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
// of K4, K5 or K6 owns rows of one tile line (bt must be a multiple of
// 32), its first warp finds the line's entries in the sorted major
// coordinate and compacts their valid tiles, in list order, into shared
// memory (compact_line), and the block walks them in that order; entries
// with valid=0 (sentinels and tail padding) add nothing.  Inside an entry
// the sums run in the dense kernels' orders: K4 is K1's pipeline over the
// listed tiles' 64-column pieces and K6 the A half of K2's over their
// 32-j pieces, K5 runs j increasing as K2's W^T P.  K7 reads no list: it
// is K3's dW tile over the dense output's 64 x 128 pieces, masked by occ
// (dw_tile; all three shared bodies are in graph_reg_tiles.cuh).  So on a
// full mask with bt a multiple of 64 K4 equals K1, K5∘K6 equals K2 and K7
// equals K3 bit for bit (K7 at any bt).  K4 and K6 read a class-padded
// copy of logP that their entry points write into a workspace the caller
// allocates (graph_reg_bsp_fwd_workspace / graph_reg_bsp_dlogp_workspace).
// No float atomics: every output element and partial has one writer, and
// repeats are bit-identical.

#include "cp_async.cuh"
#include "dynamic_smem.cuh"
#include "graph_reg_tiles.cuh"

namespace {

// K4, pass 1: K1's pipeline (fwd_partials) over the listed tiles of the
// block's tile row, in list order.  A block holds `pairs` warps of one
// tile row (blockIdx.x = tile row * groups + group); the launch takes the
// most warps a block (a power of two, at most 8) that still fill every
// SM once: 16 rows at the path's shape (k = 1, B = 2176, bt = 128), 136
// blocks.  No block splits a chain, so a tile row with many listed tiles
// takes its blocks longer than one with few.  In development runs on an
// H100 blocks of 8 or 4 rows (twice or four times the SMs) and of 32 ran
// slower, and a fourth ring stage gained nothing.
//
// What bounds it: the listed tiles' W and logP (4.3 MB at the path's
// shape, 60 of 289 tiles: 1.3 us) and 2*C flops per listed entry of W (77
// MFLOP, 1.1 us).  Pass 2 is reg_fwd_tree_sum, as K1's.  As K1's, its
// launch bounds promise one block an SM (at 128 registers it spills).
__global__ void __launch_bounds__(32 * kFwdMaxPairs, 1)
bsp_fwd_partials(const float* __restrict__ P, const float* __restrict__ L,
                 const float* __restrict__ L4, const float* __restrict__ W,
                 const int* __restrict__ rows, const int* __restrict__ cols,
                 const int* __restrict__ valid, int B, int C, int T, int bt,
                 float gc, float kappa, float ge, int vec_w,
                 float* __restrict__ partials) {
    fwd_partials<true, true>(P, L, L4, W, rows, cols, valid, T, bt, B, C, gc,
                             kappa, ge, vec_w, partials);
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
// * warp 0 finds the strip's [lo, hi) with a pivot per lane a round and
//   compacts the valid entries' tile rows, in list order, into shared
//   memory (compact_line): the pipeline reads no index from global
//   memory;
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
    const int cap = list_cap(B, T, bt);
    int* jts = reinterpret_cast<int*>(ring + kBtStages * stage_floats);
    P += (int64_t)z * B * C;
    W += (int64_t)z * B * B;
    bterm += (int64_t)z * B * C;
    crows += (int64_t)z * T;
    ccols += (int64_t)z * T;
    cvalid += (int64_t)z * T;

    if (tid < 32)
        compact_line(ccols, crows, cvalid, T, i0 / bt, nt, cap, jts,
                     &n_tiles, nullptr);
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

// K6: K2's block 0 (the A half of its pipeline, graph_reg_tiles.cuh)
// without the cluster, over the 32-j pieces of the listed tiles of the
// block's tile row in list order, with K5's bterm in place of K2's W^T P.
// Its bits: A = W logP and each row's degree are each one chain in
// increasing j over the listed tiles in list order (zeros past a tile's
// end), from +0, and the epilogue is K2's expression.
//
// What bounds it: the listed tiles' W and logP (3.9 MB at the path's
// shape: 1.2 us) and 2*C flops per listed entry of W (1.1 us); in
// practice the latency of each row's serial chain over its tile row's
// pieces.  The design:
//
// * one block per (rows of one tile row, class chunk of up to 128,
//   worker): the most rows (a multiple of 4, at most kDlMaxRows) that
//   still fill every SM once; 16 at the path's shape, 136 blocks of 80
//   threads;
// * a thread owns 2 rows x 4 classes of a class chunk of C rounded up to
//   4 (40 at C = 39, not 64), read from the class-padded logP;
// * the pieces stream through a ring of kBsDlStages cp.async stages of
//   16-byte copies (W's rows swizzled as K2's, dl_swz), so the loads of
//   the next piece are in flight while one is summed (two stages, as K2's
//   ring: in development runs on an H100 three, four and eight stages
//   ran slower, and so did blocks of 8 or 32 rows); the degrees come from
//   the same W reads, in warp 0.
constexpr int kBsDlStages = 2;   // depth of K6's cp.async ring

__global__ void __launch_bounds__(kDlMaxThreads)
bsp_bwd_dlogp(const float* __restrict__ P, const float* __restrict__ L,
              const float* __restrict__ L4, const float* __restrict__ W,
              const float* __restrict__ bterm, const float* __restrict__ g,
              const int* __restrict__ rows_l, const int* __restrict__ cols_l,
              const int* __restrict__ valid_l, int B, int C, int T, int bt,
              float gc, float kappa, float ge, int vec_w,
              float* __restrict__ dlogp) {
    extern __shared__ __align__(16) float ring[];
    __shared__ int n_tiles;
    const int quads = dl_quads(C), width = 4 * quads, C4 = pad4(C);
    const int pairs = blockDim.x / quads, rows = 2 * pairs;
    const int tid = threadIdx.x, rp = tid % pairs, q = tid / pairs;
    const int groups = (bt + rows - 1) / rows;
    const int line = blockIdx.x / groups;
    const int i0 = line * bt + (blockIdx.x - line * groups) * rows;
    const int row_end = min(line * bt + bt, B);
    if (i0 >= row_end) return;   // the last tile row's rest
    const int z = blockIdx.z, c0 = blockIdx.y * 4 * kDlMaxQuads;
    const int stage_floats = dl_stage_floats(rows, quads);
    int* list = reinterpret_cast<int*>(ring + kBsDlStages * stage_floats);
    P += (int64_t)z * B * C;
    L += (int64_t)z * B * C;
    L4 += (int64_t)z * B * C4;
    W += (int64_t)z * B * B;
    bterm += (int64_t)z * B * C;
    dlogp += (int64_t)z * B * C;
    const float gz = g[z];
    if (tid < 32)
        compact_line(rows_l + (int64_t)z * T, cols_l + (int64_t)z * T,
                     valid_l + (int64_t)z * T, T, line, (B + bt - 1) / bt,
                     list_cap(B, T, bt), list, &n_tiles, nullptr);
    __syncthreads();
    const int n = n_tiles;

    // The line's pieces in order: j0 .. j0 + 32 of the tile that ends at
    // j1.  Uniform across the block.
    int u = 0, pj = 0, pend = 0;
    auto next_piece = [&](int& j0, int& j1) -> bool {
        if (pj >= pend) {
            if (u >= n) return false;
            pj = list[u++] * bt;
            pend = min(pj + bt, B);
        }
        j0 = pj;
        j1 = pend;
        pj += kDlPiece;
        return true;
    };
    const Walk walk_w4(tid, blockDim.x, kDlPiece / 4);   // (row, j quad)
    const Walk walk_w(tid, blockDim.x, kDlPiece);        // (row, j)
    const Walk walk_v(tid, blockDim.x, quads);           // (j, class quad)
    auto load_piece = [&](int stage, int j0, int j1) {
        float* Ws = ring + stage * stage_floats;   // rows x 32 floats
        dl_load_rows(Ws, W, B, i0, row_end, j0, j1, rows, vec_w, walk_w4,
                     walk_w);
        dl_load_v(Ws + kDlPiece * rows, L4, C4, j0, j1, c0, width, walk_v);
    };

    float acc[2][4] = {}, deg[2] = {0.f, 0.f};
    int issued = 0, j0, j1;
    for (int s = 0; s < kBsDlStages - 1; ++s) {
        if (next_piece(j0, j1)) load_piece(issued++ % kBsDlStages, j0, j1);
        cp_async_commit();
    }
    for (int it = 0; it < issued; ++it) {
        cp_async_wait<kBsDlStages - 2>();
        __syncthreads();   // piece it landed; piece it - 1's slot is free
        if (next_piece(j0, j1)) load_piece(issued++ % kBsDlStages, j0, j1);
        cp_async_commit();
        const float* Ws = ring + (it % kBsDlStages) * stage_floats;
        const float4* vv = reinterpret_cast<const float4*>(
            Ws + kDlPiece * rows) + q;
        // The degree threads (q = 0: threads 0 .. pairs - 1) are all in
        // warp 0; the other warps skip the degree adds.
        if (tid < 32)
            dl_piece<true, true>(Ws, vv, rows, rp, quads, acc, deg);
        else
            dl_piece<true, false>(Ws, vv, rows, rp, quads, acc, deg);
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free: the degrees
    float* degs = ring;   // [rows]
    if (q == 0) {
        degs[2 * rp] = deg[0];
        degs[2 * rp + 1] = deg[1];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int i = i0 + 2 * rp + r;
        if (i >= row_end) continue;
        const float coef = kappa + ge * degs[2 * rp + r];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int cc = c0 + 4 * q + e;
            if (cc >= C) continue;
            const int64_t at = (int64_t)i * C + cc;
            const float p = P[at];
            dlogp[at] = gz * (-gc * (p * acc[r][e] + bterm[at])
                              + coef * p * (L[at] + 1.f));
        }
    }
}

// K7: K3's dw_tile (graph_reg_tiles.cuh) over the 64 x 128 pieces of
// worker z's dW, each element kept where its tile is occupied and zero
// elsewhere; a piece that touches no occupied tile stores its zeros and
// nothing else.  Pieces run in row-major order (x = column piece), so a
// tile row's live and dead pieces are spread over consecutive blocks.  At
// the path's shape (k = 1, B = 2176, bt = 128) 120 of the 578 pieces are
// live (60 of 289 tiles occupied, two pieces a tile); the floor is the
// dense output's 18.9 MB of stores.
__global__ void __launch_bounds__(kThreads, 3)
bsp_bwd_dw(const float* __restrict__ P, const float* __restrict__ L,
           const int* __restrict__ occ, const float* __restrict__ g,
           int B, int C, int bt, float gc, float ge, int vec,
           float* __restrict__ dW) {
    const int z = blockIdx.z, nt = (B + bt - 1) / bt;
    dw_tile(P + (int64_t)z * B * C, L + (int64_t)z * B * C, g[z], B, C, gc,
            ge, vec, DwOccupied{occ + (int64_t)z * nt * nt, nt, bt},
            dW + (int64_t)z * B * B);
}

// A block's rows lie in one tile row, in whole 32-row strips (K4's
// chains): the tile edge must be a positive multiple of 32.
bool bad_tile_edge(int bt) { return bt <= 0 || bt % 32 != 0; }

}  // namespace

extern "C" {

// Floats of a K4 launch's workspace: pass 1's partials, one per thread of
// each worker's 32-row strips, then the class-padded copy of logP, k * B *
// C4 floats (C4 = C rounded up to 4); K1's sizes.
int graph_reg_bsp_fwd_workspace(int k, int B, int C) {
    return fwd_n_partials(k, B) + k * B * pad4(C);
}

// Rows per block and dynamic shared memory (bytes) of a K4 launch: blocks
// of a power of two of warps (4 rows each, at most kFwdMaxPairs), the
// most that still fill every SM once with k * nt * (bt / 4 / pairs)
// blocks; the ring, P's rows and the compacted tile list.
int graph_reg_bsp_fwd_plan(int k, int B, int C, int T, int bt, int* rows,
                           int* smem) {
    if (k < 1 || B < 1 || C < 1 || T < 0 || bad_tile_edge(bt))
        return static_cast<int>(cudaErrorInvalidValue);
    int n_sm = 0;
    const cudaError_t err = sm_count(&n_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t lines = (int64_t)k * ((B + bt - 1) / bt);
    int pairs = kFwdMaxPairs;
    while (pairs > 1 && lines * (bt / 4 / pairs) < n_sm) pairs /= 2;
    *rows = 4 * pairs;
    *smem = static_cast<int>(sizeof(float)) * fwd_smem_floats(*rows, C)
            + static_cast<int>(sizeof(int)) * list_cap(B, T, bt);
    return 0;
}

// workspace holds graph_reg_bsp_fwd_workspace(k, B, C) floats, 16-byte
// aligned; out holds k floats.
int graph_reg_bsp_fwd(const void* p, const void* logp, const void* W,
                      const void* rows, const void* cols, const void* valid,
                      int k, int B, int C, int T, int bt, float gc,
                      float kappa, float ge, void* workspace, void* out,
                      void* stream) {
    int rows_pb = 0, smem = 0;
    int rc = graph_reg_bsp_fwd_plan(k, B, C, T, bt, &rows_pb, &smem);
    if (rc != 0) return rc;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* partials = static_cast<float*>(workspace);
    float* L4 = partials + fwd_n_partials(k, B);
    rc = launch_pad(static_cast<const float*>(logp), nullptr, (int64_t)k * B,
                    C, L4, nullptr, s);
    if (rc != 0) return rc;
    const int pairs = rows_pb / 4, nt = (B + bt - 1) / bt;
    // 16-byte copies of W's rows need B a multiple of 4 and W aligned.
    const int vec_w = B % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
    cudaError_t err = allow_dynamic_smem<bsp_fwd_partials>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    bsp_fwd_partials<<<dim3(nt * (bt / 4 / pairs), 1, k), 32 * pairs, smem,
                       s>>>(
        static_cast<const float*>(p), static_cast<const float*>(logp), L4,
        static_cast<const float*>(W), static_cast<const int*>(rows),
        static_cast<const int*>(cols), static_cast<const int*>(valid), B, C,
        T, bt, gc, kappa, ge, vec_w, partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    reg_fwd_tree_sum<<<k, kSumThreads, 0, s>>>(partials, (B + 31) / 32,
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
                            sizeof(int) * list_cap(B, T, bt));
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

// Floats of a K6 launch's workspace: the class-padded copy of logP, k * B
// * C4 floats.
int graph_reg_bsp_dlogp_workspace(int k, int B, int C) {
    return k * B * pad4(C);
}

// Rows per block and dynamic shared memory (bytes) of a K6 launch: the
// most rows (a multiple of 4, at most kDlMaxRows, bt and what
// kDlMaxThreads threads hold) that still fill every SM once with k *
// class chunks * nt * ceil(bt / rows) blocks; the ring and the compacted
// tile list.
int graph_reg_bsp_dlogp_plan(int k, int B, int C, int T, int bt, int* rows,
                             int* smem) {
    if (k < 1 || B < 1 || C < 1 || T < 0 || bad_tile_edge(bt))
        return static_cast<int>(cudaErrorInvalidValue);
    int n_sm = 0;
    const cudaError_t err = sm_count(&n_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int quads = dl_quads(C);
    const int n_chunks = (C + 4 * kDlMaxQuads - 1) / (4 * kDlMaxQuads);
    const int64_t lines = (int64_t)k * n_chunks * ((B + bt - 1) / bt);
    const int fit = 2 * (kDlMaxThreads / quads);
    int r = min(min(fit, kDlMaxRows), bt) & ~3;
    while (r > 4 && lines * ((bt + r - 1) / r) < n_sm) r -= 4;
    *rows = r;
    *smem = static_cast<int>(sizeof(float)) * kBsDlStages
            * dl_stage_floats(r, quads)
            + static_cast<int>(sizeof(int)) * list_cap(B, T, bt);
    return 0;
}

// workspace holds graph_reg_bsp_dlogp_workspace(k, B, C) floats, 16-byte
// aligned; dlogp is the (k, B, C) output.
int graph_reg_bsp_dlogp(const void* p, const void* logp, const void* W,
                        const void* bterm, const void* g, const void* rows,
                        const void* cols, const void* valid, int k, int B,
                        int C, int T, int bt, float gc, float kappa, float ge,
                        void* workspace, void* dlogp, void* stream) {
    int rows_pb = 0, smem = 0;
    int rc = graph_reg_bsp_dlogp_plan(k, B, C, T, bt, &rows_pb, &smem);
    if (rc != 0) return rc;
    const cudaError_t err = allow_dynamic_smem<bsp_bwd_dlogp>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* L4 = static_cast<float*>(workspace);
    rc = launch_pad(static_cast<const float*>(logp), nullptr, (int64_t)k * B,
                    C, L4, nullptr, s);
    if (rc != 0) return rc;
    const int quads = dl_quads(C);
    const int n_chunks = (C + 4 * kDlMaxQuads - 1) / (4 * kDlMaxQuads);
    const int nt = (B + bt - 1) / bt;
    // 16-byte copies of W need B a multiple of 4 and W aligned (each
    // piece starts at a multiple of 32 columns).
    const int vec_w = B % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
    bsp_bwd_dlogp<<<dim3(nt * ((bt + rows_pb - 1) / rows_pb), n_chunks, k),
                    rows_pb / 2 * quads, smem, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(logp), L4,
        static_cast<const float*>(W), static_cast<const float*>(bterm),
        static_cast<const float*>(g), static_cast<const int*>(rows),
        static_cast<const int*>(cols), static_cast<const int*>(valid), B, C,
        T, bt, gc, kappa, ge, vec_w, static_cast<float*>(dlogp));
    return static_cast<int>(cudaGetLastError());
}

int graph_reg_bsp_dw(const void* p, const void* logp, const void* occ,
                     const void* g, int k, int B, int C, int bt, float gc,
                     float ge, void* dW, void* stream) {
    if (bad_tile_edge(bt)) return static_cast<int>(cudaErrorInvalidValue);
    // 16-byte stores need 16-byte rows: B a multiple of 4 and dW aligned.
    const int vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(dW) % 16 == 0;
    const dim3 grid((B + kDwCols - 1) / kDwCols, (B + kDwRows - 1) / kDwRows,
                    k);
    bsp_bwd_dw<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(logp),
        static_cast<const int*>(occ), static_cast<const float*>(g), B, C, bt,
        gc, ge, vec, static_cast<float*>(dW));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

namespace {

// The kernels graph_reg_bsp_occupancy answers for, by index: the order of
// graph_reg_bsp.OCCUPANCY_KERNELS.
const OccupancyQuery kOccupancy[] = {
    occupancy<bsp_fwd_partials>,
    occupancy<bsp_bwd_bterm>,
    occupancy<bsp_bwd_dlogp>,
    occupancy<bsp_bwd_dw>,
};

}  // namespace

extern "C" {

// Blocks an SM holds at once of entry `kernel` of kOccupancy, launched
// with `threads` threads and `smem` bytes of dynamic shared memory, and
// the kernel's registers a thread and static shared memory, as the
// runtime reads them.
int graph_reg_bsp_occupancy(int kernel, int threads, int smem, int* blocks,
                            int* registers, int* static_smem) {
    return occupancy_of(kOccupancy, kernel, threads, smem, blocks, registers,
                        static_smem);
}

}  // extern "C"
