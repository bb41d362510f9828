// Device code shared by the graph-regularizer kernels, the dense ones
// (graph_reg.cu, K1-K3 and K10) and the block-sparse ones
// (graph_reg_bsp.cu, K4-K7):
//
//   * the dW tile (dw_tile), one template for K3 over every 64 x 128
//     piece of the output and K7 over the pieces that touch an occupied
//     tile;
//   * the class padding (pad_classes) of the pipelines' inputs;
//   * K1's pipeline (fwd_partials), which K10 runs without its degree
//     terms and K4 over a strip's listed column tiles, and its second
//     pass (reg_fwd_tree_sum);
//   * the A half of K2's pipeline (dl_load_rows, dl_load_v, dl_piece),
//     which K6 runs over a strip's listed column tiles;
//   * the compaction of a tile line's listed entries (compact_line), by
//     which K4, K5 and K6 find the tiles they walk.
//
// So on a full occupancy mask (bt a multiple of 64) K4 equals K1, K5∘K6
// equals K2 and K7 equals K3 bit for bit: the same sums in the same
// orders.
//
// Padding is done with masks, never with values: rows, columns and classes
// outside (B, B, C) are loaded as 0 for p, logp and W alike, so they drop
// out of every product (exp() of a padded logp is never taken).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps

__device__ __forceinline__ float warp_sum(float v) {
    // Fixed butterfly order: deterministic, every lane ends with the sum.
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
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

// Cell (a, b) of a row-major (n_a x nb) grid, visited at e = start,
// start + step, ...: each next cell from the last one without a division.
struct Walk {
    int a, b, da, db, nb;
    __device__ Walk(int start, int step, int nb_)
        : a(start / nb_), b(start % nb_), da(step / nb_), db(step % nb_),
          nb(nb_) {}
    __device__ __forceinline__ void next() {
        a += da;
        b += db;
        if (b >= nb) { b -= nb; ++a; }
    }
};

// Rows of C floats copied to rows of C4 = C rounded up to 4, zero-filled:
// the class-padded copies of logP (K1, K4, K6, K10) and of P (K2) that
// the pipelines read with 16-byte copies.  C = 39 rows are 156 bytes,
// not a multiple of 16; 4-byte copies of them cost more than the padding.
__host__ __device__ __forceinline__ int pad4(int C) { return (C + 3) / 4 * 4; }

// Grid dimension y picks the source: X (y = 0) or Y (y = 1).
__global__ void __launch_bounds__(kThreads)
pad_classes(const float* __restrict__ X, const float* __restrict__ Y,
            int64_t rows, int C, float* __restrict__ outX,
            float* __restrict__ outY) {
    const float* src = blockIdx.y ? Y : X;
    float4* out = reinterpret_cast<float4*>(blockIdx.y ? outY : outX);
    const int q4 = pad4(C) / 4;
    const int64_t n = rows * q4;
    for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
         e += (int64_t)gridDim.x * blockDim.x) {
        const int64_t r = e / q4;
        const int c = 4 * static_cast<int>(e - r * q4);
        const float* x = src + r * C + c;
        float4 v;
        v.x = c < C ? x[0] : 0.f;
        v.y = c + 1 < C ? x[1] : 0.f;
        v.z = c + 2 < C ? x[2] : 0.f;
        v.w = c + 3 < C ? x[3] : 0.f;
        out[e] = v;
    }
}

// Pads X into outX and, where Y is given, Y into outY, in one launch.
inline int launch_pad(const float* X, const float* Y, int64_t rows, int C,
                      float* outX, float* outY, cudaStream_t s) {
    const int64_t n = rows * (pad4(C) / 4);
    const int blocks = static_cast<int>((n + kThreads - 1) / kThreads < 512
                                        ? (n + kThreads - 1) / kThreads
                                        : 512);
    pad_classes<<<dim3(blocks, Y ? 2 : 1), kThreads, 0, s>>>(X, Y, rows, C,
                                                           outX, outY);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The dW tile (dw_tile): K3 and K7.
//
// dW = -g*(gc*P logP^T + ge*H(p) 1^T), (B, B) per worker, written once;
// K7 writes it on the tiles its occupancy mask marks and exact zeros
// elsewhere.  The time goes to staging P and logP, the product loop and
// the B*B stores; the design keeps each small:
//
// * one block per (64 x 128 output piece, worker): 578 blocks at the
//   path's B = 2176, three resident per SM (at most 85 registers a
//   thread); 256 threads, each with a 4 x 8 register tile (rows ty*4..,
//   columns tx*4.. and 64+tx*4..);
// * the piece's P and logP rows (and logP of its columns) are staged once
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
// The occupancy predicate decides per piece and per element.  DwDense
// (K3) takes everything, and the compiler drops its tests.  DwOccupied
// (K7) reads the mask: a piece that touches no occupied tile (the same
// test in every thread, so the block takes one branch) stages nothing,
// computes no entropy and stores zeros through the same stores; a live
// piece runs the whole body and zeroes each thread's values whose tile is
// not occupied (a thread's 4 rows lie in one tile row and each of its two
// 4-column groups in one tile column, bt being a multiple of 32; at bt =
// 32 a piece spans 2 x 4 tiles).
//
// Each S element starts at +0 and adds fmaf(P[i,c], logP[j,c], acc) in
// increasing c (zero-filled classes past C add exact zeros), then
// -gz*(gc*acc + ge*h), so K7 equals K3 bit for bit on a full mask.  Bound
// by bytes (the B*B output) and, about equally for K3, by the 2*B*B*C
// flops; no tensor cores, which would change the sum's order, and no
// atomics.
constexpr int kDwRows = 64, kDwCols = 128, kDwK = 40;

// Column of element (row, k) in a class-major swizzled tile: 4-float
// groups XORed with k mod 8.
__device__ __forceinline__ int dw_swz(int row, int k) {
    return ((((row >> 2) ^ (k & 7))) << 2) | (row & 3);
}

struct DwDense {
    __device__ bool piece(int, int, int) const { return true; }
    __device__ bool at(int, int) const { return true; }
};

// One worker's (nt, nt) occupancy mask, nt = ceil(B / bt).
struct DwOccupied {
    const int* __restrict__ occ;
    int nt, bt;
    // Whether the piece at (i0, j0) touches an occupied tile.
    __device__ bool piece(int i0, int j0, int B) const {
        const int ti1 = (min(i0 + kDwRows, B) - 1) / bt;
        const int tj1 = (min(j0 + kDwCols, B) - 1) / bt;
        bool live = false;
        for (int ti = i0 / bt; ti <= ti1; ++ti)
            for (int tj = j0 / bt; tj <= tj1; ++tj)
                live |= occ[ti * nt + tj] == 1;
        return live;
    }
    // Whether element (i, j), i, j < B, lies on an occupied tile.
    __device__ bool at(int i, int j) const {
        return occ[(i / bt) * nt + j / bt] == 1;
    }
};

// The block's piece of worker z's dW (blockIdx = (column piece, row
// piece, worker)); P, L and dW already point at worker z's rows.
template <class Occ>
__device__ __forceinline__ void dw_tile(
        const float* __restrict__ P, const float* __restrict__ L, float gz,
        int B, int C, float gc, float ge, int vec, const Occ& occ,
        float* __restrict__ dW) {
    __shared__ __align__(16) float Ps[kDwK][kDwRows];   // P[i0 + i, c]
    __shared__ __align__(16) float Li[kDwK][kDwRows];   // logP[i0 + i, c]
    __shared__ __align__(16) float Ls[kDwK][kDwCols];   // logP[j0 + j, c]
    __shared__ float Hs[kDwRows];
    const int i0 = blockIdx.y * kDwRows, j0 = blockIdx.x * kDwCols;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int warp = tid >> 5, lane = tid & 31;
    const bool live = occ.piece(i0, j0, B);   // uniform across the block

    float acc[4][8] = {};
    if (live) {
        float hpart[kDwRows / 8] = {};   // warp w: rows 8w .. 8w+7
        // Staging lanes: 8 classes x 4 consecutive rows per warp
        // instruction.
        const int kk = lane >> 2, rq = lane & 3;
        for (int c0 = 0; c0 < C; c0 += kDwK) {
            const int kc = min(kDwK, C - c0);
            const int kpad = (kc + 7) & ~7;
            if (c0 > 0) __syncthreads();   // the previous chunk's reads
            // Every copy of the chunk in flight at once (cp.async, 4
            // bytes, zero-filled where masked), then one wait.
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
                              L + (ok ? (int64_t)j * C + c0 + k : 0),
                              ok ? 4 : 0);
                }
            }
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
            // The entropy terms of this chunk: lane's classes c = lane
            // (mod 32), increasing.
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
    }
    // Whether each of the thread's two 4-column groups is written with
    // values (its rows share one tile row).
    const int ib = i0 + ty * 4;
    bool on[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int j = j0 + half * 64 + tx * 4;
        on[half] = live && ib < B && j < B && occ.at(ib, j);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = ib + r;
        if (i >= B) continue;
        const float h = live ? Hs[ty * 4 + r] : 0.f;
        float* row = dW + (int64_t)i * B;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int j = j0 + half * 64 + tx * 4;
            float w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                w[e] = on[half] ? -gz * (gc * acc[r][4 * half + e] + ge * h)
                                : 0.f;
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

// ---------------------------------------------------------------------------
// The listed tiles of a tile line (K4, K5, K6).
//
// A layout's list is sorted by its major coordinate; an empty tile line
// carries one (line, 0, valid=0) sentinel, and tail padding repeats the
// last entry with valid=0 (core/metabatch.py).  The TPU kernels walk a
// list as one ordered grid; here each block finds its line's entries and
// walks them in list order, entries with valid=0 adding nothing.

// Entries of a line's compacted tile list: a layout lists each tile at
// most once, so a line holds at most nt valid entries (and at most T).
__host__ __device__ __forceinline__ int list_cap(int B, int T, int bt) {
    return min(T, (B + bt - 1) / bt);
}

// Run by the first warp (its `lanes` threads, all of the block's if
// fewer than 32): the entries [lo, hi) of tile line `line` in the list
// sorted by `major`.  Each round probes `lanes` pivots of the remaining
// range for both bounds at once and keeps the interval that holds each
// (two rounds for lists up to ~1,000 entries, where a binary search
// takes ~20 dependent loads).
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

// Run by the block's threads tid < 32 (all of them if fewer): writes the
// `minor` coordinates of line `line`'s valid entries (valid == 1, 0 <=
// minor < nt), in list order, into `list` (shared memory, at most cap of
// them; more only where a tile is listed twice), their count into *n and,
// where `listed` is given, whether the line has any entry, a sentinel
// included, into *listed.  The caller then syncs the block: the pipelines
// read no index from global memory.
__device__ __forceinline__ void compact_line(
        const int* __restrict__ major, const int* __restrict__ minor,
        const int* __restrict__ valid, int T, int line, int nt, int cap,
        int* list, int* n_out, int* listed) {
    const int lanes = min(32, static_cast<int>(blockDim.x));
    const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1;
    const int lane = threadIdx.x;
    int lo, hi, n = 0;
    warp_line_range(major, T, line, lanes, mask, lo, hi);
    for (int e0 = lo; e0 < hi; e0 += lanes) {
        const int e = e0 + lane;
        const int t = e < hi ? minor[e] : -1;
        const bool ok = e < hi && valid[e] == 1 && t >= 0 && t < nt;
        const unsigned m = __ballot_sync(mask, ok);
        const int at = n + __popc(m & ((1u << lane) - 1));
        if (ok && at < cap) list[at] = t;
        n += __popc(m);
    }
    if (lane == 0) {
        *n_out = min(n, cap);
        if (listed) *listed = lo < hi;
    }
}

// ---------------------------------------------------------------------------
// K1's pipeline (fwd_partials): K1, K10 (kFull = false) and K4 (kListed).
//
// The loss's bits are fixed by four orders, kept from the strip kernel K1
// replaced (one 256-thread block per 32-row strip, thread (ty, tx) owning
// rows ty + 8r and columns tx + 32c of each 32 x 64 tile):
//   * S_ij = sum_c P_ic logP_jc, one fmaf chain in increasing c from +0;
//   * thread (ty, tx)'s chain cross = fmaf(W_ij, S_ij, cross) and its
//     degrees deg[r] += W_ij over the strip's 64-column pieces in order,
//     then r, then c (i < B and j inside the piece only);
//   * per row, d = warp_sum over the 32 lanes' deg[r], h = row_entropy,
//     ent += (kappa + ge*d)*h at tx = 0 in r order; the thread's value is
//     -gc*cross - ent;
//   * a fixed tree over the strip's 256 values (levels s = 128, 64, ..,
//     1 add value t + s into value t for t < s; the strip kernel's
//     shared-memory block sum), then the strips in order from +0 (pass
//     2, reg_fwd_tree_sum).
// K1's pieces are B's 64-column tiles in order.  K4's are the listed
// column tiles of the strip's tile row, in list order, each cut into
// pieces of 64 columns (one of 32 at bt = 32; the last of a tile is
// shorter where bt is not a multiple of 64 or the tile ends at B); a
// strip with any entry, a sentinel included, owes its rows' entropy.  At
// bt a multiple of 64 on a full mask the two sequences are the same.
//
// Only the consumption of S by the chains has an order, so S may come
// from any layout.  The chains of one (strip, ty) pair touch four rows
// only, so a pair is one warp here, and a block holds `pairs` warps:
// pairs of consecutive index p = 8*strip + ty, rows 32*strip + ty + 8r.
// K4's blocks stay inside one tile row (pairs divides bt / 4), so all
// their warps walk the same pieces.
//
// Each block streams stages of two pieces (128 columns) of the
// class-padded logP (all their rows) and its rows' W through a ring of
// kFwdStages cp.async stages of 16-byte copies (classes in chunks of up
// to kFwdChunk; its rows of P are loaded once when C fits one chunk), so
// the next stages' copies are in flight while one is summed; columns past
// a piece are zero-filled by the copies.  A thread computes a 4 x 4 S
// tile, its columns tx + 32c of both pieces, from 16-byte reads (its
// rows' P broadcast, its logP rows padded to an odd number of 16-byte
// groups: conflict-free), 8 loads per 64 FMAs, then feeds its chain the
// first piece's values and then the second's.  Pass 1 writes every
// thread's value (fwd_n_partials: k * strips * 256 floats); pass 2
// applies that tree to each strip's 256 and adds the strips in order.
constexpr int kFwdTile = 64;      // columns per piece: the chains' order
constexpr int kFwdSpan = 128;     // columns per ring stage: two pieces
constexpr int kFwdChunk = 64;     // classes per ring stage
constexpr int kFwdStages = 3;     // depth of the cp.async ring
constexpr int kFwdMaxPairs = 8;   // warps per block

// Pass 1's partials: one per thread of each worker's 32-row strips.
__host__ __device__ __forceinline__ int fwd_n_partials(int k, int B) {
    return k * ((B + 31) / 32) * kThreads;
}

// Floats of a class-chunk row in shared memory: `width` (a multiple of 4)
// rounded up to an odd number of 16-byte groups.
__host__ __device__ __forceinline__ int fwd_stride(int width) {
    return 4 * ((width / 4) | 1);
}

// Class chunk width: C rounded up to 4, at most kFwdChunk.
__host__ __device__ __forceinline__ int fwd_width(int C) {
    const int c4 = (C + 3) / 4 * 4;
    return c4 < kFwdChunk ? c4 : kFwdChunk;
}

// Floats of one ring stage: logP of the stage's 128 columns and W[rows,
// stage], and P of the block's rows where C takes more than one chunk (one
// chunk of P is loaded once, beside the ring).
__host__ __device__ __forceinline__ int fwd_stage_floats(int rows, int C) {
    const int width = fwd_width(C), stride = fwd_stride(width);
    return kFwdSpan * stride + rows * kFwdSpan
           + (C > width ? rows * stride : 0);
}

// Floats of a pipeline's ring and P rows in dynamic shared memory (K4's
// compacted tile list follows them).
__host__ __device__ __forceinline__ int fwd_smem_floats(int rows, int C) {
    const int width = fwd_width(C);
    return kFwdStages * fwd_stage_floats(rows, C)
           + (C > width ? 0 : rows * fwd_stride(width));
}

// Row of the block's local row lr: pair p = first + lr / 4, r = lr % 4.
__device__ __forceinline__ int fwd_row(int first_pair, int lr) {
    const int p = first_pair + (lr >> 2);
    return 32 * (p >> 3) + (p & 7) + 8 * (lr & 3);
}

// Piece p of a block's sequence: its columns j0 .. j0 + kFwdTile that lie
// below jend.  K1 (kListed = false): the p-th 64 columns of B.  K4: piece
// p % ppt of tile tiles[p / ppt] of edge bt (ppt = ceil(bt / 64) pieces a
// tile, the last of them shorter where 64 does not divide bt; past B, or
// past the n_pieces of the list, a piece holds no column).  Stage s (its
// class chunks one ring step each) holds pieces 2s and 2s + 1: a tile of
// up to 128 columns, or two tiles of 64 or 32.
template <bool kListed>
__device__ __forceinline__ void fwd_piece(const int* tiles, int ppt, int bt,
                                          int B, int n_pieces, int p,
                                          int& j0, int& jend) {
    if (!kListed) {
        j0 = kFwdTile * p;
        jend = B;
    } else if (p < n_pieces) {
        const int u = p / ppt, m = kFwdTile * (p - u * ppt);
        const int t0 = tiles[u] * bt;
        j0 = t0 + m;
        jend = min(t0 + min(m + kFwdTile, bt), B);
    } else {
        j0 = jend = 0;
    }
}

// Pass 1 of K1 (kListed = false: every 64-column tile of B, blocks of
// `pairs` warps at consecutive pairs) and of K4 (kListed: the listed
// tiles of row-major list rows_l/cols_l/valid_l (T entries a worker) of
// edge bt, blocks of `pairs` warps of one tile row, blockIdx.x = tile row
// * (bt / 4 / pairs) + group).  kFull = false (K10) drops the degrees and
// entropies.  The block's warps are its pairs: blockDim.x = 32 * pairs.
template <bool kFull, bool kListed>
__device__ __forceinline__ void fwd_partials(
        const float* __restrict__ P, const float* __restrict__ L,
        const float* __restrict__ L4, const float* __restrict__ W,
        const int* __restrict__ rows_l, const int* __restrict__ cols_l,
        const int* __restrict__ valid_l, int T, int bt, int B, int C,
        float gc, float kappa, float ge, int vec_w,
        float* __restrict__ partials) {
    extern __shared__ __align__(16) float ring[];
    __shared__ int n_tiles, line_listed;
    const int tid = threadIdx.x, warp = tid >> 5, tx = tid & 31;
    const int pairs = blockDim.x / 32, rows = 4 * pairs;
    const int z = blockIdx.z;
    const int n_strips = (B + 31) / 32;
    int first = blockIdx.x * pairs, line = 0;
    if (kListed) {
        const int groups = bt / 4 / pairs;
        line = blockIdx.x / groups;
        first = line * (bt / 4) + (blockIdx.x - line * groups) * pairs;
        if (first >= 8 * n_strips) return;   // the last tile row's rest
    }
    const int pair = first + warp;
    const int width = fwd_width(C), stride = fwd_stride(width);
    const int n_chunks = (C + width - 1) / width;
    const int stage_floats = fwd_stage_floats(rows, C);
    const int C4 = pad4(C);
    P += (int64_t)z * B * C;
    L += (int64_t)z * B * C;
    L4 += (int64_t)z * B * C4;
    W += (int64_t)z * B * B;

    const bool p_once = n_chunks == 1;
    float* const P_once = ring + kFwdStages * stage_floats;   // [rows][stride]
    int* const tiles = reinterpret_cast<int*>(ring + fwd_smem_floats(rows, C));
    const Walk walk_l(tid, blockDim.x, width / 4);   // (stage column, quad)
    const Walk walk_p(tid, blockDim.x, width);     // (local row, class)
    const Walk walk_w(tid, blockDim.x, kFwdSpan);  // (local row, column)
    const Walk walk_w4(tid, blockDim.x, kFwdSpan / 4);   // (row, 4 columns)
    auto load_p = [&](float* Ps, int c0) {
        for (Walk w = walk_p; w.a < rows; w.next()) {
            const int i = fwd_row(first, w.a), c = c0 + w.b;
            const bool ok = i < B && c < C;
            cp_async4(Ps + w.a * stride + w.b,
                      P + (ok ? (int64_t)i * C + c : 0), ok ? 4 : 0);
        }
    };
    if (p_once) load_p(P_once, 0);   // in the first stage's group

    int ppt = 1, n_pieces = (B + kFwdTile - 1) / kFwdTile;
    if (kListed) {
        if (tid < 32)
            compact_line(rows_l + (int64_t)z * T, cols_l + (int64_t)z * T,
                         valid_l + (int64_t)z * T, T, line,
                         (B + bt - 1) / bt, list_cap(B, T, bt), tiles,
                         &n_tiles, &line_listed);
        __syncthreads();
        ppt = (bt + kFwdTile - 1) / kFwdTile;
        n_pieces = n_tiles * ppt;
    }
    const int n_stages = (n_pieces + 1) / 2 * n_chunks;
    // The two pieces of ring step s's stage.
    auto pieces_of = [&](int s, int& ja, int& ea, int& jb, int& eb) {
        const int span = s / n_chunks;
        fwd_piece<kListed>(tiles, ppt, bt, B, n_pieces, 2 * span, ja, ea);
        fwd_piece<kListed>(tiles, ppt, bt, B, n_pieces, 2 * span + 1, jb, eb);
    };
    auto load_stage = [&](int slot, int s) {
        int ja, ea, jb, eb;
        pieces_of(s, ja, ea, jb, eb);
        const int u = s - (s / n_chunks) * n_chunks;
        const int c0 = u * width;
        float* Ls = ring + slot * stage_floats;   // [128][stride]
        float* Ws = Ls + kFwdSpan * stride;       // [rows][128]
        for (Walk w = walk_l; w.a < kFwdSpan; w.next()) {
            const bool h = w.a >= kFwdTile;
            const int j = (h ? jb - kFwdTile : ja) + w.a, c = c0 + 4 * w.b;
            const bool ok = j < (h ? eb : ea) && c < C4;
            cp_async16(Ls + w.a * stride + 4 * w.b,
                       L4 + (ok ? (int64_t)j * C4 + c : 0), ok ? 16 : 0);
        }
        if (!p_once) load_p(Ws + rows * kFwdSpan, c0);
        if (u < n_chunks - 1) return;   // W with the stage's last chunk
        if (vec_w) {                    // rows of W are 16-byte aligned
            for (Walk w = walk_w4; w.a < rows; w.next()) {
                const int i = fwd_row(first, w.a);
                const bool h = w.b >= kFwdTile / 4;
                const int j = (h ? jb - kFwdTile : ja) + 4 * w.b;
                const int n = i < B ? min(4, (h ? eb : ea) - j) : 0;
                cp_async16(Ws + w.a * kFwdSpan + 4 * w.b,
                           W + (n > 0 ? (int64_t)i * B + j : 0),
                           n > 0 ? 4 * n : 0);
            }
        } else {
            for (Walk w = walk_w; w.a < rows; w.next()) {
                const int i = fwd_row(first, w.a);
                const bool h = w.b >= kFwdTile;
                const int j = (h ? jb - kFwdTile : ja) + w.b;
                const bool ok = i < B && j < (h ? eb : ea);
                cp_async4(Ws + w.a * kFwdSpan + w.b,
                          W + (ok ? (int64_t)i * B + j : 0), ok ? 4 : 0);
            }
        }
    };

    int irow[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) irow[r] = fwd_row(first, 4 * warp + r);
    float S[4][4] = {};
    float cross = 0.f, deg[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < kFwdStages - 1; ++s) {
        if (s < n_stages) load_stage(s, s);
        cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
        cp_async_wait<kFwdStages - 2>();
        __syncthreads();   // stage s landed; stage s - 1's slot is free
        if (s + kFwdStages - 1 < n_stages)
            load_stage((s + kFwdStages - 1) % kFwdStages, s + kFwdStages - 1);
        cp_async_commit();
        const bool last = (s + 1) % n_chunks == 0;
        const float* Ls = ring + (s % kFwdStages) * stage_floats;
        const float* Ws = Ls + kFwdSpan * stride;
        const float* Ps = p_once ? P_once : Ws + rows * kFwdSpan;
        const float* prow = Ps + 4 * warp * stride;
        // This thread's columns of the stage: tx + 32c, c < 4, so columns
        // c = 0, 1 are its two of the first piece and c = 2, 3 of the
        // second.
        const float* lc = Ls + tx * stride;
#pragma unroll 2
        for (int c = 0; c < width; c += 4) {
            float4 a[4], b[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                a[r] = *reinterpret_cast<const float4*>(prow + r * stride + c);
#pragma unroll
            for (int m = 0; m < 4; ++m)
                b[m] = *reinterpret_cast<const float4*>(lc + 32 * m * stride
                                                        + c);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    S[r][m] = fmaf(a[r].x, b[m].x, S[r][m]);
                    S[r][m] = fmaf(a[r].y, b[m].y, S[r][m]);
                    S[r][m] = fmaf(a[r].z, b[m].z, S[r][m]);
                    S[r][m] = fmaf(a[r].w, b[m].w, S[r][m]);
                }
        }
        if (last) {
            int j0[2], jend[2];
            pieces_of(s, j0[0], jend[0], j0[1], jend[1]);
            // The chain: piece by piece, then r, then c.
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        if (irow[r] < B && j0[h] + tx + 32 * c < jend[h]) {
                            const float w = Ws[(4 * warp + r) * kFwdSpan
                                               + h * kFwdTile + tx + 32 * c];
                            cross = fmaf(w, S[r][2 * h + c], cross);
                            if (kFull) deg[r] += w;
                        }
                        S[r][2 * h + c] = 0.f;
                    }
                }
            }
        }
    }
    float ent = 0.f;
    if (!kListed || line_listed) {
#pragma unroll
        for (int r = 0; r < 4 && kFull; ++r) {
            const float d = warp_sum(deg[r]);
            if (irow[r] < B) {
                const float h = row_entropy(P, L, C, irow[r]);
                if (tx == 0) ent += (kappa + ge * d) * h;
            }
        }
    }
    if (pair < 8 * n_strips)
        partials[((int64_t)z * n_strips * 8 + pair) * 32 + tx] =
            -gc * cross - ent;
}

// Pass 2 of K1, K4 and K10: one block of kSumThreads per worker.  Warp w
// takes strips w, w + 32, ...: lane l holds the strip's values l + 32m (m
// < 8) and runs the strip's tree on them (levels 128..32 inside the lane,
// 16..1 by shuffles; a level adds red[t + s] into red[t] for t < s, and
// lanes past s feed no lane below them), then thread 0 adds the strip
// totals in strip order from +0.
constexpr int kSumThreads = 1024;

__global__ void __launch_bounds__(kSumThreads)
reg_fwd_tree_sum(const float* __restrict__ partials, int n_strips,
                 float* __restrict__ out) {
    __shared__ float totals[kSumThreads];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* part = partials + (int64_t)blockIdx.x * n_strips * kThreads;
    float sum = 0.f;
    for (int g0 = 0; g0 < n_strips; g0 += kSumThreads) {
        for (int t = g0 + warp; t < min(n_strips, g0 + kSumThreads);
             t += kSumThreads / 32) {
            float v[8];
#pragma unroll
            for (int m = 0; m < 8; ++m)
                v[m] = part[(int64_t)t * kThreads + lane + 32 * m];
#pragma unroll
            for (int m = 0; m < 4; ++m) v[m] += v[m + 4];
#pragma unroll
            for (int m = 0; m < 2; ++m) v[m] += v[m + 2];
            v[0] += v[1];
            for (int o = 16; o > 0; o >>= 1)
                v[0] += __shfl_down_sync(0xffffffffu, v[0], o);
            if (lane == 0) totals[t - g0] = v[0];
        }
        __syncthreads();
        if (threadIdx.x == 0)
            for (int t = g0; t < min(n_strips, g0 + kSumThreads); ++t)
                sum += totals[t - g0];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = sum;
}

// ---------------------------------------------------------------------------
// The A half of K2's pipeline: A = W logP and the rows' degrees, each one
// chain in increasing j from +0, 32 j a ring stage; K2 runs it over all j
// (block 0 of its clusters), K6 over the 32-j pieces of a strip's listed
// column tiles in list order (zeros past a tile's end, as before).  A
// thread owns 2 rows x 4 classes of a class chunk of C rounded up to 4 (at
// most 128), read from the class-padded logP with 16-byte copies.
constexpr int kDlPiece = 32;      // j per ring stage
constexpr int kDlMaxRows = 64;
constexpr int kDlMaxQuads = 32;   // class chunk: at most 128 classes
constexpr int kDlMaxThreads = 512;

// Class quads of a block: C rounded up to 4, at most kDlMaxQuads.
__host__ __device__ __forceinline__ int dl_quads(int C) {
    const int q = (C + 3) / 4;
    return q < kDlMaxQuads ? q : kDlMaxQuads;
}

// Floats of one ring stage: the W piece (rows x 32) and the piece's logP
// or P rows (32 x 4*quads).
__host__ __device__ __forceinline__ int dl_stage_floats(int rows, int quads) {
    return kDlPiece * (rows + 4 * quads);
}

// Position of W[i0 + r, j0 + j] in a row-major piece: 16-byte groups
// XOR-swizzled by the row pair, so the 16-byte reads of a warp's row
// pairs spread over the banks.
__device__ __forceinline__ int dl_swz(int r, int j) {
    return r * kDlPiece + ((((j >> 2) ^ (r >> 1)) & 7) << 2) + (j & 3);
}

// W[i0 + r, j0 + j] for rows i0 + r < row_end and j0 + j < j_end into a
// piece of `rows` x 32, zero-filled elsewhere: 16-byte copies where W's
// rows are 16-byte aligned (vec_w; j0 a multiple of 4), 4-byte otherwise.
__device__ __forceinline__ void dl_load_rows(
        float* Ws, const float* __restrict__ W, int B, int i0, int row_end,
        int j0, int j_end, int rows, int vec_w, const Walk& walk_w4,
        const Walk& walk_w) {
    if (vec_w) {                   // (row, j quad)
        for (Walk w = walk_w4; w.a < rows; w.next()) {
            const int i = i0 + w.a, j = j0 + 4 * w.b;
            const int n = i < row_end ? min(4, j_end - j) : 0;
            cp_async16(Ws + dl_swz(w.a, 4 * w.b),
                       W + (n > 0 ? (int64_t)i * B + j : 0),
                       n > 0 ? 4 * n : 0);
        }
    } else {                       // (row, j)
        for (Walk w = walk_w; w.a < rows; w.next()) {
            const bool ok = i0 + w.a < row_end && j0 + w.b < j_end;
            cp_async4(Ws + dl_swz(w.a, w.b),
                      W + (ok ? (int64_t)(i0 + w.a) * B + j0 + w.b : 0),
                      ok ? 4 : 0);
        }
    }
}

// Rows j0 .. j0 + 32 (those below j_end) of a class-padded (B, C4) copy,
// classes c0 .. c0 + width, into a [32][width] piece; zero elsewhere.
__device__ __forceinline__ void dl_load_v(float* Vs,
                                          const float* __restrict__ V4,
                                          int C4, int j0, int j_end, int c0,
                                          int width, const Walk& walk_v) {
    for (Walk w = walk_v; w.a < kDlPiece; w.next()) {   // (j, class quad)
        const int c = c0 + 4 * w.b;
        const bool ok = j0 + w.a < j_end && c < C4;
        cp_async16(Vs + w.a * width + 4 * w.b,
                   V4 + (ok ? (int64_t)(j0 + w.a) * C4 + c : 0),
                   ok ? 16 : 0);
    }
}

// One 32-j piece of a thread's chains: its 2 x 4 outputs and, with kDeg,
// its two rows' degrees, in increasing j.  kA: W rows from a row-major
// dl_swz piece (A = W logP); otherwise W columns from a j-major piece
// (K2's W^T P).
template <bool kA, bool kDeg>
__device__ __forceinline__ void dl_piece(const float* __restrict__ Ws,
                                         const float4* __restrict__ vv,
                                         int rows, int rp, int quads,
                                         float (&acc)[2][4], float (&deg)[2]) {
#pragma unroll
    for (int j4 = 0; j4 < kDlPiece; j4 += 4) {
        float w[2][4];
        float4 v[4];
        if (kA) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float4 t = *reinterpret_cast<const float4*>(
                    Ws + dl_swz(2 * rp + r, j4));
                w[r][0] = t.x; w[r][1] = t.y; w[r][2] = t.z; w[r][3] = t.w;
            }
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float2 t = *reinterpret_cast<const float2*>(
                    Ws + (j4 + u) * rows + 2 * rp);
                w[0][u] = t.x; w[1][u] = t.y;
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = vv[(j4 + u) * quads];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                acc[r][0] = fmaf(w[r][u], v[u].x, acc[r][0]);
                acc[r][1] = fmaf(w[r][u], v[u].y, acc[r][1]);
                acc[r][2] = fmaf(w[r][u], v[u].z, acc[r][2]);
                acc[r][3] = fmaf(w[r][u], v[u].w, acc[r][3]);
                if (kDeg) deg[r] += w[r][u];
            }
        }
    }
}

}  // namespace
