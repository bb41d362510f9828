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
// (_graph_reg_kernel), the bare cross term.  It is K1's kernel compiled
// without the degree and entropy terms (kFull = false), with K1's second
// pass, so it equals K1 at (gc, kappa, ge) = (1, 0, 0).
//
// K1, K2 and K10 keep the bits of the strip kernels they replaced: the
// same sums in the same orders, now from cp.async pipelines that fill
// every SM; their entry points first copy logP (and P) into class-padded
// rows (pad_classes) in a workspace the caller allocates, of the size
// graph_reg_fwd_workspace / graph_reg_bwd_dlogp_workspace give.
// Padding is done with masks elsewhere (graph_reg_tiles.cuh).
//
// No float atomics: every output element and every partial sum has exactly
// one writer, and every reduction runs in a fixed order, so two launches on
// the same inputs give bit-identical results.

#include <cooperative_groups.h>

#include "cp_async.cuh"
#include "dynamic_smem.cuh"
#include "graph_reg_tiles.cuh"

namespace {

// Blocks of K1 and K2 own whole rows: every output of K2 and every chain
// of K1 runs over all j in one block, so the work is split by rows only.
// A launch takes as few rows per block as fill each SM once (units of
// `step` rows, at most `max_rows`): 20 rows for K1 at the path's B = 2176
// on 132 SMs (109 blocks), and 36 for each of K2's two-block clusters (61
// clusters on 122 SMs; the SM count from dynamic_smem.cuh's sm_count).
// The number of rows changes no sum's order.
int rows_to_fill(int64_t rows_total, int n_sm, int step, int max_rows) {
    const int64_t per_sm = (rows_total + n_sm - 1) / n_sm;
    const int64_t rows = (per_sm + step - 1) / step * step;
    return static_cast<int>(rows < step ? step
                            : rows > max_rows ? max_rows : rows);
}

// K1 / K10 pass 1's partials: one per thread of each worker's 32-row
// strips.
int fwd_n_partials(int k, int B) { return k * ((B + 31) / 32) * kThreads; }

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
// the class-padded copies of logP (K1, K10) and of P and logP (K2) that
// their pipelines read with 16-byte copies.  C = 39 rows are 156 bytes,
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
int launch_pad(const float* X, const float* Y, int64_t rows, int C,
               float* outX, float* outY, cudaStream_t s) {
    const int64_t n = rows * (pad4(C) / 4);
    const int blocks = static_cast<int>((n + kThreads - 1) / kThreads < 512
                                        ? (n + kThreads - 1) / kThreads
                                        : 512);
    pad_classes<<<dim3(blocks, Y ? 2 : 1), kThreads, 0, s>>>(X, Y, rows, C,
                                                           outX, outY);
    return static_cast<int>(cudaGetLastError());
}

// K1, pass 1.  The loss's bits are fixed by four orders, kept from the
// strip kernel it replaces (one 256-thread block per 32-row strip, thread
// (ty, tx) owning rows ty + 8r and columns tx + 32c of each 32 x 64 tile):
//   * S_ij = sum_c P_ic logP_jc, one fmaf chain in increasing c from +0;
//   * thread (ty, tx)'s chain cross = fmaf(W_ij, S_ij, cross) and its
//     degrees deg[r] += W_ij over the 64-column tiles in order, then r,
//     then c (i, j < B only);
//   * per row, d = warp_sum over the 32 lanes' deg[r], h = row_entropy,
//     ent += (kappa + ge*d)*h at tx = 0 in r order; the thread's value is
//     -gc*cross - ent;
//   * block_sum's tree over the strip's 256 values, then the strips in
//     order (pass 2).
// Only the consumption of S by the chains has an order, so S may come
// from any layout.  The chains of one (strip, ty) pair touch four rows
// only, so a pair is one warp here, and a block holds `pairs` warps:
// pairs of consecutive index p = 8*strip + ty, rows 32*strip + ty + 8r.
// The launch sizes blocks to fill every SM once (20 rows at the path's
// shape, against one 32-row strip on 68 of the 132 SMs before).
//
// What bounds it: 2*B*B*C flops for S (5.5 us at the path's shape) and
// the B*B bytes of W (5.7 us).  Each block streams 128-column spans (two
// of the chains' 64-column tiles) of the class-padded logP (all B rows)
// and its rows' W span through a ring of kFwdStages cp.async stages of
// 16-byte copies (classes in chunks of up to kFwdChunk; its rows of P are
// loaded once when C fits one chunk), so the next spans' copies are in
// flight while one is summed.  A thread computes a 4 x 4 S tile, its
// columns tx + 32c of both tiles, from 16-byte reads (its rows' P
// broadcast, its logP rows padded to an odd number of 16-byte groups:
// conflict-free), 8 loads per 64 FMAs, then feeds its chain the first
// tile's values and then the second's.  Pass 1 writes every thread's
// value (fwd_n_partials: k * strips * 256 floats); pass 2
// applies block_sum's tree to each strip's 256 and adds the strips in
// order.  kFull = false (K10) drops the degrees and entropies.
constexpr int kFwdTile = 64;      // columns per tile: the chains' order
constexpr int kFwdSpan = 128;     // columns per ring stage: two tiles
constexpr int kFwdChunk = 64;     // classes per ring stage
constexpr int kFwdStages = 3;     // depth of the cp.async ring
constexpr int kFwdMaxPairs = 8;   // warps per block

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

// Floats of one ring stage: logP of the tile's 64 columns and W[rows,
// tile], and P of the block's rows where C takes more than one chunk (one
// chunk of P is loaded once, beside the ring).
__host__ __device__ __forceinline__ int fwd_stage_floats(int rows, int C) {
    const int width = fwd_width(C), stride = fwd_stride(width);
    return kFwdSpan * stride + rows * kFwdSpan
           + (C > width ? rows * stride : 0);
}

// Floats of a K1 launch's dynamic shared memory.
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

template <bool kFull>
__global__ void __launch_bounds__(32 * kFwdMaxPairs)
reg_fwd_partials(const float* __restrict__ P, const float* __restrict__ L,
                 const float* __restrict__ L4, const float* __restrict__ W,
                 int B, int C, float gc,
                 float kappa, float ge, int vec_w,
                 float* __restrict__ partials) {
    extern __shared__ __align__(16) float ring[];
    const int tid = threadIdx.x, warp = tid >> 5, tx = tid & 31;
    const int rows = blockDim.x / 8;               // 4 per warp
    const int z = blockIdx.z;
    const int n_strips = (B + 31) / 32;
    const int first = blockIdx.x * (blockDim.x / 32);
    const int pair = first + warp;
    const int width = fwd_width(C), stride = fwd_stride(width);
    const int n_chunks = (C + width - 1) / width;
    const int n_tiles = (B + kFwdSpan - 1) / kFwdSpan;   // two-tile spans
    const int n_stages = n_tiles * n_chunks;
    const int stage_floats = fwd_stage_floats(rows, C);
    const int C4 = pad4(C);
    P += (int64_t)z * B * C;
    L += (int64_t)z * B * C;
    L4 += (int64_t)z * B * C4;
    W += (int64_t)z * B * B;

    const bool p_once = n_chunks == 1;
    float* const P_once = ring + kFwdStages * stage_floats;   // [rows][stride]
    const Walk walk_l(tid, blockDim.x, width / 4);   // (tile column, quad)
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
    auto load_stage = [&](int stage, int s) {
        const int j0 = (s / n_chunks) * kFwdSpan;
        const int u = s - (s / n_chunks) * n_chunks;
        const int c0 = u * width;
        float* Ls = ring + stage * stage_floats;   // [64][stride]
        float* Ws = Ls + kFwdSpan * stride;        // [rows][128]
        for (Walk w = walk_l; w.a < kFwdSpan; w.next()) {
            const int j = j0 + w.a, c = c0 + 4 * w.b;
            const bool ok = j < B && c < C4;
            cp_async16(Ls + w.a * stride + 4 * w.b,
                       L4 + (ok ? (int64_t)j * C4 + c : 0), ok ? 16 : 0);
        }
        if (!p_once) load_p(Ws + rows * kFwdSpan, c0);
        if (u < n_chunks - 1) return;   // W with the tile's last chunk
        if (vec_w) {                    // rows of W are 16-byte aligned
            for (Walk w = walk_w4; w.a < rows; w.next()) {
                const int i = fwd_row(first, w.a), j = j0 + 4 * w.b;
                const int n = i < B ? min(4, B - j) : 0;
                cp_async16(Ws + w.a * kFwdSpan + 4 * w.b,
                           W + (n > 0 ? (int64_t)i * B + j : 0),
                           n > 0 ? 4 * n : 0);
            }
        } else {
            for (Walk w = walk_w; w.a < rows; w.next()) {
                const int i = fwd_row(first, w.a), j = j0 + w.b;
                const bool ok = i < B && j < B;
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
    if (p_once) load_p(P_once, 0);   // in the first stage's group
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
        const int tile = s / n_chunks;
        const bool last = s - tile * n_chunks == n_chunks - 1;
        const float* Ls = ring + (s % kFwdStages) * stage_floats;
        const float* Ws = Ls + kFwdSpan * stride;
        const float* Ps = p_once ? P_once : Ws + rows * kFwdSpan;
        const float* prow = Ps + 4 * warp * stride;
        // This thread's columns of the span: tx + 32c, c < 4, so columns c
        // = 0, 1 are its two of the first tile and c = 2, 3 of the second.
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
            // The chain: tile by tile, then r, then c.
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int j0 = tile * kFwdSpan + h * kFwdTile;
#pragma unroll
                for (int r = 0; r < 4; ++r) {
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const int j = j0 + tx + 32 * c;
                        if (irow[r] < B && j < B) {
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
#pragma unroll
    for (int r = 0; r < 4 && kFull; ++r) {
        const float d = warp_sum(deg[r]);
        if (irow[r] < B) {
            const float h = row_entropy(P, L, C, irow[r]);
            if (tx == 0) ent += (kappa + ge * d) * h;
        }
    }
    if (pair < 8 * n_strips)
        partials[((int64_t)z * n_strips * 8 + pair) * 32 + tx] =
            -gc * cross - ent;
}

// K1, pass 2: one block of kSumThreads per worker.  Warp w takes strips
// w, w + 32, ...: lane l holds the strip's values l + 32m (m < 8) and runs
// block_sum's tree on them (levels 128..32 inside the lane, 16..1 by
// shuffles; a level adds red[t + s] into red[t] for t < s, and lanes past
// s feed no lane below them), then thread 0 adds the strip totals in
// strip order from +0.
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

// K2: dlogp = g*[-gc*(P.*(W logP) + W^T P) + (kappa + ge*deg).*P.*(logP+1)].
// Its bits: A = W logP, Bt = W^T P and each row's degree are each one
// chain in increasing j from +0 (j padded to a multiple of 32 with zeros,
// as the 32-wide j tiles of the kernel it replaces), and the epilogue is
// the expression below.  So no split of j: parallelism comes from rows
// and classes only.
//
// What bounds it: 4*B*B*C flops (11 us at the path's shape), and feeding
// them: every output needs all of logP or P and a row or column of W, so
// each SM streams all of logP or P once.  The design:
//
// * a cluster of two blocks per (rows, class chunk of up to 128, worker):
//   block 0 sums A = W logP and the degrees from W's rows, block 1 Bt =
//   W^T P from W's columns, so each streams one of logP and P, and W in
//   its natural layout; block 1 hands its Bt tile to block 0 through
//   distributed shared memory for the epilogue.  Rows are sized to fill
//   each SM once (36 at the path's B = 2176: 61 clusters, 122 blocks,
//   against 68 blocks of 32 rows before), a multiple of 4;
// * the class chunk is C rounded up to 4 (40 at C = 39, not 64), read
//   from class-padded copies of P and logP (pad_classes) with 16-byte
//   copies;
// * a thread owns 2 rows x 4 classes; block 0 reads its two W rows four j
//   at a time (16-byte loads from a row-major piece, 16-byte groups XOR-
//   swizzled by row pair), block 1 its two W columns one j at a time
//   (8-byte loads from a j-major piece); logP / P rows as 16-byte loads;
// * 32-j pieces stream through a ring of kDlStages cp.async stages, the
//   next pieces in flight while one is summed; edges are zero-filled by
//   the copies (src-size below the copy size).
constexpr int kDlPiece = 32;      // j per ring stage
constexpr int kDlStages = 2;      // depth of the cp.async ring
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

// Position of W[i0 + r, j0 + j] in block 0's row-major piece: 16-byte
// groups XOR-swizzled by the row pair, so the 16-byte reads of a warp's
// row pairs spread over the banks.
__device__ __forceinline__ int dl_swz(int r, int j) {
    return r * kDlPiece + ((((j >> 2) ^ (r >> 1)) & 7) << 2) + (j & 3);
}

// One 32-j piece of a thread's chains: its 2 x 4 outputs and, with kDeg,
// its two rows' degrees, in increasing j.
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

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kDlMaxThreads)
reg_bwd_dlogp(const float* __restrict__ P, const float* __restrict__ L,
              const float* __restrict__ P4, const float* __restrict__ L4,
              const float* __restrict__ W, const float* __restrict__ g,
              int B, int C, float gc, float kappa, float ge, int vec_w,
              float* __restrict__ dlogp) {
    extern __shared__ __align__(16) float ring[];
    namespace cg = cooperative_groups;
    const cg::cluster_group cluster = cg::this_cluster();
    const bool is_a = cluster.block_rank() == 0;
    const int quads = dl_quads(C), width = 4 * quads, C4 = pad4(C);
    const int pairs = blockDim.x / quads, rows = 2 * pairs;
    const int tid = threadIdx.x, rp = tid % pairs, q = tid / pairs;
    const int z = blockIdx.z, i0 = (blockIdx.x >> 1) * rows;
    const int c0 = blockIdx.y * 4 * kDlMaxQuads;
    const int stage_floats = dl_stage_floats(rows, quads);
    const int n_pieces = (B + kDlPiece - 1) / kDlPiece;
    P += (int64_t)z * B * C;
    L += (int64_t)z * B * C;
    W += (int64_t)z * B * B;
    dlogp += (int64_t)z * B * C;
    const float gz = g[z];
    // Block 0 streams logP, block 1 P.
    const float* V4 = (is_a ? L4 : P4) + (int64_t)z * B * C4;

    const Walk walk_w4(tid, blockDim.x, kDlPiece / 4);   // (row, j quad)
    const Walk walk_w(tid, blockDim.x, kDlPiece);        // (row, j)
    const Walk walk_c4(tid, blockDim.x, rows / 4);       // (j, row quad)
    const Walk walk_c(tid, blockDim.x, rows);            // (j, row)
    const Walk walk_v(tid, blockDim.x, quads);           // (j, class quad)
    auto load_piece = [&](int stage, int j0) {
        float* Ws = ring + stage * stage_floats;   // rows x 32 floats
        float* Vs = Ws + kDlPiece * rows;          // [piece][width]
        if (is_a && vec_w) {            // W[i0 + r, j0 .. j0 + 32)
            for (Walk w = walk_w4; w.a < rows; w.next()) {
                const int i = i0 + w.a, j = j0 + 4 * w.b;
                const int n = i < B ? min(4, B - j) : 0;
                cp_async16(Ws + dl_swz(w.a, 4 * w.b),
                           W + (n > 0 ? (int64_t)i * B + j : 0),
                           n > 0 ? 4 * n : 0);
            }
        } else if (is_a) {
            for (Walk w = walk_w; w.a < rows; w.next()) {
                const bool ok = i0 + w.a < B && j0 + w.b < B;
                cp_async4(Ws + dl_swz(w.a, w.b),
                          W + (ok ? (int64_t)(i0 + w.a) * B + j0 + w.b : 0),
                          ok ? 4 : 0);
            }
        } else if (vec_w) {             // W[j0 + j, i0 .. i0 + rows)
            for (Walk w = walk_c4; w.a < kDlPiece; w.next()) {
                const int j = j0 + w.a, i = i0 + 4 * w.b;
                const int n = j < B ? min(4, B - i) : 0;
                cp_async16(Ws + w.a * rows + 4 * w.b,
                           W + (n > 0 ? (int64_t)j * B + i : 0),
                           n > 0 ? 4 * n : 0);
            }
        } else {
            for (Walk w = walk_c; w.a < kDlPiece; w.next()) {
                const bool ok = j0 + w.a < B && i0 + w.b < B;
                cp_async4(Ws + w.a * rows + w.b,
                          W + (ok ? (int64_t)(j0 + w.a) * B + i0 + w.b : 0),
                          ok ? 4 : 0);
            }
        }
        for (Walk w = walk_v; w.a < kDlPiece; w.next()) {
            const int c = c0 + 4 * w.b;
            const bool ok = j0 + w.a < B && c < C4;
            cp_async16(Vs + w.a * width + 4 * w.b,
                       V4 + (ok ? (int64_t)(j0 + w.a) * C4 + c : 0),
                       ok ? 16 : 0);
        }
    };

    float acc[2][4] = {}, deg[2] = {0.f, 0.f};
    for (int s = 0; s < kDlStages - 1; ++s) {
        if (s < n_pieces) load_piece(s, s * kDlPiece);
        cp_async_commit();
    }
    for (int it = 0; it < n_pieces; ++it) {
        cp_async_wait<kDlStages - 2>();
        __syncthreads();   // piece it landed; piece it - 1's slot is free
        const int nx = it + kDlStages - 1;
        if (nx < n_pieces) load_piece(nx % kDlStages, nx * kDlPiece);
        cp_async_commit();
        const float* Ws = ring + (it % kDlStages) * stage_floats;
        const float4* vv = reinterpret_cast<const float4*>(
            Ws + kDlPiece * rows) + q;
        // The degree threads (block 0, q = 0: threads 0 .. pairs - 1) are
        // all in warp 0; the other warps skip the degree adds.
        if (!is_a)
            dl_piece<false, false>(Ws, vv, rows, rp, quads, acc, deg);
        else if (tid < 32)
            dl_piece<true, true>(Ws, vv, rows, rp, quads, acc, deg);
        else
            dl_piece<true, false>(Ws, vv, rows, rp, quads, acc, deg);
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free: block 1's Bt tile, block 0's degrees
    float* Bts = ring;                  // [rows][width], in block 1
    float* degs = ring + rows * width;  // [rows], in block 0
    if (!is_a) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                Bts[(2 * rp + r) * width + 4 * q + e] = acc[r][e];
    } else if (q == 0) {
        degs[2 * rp] = deg[0];
        degs[2 * rp + 1] = deg[1];
    }
    cluster.sync();   // block 1's Bt tile and block 0's degrees are written
    if (is_a) {
        const float* rBts = cluster.map_shared_rank(Bts, 1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int i = i0 + 2 * rp + r;
            if (i >= B) continue;
            const float coef = kappa + ge * degs[2 * rp + r];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int cc = c0 + 4 * q + e;
                if (cc >= C) continue;
                const int64_t at = (int64_t)i * C + cc;
                const float p = P[at];
                dlogp[at] = gz * (-gc * (p * acc[r][e]
                                         + rBts[(2 * rp + r) * width + 4 * q + e])
                                  + coef * p * (L[at] + 1.f));
            }
        }
    }
    cluster.sync();   // block 1's shared memory outlives block 0's reads
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

// Floats of a K1 / K10 launch's workspace: pass 1's partials, one per
// thread of each worker's 32-row strips, then the class-padded copy of
// logP, k * B * C4 floats (C4 = C rounded up to 4).
int graph_reg_fwd_workspace(int k, int B, int C) {
    return fwd_n_partials(k, B) + k * B * pad4(C);
}

// Floats of a K2 launch's workspace: the class-padded copies of P and of
// logP, k * B * C4 floats each.
int graph_reg_bwd_dlogp_workspace(int k, int B, int C) {
    return 2 * k * B * pad4(C);
}

// Rows per block and dynamic shared memory (bytes) of a K1 / K10 launch.
int graph_reg_fwd_plan(int k, int B, int C, int* rows, int* smem) {
    if (k < 1 || B < 1 || C < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    int n_sm = 0;
    const cudaError_t err = sm_count(&n_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    *rows = rows_to_fill((int64_t)k * 32 * ((B + 31) / 32),
                         n_sm, 4, 4 * kFwdMaxPairs);
    *smem = static_cast<int>(sizeof(float)) * fwd_smem_floats(*rows, C);
    return 0;
}

// Rows per block and dynamic shared memory (bytes) of a K2 launch.
int graph_reg_bwd_dlogp_plan(int k, int B, int C, int* rows, int* smem) {
    if (k < 1 || B < 1 || C < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    int n_sm = 0;
    const cudaError_t err = sm_count(&n_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int quads = dl_quads(C);
    const int n_chunks = (C + 4 * kDlMaxQuads - 1) / (4 * kDlMaxQuads);
    const int fit = 2 * (kDlMaxThreads / quads);
    const int max_rows = (fit < kDlMaxRows ? fit : kDlMaxRows) & ~3;
    // One cluster, an A and a Bt block on two SMs, per rows.  More
    // clusters than that (34-row blocks, 64 clusters at the path's shape)
    // ran slower on an H100.
    *rows = rows_to_fill((int64_t)k * n_chunks * B,
                         n_sm > 1 ? n_sm / 2 : 1, 4, max_rows);
    *smem = static_cast<int>(sizeof(float)) * kDlStages
            * dl_stage_floats(*rows, quads);
    return 0;
}

}  // extern "C"

namespace {

template <bool kFull>
int launch_fwd(const void* p, const void* logp, const void* W, int k, int B,
               int C, float gc, float kappa, float ge, void* workspace,
               void* out, cudaStream_t s) {
    int rows = 0, smem = 0;
    int rc = graph_reg_fwd_plan(k, B, C, &rows, &smem);
    if (rc != 0) return rc;
    float* partials = static_cast<float*>(workspace);
    float* L4 = partials + fwd_n_partials(k, B);
    rc = launch_pad(static_cast<const float*>(logp), nullptr, (int64_t)k * B,
                    C, L4, nullptr, s);
    if (rc != 0) return rc;
    const int n_strips = (B + 31) / 32, pairs = rows / 4;
    // 16-byte copies of W's rows need B a multiple of 4 and W aligned.
    const int vec_w = B % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
    cudaError_t err = allow_dynamic_smem<reg_fwd_partials<kFull>>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    reg_fwd_partials<kFull>
        <<<dim3((8 * n_strips + pairs - 1) / pairs, 1, k), 32 * pairs, smem,
           s>>>(static_cast<const float*>(p), static_cast<const float*>(logp),
                L4, static_cast<const float*>(W), B, C, gc, kappa, ge, vec_w,
                partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    reg_fwd_tree_sum<<<k, kSumThreads, 0, s>>>(partials, n_strips,
                                                static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// workspace holds graph_reg_fwd_workspace(k, B, C) floats, 16-byte
// aligned; out holds k floats.
int graph_reg_fwd(const void* p, const void* logp, const void* W, int k,
                  int B, int C, float gc, float kappa, float ge,
                  void* workspace, void* out, void* stream) {
    return launch_fwd<true>(p, logp, W, k, B, C, gc, kappa, ge, workspace,
                            out, static_cast<cudaStream_t>(stream));
}

// K10: logp and p (B, C), W (B, B), no worker axis; workspace holds
// graph_reg_fwd_workspace(1, B, C) floats; out is one float.
int graph_reg_pairwise(const void* p, const void* logp, const void* W, int B,
                       int C, void* workspace, void* out, void* stream) {
    return launch_fwd<false>(p, logp, W, 1, B, C, 1.f, 0.f, 0.f, workspace,
                             out, static_cast<cudaStream_t>(stream));
}

// workspace holds graph_reg_bwd_dlogp_workspace(k, B, C) floats, 16-byte
// aligned; dlogp is the (k, B, C) output.
int graph_reg_bwd_dlogp(const void* p, const void* logp, const void* W,
                        const void* g, int k, int B, int C, float gc,
                        float kappa, float ge, void* workspace, void* dlogp,
                        void* stream) {
    int rows = 0, smem = 0;
    int rc = graph_reg_bwd_dlogp_plan(k, B, C, &rows, &smem);
    if (rc != 0) return rc;
    const int quads = dl_quads(C);
    const int n_chunks = (C + 4 * kDlMaxQuads - 1) / (4 * kDlMaxQuads);
    const cudaError_t err = allow_dynamic_smem<reg_bwd_dlogp>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* P4 = static_cast<float*>(workspace);
    float* L4 = P4 + (int64_t)k * B * pad4(C);
    rc = launch_pad(static_cast<const float*>(p),
                    static_cast<const float*>(logp), (int64_t)k * B, C, P4, L4,
                    s);
    if (rc != 0) return rc;
    // 16-byte copies of W need B a multiple of 4 and W aligned (rows, and
    // so each block's first row, is a multiple of 4).
    const int vec_w = B % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
    reg_bwd_dlogp<<<dim3(2 * ((B + rows - 1) / rows), n_chunks, k),
                    rows / 2 * quads, smem, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(logp), P4, L4,
        static_cast<const float*>(W), static_cast<const float*>(g), B, C, gc,
        kappa, ge, vec_w, static_cast<float*>(dlogp));
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
