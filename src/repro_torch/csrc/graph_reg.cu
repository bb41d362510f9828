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
// graph_reg_fwd_workspace / graph_reg_bwd_dlogp_workspace give.  At narrow
// B and wide C (the LM heads), K1 and K10 take a second plan instead, the
// class-split plan below, with sums of their own order, and K2 its class
// route, with the row route's bits and no workspace.  K1's
// pipeline, the A half of K2's and K3's tile live in graph_reg_tiles.cuh,
// where the block-sparse K4, K6 and K7 (graph_reg_bsp.cu) run them over
// listed or occupied tiles.
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

// K1 and K10, pass 1: K1's pipeline (fwd_partials, graph_reg_tiles.cuh)
// over every 64-column tile of B, blocks of `pairs` warps at consecutive
// (strip, ty) pairs, sized to fill every SM once (20 rows at the path's
// shape, against one 32-row strip on 68 of the 132 SMs before).
//
// What bounds it: 2*B*B*C flops for S (5.5 us at the path's shape) and
// the B*B bytes of W (5.7 us).  kFull = false (K10) drops the degrees and
// entropies.  Pass 2 is reg_fwd_tree_sum.  The plan fills each SM with
// one block, which is all the launch bounds promise: with the bare 256
// threads ptxas caps the pipeline at 128 registers, where it spills.
template <bool kFull>
__global__ void __launch_bounds__(32 * kFwdMaxPairs, 1)
reg_fwd_partials(const float* __restrict__ P, const float* __restrict__ L,
                 const float* __restrict__ L4, const float* __restrict__ W,
                 int B, int C, float gc,
                 float kappa, float ge, int vec_w,
                 float* __restrict__ partials) {
    fwd_partials<kFull, false>(P, L, L4, W, nullptr, nullptr, nullptr, 0, 0,
                               B, C, gc, kappa, ge, vec_w, partials);
}

// K2: dlogp = g*[-gc*(P.*(W logP) + W^T P) + (kappa + ge*deg).*P.*(logP+1)].
// Its bits: A = W logP, Bt = W^T P and each row's degree are each one
// chain in increasing j from +0 (j padded to a multiple of 32 with zeros,
// as the 32-wide j tiles of the kernel it replaces), and the epilogue is
// the expression below.  So no split of j: parallelism comes from rows
// and classes only.  Two routes: the row route here, for the paper's
// shapes (B = 2176, C = 39) and every B past kDcMaxRows or C within one
// 128-class chunk, and the class route (reg_bwd_dlogp_classes, below)
// for narrow B and wide C, the LM heads; both give the same bits.
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
constexpr int kDlStages = 2;      // depth of K2's cp.async ring

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
        if (is_a) {                     // W[i0 + r, j0 .. j0 + 32)
            dl_load_rows(Ws, W, B, i0, B, j0, B, rows, vec_w, walk_w4,
                         walk_w);
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
        dl_load_v(Vs, V4, C4, j0, B, c0, width, walk_v);
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

// K3: dW = -g*(gc*P logP^T + ge*H(p) 1^T), (B, B) per worker, every
// element written.  The body is dw_tile (graph_reg_tiles.cuh), which K7
// (graph_reg_bsp.cu) runs over the occupied tiles of a layout, so K3
// equals K7 bit for bit on a full mask.
__global__ void __launch_bounds__(kThreads, 3)
reg_bwd_dw(const float* __restrict__ P, const float* __restrict__ L,
           const float* __restrict__ g, int B, int C, float gc, float ge,
           int vec, float* __restrict__ dW) {
    const int z = blockIdx.z;
    dw_tile(P + (int64_t)z * B * C, L + (int64_t)z * B * C, g[z], B, C, gc,
            ge, vec, DwDense{}, dW + (int64_t)z * B * B);
}

// K1 and K10, the class-split plan: narrow B and wide C.
//
// At the LM heads B is a few sequences (4-17) and C a vocabulary (512 to
// 151,936).  There the row plan is at its least, 4 rows a block, and
// still launches 8 blocks of one warp a 32-row strip, each streaming all C
// classes: 10 ms at (1, 16, 151936) on an H100, against a 5.8 us bound (P
// and logP read once, 19.4 MB).  So where the row plan is at its least (4 rows a
// block) and C spans more than 4 of its class chunks (C > 4 * kFwdChunk),
// the classes are split across blocks instead (cs_takes; the Python
// mirror is graph_reg.fwd_plan):
//
// * pass 1 (reg_fwd_class_partials): a block per (class chunk, 64 x 64
//   tile of S, worker), chunks of a whole number of 128-class slabs sized
//   so that the blocks fill every SM at least once (1,024 classes, 149
//   blocks at (1, 16, 151936) on 132 SMs).  Each block streams its
//   chunk's P rows (the tile's i) and logP rows (its j) through a ring of
//   kCsStages cp.async stages of one slab each (16-byte copies where C is
//   a multiple of 4 and the rows aligned), and writes one partial S_ij =
//   sum_c p_ic logp_jc of its chunk for every (i, j) of its tile.  Its
//   threads are `groups` class groups (a power of two, at most 32) of
//   quads^2 threads, each owning a 4 x 4 tile of S; group g sums classes
//   g*w .. g*w + w of every slab (w = 128 / groups), one fmaf chain in
//   increasing c from +0 an entry; the block adds the groups' values in
//   group order (group 0's, then + group 1's, ...);
// * pass 2 (reg_fwd_class_sum): one block of kCsSumThreads per worker.
//   S_ij is the chunks' partials added in chunk order from +0; thread t
//   takes the entries e = t, t + kCsSumThreads, ... (e = i*B + j) in
//   order, cross = fmaf(W_e, S_e, cross), and the rows i = t, t +
//   kCsSumThreads, ...: deg_i = sum_j W_ij in increasing j from +0, H_i =
//   -S_ii (the row entropies need no second sweep over C; S_ii is handed
//   over in shared memory), ent = fmaf(fmaf(ge, deg_i, kappa), H_i, ent);
//   its value fmaf(-gc, cross, -ent) is summed over the warp by warp_sum
//   and the warps in order from +0.
//
// No float atomics: two launches give the same bits.  What bounds it:
// the bytes of P and logP (2*k*B*C floats); at B = 16 its 2*B*B*C flops
// take a fifth of that time.  The row plan's shapes (the paper's B = 2176, C = 39)
// never take this plan, so their bits stay.
constexpr int kCsSlab = 128;     // classes a ring stage
constexpr int kCsStride = kCsSlab + 4;   // floats a staged row: 33
                                         // 16-byte groups, an odd count
constexpr int kCsTile = 64;      // rows and columns of S a block
constexpr int kCsStages = 3;     // depth of the cp.async ring
constexpr int kCsMaxGroups = 32;

// Thread quads along each side of a block's tile of S: min(B, 64) / 4,
// rounded up.
__host__ __device__ __forceinline__ int cs_quads(int B) {
    return ((B < kCsTile ? B : kCsTile) + 3) / 4;
}

// Class groups of a block: the most, a power of two up to kCsMaxGroups,
// whose quads^2 threads each fit kThreads.
__host__ __device__ __forceinline__ int cs_groups(int B) {
    const int q = cs_quads(B) * cs_quads(B);
    int g = 1;
    while (2 * g <= kCsMaxGroups && 2 * g * q <= kThreads) g *= 2;
    return g;
}

// Floats of pass 1's dynamic shared memory: the ring (P and logP rows of
// a tile, 4 * quads each, kCsStride floats a row), which the groups' 4 x 4
// tiles reuse at the end.
__host__ __device__ __forceinline__ int cs_smem_floats(int B) {
    const int q = cs_quads(B);
    const int ring = kCsStages * 2 * 4 * q * kCsStride;
    const int tiles = cs_groups(B) * q * q * 16;
    return ring > tiles ? ring : tiles;
}

__global__ void __launch_bounds__(kThreads)
reg_fwd_class_partials(const float* __restrict__ P,
                       const float* __restrict__ L, int B, int C, int chunk,
                       int vec, float* __restrict__ partials) {
    extern __shared__ __align__(16) float ring[];
    const int tid = threadIdx.x, u = blockIdx.x, z = blockIdx.z;
    const int nt = (B + kCsTile - 1) / kCsTile;
    const int i0 = blockIdx.y / nt * kCsTile, j0 = blockIdx.y % nt * kCsTile;
    const int quads = cs_quads(B), rows = 4 * quads, n_quads = quads * quads;
    const int groups = cs_groups(B), width = kCsSlab / groups;
    const int g = tid / n_quads, q = tid - g * n_quads;
    const int qi = q / quads, qj = q - qi * quads;
    const int c_begin = u * chunk, c_end = min(C, c_begin + chunk);
    const int n_slabs = (c_end - c_begin + kCsSlab - 1) / kCsSlab;
    const int stage_floats = 2 * rows * kCsStride;
    P += (int64_t)z * B * C;
    L += (int64_t)z * B * C;

    // Stage `slot` <- slab s: staged row a < rows is P's row i0 + a, row
    // rows + a logP's row j0 + a; classes past c_end or rows past B are 0.
    const Walk walk4(tid, blockDim.x, kCsSlab / 4);   // (staged row, quad)
    const Walk walk1(tid, blockDim.x, kCsSlab);       // (staged row, class)
    auto load_slab = [&](int slot, int s) {
        const int c0 = c_begin + s * kCsSlab;
        float* dst = ring + slot * stage_floats;
        if (vec) {
            for (Walk w = walk4; w.a < 2 * rows; w.next()) {
                const bool is_l = w.a >= rows;
                const int i = is_l ? j0 + w.a - rows : i0 + w.a;
                const int c = c0 + 4 * w.b;
                const int n = i < B ? max(0, min(4, c_end - c)) : 0;
                cp_async16(dst + w.a * kCsStride + 4 * w.b,
                           (is_l ? L : P) + (n > 0 ? (int64_t)i * C + c : 0),
                           4 * n);
            }
        } else {
            for (Walk w = walk1; w.a < 2 * rows; w.next()) {
                const bool is_l = w.a >= rows;
                const int i = is_l ? j0 + w.a - rows : i0 + w.a;
                const int c = c0 + w.b;
                const bool ok = i < B && c < c_end;
                cp_async4(dst + w.a * kCsStride + w.b,
                          (is_l ? L : P) + (ok ? (int64_t)i * C + c : 0),
                          ok ? 4 : 0);
            }
        }
    };

    const bool active = g < groups;
    float S[4][4] = {};
    for (int s = 0; s < kCsStages - 1; ++s) {
        if (s < n_slabs) load_slab(s, s);
        cp_async_commit();
    }
    for (int s = 0; s < n_slabs; ++s) {
        cp_async_wait<kCsStages - 2>();
        __syncthreads();   // slab s landed; slab s - 1's slot is free
        if (s + kCsStages - 1 < n_slabs)
            load_slab((s + kCsStages - 1) % kCsStages, s + kCsStages - 1);
        cp_async_commit();
        if (!active) continue;
        const float* st = ring + (s % kCsStages) * stage_floats + g * width;
        const float* pr = st + 4 * qi * kCsStride;
        const float* lr = st + (rows + 4 * qj) * kCsStride;
        for (int c = 0; c < width; c += 4) {
            float4 a[4], b[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                a[r] = *reinterpret_cast<const float4*>(pr + r * kCsStride
                                                        + c);
#pragma unroll
            for (int m = 0; m < 4; ++m)
                b[m] = *reinterpret_cast<const float4*>(lr + m * kCsStride
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
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free: it takes the groups' tiles
    float* tiles = ring;   // [groups][n_quads][16]
    if (active && g > 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int m = 0; m < 4; ++m)
                tiles[(g * n_quads + q) * 16 + 4 * r + m] = S[r][m];
    }
    __syncthreads();
    if (g != 0) return;
    for (int h = 1; h < groups; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int m = 0; m < 4; ++m)
                S[r][m] += tiles[(h * n_quads + q) * 16 + 4 * r + m];
    float* out = partials + ((int64_t)z * gridDim.x + u) * B * B;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = i0 + 4 * qi + r;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            const int j = j0 + 4 * qj + m;
            if (i < B && j < B) out[(int64_t)i * B + j] = S[r][m];
        }
    }
}

// S_e: the n chunks' partials of entry e (chunk u at u * stride + e) added
// in chunk order from +0 (with stride 1, a row of n values in order).  A
// batch's kCsBatch loads are issued together (past n they read chunk n - 1
// again, unused), so a thread waits on memory once a batch, not once a
// chunk (149 chunks at (1, 16, 151936)).
constexpr int kCsBatch = 32;

__device__ __forceinline__ float cs_entry(const float* __restrict__ part,
                                          int64_t e, int64_t stride, int n) {
    float s = 0.f;
    for (int u = 0; u < n; u += kCsBatch) {
        float v[kCsBatch];
#pragma unroll
        for (int t = 0; t < kCsBatch; ++t)
            v[t] = part[min(u + t, n - 1) * stride + e];
#pragma unroll
        for (int t = 0; t < kCsBatch; ++t)
            if (u + t < n) s += v[t];
    }
    return s;
}

// Pass 2; `diag` (dynamic shared memory, B floats) keeps S_ii from the
// thread that sums entry i*B + i for the thread that owns row i.  One
// block an SM is all it runs: the launch bounds say so, which leaves
// cs_entry the registers to keep a whole batch of loads in flight (at
// 1,024 threads a block the 64 registers a thread spill).
constexpr int kCsSumThreads = 256;

__global__ void __launch_bounds__(kCsSumThreads, 1)
reg_fwd_class_sum(const float* __restrict__ partials,
                  const float* __restrict__ W, int B, int n_chunks, float gc,
                  float kappa, float ge, int full, float* __restrict__ out) {
    extern __shared__ float diag[];
    __shared__ float totals[kCsSumThreads / 32];
    const int tid = threadIdx.x, z = blockIdx.x;
    const int64_t BB = (int64_t)B * B;
    const float* part = partials + (int64_t)z * n_chunks * BB;
    W += (int64_t)z * BB;
    float cross = 0.f, ent = 0.f;
    for (int64_t e = tid; e < BB; e += blockDim.x) {
        const float S = cs_entry(part, e, BB, n_chunks);
        cross = fmaf(W[e], S, cross);
        if (e % (B + 1) == 0) diag[e / (B + 1)] = S;
    }
    __syncthreads();
    if (full) {
        for (int i = tid; i < B; i += blockDim.x) {
            // deg_i: W's row i in increasing j from +0, batched as S_e.
            const float d = cs_entry(W, (int64_t)i * B, 1, B);
            ent = fmaf(fmaf(ge, d, kappa), -diag[i], ent);
        }
    }
    const float v = warp_sum(fmaf(-gc, cross, -ent));
    if ((tid & 31) == 0) totals[tid >> 5] = v;
    __syncthreads();
    if (tid == 0) {
        float sum = 0.f;
        for (int w = 0; w < kCsSumThreads / 32; ++w) sum += totals[w];
        out[z] = sum;
    }
}

// Whether K1 / K10 at (k, B, C) on n_sm SMs take the class-split plan:
// the row plan at its least (4 rows a block) and C past 4 class chunks.
bool cs_takes(int k, int B, int C, int n_sm) {
    return rows_to_fill((int64_t)k * 32 * ((B + 31) / 32), n_sm, 4,
                        4 * kFwdMaxPairs) == 4
           && C > 4 * kFwdChunk;
}

// Classes a chunk of the class-split plan: whole slabs, as many as still
// give every SM a block (at least one slab, at most all of C).
int cs_chunk(int k, int B, int C, int n_sm) {
    const int64_t slabs = (C + kCsSlab - 1) / kCsSlab;
    const int64_t nt = (B + kCsTile - 1) / kCsTile;
    int64_t per = slabs * nt * nt * k / n_sm;
    per = per < 1 ? 1 : per > slabs ? slabs : per;
    return static_cast<int>(kCsSlab * per);
}

// Pass 1's grid of a K1 / K10 launch with `rows` rows a block and class
// chunk `chunk` (0: the row plan), as graph_reg_fwd_plan reports it and
// launch_fwd launches it.
dim3 fwd_grid(int k, int B, int C, int rows, int chunk) {
    if (chunk > 0) {
        const int nt = (B + kCsTile - 1) / kCsTile;
        return dim3((C + chunk - 1) / chunk, nt * nt, k);
    }
    return dim3((8 * ((B + 31) / 32) + rows / 4 - 1) / (rows / 4), 1, k);
}

// K2, the class route: narrow B and wide C.
//
// At the LM heads (B 4-17 sequences, C a vocabulary of 512 to 151,936)
// the row route above runs a two-block cluster per 128-class chunk, half
// of each 512-thread block without a row at B = 16, over 32-j pieces of
// which 16 are zero padding, after a pad_classes pass that copies P and
// logP once more: 0.149 + 0.011 ms at (1, 16, 151936) on an H100, against
// an 8.7 us bound (P and logP read once, dlogp written once, 29.2 MB).  So
// where B <= kDcMaxRows and C spans more than one of the row route's
// 128-class chunks (dc_takes; the Python mirror is graph_reg.dlogp_plan),
// one kernel without a cluster, a pad pass or a workspace takes over:
//
// * a block owns a span of classes (a multiple of 4, at least kDcMinSpan,
//   sized so that the blocks of all workers fill every SM kDcSmBlocks
//   times: 576 classes, 264 blocks at (1, 16, 151936) on 132 SMs), all B
//   rows and one worker;
// * it stages W and its transpose in shared memory once (zero past B),
//   and each row's degree there, one chain in increasing j from +0;
// * its threads are row groups of kDcRows rows (B rounded up) times a
//   tile's class quads, whole warps a group, kDcWarps warps shared among
//   the groups (a warp each at least: 5 warps of 128 classes at B = 17);
//   it streams its span in such tiles of logP and P rows through a ring of
//   kDcStages cp.async stages: 16-byte copies where C is a multiple of 4
//   and P, logP aligned, 4-byte copies otherwise;
// * a thread owns 4 adjacent classes of its group's rows and keeps A =
//   W logP and Bt = W^T P for them in registers: per j one 16-byte read
//   each of logP and P, and of W's column and row j (the same address
//   across the warp, a broadcast); each output is one fmaf chain in
//   increasing j from +0, as on the row route;
// * the epilogue is the row route's expression, with p and logp from the
//   stage, and adjacent threads store adjacent classes (16-byte stores
//   where aligned).
//
// Its bits are the row route's: the row route runs the chains on over j
// padded to a multiple of 32 with zeros, fmaf(+0, +0, acc), which changes
// no value and turns a -0 into +0; where B is not a multiple of 32 the
// class route adds that +0 once (__fadd_rn, never folded or contracted).
constexpr int kDcMaxRows = 64;      // widest B the route takes
constexpr int kDcRows = 4;          // rows of a thread's register tile
constexpr int kDcWarps = 8;         // warps a block, shared by its groups
constexpr int kDcMaxThreads = 32 * (kDcMaxRows / kDcRows);   // B = 64
constexpr int kDcStages = 3;        // depth of the cp.async ring
constexpr int kDcMinSpan = 128;     // classes: a warp's tile at least
constexpr int kDcSmBlocks = 2;      // blocks an SM the spans fill it with

bool dc_takes(int B, int C) {
    return B <= kDcMaxRows && C > 4 * kDlMaxQuads;
}

// Row groups of a block: B over kDcRows, rounded up.
__host__ __device__ __forceinline__ int dc_groups(int B) {
    return (B + kDcRows - 1) / kDcRows;
}

// Classes a block: C's quads split over a worker's share of kDcSmBlocks
// blocks an SM (kDcSmBlocks * n_sm / k blocks, at least one), at least
// kDcMinSpan.
int dc_span(int k, int C, int n_sm) {
    const int per = (kDcSmBlocks * n_sm + k - 1) / k;
    const int span = 4 * (((C + 3) / 4 + per - 1) / per);
    return span < kDcMinSpan ? kDcMinSpan : span;
}

// Classes a tile: 4 a thread of a group's whole warps, as many as
// kDcWarps share among the groups (one at least), and no more than the
// span.
int dc_tile(int B, int span) {
    const int warps = kDcWarps / dc_groups(B);
    const int tile = 128 * (warps < 1 ? 1 : warps);
    return tile < span ? tile : span;
}

// Threads of a block: each group's whole warps over the tile's quads.
__host__ __device__ __forceinline__ int dc_threads(int B, int tile) {
    return dc_groups(B) * 32 * ((tile + 127) / 128);
}

// Floats of the route's dynamic shared memory: the ring, W and its
// transpose (B rows of the groups' rows each) and the degrees.
int dc_smem_floats(int B, int tile) {
    return kDcStages * 2 * B * tile + (2 * B + 1) * kDcRows * dc_groups(B);
}

__device__ __forceinline__ void dc_fma4(float (&acc)[4], float w,
                                        const float4& v) {
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
    acc[2] = fmaf(w, v.z, acc[2]);
    acc[3] = fmaf(w, v.w, acc[3]);
}

// The launch bounds allow the widest B's groups a warp each (512
// threads at B = 64); the plans launch at most kDcWarps warps a block up to
// B = 32 and fill each SM with kDcSmBlocks blocks (two at the LM heads).
__global__ void __launch_bounds__(kDcMaxThreads, 1)
reg_bwd_dlogp_classes(const float* __restrict__ P,
                      const float* __restrict__ L,
                      const float* __restrict__ W,
                      const float* __restrict__ g, int B, int C, int span,
                      int tile, float gc, float kappa, float ge, int vec,
                      float* __restrict__ dlogp) {
    extern __shared__ __align__(16) float ring[];
    const int tid = threadIdx.x, z = blockIdx.z;
    const int Bs = kDcRows * dc_groups(B);
    const int per_group = blockDim.x / dc_groups(B);   // whole warps
    const int q = tid % per_group, i0 = tid / per_group * kDcRows;
    const int c_begin = blockIdx.x * span, c_end = min(C, c_begin + span);
    const int n_tiles = (c_end - c_begin + tile - 1) / tile;
    const int stage_floats = 2 * B * tile;   // logP rows, then P rows
    float* Wn = ring + kDcStages * stage_floats;   // Wn[j * Bs + i] = W_ji
    float* Wt = Wn + B * Bs;                       // Wt[j * Bs + i] = W_ij
    float* degs = Wt + B * Bs;
    P += (int64_t)z * B * C;
    L += (int64_t)z * B * C;
    W += (int64_t)z * B * B;
    dlogp += (int64_t)z * B * C;
    const float gz = g[z];

    // Stage `slot` <- tile t: row j < B is logP's row j, row B + j P's.
    auto load_tile = [&](int slot, int t) {
        const int c0 = c_begin + t * tile, width = min(tile, c_end - c0);
        float* dst = ring + slot * stage_floats;
        if (vec) {
            for (Walk w(tid, blockDim.x, width / 4); w.a < 2 * B; w.next()) {
                const int j = w.a < B ? w.a : w.a - B;
                cp_async16(dst + w.a * tile + 4 * w.b,
                           (w.a < B ? L : P) + (int64_t)j * C + c0 + 4 * w.b,
                           16);
            }
        } else {   // whole quads, zero past the tile's classes
            for (Walk w(tid, blockDim.x, (width + 3) / 4 * 4); w.a < 2 * B;
                 w.next()) {
                const int j = w.a < B ? w.a : w.a - B;
                const bool ok = w.b < width;
                cp_async4(dst + w.a * tile + w.b,
                          (w.a < B ? L : P)
                              + (ok ? (int64_t)j * C + c0 + w.b : 0),
                          ok ? 4 : 0);
            }
        }
    };

    for (int s = 0; s < kDcStages - 1; ++s) {
        if (s < n_tiles) load_tile(s, s);
        cp_async_commit();
    }
    for (int e = tid; e < B * Bs; e += blockDim.x) {
        const int j = e / Bs, i = e - j * Bs;
        Wn[e] = i < B ? W[(int64_t)j * B + i] : 0.f;
        Wt[e] = i < B ? W[(int64_t)i * B + j] : 0.f;
    }
    __syncthreads();   // W staged
    for (int i = tid; i < Bs; i += blockDim.x) {
        float d = 0.f;
        for (int j = 0; j < B; ++j) d += Wt[j * Bs + i];
        degs[i] = d;
    }
    const bool padded = B % kDlPiece != 0;
    for (int t = 0; t < n_tiles; ++t) {
        cp_async_wait<kDcStages - 2>();
        __syncthreads();   // tile t landed, degrees written; t - 1's slot free
        if (t + kDcStages - 1 < n_tiles)
            load_tile((t + kDcStages - 1) % kDcStages, t + kDcStages - 1);
        cp_async_commit();
        const int c0 = c_begin + t * tile, width = min(tile, c_end - c0);
        if (4 * q >= width) continue;
        const float* Ls = ring + (t % kDcStages) * stage_floats + 4 * q;
        const float* Ps = Ls + B * tile;
        float a[kDcRows][4] = {}, b[kDcRows][4] = {};
        for (int j = 0; j < B; ++j) {
            const float4 l = *reinterpret_cast<const float4*>(Ls + j * tile);
            const float4 p = *reinterpret_cast<const float4*>(Ps + j * tile);
            const float4* wa = reinterpret_cast<const float4*>(
                Wt + j * Bs + i0);
            const float4* wb = reinterpret_cast<const float4*>(
                Wn + j * Bs + i0);
#pragma unroll
            for (int r4 = 0; r4 < kDcRows / 4; ++r4) {
                const float4 x = wa[r4], y = wb[r4];
                dc_fma4(a[4 * r4], x.x, l);
                dc_fma4(a[4 * r4 + 1], x.y, l);
                dc_fma4(a[4 * r4 + 2], x.z, l);
                dc_fma4(a[4 * r4 + 3], x.w, l);
                dc_fma4(b[4 * r4], y.x, p);
                dc_fma4(b[4 * r4 + 1], y.y, p);
                dc_fma4(b[4 * r4 + 2], y.z, p);
                dc_fma4(b[4 * r4 + 3], y.w, p);
            }
        }
#pragma unroll
        for (int r = 0; r < kDcRows; ++r) {
            const int i = i0 + r;
            if (i >= B) break;
            const float coef = kappa + ge * degs[i];
            const float* pr = Ps + i * tile;
            const float* lr = Ls + i * tile;
            float o[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float acc = a[r][e], bt = b[r][e];
                if (padded) {
                    acc = __fadd_rn(acc, 0.f);
                    bt = __fadd_rn(bt, 0.f);
                }
                const float p = pr[e];
                o[e] = gz * (-gc * (p * acc + bt) + coef * p * (lr[e] + 1.f));
            }
            float* out = dlogp + (int64_t)i * C + c0 + 4 * q;
            if (vec) {
                *reinterpret_cast<float4*>(out) =
                    make_float4(o[0], o[1], o[2], o[3]);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (4 * q + e < width) out[e] = o[e];
            }
        }
    }
}

}  // namespace

extern "C" {

// Floats of a K1 / K10 launch's workspace.  The row plan: pass 1's
// partials, one per thread of each worker's 32-row strips, then the
// class-padded copy of logP, k * B * C4 floats (C4 = C rounded up to 4).
// The class-split plan: one (B, B) partial a class chunk and worker.  -1
// if the device cannot be asked.
int graph_reg_fwd_workspace(int k, int B, int C) {
    int n_sm = 0;
    if (sm_count(&n_sm) != cudaSuccess) return -1;
    if (k >= 1 && B >= 1 && C >= 1 && cs_takes(k, B, C, n_sm)) {
        const int chunk = cs_chunk(k, B, C, n_sm);
        return k * ((C + chunk - 1) / chunk) * B * B;
    }
    return fwd_n_partials(k, B) + k * B * pad4(C);
}

// Floats of a K2 launch's workspace: on the row route the class-padded
// copies of P and of logP, k * B * C4 floats each; none on the class
// route.
int graph_reg_bwd_dlogp_workspace(int k, int B, int C) {
    return dc_takes(B, C) ? 0 : 2 * k * B * pad4(C);
}

// Rows per block, dynamic shared memory (bytes) of pass 1, the class
// chunk and pass 1's blocks of a K1 / K10 launch: the row plan's rows and
// chunk 0, or the class-split plan's tile rows (min(B, 64)) and chunk
// width; `blocks` is the grid launch_fwd gives pass 1.
int graph_reg_fwd_plan(int k, int B, int C, int* rows, int* smem,
                       int* chunk, int* blocks) {
    if (k < 1 || B < 1 || C < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    int n_sm = 0;
    const cudaError_t err = sm_count(&n_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (cs_takes(k, B, C, n_sm)) {
        *rows = B < kCsTile ? B : kCsTile;
        *smem = static_cast<int>(sizeof(float)) * cs_smem_floats(B);
        *chunk = cs_chunk(k, B, C, n_sm);
    } else {
        *rows = rows_to_fill((int64_t)k * 32 * ((B + 31) / 32),
                             n_sm, 4, 4 * kFwdMaxPairs);
        *smem = static_cast<int>(sizeof(float)) * fwd_smem_floats(*rows, C);
        *chunk = 0;
    }
    const dim3 g = fwd_grid(k, B, C, *rows, *chunk);
    *blocks = static_cast<int>(g.x * g.y * g.z);
    return 0;
}

// Rows per block, dynamic shared memory (bytes), the class span (0 on
// the row route), blocks and threads a block of a K2 launch: on the class
// route every block holds all B rows of its span.
int graph_reg_bwd_dlogp_plan(int k, int B, int C, int* rows, int* smem,
                             int* span, int* blocks, int* threads) {
    if (k < 1 || B < 1 || C < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    int n_sm = 0;
    const cudaError_t err = sm_count(&n_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dc_takes(B, C)) {
        *span = dc_span(k, C, n_sm);
        const int tile = dc_tile(B, *span);
        *rows = B;
        *smem = static_cast<int>(sizeof(float)) * dc_smem_floats(B, tile);
        *blocks = k * ((C + *span - 1) / *span);
        *threads = dc_threads(B, tile);
        return 0;
    }
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
    *span = 0;
    *blocks = 2 * ((B + *rows - 1) / *rows) * n_chunks * k;
    *threads = *rows / 2 * quads;
    return 0;
}

}  // extern "C"

namespace {

// The class-split plan's two passes (reg_fwd_class_partials, then
// reg_fwd_class_sum), the partials in the workspace.
int launch_fwd_classes(const float* p, const float* logp, const float* W,
                       int k, int B, int C, int chunk, int smem, float gc,
                       float kappa, float ge, int full, float* partials,
                       float* out, cudaStream_t s) {
    const dim3 grid = fwd_grid(k, B, C, 0, chunk);
    // 16-byte copies need C a multiple of 4 and P, logP aligned.
    const int vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0
                    && reinterpret_cast<uintptr_t>(logp) % 16 == 0;
    cudaError_t err = allow_dynamic_smem<reg_fwd_class_partials>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    reg_fwd_class_partials<<<grid, kThreads, smem, s>>>(
        p, logp, B, C, chunk, vec, partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    reg_fwd_class_sum<<<k, kCsSumThreads, sizeof(float) * B, s>>>(
        partials, W, B, grid.x, gc, kappa, ge, full, out);
    return static_cast<int>(cudaGetLastError());
}

template <bool kFull>
int launch_fwd(const void* p, const void* logp, const void* W, int k, int B,
               int C, float gc, float kappa, float ge, void* workspace,
               void* out, cudaStream_t s) {
    int rows = 0, smem = 0, chunk = 0, blocks = 0;
    int rc = graph_reg_fwd_plan(k, B, C, &rows, &smem, &chunk, &blocks);
    if (rc != 0) return rc;
    if (chunk > 0)
        return launch_fwd_classes(
            static_cast<const float*>(p), static_cast<const float*>(logp),
            static_cast<const float*>(W), k, B, C, chunk, smem, gc, kappa,
            ge, kFull, static_cast<float*>(workspace),
            static_cast<float*>(out), s);
    float* partials = static_cast<float*>(workspace);
    float* L4 = partials + fwd_n_partials(k, B);
    rc = launch_pad(static_cast<const float*>(logp), nullptr, (int64_t)k * B,
                    C, L4, nullptr, s);
    if (rc != 0) return rc;
    const int n_strips = (B + 31) / 32;
    // 16-byte copies of W's rows need B a multiple of 4 and W aligned.
    const int vec_w = B % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
    cudaError_t err = allow_dynamic_smem<reg_fwd_partials<kFull>>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    reg_fwd_partials<kFull>
        <<<fwd_grid(k, B, C, rows, 0), 8 * rows, smem, s>>>(static_cast<const float*>(p), static_cast<const float*>(logp),
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
// aligned (none on the class route); dlogp is the (k, B, C) output.
int graph_reg_bwd_dlogp(const void* p, const void* logp, const void* W,
                        const void* g, int k, int B, int C, float gc,
                        float kappa, float ge, void* workspace, void* dlogp,
                        void* stream) {
    int rows = 0, smem = 0, span = 0, blocks = 0, threads = 0;
    int rc = graph_reg_bwd_dlogp_plan(k, B, C, &rows, &smem, &span, &blocks,
                                      &threads);
    if (rc != 0) return rc;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (span > 0) {
        // 16-byte copies and stores need C a multiple of 4 and P, logP and
        // dlogp aligned.
        const int vec = C % 4 == 0
                        && reinterpret_cast<uintptr_t>(p) % 16 == 0
                        && reinterpret_cast<uintptr_t>(logp) % 16 == 0
                        && reinterpret_cast<uintptr_t>(dlogp) % 16 == 0;
        const cudaError_t err =
            allow_dynamic_smem<reg_bwd_dlogp_classes>(smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        reg_bwd_dlogp_classes<<<dim3(blocks / k, 1, k), threads, smem, s>>>(
            static_cast<const float*>(p), static_cast<const float*>(logp),
            static_cast<const float*>(W), static_cast<const float*>(g), B, C,
            span, dc_tile(B, span), gc, kappa, ge, vec,
            static_cast<float*>(dlogp));
        return static_cast<int>(cudaGetLastError());
    }
    const int quads = dl_quads(C);
    const int n_chunks = (C + 4 * kDlMaxQuads - 1) / (4 * kDlMaxQuads);
    const cudaError_t err = allow_dynamic_smem<reg_bwd_dlogp>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
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

namespace {

// The kernels graph_reg_occupancy answers for, by index: the order of
// graph_reg.OCCUPANCY_KERNELS.
const OccupancyQuery kOccupancy[] = {
    occupancy<reg_fwd_partials<true>>,
    occupancy<reg_fwd_partials<false>>,
    occupancy<reg_bwd_dlogp>,
    occupancy<reg_bwd_dw>,
    occupancy<pad_classes>,
    occupancy<reg_fwd_tree_sum>,
    occupancy<reg_fwd_class_partials>,
    occupancy<reg_fwd_class_sum>,
    occupancy<reg_bwd_dlogp_classes>,
};

}  // namespace

extern "C" {

// Blocks an SM holds at once of entry `kernel` of kOccupancy, launched
// with `threads` threads and `smem` bytes of dynamic shared memory, and
// the kernel's registers a thread and static shared memory, as the
// runtime reads them.
int graph_reg_occupancy(int kernel, int threads, int smem, int* blocks,
                        int* registers, int* static_smem) {
    return occupancy_of(kOccupancy, kernel, threads, smem, blocks, registers,
                        static_smem);
}

}  // extern "C"
