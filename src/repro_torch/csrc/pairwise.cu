// Hopper (sm_90a) kernels for k-NN graph construction (paper section 3).
// Plain C interface, loaded with ctypes by repro_torch/kernels/pairwise.py;
// every entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError().
//
// Shapes: queries x (N, D), candidates y (M, D), their squared row norms
// nx (N,) and ny (M,), all float32, row-major and contiguous.  Both kernels
// form the squared distance as the reference does,
//
//     d2_ij = max(nx_i - 2 <x_i, y_j> + ny_j, 0),
//
// with <x_i, y_j> from the distance engine of d2_tile.cuh: register-tiled
// products over feature-major, zero-padded copies of x and y (pack_t),
// which each entry point writes into the workspace first.  Each product
// is one fmaf chain in increasing feature order from +0 (no TF32, no
// tensor cores), the order of the 32 x 64 tile these kernels used before
// their redesign, so their outputs keep those bits.
//
//   K8 knn_topk      per row i the k smallest d2_ij and their j, sorted by
//                    (d2, j); with exclude_self the pair j == i is skipped.
//   K9 rbf_affinity  w_ij = exp(-sqrt(d2_ij) / (2 sigma^2)), the dense block.
//
// K8 replaces repro/kernels/pairwise.py:_knn_topk (_topk_kernel).  Its TPU
// grid walks the column chunks in order and keeps the running top-k in
// VMEM scratch between grid steps.  Here a block owns a 128-row strip and
// one segment of the column tiles, which it walks in increasing j with the
// running lists of its rows in shared memory (k <= kKMax) or in global
// memory (k > kKMax: the outputs' rows, or the segment's partial lists).
// After each 128 x 128 tile a thread's distances below its row's current
// k-th value are buffered through shared-memory slot counters, and the
// buffers are merged into the lists by rank, one warp a row, when one is
// half full (or at the segment's end); a second pass merges the
// segments' sorted lists of each row by rank.  The result is the k
// smallest entries under the total order (d2, j), a unique set: it does
// not depend on the order of the buffering or of the merges, so no merge
// order is fixed, and the lists are those of the 32-row strip kernel K8
// had before, bit for bit.
// Bound on an H100 by operations: 2*N*M*D flops (4.19 ms at N = M =
// 20000, D = 351, 67 TFLOP/s f32).  The segments fill the card (157
// strips of the corpus on 132 SMs are 1.19 waves); the 128-row strips
// stream y through L2 157 times instead of 625.  No N x M buffer exists,
// and no atomics but the integer slot counters are used, so repeats are
// bit-identical.
//
// K9 replaces repro/kernels/pairwise.py:rbf_affinity_pallas
// (_pairwise_kernel): one block per kBM x 128 output tile (kBM = 128, or
// 64 where that leaves fewer tile rows per SM: rbf_affinity_plan), the
// RBF epilogue in registers, stored with 16-byte writes along j where the
// rows allow, edges masked.  Bound by operations at the meta-batch's shape
// (2*P*P*D flops).

#include "d2_tile.cuh"
#include "dynamic_smem.cuh"

namespace {

// Largest k of K8's shared-memory route: the block's 128 running lists of
// k (d2, j) pairs, kD2Rows * k * kListEntryBytes bytes, beside the ring
// and the candidate buffers (knn_smem_bytes), fit the 227 KB a block can
// have.  Past it (the global route, any k <= M) each row's list lives in
// global memory: the row of the outputs (one segment) or of the segment's
// partial lists in the workspace.
constexpr int kKMax = 120;
constexpr int kListEntryBytes = sizeof(float) + sizeof(int);
// Candidates a row buffers per merge round; more wait for the next round.
constexpr int kCandCap = 32;
// Segments: at most kMaxSegments, each at least kMinSegmentTiles column
// tiles long, their partial lists at most kSegmentBytesCap bytes (knn_plan).
constexpr int kMaxSegments = 16;
constexpr int kMinSegmentTiles = 4;
constexpr int64_t kSegmentBytesCap = 256ll << 20;
constexpr float kEmpty = 3.4e38f;   // d2 of an unfilled list slot (index -1)

__host__ __device__ __forceinline__ int64_t cdiv(int64_t a, int64_t b) {
    return (a + b - 1) / b;
}

// Dynamic shared memory of a K8 block: the ring, the candidate buffers
// (kD2Rows x kCandCap pairs), each warp's sorted candidates (32 pairs),
// each row's squared norm, k-th value and slot counter, and on the shared
// route the lists.
__host__ __device__ constexpr int64_t knn_smem_bytes(int k) {
    return 4ll * kD2Stages * d2_stage_floats<kD2Rows>()
           + (int64_t)kD2Rows * kCandCap * kListEntryBytes
           + (kD2Threads / 32) * 32 * kListEntryBytes
           + (int64_t)kD2Rows * (2 * sizeof(float) + sizeof(int))
           + (k <= kKMax ? (int64_t)kD2Rows * k * kListEntryBytes : 0);
}

static_assert(knn_smem_bytes(kKMax) <= 232448,
              "the shared route's lists fit a block's shared memory");

struct KnnPlan {
    int n_strips, n_col_tiles, segments, seg_tiles, n_slabs;
    int64_t Np, Mp, smem, pack_floats, workspace;
};

KnnPlan knn_plan(int N, int M, int D, int k, int same, int n_sm) {
    KnnPlan p;
    p.n_strips = static_cast<int>(cdiv(N, kD2Rows));
    p.n_col_tiles = static_cast<int>(cdiv(M, kD2Cols));
    p.n_slabs = d2_features(D) / kD2K;
    p.Np = (int64_t)p.n_strips * kD2Rows;
    p.Mp = (int64_t)p.n_col_tiles * kD2Cols;
    // The fewest segments S that minimise the column tiles one SM walks,
    // one block at a time: ceil(strips * S / n_sm) blocks of ceil(tiles /
    // S) tiles (at the corpus, 157 strips and tiles on 132 SMs: S = 5, 6
    // blocks of 32 tiles, where S = 7 gives 9 of 23).
    const int64_t by_tiles = p.n_col_tiles / kMinSegmentTiles;
    const int64_t by_bytes =
        kSegmentBytesCap / ((int64_t)N * k * kListEntryBytes);
    int64_t s_max = kMaxSegments < by_tiles ? kMaxSegments : by_tiles;
    s_max = s_max < by_bytes ? s_max : by_bytes;
    int64_t s = 1, best = cdiv(p.n_strips, n_sm) * p.n_col_tiles;
    for (int64_t t = 2; t <= s_max; ++t) {
        const int64_t cost =
            cdiv(p.n_strips * t, n_sm) * cdiv(p.n_col_tiles, t);
        if (cost < best) {
            best = cost;
            s = t;
        }
    }
    p.seg_tiles = static_cast<int>(cdiv(p.n_col_tiles, s));
    p.segments = static_cast<int>(cdiv(p.n_col_tiles, p.seg_tiles));
    p.smem = knn_smem_bytes(k);
    p.pack_floats = (int64_t)d2_features(D) * (p.Np + (same ? 0 : p.Mp));
    p.workspace = 4 * p.pack_floats
                  + (p.segments > 1 ? (int64_t)p.segments * N * k
                                      * kListEntryBytes : 0);
    return p;
}

// (d, j) before (e, f) in the total order (d2, j).
__device__ __forceinline__ bool before(float d, int j, float e, int f) {
    return d < e || (d == e && j < f);
}

// Merge n <= 32 candidates (cd, cj), distinct and unordered, into the
// sorted list (Ld, Li) of k <= 32 entries, one warp: lane t holds entry t
// and candidate t, each goes to its rank in the union, and what ranks k
// or later drops out.
__device__ __forceinline__ void merge_small(float* Ld, int* Li, int k,
                                            const float* cd, const int* cj,
                                            int n) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const bool has_e = lane < k, has_c = lane < n;
    const float ed = has_e ? Ld[lane] : 0.f;
    const int ej = has_e ? Li[lane] : 0;
    const float d = has_c ? cd[lane] : 0.f;
    const int j = has_c ? cj[lane] : 0;
    int pos = 0, rc = 0, ahead = 0;
    for (int m = 0; m < n; ++m) {
        const float dm = __shfl_sync(full, d, m);
        const int jm = __shfl_sync(full, j, m);
        rc += before(dm, jm, d, j);          // candidates before mine
        ahead += before(dm, jm, ed, ej);     // candidates before my entry
        const unsigned b =
            __ballot_sync(full, has_e && before(ed, ej, dm, jm));
        if (lane == m) pos = __popc(b);      // entries before candidate m
    }
    __syncwarp();
    if (has_e && lane + ahead < k) {
        Ld[lane + ahead] = ed;
        Li[lane + ahead] = ej;
    }
    if (has_c && pos + rc < k) {
        Ld[pos + rc] = d;
        Li[pos + rc] = j;
    }
    __syncwarp();
}

// The same for any k, one warp: the candidates sorted into the warp's
// scratch (sd, sj); each candidate's place in the list by binary search;
// the entries from the first place up move, 32 at a time from the top
// down, by the number of candidates before them (each chunk read before
// it is written, and no entry moves down, so none is overwritten unread);
// then the candidates are written.
__device__ __forceinline__ void merge_any(float* Ld, int* Li, int k,
                                          const float* cd, const int* cj,
                                          int n, float* sd, int* sj) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const bool has_c = lane < n;
    const float d = has_c ? cd[lane] : 0.f;
    const int j = has_c ? cj[lane] : 0;
    int rc = 0;
    for (int m = 0; m < n; ++m)
        rc += before(__shfl_sync(full, d, m), __shfl_sync(full, j, m), d, j);
    if (has_c) {
        sd[rc] = d;
        sj[rc] = j;
    }
    int pos = k;
    if (has_c) {
        int lo = 0, hi = k;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (before(Ld[mid], Li[mid], d, j)) lo = mid + 1; else hi = mid;
        }
        pos = lo;
    }
    const int first = __reduce_min_sync(full, pos);
    __syncwarp();   // sd, sj
    if (first < k) {
        for (int base = first + (k - 1 - first) / 32 * 32; base >= first;
             base -= 32) {
            const int t = base + lane;
            float ed = 0.f;
            int ej = 0, to = k;
            if (t < k) {
                ed = Ld[t];
                ej = Li[t];
                int lo = 0, hi = n;
                while (lo < hi) {
                    const int mid = (lo + hi) >> 1;
                    if (before(sd[mid], sj[mid], ed, ej)) lo = mid + 1;
                    else hi = mid;
                }
                to = t + lo;
            }
            __syncwarp();
            if (to < k) {
                Ld[to] = ed;
                Li[to] = ej;
            }
            __syncwarp();
        }
    }
    if (has_c && pos + rc < k) {
        Ld[pos + rc] = d;
        Li[pos + rc] = j;
    }
    __syncwarp();
}

// K8, pass 1.  Block b owns strip b / S (rows i0 .. i0 + 127) and segment
// s = b % S (column tiles s*seg_tiles ..), and leaves its rows' sorted
// lists in (out_d, out_i) at ((s * N + i) * k): the outputs when S = 1,
// the partial lists otherwise.  On the shared route the lists live in
// shared memory until the end.  kSmall (k <= 32, the paper's k = 10)
// merges in registers (merge_small), the others with merge_any.  One
// block an SM: held to 128 registers for two, the kernel spills.
template <bool kGlobalLists, bool kSmall>
__global__ void __launch_bounds__(kD2Threads, 1)
knn_topk_kernel(const float* __restrict__ XT, const float* __restrict__ YT,
                int Np, int Mp, int n_slabs, const float* __restrict__ nx,
                const float* __restrict__ ny, int N, int M, int k,
                int exclude_self, int segments, int seg_tiles,
                int n_col_tiles, float* __restrict__ out_d,
                int* __restrict__ out_i) {
    extern __shared__ __align__(16) float smem[];
    float* ring = smem;
    float* cand_d = ring + kD2Stages * d2_stage_floats<kD2Rows>();
    int* cand_j = reinterpret_cast<int*>(cand_d + kD2Rows * kCandCap);
    float* sort_d = reinterpret_cast<float*>(cand_j + kD2Rows * kCandCap);
    int* sort_j = reinterpret_cast<int*>(sort_d + kD2Threads);
    float* nxs = reinterpret_cast<float*>(sort_j + kD2Threads);
    float* kth = nxs + kD2Rows;
    int* cnt = reinterpret_cast<int*>(kth + kD2Rows);
    float* sl_d = reinterpret_cast<float*>(cnt + kD2Rows);
    int* sl_i = reinterpret_cast<int*>(sl_d + kD2Rows * k);

    const int strip = blockIdx.x / segments;
    const int seg = blockIdx.x - strip * segments;
    const int i0 = strip * kD2Rows, jt0 = seg * seg_tiles;
    const int n_tiles = min(seg_tiles, n_col_tiles - jt0);
    const int rows = min(kD2Rows, N - i0);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // This block's (rows, k) lists, row-major, in global memory.
    auto dst_d = [&] { return out_d + ((int64_t)seg * N + i0) * k; };
    auto dst_i = [&] { return out_i + ((int64_t)seg * N + i0) * k; };
    float* Ld = kGlobalLists ? dst_d() : sl_d;
    int* Li = kGlobalLists ? dst_i() : sl_i;

    for (int e = tid; e < rows * k; e += kD2Threads) {
        Ld[e] = kEmpty;
        Li[e] = -1;
    }
    if (tid < kD2Rows) {
        nxs[tid] = i0 + tid < N ? nx[i0 + tid] : 0.f;
        kth[tid] = kEmpty;
        cnt[tid] = 0;
    }
    __syncthreads();

    auto epilogue = [&](int jt, float (&acc)[8][8]) {
        const int j0 = jt * kD2Cols;
        float nyc[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const int j = j0 + d2_col(c);
            nyc[c] = j < M ? ny[j] : 0.f;
        }
        // Bit 8r + c: (r, c) is below its row's k-th value, not yet
        // buffered.  Within one segment every earlier entry has a lower j,
        // so a strict "<" keeps the (d2, j) order here.
        unsigned long long pend = 0;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int i = i0 + d2_row(r);
            const float a = nxs[d2_row(r)], thr = kth[d2_row(r)];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const int j = j0 + d2_col(c);
                const float d2 = fmaxf(a - 2.f * acc[r][c] + nyc[c], 0.f);
                acc[r][c] = d2;
                const bool live = i < N && j < M && !(exclude_self && j == i)
                                  && d2 < thr;
                pend |= (unsigned long long)live << (8 * r + c);
            }
        }
        // Buffer the tile's candidates; merge the buffers into the lists
        // only when a candidate found no slot, a buffer is half full, or
        // the segment ends (kth lags the lists meanwhile, so more pass the
        // filter; the merges drop them).
        const bool last = jt == jt0 + n_tiles - 1;
        for (;;) {
            bool full = false;
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int c = 0; c < 8; ++c) {
                    const unsigned long long bit = 1ull << (8 * r + c);
                    if (pend & bit) {
                        const int row = d2_row(r);
                        const int slot = atomicAdd(&cnt[row], 1);
                        if (slot < kCandCap) {
                            cand_d[row * kCandCap + slot] = acc[r][c];
                            cand_j[row * kCandCap + slot] = j0 + d2_col(c);
                            pend &= ~bit;
                        }
                        full |= slot >= kCandCap / 2;
                    }
                }
            if (!__syncthreads_or(pend != 0 || full || last)) break;
            for (int row = warp * (kD2Rows / 8);
                 row < (warp + 1) * (kD2Rows / 8); ++row) {
                const int n = min(cnt[row], kCandCap);
                if (n > 0) {
                    if (kSmall)
                        merge_small(Ld + row * k, Li + row * k, k,
                                    cand_d + row * kCandCap,
                                    cand_j + row * kCandCap, n);
                    else
                        merge_any(Ld + row * k, Li + row * k, k,
                                  cand_d + row * kCandCap,
                                  cand_j + row * kCandCap, n,
                                  sort_d + 32 * warp, sort_j + 32 * warp);
                }
                __syncwarp();   // every lane has read cnt[row]
                if (lane == 0 && n > 0) {
                    kth[row] = Ld[row * k + k - 1];
                    cnt[row] = 0;
                }
            }
            __syncthreads();
            // Entries of this tile may now precede a k-th entry of the same
            // tile with a higher j: keep what is not above the k-th value
            // (the merge drops what does not belong).
#pragma unroll
            for (int r = 0; r < 8; ++r) {
                const float thr = kth[d2_row(r)];
#pragma unroll
                for (int c = 0; c < 8; ++c)
                    if (acc[r][c] > thr) pend &= ~(1ull << (8 * r + c));
            }
            if (!__syncthreads_or(pend != 0)) break;
        }
    };
    d2_stream<kD2Rows>(XT, YT, Np, Mp, n_slabs, i0, jt0, n_tiles, ring,
                       epilogue);
    if (!kGlobalLists) {
        __syncthreads();
        float* od = dst_d();
        int* oi = dst_i();
        for (int e = tid; e < rows * k; e += kD2Threads) {
            od[e] = sl_d[e];
            oi[e] = sl_i[e];
        }
    }
}

// K8, pass 2 (S > 1 segments): out row i = the first k of the S sorted
// partial lists of row i, one warp a row.  Entry t of list s has rank t +
// (entries before it in each other list), ties between equal pairs (the
// unfilled slots) going to the lower segment, so the ranks are a
// permutation and each output slot is written once.
__global__ void __launch_bounds__(kD2Threads)
knn_merge_segments(const float* __restrict__ part_d,
                   const int* __restrict__ part_i, int N, int k,
                   int segments, float* __restrict__ out_d,
                   int* __restrict__ out_i) {
    const int64_t i = ((int64_t)blockIdx.x * kD2Threads + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (i >= N) return;
    const int64_t stride = (int64_t)N * k;
    const float* pd = part_d + i * k;
    const int* pi = part_i + i * k;
    for (int e = lane; e < segments * k; e += 32) {
        const int s = e / k, t = e - s * k;
        const float d = pd[s * stride + t];
        const int j = pi[s * stride + t];
        int rank = t;
        for (int o = 0; o < segments && rank < k; ++o) {
            if (o == s) continue;
            const float* od = pd + o * stride;
            const int* oi = pi + o * stride;
            int lo = 0, hi = k;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                const bool ahead = o < s ? !before(d, j, od[mid], oi[mid])
                                         : before(od[mid], oi[mid], d, j);
                if (ahead) lo = mid + 1; else hi = mid;
            }
            rank += lo;
        }
        if (rank < k) {
            out_d[i * k + rank] = d;
            out_i[i * k + rank] = j;
        }
    }
}

// K9: one block per kBM x 128 output tile.
template <int kBM>
__global__ void __launch_bounds__(kD2Threads, 2)
rbf_affinity_kernel(const float* __restrict__ XT,
                    const float* __restrict__ YT, int Np, int Mp, int n_slabs,
                    const float* __restrict__ nx, const float* __restrict__ ny,
                    int N, int M, float sigma, int vec,
                    float* __restrict__ out) {
    extern __shared__ __align__(16) float ring[];
    const int i0 = blockIdx.y * kBM;
    auto epilogue = [&](int jt, float (&acc)[kBM / 16][8]) {
        const int j0 = jt * kD2Cols;
        const float den = 2.f * sigma * sigma;
        float nyc[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const int j = j0 + d2_col(c);
            nyc[c] = j < M ? ny[j] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kBM / 16; ++r) {
            const int i = i0 + d2_row(r);
            if (i >= N) continue;
            const float a = nx[i];
            float w[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const float d2 = fmaxf(a - 2.f * acc[r][c] + nyc[c], 0.f);
                w[c] = expf(-sqrtf(d2) / den);
            }
            float* row = out + (int64_t)i * M;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int j = j0 + d2_col(4 * h);
                if (vec && j + 3 < M) {
                    *reinterpret_cast<float4*>(row + j) = make_float4(
                        w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]);
                } else {
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (j + e < M) row[j + e] = w[4 * h + e];
                }
            }
        }
    };
    d2_stream<kBM>(XT, YT, Np, Mp, n_slabs, i0, blockIdx.x, 1, ring,
                   epilogue);
}

// K9's tile rows: 128, or 64 where that gives each SM fewer rows of tiles
// to run (ceil(tiles / n_sm) * rows), e.g. at 2176 x 2176 (289 tiles of
// 128^2 on 132 SMs: 3 a SM, 384 rows; 578 of 64 x 128: 5, 320 rows).
int rbf_rows(int N, int M, int n_sm) {
    const int64_t ct = cdiv(M, kD2Cols);
    const int64_t at128 = cdiv(cdiv(N, 128) * ct, n_sm) * 128;
    const int64_t at64 = cdiv(cdiv(N, 64) * ct, n_sm) * 64;
    return at64 < at128 ? 64 : 128;
}

template <int kBM>
int launch_rbf(const float* XT, const float* YT, int64_t Np, int64_t Mp,
               int n_slabs, const float* nx, const float* ny, int N, int M,
               float sigma, float* out, cudaStream_t s) {
    constexpr int smem = 4 * kD2Stages * d2_stage_floats<kBM>();
    const cudaError_t err = allow_dynamic_smem<rbf_affinity_kernel<kBM>>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // 16-byte stores need 16-byte rows: M a multiple of 4 and out aligned.
    const int vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const dim3 grid(static_cast<unsigned>(cdiv(M, kD2Cols)),
                    static_cast<unsigned>(cdiv(N, kBM)));
    rbf_affinity_kernel<kBM><<<grid, kD2Threads, smem, s>>>(
        XT, YT, static_cast<int>(Np), static_cast<int>(Mp), n_slabs, nx, ny,
        N, M, sigma, vec, out);
    return static_cast<int>(cudaGetLastError());
}

// x and y are one operand (packed once) when they are the same rows.
bool same_rows(const void* x, const void* y, int N, int M) {
    return x == y && N == M;
}

template <bool kGlobalLists, bool kSmall>
int launch_knn(const KnnPlan& p, unsigned blocks, const float* XT,
               const float* YT, const float* nx, const float* ny, int N,
               int M, int k, int exclude_self, float* lists_d, int* lists_i,
               cudaStream_t s) {
    const cudaError_t err =
        allow_dynamic_smem<knn_topk_kernel<kGlobalLists, kSmall>>(p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    knn_topk_kernel<kGlobalLists, kSmall><<<blocks, kD2Threads, p.smem, s>>>(
        XT, YT, static_cast<int>(p.Np), static_cast<int>(p.Mp), p.n_slabs, nx,
        ny, N, M, k, exclude_self, p.segments, p.seg_tiles, p.n_col_tiles,
        lists_d, lists_i);
    return static_cast<int>(cudaGetLastError());
}

int plan_knn(int N, int M, int D, int k, int same, KnnPlan* p) {
    if (N < 1 || M < 1 || D < 0 || k < 1 || k > M)
        return static_cast<int>(cudaErrorInvalidValue);
    int n_sm = 0;
    const cudaError_t err = sm_count(&n_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    *p = knn_plan(N, M, D, k, same, n_sm);
    return 0;
}

}  // namespace

extern "C" {

// Segments, dynamic shared memory (bytes) and workspace (bytes) of a K8
// launch on the current card; same = x and y are the same rows (one
// packed copy).
int knn_topk_plan(int N, int M, int D, int k, int same, int* segments,
                  int* smem, int64_t* workspace) {
    KnnPlan p;
    const int rc = plan_knn(N, M, D, k, same, &p);
    if (rc != 0) return rc;
    *segments = p.segments;
    *smem = static_cast<int>(p.smem);
    *workspace = p.workspace;
    return 0;
}

// workspace holds knn_topk_plan's bytes, 16-byte aligned; d2 and idx are
// the (N, k) outputs.
int knn_topk(const void* x, const void* y, const void* nx, const void* ny,
             int N, int M, int D, int k, int exclude_self, void* workspace,
             void* d2, void* idx, void* stream) {
    const int same = same_rows(x, y, N, M);
    KnnPlan p;
    int rc = plan_knn(N, M, D, k, same, &p);
    if (rc != 0) return rc;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* XT = static_cast<float*>(workspace);
    float* YT = same ? XT : XT + d2_features(D) * p.Np;
    rc = launch_pack(static_cast<const float*>(x), N, D,
                     static_cast<int>(p.Np), XT, s);
    if (rc == 0 && !same)
        rc = launch_pack(static_cast<const float*>(y), M, D,
                         static_cast<int>(p.Mp), YT, s);
    if (rc != 0) return rc;
    float* lists_d = static_cast<float*>(d2);
    int* lists_i = static_cast<int*>(idx);
    if (p.segments > 1) {
        lists_d = XT + p.pack_floats;
        lists_i = reinterpret_cast<int*>(lists_d
                                         + (int64_t)p.segments * N * k);
    }
    const unsigned blocks = static_cast<unsigned>(p.n_strips) * p.segments;
    const float* nxp = static_cast<const float*>(nx);
    const float* nyp = static_cast<const float*>(ny);
    rc = k > kKMax ? launch_knn<true, false>(p, blocks, XT, YT, nxp, nyp, N,
                                             M, k, exclude_self, lists_d,
                                             lists_i, s)
         : k > 32  ? launch_knn<false, false>(p, blocks, XT, YT, nxp, nyp, N,
                                              M, k, exclude_self, lists_d,
                                              lists_i, s)
                   : launch_knn<false, true>(p, blocks, XT, YT, nxp, nyp, N,
                                             M, k, exclude_self, lists_d,
                                             lists_i, s);
    if (rc != 0 || p.segments == 1) return rc;
    knn_merge_segments<<<static_cast<unsigned>(cdiv(N, kD2Threads / 32)),
                         kD2Threads, 0, s>>>(
        lists_d, lists_i, N, k, p.segments, static_cast<float*>(d2),
        static_cast<int*>(idx));
    return static_cast<int>(cudaGetLastError());
}

// Tile rows and workspace (bytes) of a K9 launch on the current card.
int rbf_affinity_plan(int N, int M, int D, int same, int* rows,
                      int64_t* workspace) {
    if (N < 1 || M < 1 || D < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    int n_sm = 0;
    const cudaError_t err = sm_count(&n_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    *rows = rbf_rows(N, M, n_sm);
    *workspace = 4 * (int64_t)d2_features(D)
                 * (d2_round_up(N, kD2Rows)
                    + (same ? 0 : d2_round_up(M, kD2Cols)));
    return 0;
}

// workspace holds rbf_affinity_plan's bytes, 16-byte aligned; out is the
// (N, M) block.
int rbf_affinity(const void* x, const void* y, const void* nx,
                 const void* ny, int N, int M, int D, float sigma,
                 void* workspace, void* out, void* stream) {
    const int same = same_rows(x, y, N, M);
    int rows = 0;
    int64_t bytes = 0;
    int rc = rbf_affinity_plan(N, M, D, same, &rows, &bytes);
    if (rc != 0) return rc;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t Np = d2_round_up(N, kD2Rows), Mp = d2_round_up(M, kD2Cols);
    float* XT = static_cast<float*>(workspace);
    float* YT = same ? XT : XT + d2_features(D) * Np;
    rc = launch_pack(static_cast<const float*>(x), N, D,
                     static_cast<int>(Np), XT, s);
    if (rc == 0 && !same)
        rc = launch_pack(static_cast<const float*>(y), M, D,
                         static_cast<int>(Mp), YT, s);
    if (rc != 0) return rc;
    const int n_slabs = d2_features(D) / kD2K;
    const float* nxp = static_cast<const float*>(nx);
    const float* nyp = static_cast<const float*>(ny);
    float* o = static_cast<float*>(out);
    return rows == 64
        ? launch_rbf<64>(XT, YT, Np, Mp, n_slabs, nxp, nyp, N, M, sigma, o, s)
        : launch_rbf<128>(XT, YT, Np, Mp, n_slabs, nxp, nyp, N, M, sigma, o,
                          s);
}

}  // extern "C"

namespace {

// The kernels pairwise_occupancy answers for, by index: the order of
// pairwise.OCCUPANCY_KERNELS.
const OccupancyQuery kOccupancy[] = {
    occupancy<knn_topk_kernel<false, true>>,
    occupancy<knn_topk_kernel<false, false>>,
    occupancy<knn_topk_kernel<true, false>>,
    occupancy<knn_merge_segments>,
    occupancy<pack_t>,
    occupancy<rbf_affinity_kernel<64>>,
    occupancy<rbf_affinity_kernel<128>>,
};

}  // namespace

extern "C" {

// Blocks an SM holds at once of entry `kernel` of kOccupancy, launched
// with `threads` threads and `smem` bytes of dynamic shared memory, and
// the kernel's registers a thread and static shared memory, as the
// runtime reads them.
int pairwise_occupancy(int kernel, int threads, int smem, int* blocks,
                       int* registers, int* static_smem) {
    return occupancy_of(kOccupancy, kernel, threads, smem, blocks, registers,
                        static_smem);
}

}  // extern "C"
