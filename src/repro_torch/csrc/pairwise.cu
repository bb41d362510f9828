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
// with <x_i, y_j> summed in float32 over the feature axis by the tile code
// of the graph-regularizer kernels (graph_reg_tiles.cuh: 32 x 64 output
// tile, 16-wide feature slabs staged in shared memory, plain fmaf, no
// TF32).
//
//   K8 knn_topk      per row i the k smallest d2_ij and their j, sorted by
//                    (d2, j); with exclude_self the pair j == i is skipped.
//   K9 rbf_affinity  w_ij = exp(-sqrt(d2_ij) / (2 sigma^2)), the dense block.
//
// K8 replaces repro/kernels/pairwise.py:_knn_topk (_topk_kernel).  Its TPU
// grid walks the column chunks in order and keeps the running top-k in
// VMEM scratch between grid steps.  CUDA blocks run in no order, so here
// one block owns a 32-row strip and loops over ALL column chunks itself,
// in increasing j; the running top-k of each row lives in shared memory
// (k <= kKMax) or in the row's outputs (k > kKMax) and is owned by one
// warp.  Bound on an H100 by operations: 2*N*M*D flops
// (4.19 ms at N = M = 20000, D = 351, 67 TFLOP/s f32); no N x M buffer
// exists anywhere, and no atomics are used, so repeats are bit-identical.
//
// K9 replaces repro/kernels/pairwise.py:rbf_affinity_pallas
// (_pairwise_kernel): one block per 32 x 64 output tile, the reference's
// zero padding replaced by masks at the edges.  Bound by operations at the
// meta-batch's shape (2*P*P*D flops).

#include "dynamic_smem.cuh"
#include "graph_reg_tiles.cuh"

namespace {

// Largest k of K8's shared-memory route.  The block's 32 running lists of
// k (d2, j) pairs live in dynamic shared memory, kRows * k *
// kListEntryBytes bytes: 64 KB at k = 256, above the 48 KB a launch gets
// without opting in.  Past it (the global route, any k <= M) each row's
// list lives in its own row of the outputs, which the wrapper allocates
// (N * k * kListEntryBytes bytes): the lists need no other workspace and
// no final copy.  The merge code is the same on both routes: a row's
// list is owned by one warp, and __syncwarp orders lane 0's inserts
// before the warp's next reads in either memory.
constexpr int kKMax = 256;
constexpr int kListEntryBytes = sizeof(float) + sizeof(int);

// Thread (ty, tx) of xy_tile holds d2 of rows ty+8r and columns tx+32c of
// the tile, so warp ty holds all 64 columns of its four rows: it merges
// them into those rows' running lists with no shared-memory tile and no
// block barrier.  A warp ballot picks the columns below the row's current
// k-th distance; lane 0 inserts them one by one in increasing j, each
// after any equal entries.  Visiting j in increasing order with a strict
// "<" test gives the reference's order: ties go to the lowest index.
template <bool kGlobalLists>
__global__ void __launch_bounds__(kThreads)
knn_topk_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                const float* __restrict__ nx, const float* __restrict__ ny,
                int N, int M, int D, int k, int exclude_self,
                float* __restrict__ out_d2, int* __restrict__ out_idx) {
    __shared__ float Xs[kChunk][kRows + 1];
    __shared__ float Ys[kChunk][kCols + 1];
    extern __shared__ float lists[];            // best_d then best_i, row-major
    const int i0 = blockIdx.x * kRows;
    // (kRows, k) each, row-major: shared memory, or the outputs' rows.
    float* best_d = kGlobalLists ? out_d2 + (int64_t)i0 * k : lists;
    int* best_i = kGlobalLists ? out_idx + (int64_t)i0 * k
                               : reinterpret_cast<int*>(lists + kRows * k);
    const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
    const unsigned full = 0xffffffffu;

    if (kGlobalLists) {
        for (int row = ty; row < kRows && i0 + row < N; row += 8)
            for (int t = tx; t < k; t += 32) {
                best_d[row * k + t] = 3.4e38f;
                best_i[row * k + t] = -1;
            }
    } else {
        for (int e = tid; e < kRows * k; e += kThreads) {
            best_d[e] = 3.4e38f;
            best_i[e] = -1;
        }
    }
    float nxr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 8 * r;
        nxr[r] = i < N ? nx[i] : 0.f;
    }
    __syncthreads();   // the lists are written block-wide, read per warp

    for (int j0 = 0; j0 < M; j0 += kCols) {
        float acc[4][2] = {};
        xy_tile(X, Y, N, M, D, i0, j0, Xs, Ys, acc);
        float nyc[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int j = j0 + tx + 32 * c;
            nyc[c] = j < M ? ny[j] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int row = ty + 8 * r, i = i0 + row;
            if (i >= N) continue;                 // uniform across the warp
            float* bd = best_d + row * k;
            int* bi = best_i + row * k;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int j = j0 + tx + 32 * c;
                const float d2 = fmaxf(nxr[r] - 2.f * acc[r][c] + nyc[c], 0.f);
                const bool live = j < M && !(exclude_self && j == i);
                unsigned cand = __ballot_sync(full, live && d2 < bd[k - 1]);
                while (cand) {                    // uniform: a ballot result
                    const int src = __ffs(cand) - 1;
                    cand &= cand - 1;
                    const float v = __shfl_sync(full, d2, src);
                    if (tx == 0 && v < bd[k - 1]) {
                        int p = k - 1;
                        for (; p > 0 && bd[p - 1] > v; --p) {
                            bd[p] = bd[p - 1];
                            bi[p] = bi[p - 1];
                        }
                        bd[p] = v;
                        bi[p] = j0 + 32 * c + src;
                    }
                }
                __syncwarp();                     // lane 0's inserts visible
            }
        }
    }
#pragma unroll
    for (int r = 0; r < 4 && !kGlobalLists; ++r) {
        const int row = ty + 8 * r, i = i0 + row;
        if (i >= N) continue;
        for (int t = tx; t < k; t += 32) {
            out_d2[(int64_t)i * k + t] = best_d[row * k + t];
            out_idx[(int64_t)i * k + t] = best_i[row * k + t];
        }
    }
}

// K9: one block per (32 x 64 output tile); the inner products over all
// features, then the RBF epilogue, written once, coalesced along j.
__global__ void __launch_bounds__(kThreads)
rbf_affinity_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                    const float* __restrict__ nx, const float* __restrict__ ny,
                    int N, int M, int D, float sigma, float* __restrict__ out) {
    __shared__ float Xs[kChunk][kRows + 1];
    __shared__ float Ys[kChunk][kCols + 1];
    const int i0 = blockIdx.y * kRows, j0 = blockIdx.x * kCols;
    const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;

    float acc[4][2] = {};
    xy_tile(X, Y, N, M, D, i0, j0, Xs, Ys, acc);
    const float den = 2.f * sigma * sigma;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 8 * r;
        if (i >= N) continue;
        const float a = nx[i];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int j = j0 + tx + 32 * c;
            if (j >= M) continue;
            const float d2 = fmaxf(a - 2.f * acc[r][c] + ny[j], 0.f);
            out[(int64_t)i * M + j] = expf(-sqrtf(d2) / den);
        }
    }
}

}  // namespace

extern "C" {

int knn_topk(const void* x, const void* y, const void* nx, const void* ny,
             int N, int M, int D, int k, int exclude_self, void* d2,
             void* idx, void* stream) {
    if (k < 1 || k > M) return static_cast<int>(cudaErrorInvalidValue);
    const int n_strips = (N + kRows - 1) / kRows;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (k > kKMax) {
        knn_topk_kernel<true><<<n_strips, kThreads, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(y),
            static_cast<const float*>(nx), static_cast<const float*>(ny), N,
            M, D, k, exclude_self, static_cast<float*>(d2),
            static_cast<int*>(idx));
        return static_cast<int>(cudaGetLastError());
    }
    const size_t lists = (size_t)kRows * k * kListEntryBytes;
    const cudaError_t err = allow_dynamic_smem<knn_topk_kernel<false>>(lists);
    if (err != cudaSuccess) return static_cast<int>(err);
    knn_topk_kernel<false><<<n_strips, kThreads, lists, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(nx), static_cast<const float*>(ny), N, M, D,
        k, exclude_self, static_cast<float*>(d2), static_cast<int*>(idx));
    return static_cast<int>(cudaGetLastError());
}

int rbf_affinity(const void* x, const void* y, const void* nx,
                 const void* ny, int N, int M, int D, float sigma, void* out,
                 void* stream) {
    const dim3 grid((M + kCols - 1) / kCols, (N + kRows - 1) / kRows);
    rbf_affinity_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(nx), static_cast<const float*>(ny), N, M, D,
        sigma, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
