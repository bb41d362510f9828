// Hopper (sm_90a) tensor-core route of kernel K11 (flash attention
// forward), for bfloat16 with head dim 64, 112 or 128.  Included by
// flash_attention.cu, whose entry point flash_attention_fwd dispatches
// here; float32, and bfloat16 with head dim 16 or 32, stay on the FMA
// kernel there.
//
// It computes what the FMA kernel computes, with the reference's parity
// points (repro/kernels/flash_attention.py:_flash_fwd_kernel): q already
// scaled in bf16 by the wrapper, s = q.k summed in float32, masked to
// -1e30, m_new = max(m, rowmax s), p = exp(s - m_new) kept in float32 for
// the row sum l, p rounded to bf16 (to nearest) before P.V, o = acc /
// max(l, 1e-30) cast to bf16; query row t at Tk - Tq + t, query head h on
// KV head h / (H / KV).  Only the schedule and the hardware units differ.
//
// Bound on an H100 at the serve path's shape (q (4, 2048, 12, 128), k/v
// (4, 2048, 2, 128), causal): 5.15e10 flops, 0.052 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against 58.7 MB of q, k, v and o (0.018 ms): bound
// by operations, so both products run on the tensor cores (wgmma) and the
// loads run on the TMA, off the threads' instruction stream.
//
// Design.  One block owns 128 query rows of one (batch, head): two
// warpgroups of 64 rows, 256 threads, the heaviest causal blocks first.
// Keys come in 128-key tiles.
//   * Tiles: HD columns are held in a tile of padded width HDP (HD rounded
//     up to 64: one or two 128-byte swizzle rows).  hd 112 (kimi-k2's,
//     224-byte rows) takes the tile of hd 128: its second box covers
//     columns 64-127 of a tensor map whose rows end at 112, so the TMA
//     fills columns 112-127 with zeros (and counts them in the bytes the
//     mbarrier expects, as it counts rows past T).
//   * Loads: the TMA (cp.async.bulk.tensor) copies 4-D boxes of the (hd,
//     heads, T, B) layout, 64 columns (one 128-byte swizzle row) by 128
//     rows, with the 128-byte swizzle; HDP / 64 boxes a tile.  Q is
//     loaded once; K and V go through a 2-stage ring with one mbarrier per
//     stage that carries the expected bytes.  Thread 0 issues tile j+1
//     before the block computes on tile j; a block-wide barrier at the end
//     of each iteration frees the stage.  Rows past Tq or Tk are filled
//     with zeros by the TMA; keys past Tk are also masked by bounds, and
//     query rows past Tq are never written.
//   * S = Q.K^T: HD/16 wgmma m64n128k16 per warpgroup (7 at hd 112: the
//     zero columns 112-127 are skipped), A (its 64 Q rows) and B (K,
//     K-major) read from shared memory through descriptors of the
//     128-byte swizzle layout (a 16-column step is +32 bytes of the start
//     address inside a swizzle row).
//   * Online softmax in registers, on the accumulator fragment: thread
//     (warp w, lane l) holds rows 16w + l/4 and 16w + l/4 + 8 of its
//     warpgroup; row max and row sum reduce in the thread, then over the
//     4 lanes of a quad.  The mask runs only on tiles that cross the
//     diagonal or Tk; the loop ends at the last tile holding a key at or
//     before the block's last query (exact: later tiles have p = 0 and
//     alpha = 1).  exp(x) is ex2.approx(x * log2 e).
//   * P.V: wgmma m64n{HDP}k16 with A from registers.  For 16-bit A the S
//     accumulator's registers 8k..8k+7, rounded to bf16 in pairs, are the
//     A fragment of the k-th 16-key slice, so P never leaves registers.
//     B is V read from shared memory as MN-major (the transpose bit).  The
//     O accumulator (HDP/2 floats a thread; at hd 112 its columns 112-127
//     stay 0 and are never stored) is rescaled by alpha in registers
//     before each P.V.
//   * Epilogue: acc / max(l, 1e-30) to bf16, HD columns stored from
//     registers, rows masked at Tq.  Nothing is atomic: two launches give
//     the same bits.
//
// Shared memory: Q + 2 x (K + V), 128 rows x HDP bf16 each (160 KB at hd
// 112 and 128, 80 KB at hd 64), aligned to 1024 bytes for the swizzle,
// then the three mbarriers.  Tensor maps are encoded on the host per
// launch through cudaGetDriverEntryPoint, so no driver library is linked.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver library is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace k11_wgmma {

constexpr int kBQ = 128;        // query rows per block: two warpgroups of 64
constexpr int kBK = 128;        // keys per tile
constexpr int kThreads = 256;
constexpr int kBoxCols = 64;    // bf16 columns in one 128-byte swizzle row
constexpr uint32_t kBoxBytes = 128 * 128;  // one 64-column box of 128 rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The padded tile width of head dim HD: HD rounded up to whole 64-column
// boxes.  HD must be a multiple of 16 (one wgmma k-step) and at most 128
// (two boxes), so no instantiation loads a partial row.
template <int HD>
__host__ __device__ constexpr int padded_hd() {
    static_assert(HD % 16 == 0 && HD > 0 && HD <= 2 * kBoxCols,
                  "the wgmma route takes head dims of whole 16-column "
                  "steps that fit two 64-column boxes");
    return (HD + kBoxCols - 1) / kBoxCols * kBoxCols;
}

// Bytes of one 128-row tile of HDP columns, and of the kernel's shared
// memory: Q, two (K, V) stages, three mbarriers, 1024 bytes of alignment.
template <int HD>
__host__ __device__ constexpr uint32_t tile_bytes() {
    return (padded_hd<HD>() / kBoxCols) * kBoxBytes;
}
template <int HD>
__host__ __device__ constexpr size_t smem_bytes() { return 5 * tile_bytes<HD>() + 64 + 1024; }

__device__ __forceinline__ void mbar_init(uint32_t bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// One 64-column by 128-row box at (col, head, row, batch) into shared
// memory at dst, completing on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
        "r"(row), "r"(batch)
        : "memory");
}

// Rows [row, row + 128) of one head, all HDP columns, as HDP/64 boxes
// (columns past HD read as zeros).
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int row,
                                          int batch) {
#pragma unroll
    for (int c = 0; c < padded_hd<HD>() / kBoxCols; ++c)
        tma_load(dst + c * kBoxBytes, map, bar, c * kBoxCols, head, row, batch);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>(lbo >> 4) << 16 |
           static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// Two floats rounded to bf16 (to nearest), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 128, f32) (+)= A (64 x 16, bf16, shared, K-major) . B (128 x 16,
// bf16, shared, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a,
                                                  uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, bf16, registers) . B (16 x 128, bf16,
// shared, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16, registers) . B (16 x 64, bf16,
// shared, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int Tq, int Tk, int H,
                       int KV, int causal) {
    constexpr uint32_t kTile = tile_bytes<HD>();
    constexpr int kHDP = padded_hd<HD>();
    constexpr int kAcc = kHDP / 2;  // O accumulator floats per thread
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base =
        (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
        ~1023u;
    // Q at base; stage s: K at base + (1 + 2s) kTile, V right after it;
    // mbarriers: Q at bar_q, stage s at bar_q + 8 (1 + s).
    const uint32_t sQ = base;
    const uint32_t bar_q = base + 5 * kTile;

    const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
              lane = tid & 31;
    const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
    const int q_offset = Tk - Tq;
    // Keys past the block's last query position are masked whole (causal
    // skip, exact).
    const int kv_end = causal ? min(Tk, q_offset + min(q0 + kBQ, Tq)) : Tk;
    const int n_tiles = (kv_end + kBK - 1) / kBK;

    if (tid == 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i) mbar_init(bar_q + 8 * i);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        mbar_expect_tx(bar_q, kTile);
        load_tile<HD>(sQ, &tm_q, bar_q, h, q0, b);
        mbar_expect_tx(bar_q + 8, 2 * kTile);
        load_tile<HD>(base + kTile, &tm_k, bar_q + 8, kvh, 0, b);
        load_tile<HD>(base + 2 * kTile, &tm_v, bar_q + 8, kvh, 0, b);
    }

    // This thread's rows of the block: row0 and row0 + 8.
    const int row0 = 64 * wg + 16 * warp + (lane >> 2);
    const int qpos0 = q_offset + q0 + row0;
    const int cb = 2 * (lane & 3);  // first column of each 8-column group
    const int wg_first_q = q_offset + q0 + 64 * wg;
    const uint32_t sQ_wg = sQ + 64 * wg * 128;  // this warpgroup's 64 rows

    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1, j0 = it * kBK;
        if (tid == 0 && it + 1 < n_tiles) {
            const uint32_t nk = base + (1 + 2 * (st ^ 1)) * kTile;
            const uint32_t nbar = bar_q + 8 * (1 + (st ^ 1));
            mbar_expect_tx(nbar, 2 * kTile);
            load_tile<HD>(nk, &tm_k, nbar, kvh, j0 + kBK, b);
            load_tile<HD>(nk + kTile, &tm_v, nbar, kvh, j0 + kBK, b);
        }
        const uint32_t sK = base + (1 + 2 * st) * kTile, sV = sK + kTile;
        mbar_wait(bar_q + 8 * (1 + st), (it >> 1) & 1);

        // S = Q.K^T (64 x 128 per warpgroup), K-major A and B.
        float s[64];
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
            wgmma_m64n128k16_ss(s, sw128_desc(sQ_wg + off, 16, 1024),
                                sw128_desc(sK + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // Mask only where the tile crosses this warpgroup's diagonal or Tk.
        if (j0 + kBK > Tk || (causal && j0 + kBK - 1 > wg_first_q)) {
            const int lim0 = causal ? min(Tk - 1, qpos0) : Tk - 1;
            const int lim1 = causal ? min(Tk - 1, qpos0 + 8) : Tk - 1;
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int key = j0 + 8 * j + cb + e;
                    if (key > lim0) s[4 * j + e] = kNegInf;
                    if (key > lim1) s[4 * j + 2 + e] = kNegInf;
                }
        }

        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
            mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float al0 = ex2((m0 - mx0) * kLog2e);
        const float al1 = ex2((m1 - mx1) * kLog2e);
        m0 = mx0;
        m1 = mx1;
        // l is kept per thread (its columns) and summed over the quad at
        // the end: every lane of a quad scales by the same alpha.
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                s[4 * j + e] = ex2((s[4 * j + e] - mx0) * kLog2e);
                s[4 * j + 2 + e] = ex2((s[4 * j + 2 + e] - mx1) * kLog2e);
                rs0 += s[4 * j + e];
                rs1 += s[4 * j + 2 + e];
            }
        l0 = l0 * al0 + rs0;
        l1 = l1 * al1 + rs1;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            acc[4 * j] *= al0;
            acc[4 * j + 1] *= al0;
            acc[4 * j + 2] *= al1;
            acc[4 * j + 3] *= al1;
        }
        // The A fragment of 16-key slice k is S's registers 8k..8k+7.
        uint32_t p[8][4];
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
            for (int r = 0; r < 4; ++r)
                p[k][r] = pack_bf16(s[8 * k + 2 * r], s[8 * k + 2 * r + 1]);

        // O += P.V, V MN-major: a 16-key slice is 16 rows of 128 bytes; the
        // second 64 columns (hd 112 and 128) are one box further (the
        // leading byte offset).
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const uint64_t vd = sw128_desc(sV + k * 16 * 128, kBoxBytes, 1024);
            if constexpr (kHDP == 128)
                wgmma_m64n128k16_rs(acc, p[k], vd);
            else
                wgmma_m64n64k16_rs(acc, p[k], vd);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        __syncthreads();  // stage st is free for the load of tile it + 2
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const int t0 = q0 + row0;
    const int64_t row_stride = static_cast<int64_t>(H) * HD;
    __nv_bfloat16* out =
        o + (static_cast<int64_t>(b) * Tq + t0) * row_stride +
        static_cast<int64_t>(h) * HD + cb;
    if (t0 < Tq) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
                __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
    }
    if (t0 + 8 < Tq) {
        out += 8 * row_stride;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
                __floats2bfloat162_rn(acc[4 * j + 2] / d1,
                                      acc[4 * j + 3] / d1);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
inline EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p)
                   : nullptr;
    }();
    return fn;
}

// The (hd, heads, T, B) view of a contiguous (B, T, heads, hd) bf16 tensor,
// in 64-column by 128-row boxes with the 128-byte swizzle; out-of-bounds
// rows, and columns past hd (the padded tile of hd 112), read as zeros.
inline bool encode_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                       int hd, int heads, int T, int B) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                                static_cast<cuuint64_t>(heads),
                                static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
    const cuuint64_t strides[3] = {row, row * heads, row * heads * T};
    const cuuint32_t box[4] = {kBoxCols, 1, 128, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<void*>(ptr), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q, k, v and o contiguous bf16, every pointer 16-byte aligned (the TMA's
// rule; the row strides, hd * 2 bytes, are multiples of 16 for hd 64, 112
// and 128).
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int Tk, int H, int KV, int causal, cudaStream_t stream) {
    for (const void* ptr : {q, k, v, static_cast<const void*>(o)})
        if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
            return static_cast<int>(cudaErrorMisalignedAddress);
    const int n_qblocks = (Tq + kBQ - 1) / kBQ;
    if (n_qblocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    CUtensorMap mq, mk, mv;
    if (!encode_map(enc, &mq, q, HD, H, Tq, B) ||
        !encode_map(enc, &mk, k, HD, KV, Tk, B) ||
        !encode_map(enc, &mv, v, HD, KV, Tk, B))
        return static_cast<int>(cudaErrorInvalidValue);
    constexpr size_t smem = smem_bytes<HD>();
    auto kernel = flash_fwd_wgmma_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(B * H, n_qblocks);
    kernel<<<grid, kThreads, smem, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(o), Tq, Tk, H, KV, causal);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace k11_wgmma
