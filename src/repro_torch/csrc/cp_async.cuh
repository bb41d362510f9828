// Asynchronous global -> shared copies (cp.async, sm_80 and later), used by
// the redesigned K1-K3 (graph_reg.cu), K5 (graph_reg_bsp.cu) and K8-K9
// (d2_tile.cuh).  A copy with src-size bytes < the copy size zero-fills
// the rest of the shared destination, so masked elements are written as 0
// without a branch; the source address of a fully masked copy is never
// read, but must still be a valid global address.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in
// flight (a barrier then publishes every thread's copies).
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

}  // namespace
