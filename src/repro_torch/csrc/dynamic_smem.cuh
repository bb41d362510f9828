// Per-device queries of the launches, each asked once per device, and the
// runtime's occupancy of each kernel.
//
// Dynamic shared memory past the default allowance, used by K1, K2 and K10
// (graph_reg.cu), K5 (graph_reg_bsp.cu), K8 and K9 (pairwise.cu).  A kernel
// may take 48 KB of shared memory, static and dynamic together, unless it
// first raises its cudaFuncAttributeMaxDynamicSharedMemorySize on the
// current device.
// allow_dynamic_smem<kernel>(bytes) raises it only when a launch needs
// more than the device allows the kernel now, and keeps that allowance
// per device, so a launch of a shape that has run before (also one under
// stream capture) calls no attribute function.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSmemMaxDevices = 64;

template <auto kKernel>
cudaError_t allow_dynamic_smem(size_t bytes) {
    static bool known[kSmemMaxDevices];
    static size_t allowed[kSmemMaxDevices];   // dynamic bytes, per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kSmemMaxDevices) return cudaErrorInvalidDevice;
    if (!known[dev]) {
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, kKernel);
        if (err != cudaSuccess) return err;
        allowed[dev] = static_cast<size_t>(attr.maxDynamicSharedSizeBytes);
        known[dev] = true;
    }
    if (bytes <= allowed[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kKernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err == cudaSuccess) allowed[dev] = bytes;
    return err;
}

// The number of SMs of the current device, which K1 and K2 size their
// grids to fill, K8 its column segments and K9 its tile rows.
inline cudaError_t sm_count(int* n) {
    static int known[kSmemMaxDevices];   // per device, 0 until asked
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kSmemMaxDevices) return cudaErrorInvalidDevice;
    if (known[dev] == 0) {
        err = cudaDeviceGetAttribute(&known[dev],
                                     cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
    }
    *n = known[dev];
    return cudaSuccess;
}

// The runtime's reading of one kernel: the blocks of `threads` threads and
// `smem` bytes of dynamic shared memory an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after raising the
// kernel's allowance as its launch does), and its registers a thread and
// static shared memory (cudaFuncGetAttributes).
using OccupancyQuery = cudaError_t (*)(int, int, int*, int*, int*);

template <auto kKernel>
cudaError_t occupancy(int threads, int smem, int* blocks, int* registers,
                      int* static_smem) {
    cudaError_t err = allow_dynamic_smem<kKernel>(static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kKernel);
    if (err != cudaSuccess) return err;
    *registers = attr.numRegs;
    *static_smem = static_cast<int>(attr.sharedSizeBytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kKernel, threads, static_cast<size_t>(smem));
}

// Entry `kernel` of a library's occupancy table.
template <int N>
int occupancy_of(const OccupancyQuery (&table)[N], int kernel, int threads,
                 int smem, int* blocks, int* registers, int* static_smem) {
    if (kernel < 0 || kernel >= N || threads < 1 || smem < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        table[kernel](threads, smem, blocks, registers, static_smem));
}

}  // namespace
