// Asynchronous global -> shared copies (cp.async, sm_80 and later) and the
// cluster launch shared by the kernels that stage their operands in rings.
#pragma once
#include <cuda_runtime.h>

// Copy 16 bytes; bytes past src_bytes (0 or 16) are written as zeros, so a
// ragged edge is masked by passing 0 (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes));
}

// Copy 4 bytes (for rows that are not 16-byte aligned); 0 src_bytes -> 0.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Launch `kernel` on a 3-D grid whose x dimension is cut into clusters of
// `cluster` blocks (grid.x must be a multiple of it); the launch error.
template <typename... KArgs, typename... Args>
int launch_clustered(void (*kernel)(KArgs...), dim3 grid, int threads,
                     size_t smem, cudaStream_t stream, int cluster,
                     Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
