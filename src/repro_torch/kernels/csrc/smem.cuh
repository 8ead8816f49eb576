// Dynamic shared memory above 48 KB: a kernel must be granted it with
// cudaFuncSetAttribute before its launch. Granting it on every launch costs
// host time on the decode path, so each kernel is granted the opt-in
// maximum once per device and process.
#pragma once
#include <cuda_runtime.h>

// The dynamic shared memory one block of Kernel may take on the current
// device (the opt-in maximum less the kernel's static shared memory),
// granted on the first call for each device; -1 on a CUDA error.
template <auto Kernel>
int grant_max_dynamic_smem() {
    static int limit[64];
    static bool done[64];
    int dev;
    if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return -1;
    if (!done[dev]) {
        int optin;
        cudaFuncAttributes fa;
        if (cudaDeviceGetAttribute(&optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev) != cudaSuccess ||
            cudaFuncGetAttributes(&fa, Kernel) != cudaSuccess)
            return -1;
        const int lim = optin - (int)fa.sharedSizeBytes;
        if (cudaFuncSetAttribute(Kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 lim) != cudaSuccess)
            return -1;
        limit[dev] = lim;
        done[dev] = true;
    }
    return limit[dev];
}

// The error to return when grant_max_dynamic_smem failed.
inline int smem_grant_error() {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorUnknown;
}
