// Helpers shared by the COO kernels (dsc.cu, wc.cu).  Plain CUDA C++: no
// PyTorch header is included anywhere under csrc/, so nvcc builds each
// kernel in seconds (route (b): a shared library with a C interface, loaded
// from Python with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

// Storage types of the dictionary and the Phi values: float, or bf16 widened
// on load.  Every sum is taken in float.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Dictionary loads: from shared memory when the kernel staged D there, else
// from device memory through the read-only data cache.
template <bool kSmem, typename T>
__device__ __forceinline__ float load_dict(const T* p) {
  if constexpr (kSmem) {
    return to_float(*p);
  } else {
    return to_float(__ldg(p));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Shared memory one block may use after opting in (227 KB on an H100).
static inline int smem_optin_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return bytes;
}

// Grid for a kernel whose blocks stride over `work_items` row blocks: as
// many blocks as fit on the SMs at once (never more than there is work),
// so per-block set-up such as staging the dictionary is paid once per
// resident block.  Opts the kernel in to `smem` bytes of dynamic shared
// memory first when that exceeds the 48 KB default.
template <typename Kernel>
static cudaError_t resident_grid(Kernel kernel, int threads, size_t smem,
                                 int work_items, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long g = static_cast<long long>(sms) * per_sm;
  if (g > work_items) g = work_items;
  *grid = static_cast<int>(g < 1 ? 1 : g);
  return cudaSuccess;
}
