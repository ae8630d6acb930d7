// The grid of a persistent launch (csrc/cost.cu, csrc/extract.cu): as many
// blocks as the card holds at once, each walking its share of the work
// items (item blockIdx.x, + gridDim.x, ...), so that the card fills at one
// frame and a block's loads for its next item overlap its current one.

#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace fsgm_persistent {

// Blocks of `kernel` the card holds at once with `threads` threads and
// `shmem` bytes of dynamic shared memory each: cudaOccupancyMaxActive-
// BlocksPerMultiprocessor x SMs, after raising the kernel's dynamic shared-
// memory limit to shmem and preferring shared memory to L1 where it takes
// any.  `cache` keeps the last answer with its (device, shmem), so a launch
// asks the CUDA runtime again only when either changes.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t shmem,
                            std::atomic<long long>& cache, long long* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const long long key = ((long long)shmem << 24) | ((long long)dev << 16);
  const long long hit = cache.load(std::memory_order_relaxed);
  if (hit != 0 && (hit & ~0xffffLL) == key) {
    *blocks = hit & 0xffff;
    return cudaSuccess;
  }
  if (shmem > 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, shmem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || (long long)per_sm * sms > 0xffff)
    return cudaErrorInvalidConfiguration;
  *blocks = (long long)per_sm * sms;
  cache.store(key | *blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace fsgm_persistent
