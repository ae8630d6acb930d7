// Hopper's asynchronous copies from device memory into shared memory
// (cp.async), shared by K2's walk (sgm_walk.cuh), K3 (extract.cu) and K4
// (extract_flow.cu): a copy of 16 or 4 bytes, the commit of the copies
// issued so far as one group, and a wait until at most N groups are still
// in flight.

#pragma once

#include <cuda_runtime.h>

namespace fsgm_cp {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace fsgm_cp
