// cp.async helpers shared by the port's kernels (sm_80 and later): a
// 16-byte copy from global to shared memory that does not pass through
// registers, committed in groups and waited on before a barrier.

#pragma once

#include <cuda_runtime.h>

namespace tcsdn {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until every copy this thread committed has landed; a barrier
// after it makes all threads' copies visible to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace tcsdn
