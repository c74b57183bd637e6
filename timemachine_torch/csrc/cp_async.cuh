// Asynchronous global -> shared-memory copies (cp.async) of the sweeps'
// staging rings (rowscan.cu, nb_tiles.cu): copy 16 bytes, close a group of
// copies, wait until at most N groups are pending. Both addresses 16-byte
// aligned; a barrier after the wait makes the copies visible to the block.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
