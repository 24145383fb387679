// Asynchronous 16-byte copies from device memory into shared memory
// (cp.async, sm_80 and later), shared by the attention kernels' tile rings.
//
// A kernel issues the copies of the next tile, commits them as one group and
// computes on the current tile; cp_async_wait<N> then blocks until at most N
// groups are still in flight, and a __syncthreads makes the copies of every
// thread visible to the block. Replaces the TPU kernels' double-buffered
// pltpu.make_async_copy + semaphore pattern.
#pragma once

#include <cstdint>

namespace gofr {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from `src` to `dst`, bypassing L1 (.cg). When `valid` is
// false the source size is 0: nothing is read and `dst` is zero-filled, so
// rows past the data never hold stale values. `src` must still be a mapped
// address (callers pass the matrix base).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Copy 4 bytes (a block-table entry) from `src` to `dst`, through L1 (.ca:
// the 16-byte .cg form is the only one that bypasses it).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace gofr
