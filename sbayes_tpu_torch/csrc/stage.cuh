// Staging of a chain's tables from device memory into shared memory.
//
// Both kernels run one block per chain and read the chain's tables many
// times, so each table row goes to shared memory once. A row whose source
// address, destination address and size are all multiples of 16 bytes is
// copied by Hopper's bulk-copy engine (cp.async.bulk, started by one lane of
// the first warp, the rows dealt round over its lanes; completion counted in
// bytes on an mbarrier), which costs the block one instruction per row and no
// registers. Any other row (odd shapes, a ragged last feature tile) is
// loaded by the threads of the block with plain loads.
// Both paths are part of the same kernel; the choice is the same in every
// thread because it depends on addresses and sizes only.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace sbt {

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Called by one thread; the block synchronises before any other use.
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of a phase, announcing the bytes of its bulk copies.
__device__ __forceinline__ void barrier_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// dst[r * row_len + i] = src[r * src_stride + i] for r < n_rows, i < row_len,
// called by every thread of the block. Returns the bytes handed to the
// bulk-copy engine (the same value in every thread): thread 0 passes their
// sum to barrier_arrive_expect, everyone then waits on the barrier and on
// __syncthreads() (for the rows loaded with plain loads). A copy that another
// lane started may complete before thread 0 announces its bytes: the phase
// cannot end before thread 0's arrival, which is the only one it waits for.
template <typename T>
__device__ uint32_t stage_rows(T* dst, const T* src, int n_rows, int row_len, size_t src_stride,
                               uint64_t* bar) {
  if ((size_t)row_len == src_stride) {  // rows are contiguous: one long row
    row_len *= n_rows;
    n_rows = 1;
  }
  const uint32_t bytes = (uint32_t)row_len * sizeof(T);
  uint32_t queued = 0;
  for (int r = 0; r < n_rows; ++r) {
    T* d = dst + (size_t)r * row_len;
    const T* s = src + (size_t)r * src_stride;
    const bool aligned =
        bytes > 0 && ((bytes | shared_addr(d) | (uint32_t)reinterpret_cast<uintptr_t>(s)) & 15u) == 0;
    if (aligned) {
      if (threadIdx.x == (r & 31)) bulk_copy(d, s, bytes, bar);
      queued += bytes;
    } else {
      for (int i = threadIdx.x; i < row_len; i += blockDim.x) d[i] = s[i];
    }
  }
  return queued;
}

}  // namespace sbt
