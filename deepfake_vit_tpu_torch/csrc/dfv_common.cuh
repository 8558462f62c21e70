// Device helpers shared by the port's kernels (csrc/*.cu): 32-bit division
// by a run-time constant, and the zero-filling asynchronous copy with its
// commit and wait (sm_80+).
#pragma once

#include <cuda_runtime.h>

namespace dfv {

// floor(v / d) for v * d < 2^32: v times the reciprocal ceil(2^32 / d).
__device__ __forceinline__ unsigned recip32(unsigned d) { return 0xffffffffu / d + 1u; }
__device__ __forceinline__ unsigned div_by(unsigned v, unsigned d, unsigned rcp) {
  return d == 1u ? v : __umulhi(v, rcp);
}

// kW-byte asynchronous copy (16, 8 or 4), device memory -> shared memory:
// the first src_bytes come from gmem_src, the rest are zeros.
template <int kW>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* gmem_src, int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  if constexpr (kW == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem_src),
                 "n"(kW), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace dfv
