// Device helpers shared by the port's kernels (csrc/*.cu): 32-bit division
// by a run-time constant, the zero-filling asynchronous copy with its
// commit and wait (sm_80+), and 16-byte vectors of 8 bf16 or 4 float32
// to and from float32 registers.
#pragma once

#include <cuda_bf16.h>
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

// The 8 bf16 of a 16-byte vector as float32, and back, rounded to nearest even;
// 8 float32 from two 16-byte loads.
__device__ __forceinline__ void bf16x8_to_float(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 float_to_bf16x8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ void load_float8(const float4* p, float (&f)[8]) {
  const float4 lo = __ldg(p), hi = __ldg(p + 1);
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

}  // namespace dfv
