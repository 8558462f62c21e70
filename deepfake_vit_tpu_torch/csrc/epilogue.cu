// The EfficientNet backbone's BatchNorm epilogues in inference, one bf16
// channels-last pass each (sm_90a): BatchNorm + SiLU (bn_act_kernel),
// BatchNorm with an optional residual add (bn_add_kernel) and the
// squeeze-excite gate (se_gate_kernel).
//
// These replace no TPU kernel: XLA fused each BatchNorm and the elementwise
// operations around it into the convolution's neighbours in the JAX
// package. Eager PyTorch runs about nine float32 passes per BatchNorm
// instead (the cast up, x - mean, * mul, + bias, the cast down, then SiLU,
// the gate or the residual as passes of their own), each a broadcast over a
// channels-last tensor that takes PyTorch's generic strided kernel.
//
// What bounds them on an H100: bytes. Each moves 2 bytes in and 2 out per
// element (a residual or gate 2 more in) against a few operations, about
// 0.5 operations a byte, far below the card's 295: at 3.35 TB/s block 2's
// expand output (128 x 112 x 112 x 144 bf16, 0.925 GB in and out) takes
// 0.276 ms at best. The design moves each byte once, 16 bytes at a time:
// one thread owns 8 consecutive channels of a pixel (one 16-byte load and
// store, neighbouring threads on neighbouring addresses), and the grid is a
// whole number of pixel rows of C / 8 threads, so a thread keeps the same 8
// channels on every step of its grid-stride loop and loads their three
// factors into registers once. A step covers kEpilogueUnroll vectors and
// loads the next step's before it computes: the SiLU's expf and division
// take about 30 instructions an element, and without the prefetch a warp
// computing has no load in flight. Three blocks of 256 threads an SM (at
// most 85 registers a thread); four, more unrolling or no prefetch measured
// slower on an H100 (bn_act at block 2's expand: 0.335 ms against
// 0.351-0.424 ms for seven other shapes of the loop; a plain device copy of
// the same bytes 0.308 ms).
//
// Rounding: the eager path's, bit for bit. BatchNorm is ((x - mean) * mul)
// + bias, each step rounded in float32 (__fsub_rn / __fmul_rn / __fadd_rn:
// nvcc would otherwise contract them to an FMA), then rounded to bf16; SiLU
// is v / (1 + expf(-v)) in float32 on that bf16 value, rounded to bf16; the
// residual f32(bf16) + f32(bf16) and the gate f32(x) * f32(gate), each
// rounded to bf16. mul = rsqrt(var + eps) * weight comes from the caller,
// computed by the same torch expression as the eager BatchNorm.
// Plain C interface, loaded with ctypes; the plain PyTorch versions are in
// deepfake_vit_tpu_torch/ops/bn_epilogue.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dfv_common.cuh"

namespace dfv {

constexpr int kEpilogueThreads = 256;
constexpr int kEpilogueBlocksPerSm = 3;  // ops/bn_epilogue.py::EPILOGUE_BLOCKS_PER_SM
constexpr int kEpilogueUnroll = 2;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

enum EpilogueMode : int { kBnSilu = 0, kBn = 1, kBnResidual = 2, kSeGate = 3 };

// One pass over nvec 16-byte vectors of a channels-last tensor whose pixels
// hold cv = C / 8 vectors. The grid's first lanes * cv threads run; a
// thread's vectors are t, t + lanes * cv, ... so its channels never change.
// factors: (3, C) float32 mean, mul, bias. other: the residual (same shape
// as x) or the gate ((B, C) bf16, hwcv = H * W * cv vectors an image).
template <int kMode>
__device__ __forceinline__ void epilogue_pass(const uint4* __restrict__ x,
                                              const uint4* __restrict__ other,
                                              uint4* __restrict__ out,
                                              const float* __restrict__ factors, unsigned nvec,
                                              unsigned cv, unsigned hwcv, unsigned lanes) {
  const unsigned stride = lanes * cv;
  const unsigned t = blockIdx.x * kEpilogueThreads + threadIdx.x;
  if (t >= stride) return;
  const unsigned c8 = t % cv;
  float mean[8], mul[8], bias[8];
  if constexpr (kMode != kSeGate) {
    const float4* f4 = reinterpret_cast<const float4*>(factors) + 2 * c8;
    load_float8(f4, mean);
    load_float8(f4 + 2 * cv, mul);
    load_float8(f4 + 4 * cv, bias);
  }
  // Each step loads the next step's vectors before it computes its own, so
  // that loads stay in flight while the SiLU's arithmetic runs.
  auto load = [&](unsigned v0, uint4 (&a)[kEpilogueUnroll], uint4 (&b)[kEpilogueUnroll]) {
#pragma unroll
    for (int u = 0; u < kEpilogueUnroll; ++u) {
      const unsigned v = v0 + u * stride;
      if (v < nvec) {
        a[u] = __ldg(x + v);
        if constexpr (kMode == kBnResidual) b[u] = __ldg(other + v);
        if constexpr (kMode == kSeGate) b[u] = __ldg(other + (v / hwcv) * cv + c8);
      }
    }
  };
  uint4 a[kEpilogueUnroll], b[kEpilogueUnroll];
  load(t, a, b);
  for (unsigned v0 = t; v0 < nvec; v0 += kEpilogueUnroll * stride) {
    uint4 next_a[kEpilogueUnroll], next_b[kEpilogueUnroll];
    load(v0 + kEpilogueUnroll * stride, next_a, next_b);
#pragma unroll
    for (int u = 0; u < kEpilogueUnroll; ++u) {
      const unsigned v = v0 + u * stride;
      if (v >= nvec) break;
      float f[8];
      bf16x8_to_float(a[u], f);
      if constexpr (kMode == kSeGate) {
        float g[8];
        bf16x8_to_float(b[u], g);
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = __fmul_rn(f[i], g[i]);
      } else {
        float r[8];
        if constexpr (kMode == kBnResidual) bf16x8_to_float(b[u], r);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float y = round_bf16(__fadd_rn(__fmul_rn(__fsub_rn(f[i], mean[i]), mul[i]), bias[i]));
          if constexpr (kMode == kBnSilu) y = y / (1.0f + expf(-y));
          if constexpr (kMode == kBnResidual) y = __fadd_rn(y, r[i]);
          f[i] = y;
        }
      }
      out[v] = float_to_bf16x8(f);
    }
#pragma unroll
    for (int u = 0; u < kEpilogueUnroll; ++u) {
      a[u] = next_a[u];
      b[u] = next_b[u];
    }
  }
}

__global__ void __launch_bounds__(kEpilogueThreads, kEpilogueBlocksPerSm)
    bn_act_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                  const float* __restrict__ factors, unsigned nvec, unsigned cv, unsigned lanes) {
  epilogue_pass<kBnSilu>(x, nullptr, out, factors, nvec, cv, 0u, lanes);
}

template <bool kResidual>
__global__ void __launch_bounds__(kEpilogueThreads, kEpilogueBlocksPerSm)
    bn_add_kernel(const uint4* __restrict__ x, const uint4* __restrict__ residual,
                  uint4* __restrict__ out, const float* __restrict__ factors, unsigned nvec,
                  unsigned cv, unsigned lanes) {
  epilogue_pass<kResidual ? kBnResidual : kBn>(x, residual, out, factors, nvec, cv, 0u, lanes);
}

__global__ void __launch_bounds__(kEpilogueThreads, kEpilogueBlocksPerSm)
    se_gate_kernel(const uint4* __restrict__ x, const uint4* __restrict__ gate,
                   uint4* __restrict__ out, unsigned nvec, unsigned cv, unsigned hwcv,
                   unsigned lanes) {
  epilogue_pass<kSeGate>(x, gate, out, nullptr, nvec, cv, hwcv, lanes);
}

}  // namespace dfv

extern "C" {

// Returns cudaGetLastError() after the launch (0 when it was accepted).
// mode: 0 BatchNorm + SiLU, 1 BatchNorm, 2 BatchNorm + residual (other), 3
// the gate (other: (B, C) bf16). x, other and out are bf16 with C a
// multiple of 8, 16-byte aligned; factors (3, C) float32 for modes 0-2.
// nvec = numel / 8, cv = C / 8, hwcv = H * W * cv; lanes and blocks come
// from epilogue_plan in ops/bn_epilogue.py (blocks * 256 >= lanes * cv).
int dfv_epilogue(const void* x, const void* other, void* out, const void* factors, int mode,
                 int nvec, int cv, int hwcv, int lanes, int blocks, void* stream) {
  if (nvec <= 0) return (int)cudaGetLastError();
  if (cv <= 0 || lanes <= 0 || blocks <= 0 || (long long)blocks * dfv::kEpilogueThreads <
                                                   (long long)lanes * cv)
    return (int)cudaErrorInvalidValue;
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* ov = static_cast<const uint4*>(other);
  uint4* outv = static_cast<uint4*>(out);
  const float* f = static_cast<const float*>(factors);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n = (unsigned)nvec, c = (unsigned)cv, l = (unsigned)lanes;
  switch (mode) {
    case dfv::kBnSilu:
      dfv::bn_act_kernel<<<blocks, dfv::kEpilogueThreads, 0, s>>>(xv, outv, f, n, c, l);
      break;
    case dfv::kBn:
      dfv::bn_add_kernel<false><<<blocks, dfv::kEpilogueThreads, 0, s>>>(xv, nullptr, outv, f, n,
                                                                         c, l);
      break;
    case dfv::kBnResidual:
      dfv::bn_add_kernel<true><<<blocks, dfv::kEpilogueThreads, 0, s>>>(xv, ov, outv, f, n, c, l);
      break;
    case dfv::kSeGate:
      if (hwcv <= 0) return (int)cudaErrorInvalidValue;
      dfv::se_gate_kernel<<<blocks, dfv::kEpilogueThreads, 0, s>>>(xv, ov, outv, n, c,
                                                                   (unsigned)hwcv, l);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
