// The transformers' LayerNorm in inference, one bf16 pass (sm_90a):
// layer_norm_kernel normalizes each row of W values over its last dim, as
// flax's nn.LayerNorm does, for the ViT's 25 and the TimeSformer's 37
// LayerNorms a served batch.
//
// It replaces no TPU kernel: XLA fused the LayerNorm's passes in the JAX
// package. Eager PyTorch runs about ten passes instead: the cast to float32,
// the row mean, x * x and its row mean, the variance, rsqrt * scale,
// x - mean, * mul, + bias and the cast back, the broadcasts over the last
// dim on PyTorch's generic strided kernel.
//
// What bounds it on an H100: bytes. It reads 2 bytes and writes 2 an
// element against about ten operations, far below the card's 295 a byte: a
// served batch's LayerNorm over 25,216 rows of 768 (38.7 MB in, 38.7 MB out,
// 77.4 MB) takes 0.0231 ms at 3.35 TB/s at best. The design moves each byte
// once, 16 bytes at a time, and never reads a row twice: one warp a row,
// lane l holding the row's 16-byte vectors l, l + 32, ... in registers (three
// at W = 768, 24 values: a row is 1.5 KB, so registers hold it whole and no
// shared memory is needed). Warp-shuffle sums give every lane the row's
// statistics; the lane then writes its own vectors. Each lane keeps its
// columns' scale and bias in registers for the whole grid-stride loop (48
// floats at W = 768) and loads the next row before it reduces this one, so
// two rows a warp are in flight: 16 warps an SM (two blocks of 8, at most
// 128 registers a thread) keep 48 KB an SM in flight, enough to cover the
// device memory's latency. Rows are found by one stride or two (row r at
// (r / inner) * outer + (r % inner) * inner_stride), so that the
// TimeSformer's CLS rows x[:, 0] and the temporal rows of a single clip,
// views of its tokens, are read where they lie, without a copy.
//
// Rounding: the plain version's (ops/layer_norm.py::layer_norm_plain), but
// for the order of the float32 row sums. mean = sum(x) * (1 / W) and
// var = max(sum(x * x) * (1 / W) - mean * mean, 0) (flax's E[x^2] - E[x]^2;
// PyTorch's mean is its sum times the float32 reciprocal, and its clamp
// keeps a NaN), mul = rsqrtf(var + eps) * scale, then ((x - mean) * mul) +
// bias, each step rounded in float32 (__fsub_rn / __fmul_rn / __fadd_rn:
// nvcc would otherwise contract them to an FMA), then rounded once to bf16.
// The sums run in the warp's order, PyTorch's reduction in its own, so a
// mean or variance may differ in its last float32 bit and an output by one
// bf16 step.
// Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dfv_common.cuh"

namespace dfv {

constexpr int kLnWarps = 8;                // rows in flight a block; ops/layer_norm.py::LN_WARPS
constexpr int kLnThreads = 32 * kLnWarps;
constexpr int kLnBlocksPerSm = 2;          // ops/layer_norm.py::LN_BLOCKS_PER_SM
constexpr int kLnMaxVecs = 3;              // 16-byte vectors a lane: W <= 3 * 32 * 8 = 768

// rows rows of wv = W / 8 vectors: row r of x starts at vector
// (r / inner) * outer_stride + (r % inner) * inner_stride (one stride when
// inner = rows; two for rows that a view left in an outer x inner grid), row
// r of out at r * wv. scale and bias: W float32. The grid's warps take rows
// w, w + warps, ...
template <int kVecs>
__global__ void __launch_bounds__(kLnThreads, kLnBlocksPerSm)
    layer_norm_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      unsigned rows, unsigned wv, unsigned inner, unsigned outer_stride,
                      unsigned inner_stride, float inv_w, float eps) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warps = gridDim.x * kLnWarps;
  unsigned row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  float s[kVecs][8], b[kVecs][8];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const unsigned v = lane + 32u * i;
    if (v < wv) {
      load_float8(reinterpret_cast<const float4*>(scale) + 2 * v, s[i]);
      load_float8(reinterpret_cast<const float4*>(bias) + 2 * v, b[i]);
    }
  }
  auto load = [&](unsigned r, uint4 (&a)[kVecs]) {
    const uint4* p = x + (size_t)(r / inner) * outer_stride + (size_t)(r % inner) * inner_stride;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const unsigned v = lane + 32u * i;
      a[i] = v < wv ? __ldg(p + v) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  uint4 a[kVecs];
  load(row, a);
  for (; row < rows; row += warps) {
    uint4 next[kVecs] = {};
    if (row + warps < rows) load(row + warps, next);
    // Lanes past the row's end hold zeros: they add nothing to either sum.
    float sum = 0.0f, sq = 0.0f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      float f[8];
      bf16x8_to_float(a[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sum = __fadd_rn(sum, f[j]);
        sq = __fadd_rn(sq, __fmul_rn(f[j], f[j]));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
    }
    const float mean = __fmul_rn(sum, inv_w);
    float var = __fsub_rn(__fmul_rn(sq, inv_w), __fmul_rn(mean, mean));
    var = var < 0.0f ? 0.0f : var;
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    uint4* o = out + (size_t)row * wv;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const unsigned v = lane + 32u * i;
      if (v < wv) {
        float f[8];
        bf16x8_to_float(a[i], f);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          f[j] = __fadd_rn(__fmul_rn(__fsub_rn(f[j], mean), __fmul_rn(rstd, s[i][j])), b[i][j]);
        o[v] = float_to_bf16x8(f);
      }
    }
#pragma unroll
    for (int i = 0; i < kVecs; ++i) a[i] = next[i];
  }
}

}  // namespace dfv

extern "C" {

// Returns cudaGetLastError() after the launch (0 when it was accepted).
// x: rows rows of width bf16 (width a multiple of 8, at most 768), row r at
// element (r / inner) * outer_stride + (r % inner) * inner_stride (both
// strides multiples of 8), 16-byte aligned; out: rows * width bf16,
// contiguous, 16-byte aligned; scale and bias: width float32, 16-byte
// aligned. The layout and blocks come from _row_layout and layer_norm_plan
// in ops/layer_norm.py.
int dfv_layer_norm(const void* x, void* out, const void* scale, const void* bias, int rows,
                   int width, int inner, int outer_stride, int inner_stride, int blocks, float eps,
                   void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const int wv = width / 8;
  const int vecs = (wv + 31) / 32;
  if (width <= 0 || width % 8 || vecs > dfv::kLnMaxVecs || blocks <= 0 || inner <= 0 ||
      outer_stride < 0 || outer_stride % 8 || inner_stride < 0 || inner_stride % 8)
    return (int)cudaErrorInvalidValue;
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* ov = static_cast<uint4*>(out);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned n = (unsigned)rows, w = (unsigned)wv, in = (unsigned)inner;
  const unsigned os = (unsigned)(outer_stride / 8), is = (unsigned)(inner_stride / 8);
  const float inv_w = 1.0f / (float)width;
  // One instantiation for each number of vectors a lane: 1 up to W = 256, 2 up to 512, 3.
  auto kernel = vecs == 1 ? dfv::layer_norm_kernel<1>
                : vecs == 2 ? dfv::layer_norm_kernel<2> : dfv::layer_norm_kernel<3>;
  kernel<<<blocks, dfv::kLnThreads, 0, st>>>(xv, ov, s, b, n, w, in, os, is, inv_w, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
