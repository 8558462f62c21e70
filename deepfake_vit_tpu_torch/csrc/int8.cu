// Int8 product kernels for Hopper (sm_90a): the s8 x s8 -> s32 GEMM of the
// int8 EfficientNet tail and the s8 implicit-GEMM convolution of the int8
// SCRFD detector, each with the dequantizing epilogue
//     out = (f32(acc) * sx) * sw + bias
// in exactly that order, with round-to-nearest multiplies and adds
// (__fmul_rn / __fadd_rn: nvcc would otherwise contract them to an FMA).
// The s32 sums are exact, so each kernel agrees bit for bit with the plain
// PyTorch version in deepfake_vit_tpu_torch/ops/int8_kernel.py. Plain C
// interface, loaded with ctypes.
//
// Both kernels are one tiled product: a block of 256 threads computes a
// 64 x 64 output tile, walking K in steps of 32 s8 values. The A tile
// (activations) and the B tile (weights, (K, N) row-major) are staged in
// shared memory as words of four consecutive-k s8 values, B transposed in
// registers with __byte_perm on the way in, and each thread accumulates a
// 4 x 4 patch with __dp4a (four s8 products per instruction). The two
// kernels differ only in how a row of A is found: a row of the matrix, or
// the (batch, row, column) of an output pixel whose k index walks the
// kernel taps and input channels of an NHWC image (implicit GEMM: no
// im2col tensor in device memory; padding taps read as zero).
//
// What bounds them on an H100: 2*M*K*N operations against 1,979 TOP/s
// int8, and M*K + K*N + 4*M*N bytes against 3.35 TB/s. Writing the f32
// output alone takes longer than the operations while K < 2*1979/3.35 =
// 1181, and the tail's widest products (K = 2688 into N = 448) still move
// 4480 bytes a row against 2.4e6 operations, 1.34 ns against 1.22 ns: every
// GEMM of the tail is byte-bound. The detector's 3x3 convolutions have
// K = 9*Cin; at Cin = Cout = 256 (K = 2304: 1.18e6 operations against 1280
// bytes an output pixel) they are bound by operations, below that by bytes.
// This first version runs on the integer pipes (__dp4a), not the tensor
// cores. Measured on an NVIDIA H100 80GB HBM3 at 700 W by chip_smoke.py: the
// GEMM takes 1.9x its bound at the tail's largest-M shape and 21x at its
// largest-K shape (47 and 82 TOP/s); the 3x3 convolutions 8x to 44x.
// mma.sync / wgmma tiles, cp.async staging and a fused quantize/activation
// prologue and epilogue are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK4 = 8;       // K step in packed words (32 s8 values)
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 patch each
constexpr int kPad = 4;      // keeps tile rows 16-byte aligned, stores conflict-free

// A operand of the GEMM: row m of a (M, K) row-major s8 matrix.
struct GemmA {
  const int8_t* x;
  int M, K;
  struct Row {
    const int8_t* p;
    bool ok;
  };
  __device__ Row row(int m) const {
    return {x + (size_t)(m < M ? m : 0) * K, m < M};
  }
  // Four s8 values k..k+3 of the row, packed little-endian.
  __device__ int load(const Row& r, int k) const {
    return (r.ok && k < K) ? *reinterpret_cast<const int*>(r.p + k) : 0;
  }
};

// A operand of the convolution: output pixel m = (b, ho, wo) of an NHWC s8
// image; k = (tap_row * ksize + tap_col) * Cin + c, the HWIO kernel's own
// flattening, so the B operand is the kernel read as a (K, Cout) matrix.
struct ConvA {
  const int8_t* x;
  int M, H, W, Cin, ksize, stride, pad_t, pad_l, Ho, Wo, K;
  struct Row {
    const int8_t* img;
    int hi0, wi0;
    bool ok;
  };
  __device__ Row row(int m) const {
    const bool ok = m < M;
    const int mm = ok ? m : 0;
    const int b = mm / (Ho * Wo);
    const int rem = mm - b * (Ho * Wo);
    const int ho = rem / Wo;
    const int wo = rem - ho * Wo;
    return {x + (size_t)b * H * W * Cin, ho * stride - pad_t, wo * stride - pad_l, ok};
  }
  __device__ int load(const Row& r, int k) const {
    if (!r.ok || k >= K) return 0;
    const int tap = k / Cin;
    const int c = k - tap * Cin;
    const int kr = tap / ksize;
    const int hi = r.hi0 + kr;
    const int wi = r.wi0 + (tap - kr * ksize);
    if (hi < 0 || hi >= H || wi < 0 || wi >= W) return 0;  // padding reads as zero
    return *reinterpret_cast<const int*>(r.img + ((size_t)hi * W + wi) * Cin + c);
  }
};

// out[m, n] = (f32(sum_k A[m, k] * wq[k, n]) * sx[m / rows_per_scale]) * sw[n] + bias[n]
template <class A>
__device__ __forceinline__ void int8_tile_product(
    const A a, const int8_t* __restrict__ wq, const float* __restrict__ sx,
    const float* __restrict__ sw, const float* __restrict__ bias,
    float* __restrict__ out, int M, int K, int N, int rows_per_scale) {
  __shared__ __align__(16) int As[BK4][BM + kPad];
  __shared__ __align__(16) int Bs[BK4][BN + kPad];

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // Loader roles. A: word a_k4 of rows a_m and a_m + 32. B (threads 0..127):
  // rows 4*b_k4..+3 of wq, columns b_n..b_n+3, transposed to four words.
  const int a_k4 = t % BK4, a_m = t / BK4;
  const typename A::Row row0 = a.row(m0 + a_m), row1 = a.row(m0 + a_m + 32);
  const int b_k4 = t / 16, b_nl = 4 * (t % 16), b_n = n0 + b_nl;

  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 4 * BK4) {
    As[a_k4][a_m] = a.load(row0, k0 + 4 * a_k4);
    As[a_k4][a_m + 32] = a.load(row1, k0 + 4 * a_k4);
    if (t < 16 * BK4) {
      const int k = k0 + 4 * b_k4;
      int r0 = 0, r1 = 0, r2 = 0, r3 = 0;
      if (k < K && b_n < N) {  // K and N are multiples of 4: whole words
        const int8_t* p = wq + (size_t)k * N + b_n;
        r0 = *reinterpret_cast<const int*>(p);
        r1 = *reinterpret_cast<const int*>(p + N);
        r2 = *reinterpret_cast<const int*>(p + 2 * (size_t)N);
        r3 = *reinterpret_cast<const int*>(p + 3 * (size_t)N);
      }
      // 4 x 4 byte transpose: word j holds column b_n + j at k..k+3.
      const int lo01 = __byte_perm(r0, r1, 0x5140), hi01 = __byte_perm(r0, r1, 0x7362);
      const int lo23 = __byte_perm(r2, r3, 0x5140), hi23 = __byte_perm(r2, r3, 0x7362);
      *reinterpret_cast<int4*>(&Bs[b_k4][b_nl]) =
          make_int4(__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                    __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632));
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < BK4; ++k4) {
      const int4 av = *reinterpret_cast<const int4*>(&As[k4][4 * ty]);
      const int4 bv = *reinterpret_cast<const int4*>(&Bs[k4][4 * tx]);
      const int aa[4] = {av.x, av.y, av.z, av.w};
      const int bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(aa[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int n = n0 + 4 * tx;
  if (n >= N) return;
  const float4 w4 = *reinterpret_cast<const float4*>(sw + n);
  float4 b4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias != nullptr) b4 = *reinterpret_cast<const float4*>(bias + n);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
    const float s = sx[m / rows_per_scale];
    float4 v;
    v.x = __fmul_rn(__fmul_rn((float)acc[i][0], s), w4.x);
    v.y = __fmul_rn(__fmul_rn((float)acc[i][1], s), w4.y);
    v.z = __fmul_rn(__fmul_rn((float)acc[i][2], s), w4.z);
    v.w = __fmul_rn(__fmul_rn((float)acc[i][3], s), w4.w);
    if (bias != nullptr) {
      v.x = __fadd_rn(v.x, b4.x);
      v.y = __fadd_rn(v.y, b4.y);
      v.z = __fadd_rn(v.z, b4.z);
      v.w = __fadd_rn(v.w, b4.w);
    }
    *reinterpret_cast<float4*>(out + (size_t)m * N + n) = v;
  }
}

// ---------------------------------------------------------------------------
// int8_gemm
//
// Replaces deepfake_vit_tpu/models/int8_tail.py::_int8_matmul (an XLA
// dot_general s8 x s8 -> s32 with the dequantizing multiply-add fused by the
// compiler; not a Pallas kernel on the TPU). xq (M, K) s8, wq (K, N) s8.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const float* __restrict__ bias, float* __restrict__ out, int M,
                 int K, int N, int rows_per_scale) {
  int8_tile_product(GemmA{xq, M, K}, wq, sx, sw, bias, out, M, K, N, rows_per_scale);
}

// ---------------------------------------------------------------------------
// int8_conv
//
// Replaces deepfake_vit_tpu/models/scrfd_int8.py::ScrfdInt8Runner._conv_s8
// with its dequantizing epilogue (an XLA s8 convolution on the TPU; not a
// Pallas kernel). xq (B, H, W, Cin) s8 NHWC, kq (ksize, ksize, Cin, Cout) s8
// HWIO, explicit top/left padding (the bottom/right padding follows from
// Ho, Wo), square stride.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ kq,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const float* __restrict__ bias, float* __restrict__ out, int B,
                 int H, int W, int Cin, int Cout, int ksize, int stride, int pad_t,
                 int pad_l, int Ho, int Wo, int rows_per_scale) {
  const int M = B * Ho * Wo, K = ksize * ksize * Cin;
  int8_tile_product(ConvA{xq, M, H, W, Cin, ksize, stride, pad_t, pad_l, Ho, Wo, K},
                    kq, sx, sw, bias, out, M, K, Cout, rows_per_scale);
}

dim3 tiles(int M, int N) { return dim3((M + BM - 1) / BM, (N + BN - 1) / BN); }

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 when it was accepted).
// K and N (Cin and Cout) must be multiples of 4 and every pointer 16-byte
// aligned; sx holds ceil(M / rows_per_scale) scales; bias may be null.

int dfv_int8_gemm(const void* xq, const void* wq, const void* sx, const void* sw,
                  const void* bias, void* out, int M, int K, int N,
                  int rows_per_scale, void* stream) {
  if (M > 0 && N > 0) {
    int8_gemm_kernel<<<tiles(M, N), kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)xq, (const int8_t*)wq, (const float*)sx, (const float*)sw,
        (const float*)bias, (float*)out, M, K, N, rows_per_scale);
  }
  return (int)cudaGetLastError();
}

int dfv_int8_conv(const void* xq, const void* kq, const void* sx, const void* sw,
                  const void* bias, void* out, int B, int H, int W, int Cin,
                  int Cout, int ksize, int stride, int pad_t, int pad_l, int Ho,
                  int Wo, int rows_per_scale, void* stream) {
  const int M = B * Ho * Wo;
  if (M > 0 && Cout > 0) {
    int8_conv_kernel<<<tiles(M, Cout), kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)xq, (const int8_t*)kq, (const float*)sx, (const float*)sw,
        (const float*)bias, (float*)out, B, H, W, Cin, Cout, ksize, stride, pad_t,
        pad_l, Ho, Wo, rows_per_scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
