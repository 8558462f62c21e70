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
// What bounds them on an H100: 2*M*K*N operations against 1,979 TOP/s
// int8, and M*K + K*N + 4*M*N bytes against 3.35 TB/s. Writing the f32
// output alone takes longer than the operations while K < 2*1979/3.35 =
// 1181, and the tail's widest products (K = 2688 into N = 448) still move
// 4480 bytes a row against 2.4e6 operations, 1.34 ns against 1.22 ns: every
// GEMM of the tail is byte-bound, the K = 2688 one barely. The detector's
// 3x3 convolutions have K = 9*Cin; at Cin = Cout = 256 (K = 2304: 1.18e6
// operations against 1280 bytes an output pixel) they are bound by
// operations, below that by bytes.
//
// Both run one tile product on the tensor cores (tile_product): a block
// computes a BM x BN output tile, each warp a 64 x 32 sub-tile as 4 x 4
// mma.sync.m16n8k32 s8 products with fragments from shared memory through
// ldmatrix; A and the weights, kept K-major by the caller, stream in 64-byte
// K steps through a three-stage cp.async pipeline, 16-, 8- or 4-byte copies
// by the alignment of K (GEMM) or Cin (convolution); ragged K steps, M and N
// tiles read zeros. The epilogue dequantizes in registers and stores
// straight from the fragments with the evict-first hint: each store
// instruction of a warp writes whole 32-byte sectors. Tiles run column tile
// fastest, so the blocks in flight cover whole output rows.
//
// The GEMM (int8_gemm_mma_kernel) takes 128 x 128 or 128 x 64 tiles
// (int8_gemm_plan in ops/int8_kernel.py picks 128 x 128 where it makes at
// least two blocks per SM). Staging the output tile in shared memory for
// 16-byte stores, a persistent grid that prefetches its next tile under the
// stores, deeper pipelines and 128-byte K steps measured no faster on the
// tail's shapes. Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at
// 700 W, device time: 0.051 ms at (73728, 56) x (56, 336), 1.7x its bound;
// 0.041 ms at (18432, 160) x (160, 960), 1.9x its bound and 1.8x a plain
// fill of the output; 0.032-0.034 ms at (4608, 2688) x (2688, 448), 5x its
// bound, 340 TOP/s of mma.sync with two 4-warp blocks on most SMs.
// torch._int_mm on the same K-major operands takes 0.069, 0.033 and 0.025
// ms; wgmma with TMA, or split K for the last shape, is the next step.
//
// The convolution (int8_conv_kernel) is an implicit GEMM on the same tile
// product: row m is an output pixel, its K steps are copied straight from
// the NHWC image through a per-block row table, padding taps are zero-fill
// copies, no im2col tensor exists. int8_conv_plan picks 512 x 32 tiles for
// Cout 32, 512 x 64 for the one-step 1x1 convolutions, 256 x 64 otherwise
// and 128 x 64 where those leave SMs idle: at the detector's shapes the
// larger blocks measured faster than 128 x 64 (tools/mma_variants.py: 1.02
// against 1.21 ms a batch); 4 stages or plain stores changed it by 1 % or
// less either way.
// Measured by tools/kernel_times.py on an NVIDIA H100 80GB HBM3 at 700 W,
// device time at B = 128: 0.134 ms at 160^2 32->32 s2 and 0.060 ms at 40^2
// 64->64, 2.1x and 3.1x their bytes; 1.02 ms for the detector's 25 launches
// of a batch against a summed bound of 0.33 ms and the first version's
// 4.45 ms. The 10^2 and 20^2 3x3 shapes stay at 4.3x-7.4x: 100-400 blocks
// for 132 SMs and, at 256 -> 256 channels, mma.sync's share of the int8
// peak; wgmma and split K are the next step.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dfv_common.cuh"

namespace {

using namespace dfv;

// ---------------------------------------------------------------------------
// The tensor-core tile product shared by the GEMM and the convolution.
// ---------------------------------------------------------------------------
namespace mma {

constexpr int WM = 64, WN = 32;  // warp tile: 4 x 4 m16n8 tiles
constexpr int BK = 64;           // K step: two m16n8k32 steps
constexpr int kStages = 3;       // cp.async pipeline depth
constexpr int kRowBytes = BK + 16;  // smem row stride: ldmatrix rows hit distinct banks

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* smem_row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A configuration of the tile product: a BM x BN block tile of 64 x 32
// warp tiles.
template <int BM_, int BN_>
struct Config {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int kWarpsN = BN / WN, kThreads = (BM / WM) * kWarpsN * 32;
  static constexpr int kStageBytes = (BM + BN) * kRowBytes;
  static constexpr int kSmem = kStages * kStageBytes;
};

// Rows row0.. of a K-contiguous s8 matrix with `rows` rows, K step k0, into
// a ROWS x BK tile of kRowBytes-byte rows. K % kW == 0, so a copy lies wholly
// inside or wholly outside the matrix; outside reads as zero.
template <class Cfg, int kW, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const int8_t* __restrict__ src,
                                          int row0, int rows, int K, int k0, int tid) {
  constexpr int kPerRow = BK / kW, kCopies = ROWS * kPerRow, T = Cfg::kThreads;
#pragma unroll
  for (int i = 0; i < (kCopies + T - 1) / T; ++i) {
    const int u = tid + i * T;
    if (kCopies % T != 0 && u >= kCopies) break;
    const int rr = u / kPerRow, cc = u % kPerRow;
    const int row = row0 + rr, k = k0 + cc * kW;
    const bool ok = row < rows && k < K;
    cp_async<kW>(dst + rr * kRowBytes + cc * kW, ok ? src + (size_t)row * K + k : src,
                 ok ? kW : 0);
  }
}

// out[m0.., n0..] = dequant(A[m, :] . wt[n, :]) for one BM x BN tile.
// load_a(dst, k0) stages the tile's A rows at K step k0 (BM rows of BK
// bytes, kRowBytes apart) with cp.async copies; the weights wt (N, K) are
// K-major. Three-stage cp.async ring, fragments through ldmatrix, 4 x 4
// mma.sync.m16n8k32 s8 products a warp and a k32 step, then the epilogue
// straight from the fragments.
template <class Cfg, int kW, class LoadA>
__device__ __forceinline__ void tile_product(const LoadA& load_a, unsigned char* smem,
                                             const int8_t* __restrict__ wt,
                                             const float* __restrict__ sx,
                                             const float* __restrict__ sw,
                                             const float* __restrict__ bias,
                                             float* __restrict__ out, int M, int K, int N,
                                             int rows_per_scale, int m0, int n0) {
  constexpr int A_BYTES = Cfg::BM * kRowBytes;
  constexpr int kMT = WM / 16, kNT = WN / 8, kHalves = BK / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Cfg::kWarpsN, wn = warp % Cfg::kWarpsN;
  const int KT = (K + BK - 1) / BK;

  auto load_stage = [&](int kt) {
    unsigned char* st = smem + (kt % kStages) * Cfg::kStageBytes;
    load_a(st, kt * BK);
    load_tile<Cfg, kW, Cfg::BN>(st + A_BYTES, wt, n0, N, K, kt * BK, tid);
  };

  int acc[kMT][kNT][4] = {};  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < KT) load_stage(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step kt has landed; every warp is done with step kt - 1
    if (kt + kStages - 1 < KT) load_stage(kt + kStages - 1);
    cp_async_commit();
    const unsigned char* As = smem + (kt % kStages) * Cfg::kStageBytes;
    const unsigned char* Bs = As + A_BYTES;
    // All k32 steps' fragments first, then their products: the asm
    // statements keep their order, so each step's mma waits only on its own
    // loads. A ragged last K step's zero-filled part adds zero.
    unsigned a[kHalves][kMT][4], b[kHalves][kNT][2];
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldmatrix_x4(a[h][mt], As + (wm * WM + mt * 16 + (lane & 15)) * kRowBytes + 32 * h +
                                  (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        unsigned r[4];
        ldmatrix_x4(r, Bs + (wn * WN + np * 16 + ((lane >> 4) << 3) + (lane & 7)) * kRowBytes +
                           32 * h + ((lane >> 3) & 1) * 16);
        b[h][2 * np][0] = r[0];
        b[h][2 * np][1] = r[1];
        b[h][2 * np + 1][0] = r[2];
        b[h][2 * np + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_s8(acc[mt][nt], a[h][mt], b[h][nt]);
  }

  // Epilogue, straight from the fragments: fragment (mt, nt) holds rows
  // wm*64 + mt*16 + g (+8) and columns wn*32 + nt*8 + 2*t4 (+1). Dequantize
  // in registers in the fixed order, (f32(acc) * sx) * sw, then + bias, and
  // store with the evict-first hint (the output is read by the next kernel,
  // not by this one). A warp's store instruction writes whole 32-byte
  // sectors: eight rows of 32 bytes.
  const int g = lane >> 2, t4 = lane & 3;
  float wv[kNT][2], bv[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + wn * WN + nt * 8 + 2 * t4 + j;
      wv[nt][j] = n < N ? sw[n] : 0.0f;
      bv[nt][j] = (bias != nullptr && n < N) ? bias[n] : 0.0f;
    }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + mt * 16 + h * 8 + g;
      if (m >= M) continue;
      const float s = sx[m / rows_per_scale];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int n = n0 + wn * WN + nt * 8 + 2 * t4;
        if (n >= N) continue;  // N % 4 == 0 and n even: both columns are inside
        float v0 = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * h], s), wv[nt][0]);
        float v1 = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * h + 1], s), wv[nt][1]);
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, bv[nt][0]);
          v1 = __fadd_rn(v1, bv[nt][1]);
        }
        __stcs(reinterpret_cast<float2*>(out + (size_t)m * N + n), make_float2(v0, v1));
      }
    }
}

// ---------------------------------------------------------------------------
// int8_gemm
//
// Replaces deepfake_vit_tpu/models/int8_tail.py::_int8_matmul (an XLA
// dot_general s8 x s8 -> s32 with the dequantizing multiply-add fused by the
// compiler; not a Pallas kernel on the TPU). xq (M, K) s8 row-major; the
// weights as wt (N, K) s8, K-major: mma.sync takes B with K contiguous per
// column, and the tail's weights are static, so the runner keeps this copy
// once (models/int8_tail.py) instead of transposing in the loader.
// Tiles are numbered column tile fastest, so the blocks in flight together
// cover whole rows of the output.
// ---------------------------------------------------------------------------
template <class Cfg, int kW>
__global__ void __launch_bounds__(Cfg::kThreads)
int8_gemm_mma_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wt,
                     const float* __restrict__ sx, const float* __restrict__ sw,
                     const float* __restrict__ bias, float* __restrict__ out, int M, int K,
                     int N, int rows_per_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int tiles_n = (N + Cfg::BN - 1) / Cfg::BN;
  const int m0 = (blockIdx.x / tiles_n) * Cfg::BM, n0 = (blockIdx.x % tiles_n) * Cfg::BN;
  auto load_a = [&](unsigned char* dst, int k0) {
    load_tile<Cfg, kW, Cfg::BM>(dst, xq, m0, M, K, k0, tid);
  };
  tile_product<Cfg, kW>(load_a, smem, wt, sx, sw, bias, out, M, K, N, rows_per_scale, m0, n0);
}

// ---------------------------------------------------------------------------
// int8_conv
//
// Replaces deepfake_vit_tpu/models/scrfd_int8.py::ScrfdInt8Runner._conv_s8
// with its dequantizing epilogue (an XLA s8 convolution on the TPU; not a
// Pallas kernel). xq (B, H, W, Cin) s8 NHWC; the kernel as wt (Cout, k, k,
// Cin) s8, K-major (the HWIO kernel's K = (tap_row * k + tap_col) * Cin + c
// contiguous per output channel); explicit top/left padding (the
// bottom/right padding follows from Ho, Wo), square stride.
//
// An implicit GEMM: row m of the tile is output pixel (b, ho, wo), and its
// K step copies come straight from the image, no im2col tensor. A copy of
// kW bytes lies inside one tap (Cin % kW == 0); a padding tap, a ragged K
// end or a row beyond M is a zero-fill copy (src-size 0), so the inner loop
// has no branch. Each block first writes a table of its rows (image offset
// of the pixel under tap (0, 0), its top-left input row and column), and
// each thread keeps one K column of the step (cc) for all its rows: a K step
// costs a thread one tap decode and, per row, a table read, two bound
// checks and an address.
// ---------------------------------------------------------------------------
template <class Cfg, int kW>
__global__ void __launch_bounds__(Cfg::kThreads)
int8_conv_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wt,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const float* __restrict__ bias, float* __restrict__ out, int B, int H, int W,
                 int Cin, int Cout, int ksize, int stride, int pad_t, int pad_l, int Ho, int Wo,
                 int rows_per_scale) {
  constexpr int BM = Cfg::BM, T = Cfg::kThreads, kPerRow = BK / kW;
  constexpr int kRowStep = T / kPerRow, kRowsPerThread = BM / kRowStep;
  static_assert(T % kPerRow == 0 && BM % kRowStep == 0, "whole rows of copies a pass");
  extern __shared__ __align__(16) unsigned char smem[];
  int4* rowS = reinterpret_cast<int4*>(smem + kStages * Cfg::kStageBytes);  // [BM]
  const int tid = threadIdx.x;
  const int M = B * Ho * Wo, K = ksize * ksize * Cin;
  const int tiles_n = (Cout + Cfg::BN - 1) / Cfg::BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * Cfg::BN;

  // Row table: (offset of input pixel (hi0, wi0) of image b, hi0, wi0). A row
  // beyond M gets hi0 far outside the image: every copy of it reads zero.
  for (int i = tid; i < BM; i += T) {
    const int m = m0 + i;
    int4 r = make_int4(0, -(1 << 28), 0, 0);
    if (m < M) {
      const int b = m / (Ho * Wo);
      const int rem = m - b * (Ho * Wo);
      const int ho = rem / Wo;
      const int hi0 = ho * stride - pad_t, wi0 = (rem - ho * Wo) * stride - pad_l;
      r = make_int4(((b * H + hi0) * W + wi0) * Cin, hi0, wi0, 0);
    }
    rowS[i] = r;
  }
  __syncthreads();

  const int cc = tid % kPerRow, r0 = tid / kPerRow;
  auto load_a = [&](unsigned char* dst, int k0) {
    const int k = k0 + cc * kW;
    const int tap = k / Cin;
    const int tr = tap / ksize, tc = tap - tr * ksize;
    const int koff = (tr * W + tc) * Cin + (k - tap * Cin);
    const bool kin = k < K;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int rr = r0 + i * kRowStep;
      const int4 row = rowS[rr];
      const bool ok = kin && (unsigned)(row.y + tr) < (unsigned)H &&
                      (unsigned)(row.z + tc) < (unsigned)W;
      cp_async<kW>(dst + rr * kRowBytes + cc * kW, ok ? xq + row.x + koff : xq, ok ? kW : 0);
    }
  };
  tile_product<Cfg, kW>(load_a, smem, wt, sx, sw, bias, out, M, K, Cout, rows_per_scale, m0, n0);
}

// Launch one configuration with the copy width of the plan.
template <class Cfg, class Kernel, class... Args>
int launch(Kernel kernel, size_t smem, long long tiles, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)tiles, Cfg::kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <class Cfg>
long long tile_count(int M, int N) {
  return (long long)((N + Cfg::BN - 1) / Cfg::BN) * ((M + Cfg::BM - 1) / Cfg::BM);
}

// f(std::integral_constant<int, copy_bytes>()) for a copy width of 16, 8 or 4.
template <class F>
int with_copy_bytes(int copy_bytes, F f) {
  switch (copy_bytes) {
    case 16: return f(std::integral_constant<int, 16>());
    case 8: return f(std::integral_constant<int, 8>());
    case 4: return f(std::integral_constant<int, 4>());
  }
  return (int)cudaErrorInvalidValue;
}

template <class Cfg>
int launch_gemm(int copy_bytes, const int8_t* xq, const int8_t* wt, const float* sx,
                const float* sw, const float* bias, float* out, int M, int K, int N,
                int rows_per_scale, cudaStream_t stream) {
  return with_copy_bytes(copy_bytes, [&](auto w) {
    return launch<Cfg>(int8_gemm_mma_kernel<Cfg, decltype(w)::value>, Cfg::kSmem,
                       tile_count<Cfg>(M, N), stream, xq, wt, sx, sw, bias, out, M, K, N,
                       rows_per_scale);
  });
}

template <class Cfg>
int launch_conv(int copy_bytes, const int8_t* xq, const int8_t* wt, const float* sx,
                const float* sw, const float* bias, float* out, int B, int H, int W, int Cin,
                int Cout, int ksize, int stride, int pad_t, int pad_l, int Ho, int Wo,
                int rows_per_scale, cudaStream_t stream) {
  return with_copy_bytes(copy_bytes, [&](auto w) {
    return launch<Cfg>(int8_conv_kernel<Cfg, decltype(w)::value>,
                       Cfg::kSmem + Cfg::BM * sizeof(int4), tile_count<Cfg>(B * Ho * Wo, Cout),
                       stream, xq, wt, sx, sw, bias, out, B, H, W, Cin, Cout, ksize, stride,
                       pad_t, pad_l, Ho, Wo, rows_per_scale);
  });
}

using GemmLaunch = int (*)(int, const int8_t*, const int8_t*, const float*, const float*,
                           const float*, float*, int, int, int, int, cudaStream_t);
using ConvLaunch = int (*)(int, const int8_t*, const int8_t*, const float*, const float*,
                           const float*, float*, int, int, int, int, int, int, int, int, int,
                           int, int, int, cudaStream_t);

// The block tiles int8_gemm_plan and int8_conv_plan (ops/int8_kernel.py)
// choose from, by index.
constexpr GemmLaunch kGemmConfigs[] = {
    launch_gemm<Config<128, 128>>,
    launch_gemm<Config<128, 64>>,
};
constexpr ConvLaunch kConvConfigs[] = {
    launch_conv<Config<256, 64>>,
    launch_conv<Config<512, 32>>,
    launch_conv<Config<128, 64>>,
    launch_conv<Config<512, 64>>,
};
constexpr int kNumGemmConfigs = sizeof(kGemmConfigs) / sizeof(kGemmConfigs[0]);
constexpr int kNumConvConfigs = sizeof(kConvConfigs) / sizeof(kConvConfigs[0]);

}  // namespace mma

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 when it was accepted).
// K and N (Cin and Cout) must be multiples of 4 and every pointer 16-byte
// aligned; sx holds ceil(M / rows_per_scale) scales; bias may be null. Both
// take their weights K-major: the GEMM wt (N, K), the convolution wt (Cout,
// k, k, Cin). config (an index into mma::kGemmConfigs or kConvConfigs) and
// copy_bytes (16, 8 or 4, dividing K, and Cin for the convolution) come
// from int8_gemm_plan and int8_conv_plan.

int dfv_int8_gemm(const void* xq, const void* wt, const void* sx, const void* sw,
                  const void* bias, void* out, int M, int K, int N, int rows_per_scale,
                  int config, int copy_bytes, void* stream) {
  if (config < 0 || config >= mma::kNumGemmConfigs) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  return mma::kGemmConfigs[config](copy_bytes, (const int8_t*)xq, (const int8_t*)wt,
                                   (const float*)sx, (const float*)sw, (const float*)bias,
                                   (float*)out, M, K, N, rows_per_scale, (cudaStream_t)stream);
}

int dfv_int8_conv(const void* xq, const void* wt, const void* sx, const void* sw,
                  const void* bias, void* out, int B, int H, int W, int Cin, int Cout,
                  int ksize, int stride, int pad_t, int pad_l, int Ho, int Wo,
                  int rows_per_scale, int config, int copy_bytes, void* stream) {
  if (config < 0 || config >= mma::kNumConvConfigs) return (int)cudaErrorInvalidValue;
  if (B * Ho * Wo <= 0 || Cout <= 0) return (int)cudaGetLastError();
  return mma::kConvConfigs[config](copy_bytes, (const int8_t*)xq, (const int8_t*)wt,
                                   (const float*)sx, (const float*)sw, (const float*)bias,
                                   (float*)out, B, H, W, Cin, Cout, ksize, stride, pad_t, pad_l,
                                   Ho, Wo, rows_per_scale, (cudaStream_t)stream);
}

}  // extern "C"
