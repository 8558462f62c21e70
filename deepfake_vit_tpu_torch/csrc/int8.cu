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
// The GEMM (int8_gemm_mma_kernel) runs on the tensor cores: a block
// computes a 128 x 128 or 128 x 64 output tile (int8_gemm_plan in
// ops/int8_kernel.py picks 128 x 128 where it makes at least two blocks per
// SM, else 128 x 64), each warp a 64 x 32 sub-tile as 4 x 4
// mma.sync.m16n8k32 s8 products with fragments from shared memory through
// ldmatrix. A and the weights, kept K-major (N, K) by the caller, stream in
// 64-byte K steps through a three-stage cp.async pipeline, 16-, 8- or
// 4-byte copies by K's alignment (K = 56 rows are 8-byte aligned only);
// ragged K steps, M and N tiles read zeros. The epilogue dequantizes in
// registers and stores straight from the fragments with the evict-first
// hint: each store instruction of a warp writes whole 32-byte sectors.
// Tiles run column tile fastest, so the blocks in flight cover whole output
// rows. Staging the output tile in shared memory for 16-byte stores, a
// persistent grid that prefetches its next tile under the stores, deeper
// pipelines and 128-byte K steps measured no faster on the tail's shapes.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, device
// time: 0.051 ms at (73728, 56) x (56, 336), 1.7x its bound; 0.041 ms at
// (18432, 160) x (160, 960), 1.9x its bound and 1.8x a plain fill of the
// output; 0.032-0.034 ms at (4608, 2688) x (2688, 448), 5x its bound, 340
// TOP/s of mma.sync with two 4-warp blocks on most SMs. torch._int_mm on the
// same K-major operands takes 0.069, 0.033 and 0.025 ms; wgmma with TMA, or
// split K for the last shape, is the next step.
//
// The convolution is still the first version: one 64 x 64 tile of 256
// threads on the integer pipes (__dp4a, four s8 products an instruction),
// K walked in steps of 32 s8 values, A (the (batch, row, column) of an
// output pixel whose k index walks the kernel taps and input channels of an
// NHWC image: implicit GEMM, no im2col tensor, padding taps read as zero)
// and B ((K, N) row-major, transposed in registers with __byte_perm) staged
// as words of four consecutive-k values; 8x to 44x its bounds (PERF.md).
// Its mma.sync / wgmma redesign is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The convolution's tile.
constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK4 = 8;       // K step in packed words (32 s8 values)
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 patch each
constexpr int kPad = 4;      // keeps tile rows 16-byte aligned, stores conflict-free

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

// The convolution's tile product:
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

// ---------------------------------------------------------------------------
// int8_gemm
//
// Replaces deepfake_vit_tpu/models/int8_tail.py::_int8_matmul (an XLA
// dot_general s8 x s8 -> s32 with the dequantizing multiply-add fused by the
// compiler; not a Pallas kernel on the TPU). xq (M, K) s8 row-major; the
// weights as wt (N, K) s8, K-major: mma.sync takes B with K contiguous per
// column, and the tail's weights are static, so the runner keeps this copy
// once (models/int8_tail.py) instead of transposing in the loader.
// ---------------------------------------------------------------------------
namespace mma {

constexpr int WM = 64, WN = 32;  // warp tile: 4 x 4 m16n8 tiles
constexpr int BK = 64;           // K step: two m16n8k32 steps
constexpr int kStages = 3;       // cp.async pipeline depth
constexpr int kRowBytes = BK + 16;  // smem row stride: ldmatrix rows hit distinct banks

template <int kW>  // bytes per copy: 16, 8 or 4; zero-filled where !valid
__device__ __forceinline__ void cp_async(void* smem_dst, const void* src, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  const int n = valid ? kW : 0;
  if constexpr (kW == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(kW),
                 "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

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

// A configuration of the GEMM kernel: a BM x BN block tile of 64 x 32 warp
// tiles.
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
    cp_async<kW>(dst + rr * kRowBytes + cc * kW, ok ? src + (size_t)row * K + k : src, ok);
  }
}

// Tiles are numbered column tile fastest, so the blocks in flight together
// cover whole rows of the output.
template <class Cfg, int kW>
__global__ void __launch_bounds__(Cfg::kThreads)
int8_gemm_mma_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wt,
                     const float* __restrict__ sx, const float* __restrict__ sw,
                     const float* __restrict__ bias, float* __restrict__ out, int M, int K,
                     int N, int rows_per_scale) {
  constexpr int BM = Cfg::BM, BN = Cfg::BN, A_BYTES = BM * kRowBytes;
  constexpr int kMT = WM / 16, kNT = WN / 8, kHalves = BK / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Cfg::kWarpsN, wn = warp % Cfg::kWarpsN;
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int KT = (K + BK - 1) / BK;

  auto load_stage = [&](int kt) {
    unsigned char* st = smem + (kt % kStages) * Cfg::kStageBytes;
    load_tile<Cfg, kW, BM>(st, xq, m0, M, K, kt * BK, tid);
    load_tile<Cfg, kW, BN>(st + A_BYTES, wt, n0, N, K, kt * BK, tid);
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

template <class Cfg, int kW>
int launch_gemm(const int8_t* xq, const int8_t* wt, const float* sx, const float* sw,
                const float* bias, float* out, int M, int K, int N, int rows_per_scale,
                cudaStream_t stream) {
  auto kernel = int8_gemm_mma_kernel<Cfg, kW>;
  if (Cfg::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long tiles =
      (long long)((N + Cfg::BN - 1) / Cfg::BN) * ((M + Cfg::BM - 1) / Cfg::BM);
  kernel<<<(unsigned)tiles, Cfg::kThreads, Cfg::kSmem, stream>>>(xq, wt, sx, sw, bias, out, M,
                                                                 K, N, rows_per_scale);
  return (int)cudaGetLastError();
}

template <class Cfg>
int launch_config(int copy_bytes, const int8_t* xq, const int8_t* wt, const float* sx,
                  const float* sw, const float* bias, float* out, int M, int K, int N,
                  int rows_per_scale, cudaStream_t stream) {
  switch (copy_bytes) {
    case 16: return launch_gemm<Cfg, 16>(xq, wt, sx, sw, bias, out, M, K, N, rows_per_scale, stream);
    case 8: return launch_gemm<Cfg, 8>(xq, wt, sx, sw, bias, out, M, K, N, rows_per_scale, stream);
    case 4: return launch_gemm<Cfg, 4>(xq, wt, sx, sw, bias, out, M, K, N, rows_per_scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

using Launch = int (*)(int, const int8_t*, const int8_t*, const float*, const float*,
                       const float*, float*, int, int, int, int, cudaStream_t);

// The block tiles int8_gemm_plan (ops/int8_kernel.py) chooses from, by
// index.
constexpr Launch kConfigs[] = {
    launch_config<Config<128, 128>>,
    launch_config<Config<128, 64>>,
};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);

}  // namespace mma

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 when it was accepted).
// K and N (Cin and Cout) must be multiples of 4 and every pointer 16-byte
// aligned; sx holds ceil(M / rows_per_scale) scales; bias may be null. The
// GEMM takes its weights K-major, wt (N, K); config (an index into
// mma::kConfigs) and copy_bytes (16, 8 or 4, dividing K) come from
// int8_gemm_plan.

int dfv_int8_gemm(const void* xq, const void* wt, const void* sx, const void* sw,
                  const void* bias, void* out, int M, int K, int N, int rows_per_scale,
                  int config, int copy_bytes, void* stream) {
  if (config < 0 || config >= mma::kNumConfigs) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  return mma::kConfigs[config](copy_bytes, (const int8_t*)xq, (const int8_t*)wt,
                               (const float*)sx, (const float*)sw, (const float*)bias,
                               (float*)out, M, K, N, rows_per_scale, (cudaStream_t)stream);
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
