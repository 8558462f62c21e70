// Serving-warp kernels for Hopper (sm_90a): fractional window crop (legacy
// and rank-1 "mxu" taps), pooled window crop, and the affine warp with legacy,
// rank-1 ("uw"/"uw16") and q7 int8 taps. Plain C interface, loaded with
// ctypes by
// deepfake_vit_tpu_torch/ops/warp_kernel.py, whose plain PyTorch versions
// compute the same functions with the same rounding points.
//
// Rounding contract (shared with the plain versions):
//   * source coordinates in f32 with round-to-nearest multiplies and adds
//     (__fmul_rn / __fadd_rn: nvcc would otherwise contract them to FMAs);
//   * legacy tap weights bf16(max(0, 1 - |s - t|)) — the expression itself,
//     not 1 - frac(s), which rounds differently;
//   * rank-1 tap weights bf16(max(0, 1 - |U - 1|)) with U = s + (1 - t)
//     rounded once: the TPU kernels get U from a K = 8 matmul whose products
//     are exact (the factors are 1 and integers), so only the sums round;
//     outside the legacy support |U - 1| >= 1 still holds (rounding is
//     monotone), so both constructions read the same 2x2 footprint;
//   * each two-tap sum in f32 of exact bf16 x bf16 products, rounded once.
//
// All these kernels are bound by device-memory bytes: a few operations per
// byte. They gather straight from device memory in ONE pass and keep every
// intermediate (tap weights, the vertical pass) in registers — no strip
// copy, no tap planes, nothing written back but the output. Staging the
// source tile in shared memory is left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16(max(0, 1 - |s - t|)) as f32.
__device__ __forceinline__ float tri_bf16(float s, float t) {
  return round_bf16(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(s, t)))));
}

// Rank-1 tap bf16(max(0, 1 - |U - 1|)), U = a + b rounded once.
__device__ __forceinline__ float tri_u_bf16(float a, float b) {
  const float u = __fadd_rn(a, b);
  return round_bf16(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(u, 1.0f)))));
}

// Tap constructions, a compile-time parameter of the crop and warp kernels.
enum Taps { kLegacy = 0, kRank1 = 1 };

// Weight of integer tap t for coordinate s. Rank-1: U = s + (1 - t), the
// order of the TPU kernels' U = s * 1 + (1 - t) * 1.
template <int kTaps>
__device__ __forceinline__ float tap_bf16(float s, int t) {
  return kTaps == kLegacy ? tri_bf16(s, (float)t) : tri_u_bf16(s, (float)(1 - t));
}

// off + (i + 0.5) * r - 0.5, evaluated left to right without contraction.
__device__ __forceinline__ float window_coord(float off, int i, float r) {
  return __fsub_rn(__fadd_rn(off, __fmul_rn(__fadd_rn((float)i, 0.5f), r)), 0.5f);
}

// ---------------------------------------------------------------------------
// crop_frac
//
// Replaces deepfake_vit_tpu/ops/pallas/warp_kernel.py::_crop_frac_kernel
// (launcher crop_window_frac_pallas, construction="legacy"). The TPU kernel
// DMAs a strip of rows and runs two one-hot tap matmuls, because gathers are
// slow there; here one thread computes one output element (n, o, jx, c)
// from at most 2x2 source pixels read directly from the frame.
//
// kTaps == kRank1 replaces the "mxu" construction of the same TPU kernel
// (chosen by every tap mode but "legacy"): V = bf16(tri(U)) with
// U = t + (1 - sy), Hx = bf16(tri(U)) with U = sx + (1 - s), in the order of
// its rank-1 matmuls (t * 1 + (1 - sy) * 1 and sx * 1 + (1 - s) * 1). At
// r = 1 every U is an integer, so the crop stays an exact copy.
//
// Bound: bytes. Per face the kernel must read the distinct source pixels
// its nonzero-weight taps touch (about (window*r)^2 * C bf16 values) and
// write window^2 * C bf16 values; the scalars are 24 bytes. At the H100's
// 3.35 TB/s that is the floor chip_smoke.py reports as bound_ms.
// ---------------------------------------------------------------------------
template <int kTaps>
__global__ void crop_frac_kernel(const __nv_bfloat16* __restrict__ frames,
                                 __nv_bfloat16* __restrict__ out,
                                 const int* __restrict__ strip0,
                                 const int* __restrict__ level,
                                 const int* __restrict__ frame_idx,
                                 const int* __restrict__ rfp,
                                 const int* __restrict__ off_y,
                                 const int* __restrict__ x0f,
                                 int n_faces, int H, int W, int C, int window) {
  const long long total = (long long)n_faces * window * window * C;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  long long rest = idx / C;
  const int jx = (int)(rest % window);
  rest /= window;
  const int o = (int)(rest % window);
  const int n = (int)(rest / window);

  const float r = __fmul_rn((float)rfp[n], 1.0f / 65536.0f);
  const int rows = min(window << level[n], H);
  const __nv_bfloat16* strip =
      frames + ((long long)frame_idx[n] * H + strip0[n]) * (long long)W * C;

  // Strip-relative source row and absolute source column.
  const float sy = window_coord((float)off_y[n], o, r);
  const float sx = window_coord((float)x0f[n], jx, r);

  // A vertical tap counts only inside the face's strip and the frame.
  float vw[2] = {0.0f, 0.0f};
  int ty[2] = {0, 0};
  if (sy > -1.0f && sy < (float)rows) {
    const int t0 = (int)floorf(sy);
    const float one_minus_sy = __fsub_rn(1.0f, sy);
    for (int k = 0; k < 2; ++k) {
      ty[k] = t0 + k;
      const int row = strip0[n] + ty[k];
      if (ty[k] >= 0 && ty[k] < rows && row >= 0 && row < H)
        vw[k] = kTaps == kLegacy ? tri_bf16(sy, (float)ty[k])
                                 : tri_u_bf16((float)ty[k], one_minus_sy);
    }
  }

  float acc = 0.0f;
  if (sx > -1.0f && sx < (float)W) {
    const int s0 = (int)floorf(sx);
    for (int k = 0; k < 2; ++k) {
      const int s = s0 + k;
      if (s < 0 || s >= W) continue;
      const float hw = tap_bf16<kTaps>(sx, s);
      if (hw == 0.0f) continue;
      // t1 = bf16(sum_t V[o, t] * strip[t, s, c]) — the vertical pass,
      // rounded to the pixel dtype as the TPU kernel's t1 is.
      float col = 0.0f;
      for (int q = 0; q < 2; ++q) {
        if (vw[q] == 0.0f) continue;
        const float px = __bfloat162float(strip[((long long)ty[q] * W + s) * C + c]);
        col = __fadd_rn(col, __fmul_rn(vw[q], px));
      }
      acc = __fadd_rn(acc, __fmul_rn(round_bf16(col), hw));
    }
  }
  out[idx] = __float2bfloat16_rn(acc);
}

// ---------------------------------------------------------------------------
// crop_pool
//
// Replaces deepfake_vit_tpu/ops/pallas/warp_kernel.py::_crop_pool_kernel
// (launcher crop_window_pool_pallas, constructions "legacy" and "mxu": both
// compute this function). The TPU kernel DMAs a strip of window*2^l rows and
// pools and crops it with two selection matmuls Vp @ strip @ Hp; here one
// thread computes one output element (n, o, j, c) from its own 2^l x 2^l
// block of level-0 pixels:
//   t1[s]  = bf16(sum_{r < 2^l} 2^-l * frame[y0_l0 + (o << l) + r, s, c])
//   out    = bf16(sum_{s < 2^l} 2^-l * t1[((x0 + j) << l) + s])
// with f32 sums and the TPU kernel's one intermediate rounding to bf16.
// Blocks of different outputs are disjoint, so every source pixel is read
// exactly once and nothing is staged.
//
// Bound: bytes. Per face (window * 2^l)^2 * C bf16 source values read and
// window^2 * C written, plus 16 bytes of scalars; at the H100's 3.35 TB/s
// that is the floor chip_smoke.py reports as bound_ms.
// ---------------------------------------------------------------------------
__global__ void crop_pool_kernel(const __nv_bfloat16* __restrict__ frames,
                                 __nv_bfloat16* __restrict__ out,
                                 const int* __restrict__ y0_l0,
                                 const int* __restrict__ x0,
                                 const int* __restrict__ level,
                                 const int* __restrict__ frame_idx,
                                 int n_faces, int H, int W, int C, int window) {
  const long long total = (long long)n_faces * window * window * C;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  long long rest = idx / C;
  const int j = (int)(rest % window);
  rest /= window;
  const int o = (int)(rest % window);
  const int n = (int)(rest / window);

  const int l = level[n];
  const int side = 1 << l;
  const float inv = 1.0f / (float)side;  // a power of two: products are exact
  const int row0 = y0_l0[n] + (o << l);
  const int col0 = (x0[n] + j) << l;
  const __nv_bfloat16* frame = frames + (long long)frame_idx[n] * H * W * C;

  float acc = 0.0f;
  for (int s = 0; s < side; ++s) {
    const int col = col0 + s;
    if (col < 0 || col >= W) continue;
    float t1 = 0.0f;
    for (int r = 0; r < side; ++r) {
      const int row = row0 + r;
      if (row < 0 || row >= H) continue;
      const float px = __bfloat162float(frame[((long long)row * W + col) * C + c]);
      t1 = __fadd_rn(t1, __fmul_rn(inv, px));
    }
    acc = __fadd_rn(acc, __fmul_rn(inv, round_bf16(t1)));
  }
  out[idx] = __float2bfloat16_rn(acc);
}

// ---------------------------------------------------------------------------
// warp_affine_legacy
//
// Replaces deepfake_vit_tpu/ops/pallas/warp_kernel.py::_warp_kernel
// (launcher warp_affine_pallas, construction="legacy"): cv2.warpAffine,
// bilinear, border 0. The TPU kernel builds dense V/H tap planes and runs a
// channel-stacked matmul over the whole source height; here one thread
// computes one output pixel for all C channels from its 2x2 source taps.
//
// kTaps == kRank1 replaces the "uw" and "uw16" constructions of the same
// TPU kernel, which compute one function: both round the rank-1 tap plane
// to bf16 (warp_kernel.py:165, :173). Their tap is
// bf16(max(0, 1 - |(s + (1 - t)) - 1|)). The TPU kernel pads the source to
// 16 rows and columns of zero pixels; a zero pixel adds nothing to any sum,
// so here taps outside the source are dropped instead.
//
// Bound: bytes. It must read the crop pixels that the output points'
// nonzero-weight taps touch (bf16, at most the whole crop) and write the
// (N, Ho, Wo, C) f32 output once; at the H100's 3.35 TB/s that is the floor
// chip_smoke.py reports as bound_ms.
// ---------------------------------------------------------------------------

// dst -> src coordinates of output pixel (i, j): a*j + b*i + c, in the TPU
// kernel's order.
__device__ __forceinline__ void warp_coords(const float* A, int i, int j, float* sx,
                                            float* sy) {
  *sx = __fadd_rn(__fadd_rn(__fmul_rn(A[0], (float)j), __fmul_rn(A[1], (float)i)), A[2]);
  *sy = __fadd_rn(__fadd_rn(__fmul_rn(A[3], (float)j), __fmul_rn(A[4], (float)i)), A[5]);
}

template <int kTaps>
__global__ void warp_bf16_kernel(const __nv_bfloat16* __restrict__ img,
                                   const float* __restrict__ coef,
                                   float* __restrict__ out,
                                   int n_img, int Hs, int Ws, int C, int Ho,
                                   int Wo) {
  const long long total = (long long)n_img * Ho * Wo;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % Wo);
  const int i = (int)((idx / Wo) % Ho);
  const int n = (int)(idx / ((long long)Ho * Wo));

  float sx, sy;
  warp_coords(coef + 6 * n, i, j, &sx, &sy);

  float vw[2] = {0.0f, 0.0f}, hw[2] = {0.0f, 0.0f};
  int ty[2] = {0, 0}, tx[2] = {0, 0};
  if (sy > -1.0f && sy < (float)Hs) {
    const int t0 = (int)floorf(sy);
    for (int k = 0; k < 2; ++k) {
      ty[k] = t0 + k;
      if (ty[k] >= 0 && ty[k] < Hs) vw[k] = tap_bf16<kTaps>(sy, ty[k]);
    }
  }
  if (sx > -1.0f && sx < (float)Ws) {
    const int s0 = (int)floorf(sx);
    for (int k = 0; k < 2; ++k) {
      tx[k] = s0 + k;
      if (tx[k] >= 0 && tx[k] < Ws) hw[k] = tap_bf16<kTaps>(sx, tx[k]);
    }
  }

  const __nv_bfloat16* src = img + (long long)n * Hs * Ws * C;
  float* dst = out + idx * C;
  for (int ch = 0; ch < C; ++ch) {
    float acc = 0.0f;
    for (int k = 0; k < 2; ++k) {
      if (hw[k] == 0.0f) continue;
      // P = bf16(sum_t V[t] * img[t, s, ch]).
      float p = 0.0f;
      for (int q = 0; q < 2; ++q) {
        if (vw[q] == 0.0f) continue;
        const float px =
            __bfloat162float(src[((long long)ty[q] * Ws + tx[k]) * C + ch]);
        p = __fadd_rn(p, __fmul_rn(vw[q], px));
      }
      // out = sum_s f32(bf16(P * H)).
      acc = __fadd_rn(acc, round_bf16(__fmul_rn(round_bf16(p), hw[k])));
    }
    dst[ch] = acc;
  }
}

// ---------------------------------------------------------------------------
// warp_affine_int8
//
// Replaces the "int8" construction of the same TPU kernel: q7 vertical taps
// and shifted-s8 pixels, so the TPU's main contraction runs s8 x s8 -> s32.
// Per output pixel and channel:
//   q[t, s]  = clip(rint(px) - 128, -128, 127)             (round half even)
//   V[t]     = trunc(max(0.5, 127.5 - |U - 127.5|)),
//              U = 127*sy + (127*(1 - t) + 0.5)    (product and sum rounded)
//   H[s]     = bf16(max(0, 1 - |(sx + (1 - s)) - 1|))          (rank-1 tap)
//   P[s]     = bf16(sum_t q[t, s] * V[t])          (exact s32 sum, then bf16)
//   out      = (sum_s f32(bf16(P[s] * H[s])) + (128 * sum_t V) * sum_s H)
//              * f32(1/127)
// The shift comes back through the separable correction 128*(sum V)*(sum H).
// The TPU kernel pads the source to 32 rows and columns whose taps it
// zeroes (U = -1 there), so here taps outside the source are dropped and
// the sums run over valid rows and columns only. The kernel reads the bf16
// source and quantizes in registers: no s8 copy of the crop is written.
//
// Bound: bytes, as the bf16 warp: the touched crop pixels read once, the
// f32 output written once.
// ---------------------------------------------------------------------------
__global__ void warp_int8_kernel(const __nv_bfloat16* __restrict__ img,
                                 const float* __restrict__ coef,
                                 float* __restrict__ out,
                                 int n_img, int Hs, int Ws, int C, int Ho, int Wo) {
  const long long total = (long long)n_img * Ho * Wo;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % Wo);
  const int i = (int)((idx / Wo) % Ho);
  const int n = (int)(idx / ((long long)Ho * Wo));

  float sx, sy;
  warp_coords(coef + 6 * n, i, j, &sx, &sy);

  int vq[2] = {0, 0}, ty[2] = {0, 0}, tx[2] = {0, 0};
  float hw[2] = {0.0f, 0.0f};
  if (sy > -1.0f && sy < (float)Hs) {
    const int t0 = (int)floorf(sy);
    const float u0 = __fmul_rn(127.0f, sy);
    for (int k = 0; k < 2; ++k) {
      ty[k] = t0 + k;
      if (ty[k] < 0 || ty[k] >= Hs) continue;
      const float u = __fadd_rn(u0, (float)(127 * (1 - ty[k])) + 0.5f);
      vq[k] = (int)fmaxf(0.5f, __fsub_rn(127.5f, fabsf(__fsub_rn(u, 127.5f))));
    }
  }
  if (sx > -1.0f && sx < (float)Ws) {
    const int s0 = (int)floorf(sx);
    for (int k = 0; k < 2; ++k) {
      tx[k] = s0 + k;
      if (tx[k] >= 0 && tx[k] < Ws) hw[k] = tri_u_bf16(sx, (float)(1 - tx[k]));
    }
  }
  const float corr = __fmul_rn((float)(128 * (vq[0] + vq[1])), __fadd_rn(hw[0], hw[1]));

  const __nv_bfloat16* src = img + (long long)n * Hs * Ws * C;
  float* dst = out + idx * C;
  for (int ch = 0; ch < C; ++ch) {
    float acc = 0.0f;
    for (int k = 0; k < 2; ++k) {
      if (hw[k] == 0.0f) continue;
      int p = 0;
      for (int q = 0; q < 2; ++q) {
        if (vq[q] == 0) continue;
        const float px = __bfloat162float(src[((long long)ty[q] * Ws + tx[k]) * C + ch]);
        const int s8 = min(127, max(-128, __float2int_rn(px) - 128));
        p += s8 * vq[q];
      }
      acc = __fadd_rn(acc, round_bf16(__fmul_rn(round_bf16((float)p), hw[k])));
    }
    dst[ch] = __fmul_rn(__fadd_rn(acc, corr), 1.0f / 127.0f);
  }
}

constexpr int kThreads = 256;

unsigned int blocks_for(long long total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after the launch (0 when it was
// accepted). ``taps`` selects the construction: 0 legacy, 1 rank-1.
int dfv_crop_frac_bf16(const void* frames, void* out, const void* strip0,
                       const void* level, const void* frame_idx,
                       const void* rfp, const void* off_y, const void* x0f,
                       int n_faces, int H, int W, int C, int window, int taps,
                       void* stream) {
  const long long total = (long long)n_faces * window * window * C;
  if (total > 0) {
    auto kernel = taps == kRank1 ? crop_frac_kernel<kRank1> : crop_frac_kernel<kLegacy>;
    kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)frames, (__nv_bfloat16*)out, (const int*)strip0,
        (const int*)level, (const int*)frame_idx, (const int*)rfp,
        (const int*)off_y, (const int*)x0f, n_faces, H, W, C, window);
  }
  return (int)cudaGetLastError();
}

int dfv_crop_pool_bf16(const void* frames, void* out, const void* y0_l0,
                       const void* x0, const void* level, const void* frame_idx,
                       int n_faces, int H, int W, int C, int window,
                       void* stream) {
  const long long total = (long long)n_faces * window * window * C;
  if (total > 0) {
    crop_pool_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)frames, (__nv_bfloat16*)out, (const int*)y0_l0,
        (const int*)x0, (const int*)level, (const int*)frame_idx, n_faces, H, W,
        C, window);
  }
  return (int)cudaGetLastError();
}

int dfv_warp_affine_bf16(const void* img, const void* coef, void* out,
                         int n_img, int Hs, int Ws, int C, int Ho, int Wo,
                         int taps, void* stream) {
  const long long total = (long long)n_img * Ho * Wo;
  if (total > 0) {
    auto kernel = taps == kRank1 ? warp_bf16_kernel<kRank1> : warp_bf16_kernel<kLegacy>;
    kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)img, (const float*)coef, (float*)out, n_img, Hs,
        Ws, C, Ho, Wo);
  }
  return (int)cudaGetLastError();
}

int dfv_warp_affine_int8(const void* img, const void* coef, void* out,
                         int n_img, int Hs, int Ws, int C, int Ho, int Wo,
                         void* stream) {
  const long long total = (long long)n_img * Ho * Wo;
  if (total > 0) {
    warp_int8_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)img, (const float*)coef, (float*)out, n_img, Hs,
        Ws, C, Ho, Wo);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
