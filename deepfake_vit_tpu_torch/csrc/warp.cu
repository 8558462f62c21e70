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
// byte. Nothing is written back but the output: no strip copy, no tap
// planes. The fractional crop stages the source rows a band of output rows
// needs in shared memory with 16-byte cp.async copies and resamples from
// there (see crop_frac_band_kernel); the pooled crop and the warps gather
// straight from device memory in one pass and keep every intermediate in
// registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

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

// 16-byte asynchronous copy, device memory -> shared memory (sm_80+).
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// crop_frac
//
// Replaces deepfake_vit_tpu/ops/pallas/warp_kernel.py::_crop_frac_kernel
// (launcher crop_window_frac_pallas, construction="legacy"). The TPU kernel
// DMAs a strip of rows and runs two one-hot tap matmuls, because gathers are
// slow there. Per face n and output (o, jx, c):
//   sy  = off_y + (o + 0.5) * r - 0.5   (strip-relative row)
//   sx  = x0f + (jx + 0.5) * r - 0.5    (absolute column)
//   t1  = bf16(sum_t V[o, t] * strip[t, s, c])   (the vertical pass)
//   out = bf16(sum_s t1[s] * Hx[s, jx])
// over the two taps of each coordinate, the vertical taps counted only inside
// the face's strip [strip0, strip0 + min(window * 2^level, H)) and the frame.
//
// kTaps == kRank1 replaces the "mxu" construction of the same TPU kernel
// (chosen by every tap mode but "legacy"): V = bf16(tri(U)) with
// U = t + (1 - sy), Hx = bf16(tri(U)) with U = sx + (1 - s), in the order of
// its rank-1 matmuls (t * 1 + (1 - sy) * 1 and sx * 1 + (1 - s) * 1). At
// r = 1 every U is an integer, so the crop stays an exact copy.
//
// The per-face scalars come in the geometry's own types: r, off_y and x0f as
// f32, strip0 and level as s32, frame_idx as s32 or null (the identity). r
// lies on the 2^-16 grid and is at most 2^8, and off_y and x0f are integers,
// so they equal the fixed-point forms the plain version takes (rfp * 2^-16 is
// exact in f32): no conversion runs before the kernel.
//
// Design: one block per (face, band of output rows). The block
//   1. tabulates in shared memory the first tap column and the two bf16
//      weights of every output column, and the first tap row and two weights
//      of every band row: index and tap arithmetic once per block, in 32-bit
//      integers;
//   2. stages the source rows that band rows read with a nonzero weight,
//      each row once (at r ~ 1 output rows o and o + 1 share one), over the
//      columns [c_lo, c_hi] the output columns' taps touch, clipped to the
//      frame, with 16-byte cp.async copies of the span's 16-byte-aligned
//      superset. Each row takes a slot of one span; a pass takes as many band
//      rows as the slots hold (the whole band at r ~ 1; at the largest r,
//      where a span is the frame width, a few output rows);
//   3. resamples from shared memory, eight outputs a thread, and writes them
//      with one 16-byte store (an output row is window * C bf16).
// The vertical pass runs per output element on the staged pixels rather than
// once per staged column: at large r most staged columns carry no tap.
// Blocks of one SM overlap one block's copies with another's arithmetic.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W (128 faces,
// 640^2 frames, window 128, every strip bucket): 0.038 ms of device time for
// either construction, 2.9x the bound, against 0.056 ms for F.grid_sample
// and 0.072 ms for the one-thread-per-output gather kernel it replaces.
//
// Bound: bytes. Per face the kernel must read the distinct source pixels
// its nonzero-weight taps touch (about (window*r)^2 * C bf16 values) and
// write window^2 * C bf16 values; the scalars are 24 bytes. At the H100's
// 3.35 TB/s that is the floor chip_smoke.py reports as bound_ms.
// ---------------------------------------------------------------------------
constexpr int kCropThreads = 256;
constexpr int kOutVec = 8;  // bf16 outputs per 16-byte store

// v0 * p0[idx] + v1 * p1[idx] over the nonzero vertical weights, in f32.
__device__ __forceinline__ float vertical_pass(const __nv_bfloat16* p0,
                                               const __nv_bfloat16* p1, float2 v,
                                               int idx) {
  float col = 0.0f;
  if (v.x != 0.0f) col = __fadd_rn(col, __fmul_rn(v.x, __bfloat162float(p0[idx])));
  if (v.y != 0.0f) col = __fadd_rn(col, __fmul_rn(v.y, __bfloat162float(p1[idx])));
  return col;
}

// Dynamic shared memory, in this order: slot_budget bytes of row slots, then
// col_w (window float2), row_w (band float2), row_slot (band int2), col_s0
// (window int), row_t0 (band int), slot_row and slot_ph (2 * band int each):
// slot_budget + 12 * window + 36 * band bytes (crop_frac_plan in
// ops/warp_kernel.py).
template <int kTaps>
__global__ void __launch_bounds__(kCropThreads)
crop_frac_band_kernel(const __nv_bfloat16* __restrict__ frames,
                      __nv_bfloat16* __restrict__ out, const int* __restrict__ strip0,
                      const int* __restrict__ level, const int* __restrict__ frame_idx,
                      const float* __restrict__ r_in, const float* __restrict__ off_y,
                      const float* __restrict__ x0f, int H, int W, int C, int window,
                      int band, int slot_budget) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pass_end, pass_slots;
  unsigned char* slots = smem;
  float2* col_w = reinterpret_cast<float2*>(smem + slot_budget);
  float2* row_w = col_w + window;
  int2* row_slot = reinterpret_cast<int2*>(row_w + band);
  int* col_s0 = reinterpret_cast<int*>(row_slot + band);
  int* row_t0 = col_s0 + window;
  int* slot_row = row_t0 + band;
  int* slot_ph = slot_row + 2 * band;

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int o0 = blockIdx.x * band;
  const int nrows = min(band, window - o0);
  const float r = r_in[n], oy = off_y[n], ox = x0f[n];
  const int s0 = strip0[n];
  const int rows = min(window << level[n], H);
  const int rowlen = W * C;  // elements of a frame row
  const __nv_bfloat16* strip =
      frames + ((size_t)(frame_idx != nullptr ? frame_idx[n] : n) * H + s0) * rowlen;

  // 1. Tap tables. A tap outside the frame (columns) or outside the strip
  //    and the frame (rows) gets weight 0, and a 0 weight is skipped below.
  for (int jx = tid; jx < window; jx += kCropThreads) {
    const float sx = window_coord(ox, jx, r);
    int t = 0;
    float w0 = 0.0f, w1 = 0.0f;
    if (sx > -1.0f && sx < (float)W) {
      t = (int)floorf(sx);  // -1 <= t < W
      if (t >= 0) w0 = tap_bf16<kTaps>(sx, t);
      if (t + 1 < W) w1 = tap_bf16<kTaps>(sx, t + 1);
    }
    col_s0[jx] = t;
    col_w[jx] = make_float2(w0, w1);
  }
  for (int i = tid; i < nrows; i += kCropThreads) {
    const float sy = window_coord(oy, o0 + i, r);
    int t = 0;
    float w[2] = {0.0f, 0.0f};
    if (sy > -1.0f && sy < (float)rows) {
      t = (int)floorf(sy);
      const float one_minus_sy = __fsub_rn(1.0f, sy);
      for (int k = 0; k < 2; ++k) {
        const int ty = t + k;
        if (ty >= 0 && ty < rows && s0 + ty >= 0 && s0 + ty < H)
          w[k] = kTaps == kLegacy ? tri_bf16(sy, (float)ty)
                                  : tri_u_bf16((float)ty, one_minus_sy);
      }
    }
    row_t0[i] = t;
    row_w[i] = make_float2(w[0], w[1]);
  }

  // The columns any output column's taps touch: sx grows with jx.
  const float sx_first = window_coord(ox, 0, r), sx_last = window_coord(ox, window - 1, r);
  int c_lo = 0, c_hi = -1;
  if (sx_last > -1.0f && sx_first < (float)W) {
    c_lo = max(0, (int)floorf(fmaxf(sx_first, -1.0f)));
    c_hi = min(W - 1, (int)floorf(fminf(sx_last, (float)W)) + 1);
  }
  const int span = c_hi >= c_lo ? (c_hi - c_lo + 1) * C * 2 : 0;  // bytes of a row's span
  const int nch = span > 0 ? (span + 15) / 16 + 1 : 0;  // 16-byte chunks of its superset
  const int stride = 16 * nch;                          // bytes of a slot
  const int max_slots = stride > 0 ? min(2 * band, slot_budget / stride) : 2 * band;
  const size_t span_off = (size_t)c_lo * C;  // elements from a row's start
  const int ochunks = window * C / kOutVec;
  __syncthreads();

  for (int i0 = 0; i0 < nrows;) {
    // 2. The pass: band rows i0.. and the distinct source rows they read
    //    (nondecreasing, so a repeat is the previous slot's row).
    if (tid == 0) {
      int ns = 0, last = INT_MIN, i = i0;
      for (; i < nrows; ++i) {
        const float2 v = row_w[i];
        const int t = row_t0[i];
        const int add = (v.x != 0.0f && t != last) +
                        (v.y != 0.0f && t + 1 != (v.x != 0.0f ? t : last));
        if (ns + add > max_slots) break;
        int2 sl = make_int2(-1, -1);
        for (int k = 0; k < 2; ++k) {
          if ((k == 0 ? v.x : v.y) == 0.0f) continue;
          if (t + k != last) {
            const __nv_bfloat16* p = strip + (size_t)(t + k) * rowlen + span_off;
            slot_row[ns] = t + k;
            slot_ph[ns] = (int)(((uintptr_t)p & 15) >> 1);
            last = t + k;
            ++ns;
          }
          (k == 0 ? sl.x : sl.y) = ns - 1;
        }
        row_slot[i] = sl;
      }
      pass_end = i;
      pass_slots = ns;
    }
    __syncthreads();
    const int i1 = pass_end, ns = pass_slots;

    // Stage: chunk q of slot j is the q-th 16 bytes of the aligned superset.
    for (int u = tid; u < ns * nch; u += kCropThreads) {
      const int j = u / nch, q = u - j * nch;
      const unsigned char* begin = reinterpret_cast<const unsigned char*>(
          strip + (size_t)slot_row[j] * rowlen + span_off);
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>((uintptr_t)begin & ~(uintptr_t)15) + 16 * q;
      if (src < begin + span) cp_async16(slots + j * stride + 16 * q, src);
    }
    cp_async_wait_all();
    __syncthreads();

    // 3. Resample: eight consecutive outputs of one row per thread.
    for (int u = tid; u < (i1 - i0) * ochunks; u += kCropThreads) {
      const int di = u / ochunks, q = u - di * ochunks;
      const int i = i0 + di;
      const float2 v = row_w[i];
      const int2 sl = row_slot[i];
      const __nv_bfloat16* p0 =
          reinterpret_cast<const __nv_bfloat16*>(slots + (v.x != 0.0f ? sl.x : 0) * stride) +
          (v.x != 0.0f ? slot_ph[sl.x] : 0);
      const __nv_bfloat16* p1 =
          reinterpret_cast<const __nv_bfloat16*>(slots + (v.y != 0.0f ? sl.y : 0) * stride) +
          (v.y != 0.0f ? slot_ph[sl.y] : 0);
      int e = q * kOutVec;
      int jx = e / C, c = e - jx * C;
      __align__(16) __nv_bfloat16 res[kOutVec];
#pragma unroll
      for (int k = 0; k < kOutVec; ++k) {
        const int s = col_s0[jx];
        const float2 hw = col_w[jx];
        const int idx = (s - c_lo) * C + c;
        float acc = 0.0f;
        if (hw.x != 0.0f)
          acc = __fadd_rn(acc, __fmul_rn(round_bf16(vertical_pass(p0, p1, v, idx)), hw.x));
        if (hw.y != 0.0f)
          acc = __fadd_rn(acc, __fmul_rn(round_bf16(vertical_pass(p0, p1, v, idx + C)), hw.y));
        res[k] = __float2bfloat16_rn(acc);
        if (++c == C) {
          c = 0;
          ++jx;
        }
      }
      *reinterpret_cast<uint4*>(out + ((size_t)n * window + o0 + i) * window * C + e) =
          *reinterpret_cast<const uint4*>(res);
    }
    __syncthreads();  // the slots and row_slot are rewritten by the next pass
    i0 = i1;
  }
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
// frame_idx may be null (the identity); window * C must be a multiple of 8.
int dfv_crop_frac_bf16(const void* frames, void* out, const void* strip0,
                       const void* level, const void* frame_idx, const void* r,
                       const void* off_y, const void* x0f, int n_faces, int H, int W,
                       int C, int window, int taps, int band, int slot_budget,
                       int smem_bytes, void* stream) {
  if (n_faces > 0) {
    auto kernel = taps == kRank1 ? crop_frac_band_kernel<kRank1>
                                 : crop_frac_band_kernel<kLegacy>;
    if (smem_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((window + band - 1) / band, n_faces);
    kernel<<<grid, kCropThreads, smem_bytes, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)frames, (__nv_bfloat16*)out, (const int*)strip0,
        (const int*)level, (const int*)frame_idx, (const float*)r, (const float*)off_y,
        (const float*)x0f, H, W, C, window, band, slot_budget);
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
