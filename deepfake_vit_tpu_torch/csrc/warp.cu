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
// there (see crop_frac_band_kernel); the warps stage the source box of a 2-D
// tile of output pixels the same way and write the tile with 16-byte stores
// (see warp_tile_kernel); the pooled crop stages a band's consecutive frame
// rows in double-buffered stages of 16-byte cp.async copies, sums them down
// in place and pools the result across (see crop_pool_band_kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "dfv_common.cuh"

namespace {

using namespace dfv;

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

// Tap constructions, a compile-time parameter of the crop and warp kernels
// (kInt8: the warp's q7 vertical taps; its horizontal taps are rank-1).
enum Taps { kLegacy = 0, kRank1 = 1, kInt8 = 2 };

// Weight of integer tap t for coordinate s. Rank-1 (every construction but
// kLegacy): U = s + (1 - t), the order of the TPU kernels' U = s * 1 + (1 - t) * 1.
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
      if (src < begin + span) cp_async<16>(slots + j * stride + 16 * q, src, 16);
    }
    cp_async_commit();
    cp_async_wait<0>();
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
// pools and crops it with two selection matmuls Vp @ strip @ Hp. Per face n
// and output (o, j, c), with f32 sums and the TPU kernel's one intermediate
// rounding to bf16:
//   t1[s] = bf16(sum_{r < 2^l} 2^-l * frame[y0_l0 + (o << l) + r, s, c])
//   out   = bf16(sum_{s < 2^l} 2^-l * t1[((x0 + j) << l) + s])
// Pixels outside the frame read as 0. A power-of-two factor commutes with
// rounding, so 2^-l * (sum of the terms in order) is bit for bit the sum of
// the scaled terms in order: the kernel scales once after each sum.
//
// Bound: bytes. Per face its (window * 2^l)^2 * C source values inside the
// frame are read once and window^2 * C values written, plus 16 bytes of
// scalars; at the H100's 3.35 TB/s that is the floor chip_smoke.py reports
// as bound_ms.
//
// Design: one block per (face, band of output rows), from a 2-D grid (face,
// band): no division finds them. The band's source rows are consecutive
// frame rows, y0_l0 + (o0 << l) + k for k < band * 2^l, and go through shared
// memory in stages of a power-of-two number of rows (crop_pool_plan in
// ops/warp_kernel.py sizes them):
//   1. each row's columns that the face reads, (x0 << l) .. ((x0 + window)
//      << l), clipped to the frame, are copied with 16-byte cp.async as their
//      16-byte-aligned superset (the values sit ph elements into their slot);
//      the copies of stage s + 1 are in flight while stage s is reduced;
//   2. the vertical pass adds each element's 2^l rows in r order (a row
//      outside the frame adds nothing), 8 elements a thread with 16-byte
//      loads when every row shares its phase (W * C a multiple of 8), one
//      element a thread otherwise, and writes t1 as bf16 over the output
//      row's first slot; when an output row's rows outnumber a stage, the
//      f32 sums carry to the next stage in shared memory;
//   3. the horizontal pass computes the output rows a stage completes, one
//      output a thread, neighbouring threads on neighbouring outputs (their
//      t1 reads are nearly consecutive: at most two-way bank conflicts), taps only
//      on the frame's columns, into a shared-memory copy of the rows;
//   4. the rows go out with 16-byte stores (an output row is window * C
//      bf16, a multiple of 8).
// Indices come from the block's coordinates, the thread's index and
// multiplications by 32-bit reciprocals: no 64-bit division runs.
// Measured by tools/kernel_times.py on an NVIDIA H100 80GB HBM3 at 700 W
// (640^2 frames, window 160, levels 0-2): 0.098 ms of device time for 128
// faces, 1.7x the bound, and 0.076 ms for 96 faces sharing 32 frames,
// against 0.175 and 0.13 ms for the one-thread-per-output gather it
// replaces; other bands and stage sizes are no faster
// (tools/stem_pool_variants.py).
// ---------------------------------------------------------------------------
constexpr int kPoolThreads = 256;
constexpr int kPoolWarps = kPoolThreads / 32;

// Dynamic shared memory: two stage buffers of stage_bytes, f32 carries of
// one slot's elements (2 * slot_cap bytes), the stage's output rows
// (out_rows * window * C bf16). slot_cap is the plan's slot: the 16-byte
// superset of a whole frame row plus one chunk.
template <bool kVec>
__global__ void __launch_bounds__(kPoolThreads)
crop_pool_band_kernel(const __nv_bfloat16* __restrict__ frames, __nv_bfloat16* __restrict__ out,
                      const int* __restrict__ y0_l0, const int* __restrict__ x0_in,
                      const int* __restrict__ level, const int* __restrict__ frame_idx,
                      int n_frames, int H, int W, int C, int window, int band, int stage_bytes,
                      int slot_cap, int out_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* carry = reinterpret_cast<float*>(smem + 2 * stage_bytes);
  __nv_bfloat16* outS =
      reinterpret_cast<__nv_bfloat16*>(smem + 2 * stage_bytes + 2 * slot_cap);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x;
  const int o0 = blockIdx.y * band;
  const int nrows = min(band, window - o0);
  const int l = level[n], side = 1 << l;
  const float inv = __int_as_float((127 - l) << 23);  // 2^-l
  const int fi = frame_idx != nullptr ? frame_idx[n] : n;
  const int x0 = x0_in[n];
  const int rowlen = W * C;
  const __nv_bfloat16* frame = frames + (size_t)fi * H * rowlen;
  const unsigned char* frames_end =
      reinterpret_cast<const unsigned char*>(frames + (size_t)n_frames * H * rowlen);
  const int ybase = y0_l0[n] + (o0 << l);  // frame row of the band's source row k: ybase + k
  const int total = nrows * side;          // the band's source rows

  // The face's columns on the frame, [cv_lo, cv_hi): the same for every row.
  const int cv_lo = max(x0 * side, 0), cv_hi = min((x0 + window) * side, W);
  const int span = cv_hi > cv_lo ? (cv_hi - cv_lo) * C : 0;  // elements a row stages
  const int nch = span > 0 ? (span * 2 + 15) / 16 + 1 : 0;   // 16-byte chunks of a slot
  const int slot = 16 * max(nch, 1);
  // Rows a stage: a power of two, whole output rows where they fit, at most
  // out_rows output rows (their copy in outS) and never past the band.
  int rs = 1;
  while (2 * rs * slot <= stage_bytes && 2 * rs <= side * out_rows && 2 * rs <= total) rs *= 2;
  const int rows_per_out = min(rs, side);     // of each, rows in the stage
  const int n_stages = (total + rs - 1) / rs;
  const int oelems = window * C;  // elements of an output row
  // Element phase of row y's first value in its slot: frames is 16-byte
  // aligned, so only the element offset mod 8 counts (32-bit wrap keeps it).
  auto phase = [&](int y) {
    return (int)(((unsigned)(fi * H + y) * (unsigned)rowlen + (unsigned)(cv_lo * C)) & 7u);
  };
  const unsigned rcp_nch = recip32(max(nch, 1)), rcp_span = recip32(max(span, 1));
  const unsigned rcp_oel = recip32(oelems), rcp_c = recip32(C), rcp_och = recip32(oelems / 8);

  auto copy_stage = [&](int s) {
    unsigned char* buf = smem + (s & 1) * stage_bytes;
    for (int i = warp; i < rs && s * rs + i < total; i += kPoolWarps) {
      const int y = ybase + s * rs + i;
      if (y < 0 || y >= H) continue;  // outside the frame: the row adds nothing
      const unsigned char* begin =
          reinterpret_cast<const unsigned char*>(frame + (size_t)y * rowlen + cv_lo * C);
      const unsigned char* a =
          reinterpret_cast<const unsigned char*>((uintptr_t)begin & ~(uintptr_t)15);
      for (int q = lane; q < nch; q += 32) {
        const unsigned char* src = a + 16 * q;
        if (src < begin + 2 * span)
          cp_async<16>(buf + i * slot + 16 * q, src,
                       (int)min(16LL, (long long)(frames_end - src)));
      }
    }
    cp_async_commit();
  };

  if (nch > 0) copy_stage(0);
  for (int s = 0; s < n_stages; ++s) {
    unsigned char* buf = smem + (s & 1) * stage_bytes;
    const int k0 = s * rs, k1 = min(k0 + rs, total);
    const int n_out = max(1, (k1 - k0) >> l);               // output rows in this stage
    const bool first = (k0 & (side - 1)) == 0, last = (k1 & (side - 1)) == 0;
    if (nch > 0) {
      if (s + 1 < n_stages) {
        copy_stage(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    }
    __syncthreads();

    // 2. Vertical pass: output row oi of the stage reads slots
    //    oi * rows_per_out + r; its t1 goes over slot oi * rows_per_out.
    if (kVec) {
      // Every row shares one phase: slot chunk u holds the same elements in
      // every slot.
      for (int t = tid; t < n_out * nch; t += kPoolThreads) {
        const int oi = (int)div_by((unsigned)t, (unsigned)nch, rcp_nch), u = t - oi * nch;
        const int i0 = oi * rows_per_out, yf = ybase + k0 + i0;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = first ? 0.0f : carry[8 * u + e];
        for (int r = 0; r < rows_per_out; ++r) {
          const int y = yf + r;
          if (y < 0 || y >= H) continue;
          const uint4 w = *reinterpret_cast<const uint4*>(buf + (i0 + r) * slot + 16 * u);
          const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[2 * e] = __fadd_rn(v[2 * e], __uint_as_float(ws[e] << 16));
            v[2 * e + 1] = __fadd_rn(v[2 * e + 1], __uint_as_float(ws[e] & 0xffff0000u));
          }
        }
        if (last) {
          uint32_t packed[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 h =
                __floats2bfloat162_rn(__fmul_rn(v[2 * e], inv), __fmul_rn(v[2 * e + 1], inv));
            packed[e] = *reinterpret_cast<const uint32_t*>(&h);
          }
          *reinterpret_cast<uint4*>(buf + i0 * slot + 16 * u) =
              make_uint4(packed[0], packed[1], packed[2], packed[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) carry[8 * u + e] = v[e];
        }
      }
    } else {
      // Rows may differ in phase: one element a thread, each row read at its
      // own phase, t1 written at the first slot's.
      for (int t = tid; t < n_out * span; t += kPoolThreads) {
        const int oi = (int)div_by((unsigned)t, (unsigned)span, rcp_span), e = t - oi * span;
        const int i0 = oi * rows_per_out, yf = ybase + k0 + i0;
        float v = first ? 0.0f : carry[e];
        for (int r = 0; r < rows_per_out; ++r) {
          const int y = yf + r;
          if (y < 0 || y >= H) continue;
          const __nv_bfloat16* row = reinterpret_cast<const __nv_bfloat16*>(buf + (i0 + r) * slot);
          v = __fadd_rn(v, __bfloat162float(row[phase(y) + e]));
        }
        if (last) {
          reinterpret_cast<__nv_bfloat16*>(buf + i0 * slot)[phase(yf) + e] =
              __float2bfloat16_rn(__fmul_rn(v, inv));
        } else {
          carry[e] = v;
        }
      }
    }
    if (!last) {  // the output row continues in the next stage
      __syncthreads();
      continue;
    }
    __syncthreads();

    // 3. Horizontal pass: output (j, c) of row oi sums t1 over the frame
    //    columns among ((x0 + j) << l) + s, s < 2^l, in s order.
    for (int t = tid; t < n_out * oelems; t += kPoolThreads) {
      const int oi = (int)div_by((unsigned)t, (unsigned)oelems, rcp_oel), e = t - oi * oelems;
      const int j = (int)div_by((unsigned)e, (unsigned)C, rcp_c), c = e - j * C;
      const int i0 = oi * rows_per_out, yf = ybase + k0 + i0;
      const __nv_bfloat16* t1 =
          reinterpret_cast<const __nv_bfloat16*>(buf + i0 * slot) + phase(yf) + c;
      const int col0 = (x0 + j) * side;
      const int s_lo = max(0, cv_lo - col0), s_hi = min(side, cv_hi - col0);
      float acc = 0.0f;
      for (int sc = s_lo; sc < s_hi; ++sc)
        acc = __fadd_rn(acc, __bfloat162float(t1[(col0 + sc - cv_lo) * C]));
      outS[oi * oelems + e] = __float2bfloat16_rn(__fmul_rn(acc, inv));
    }
    __syncthreads();

    // 4. The stage's output rows, 16-byte stores.
    const int o_first = o0 + (k0 >> l), ochunks = oelems / 8;
    for (int t = tid; t < n_out * ochunks; t += kPoolThreads) {
      const int oi = (int)div_by((unsigned)t, (unsigned)ochunks, rcp_och), q = t - oi * ochunks;
      *reinterpret_cast<uint4*>(out + ((size_t)n * window + o_first + oi) * oelems + 8 * q) =
          *reinterpret_cast<const uint4*>(outS + oi * oelems + 8 * q);
    }
    // No barrier here: the next stage's copies go to the other buffer, and
    // its passes rewrite outS and this buffer only after its first barrier.
  }
}

// ---------------------------------------------------------------------------
// warp_affine_legacy, warp_affine_uw / uw16, warp_affine_int8
//
// Replaces deepfake_vit_tpu/ops/pallas/warp_kernel.py::_warp_kernel
// (launcher warp_affine_pallas): cv2.warpAffine, bilinear, border 0, bf16
// (N, Hs, Ws, C) source, f32 (N, Ho, Wo, C) output. The TPU kernel builds
// dense V/H tap planes and runs a channel-stacked matmul over the whole
// source height; here each output pixel reads its 2x2 source taps. One
// template over the three tap constructions of the TPU kernel:
//
//   kLegacy ("legacy"): taps bf16(max(0, 1 - |s - t|));
//   kRank1 ("uw" and "uw16", one function: both round the rank-1 tap plane
//     to bf16, warp_kernel.py:165, :173): bf16(max(0, 1 - |(s + (1 - t)) - 1|));
//   kInt8 ("int8", :160-207): q7 vertical taps on shifted-s8 pixels, rank-1
//     bf16 horizontal taps:
//       q[t, s] = clip(rint(px) - 128, -128, 127)            (half to even)
//       V[t]    = trunc(max(0.5, 127.5 - |U - 127.5|)),
//                 U = 127*sy + (127*(1 - t) + 0.5)   (product and sum rounded)
//       P[s]    = bf16(sum_t q[t, s] * V[t])         (exact s32 sum, then bf16)
//       out     = (sum_s f32(bf16(P[s] * H[s])) + (128 * sum_t V) * sum_s H)
//                 * f32(1/127)
//     the shift coming back through the separable correction; pixels are
//     quantized as they are read from the staged box (no s8 copy of the
//     source is written).
// Per output pixel (i, j): sx = a*j + b*i + c, sy = d*j + e*i + f (rounded
// products and sums in that order); for the bf16 constructions
// P[s] = bf16(sum_t V[t] * px[t, s]) and out = sum_s f32(bf16(P[s] * H[s])).
// The TPU kernel pads the source with zero pixels (16 or 32 rows and
// columns, whose int8 taps it zeroes); a zero pixel adds nothing to any sum,
// so here taps outside the source are dropped and the sums of V and H run
// over the taps inside it.
//
// Bound: bytes. It must read the source pixels that the output points'
// nonzero-weight taps touch (bf16) and write the f32 output once; at the
// H100's 3.35 TB/s that is the floor chip_smoke.py reports as bound_ms. At
// C = 3 the output is most of it (56.6 MB for 128 faces at 192^2).
//
// Design: one block per (face, 32 x tile_h tile of output pixels), from a
// 3-D grid (tile column, tile row, face): no division finds them.
//   1. The tile's source box: coordinates are monotone in i and j (rounded
//      products and sums are monotone), so the extremes of sx and sy over
//      the tile lie at its four corners; the box is floor(min) .. floor(max)
//      + 1, clipped to the source. It stays small at any rotation of a
//      similarity warp (a band of whole output rows would not: it grows
//      with Wo * |sin(roll)|).
//   2. If the box fits the plan's budget, it is staged in shared memory,
//      each source pixel read once, widened to f32 (kInt8: quantized) and
//      stored as ceil(C / 4) float4s; otherwise (a large down-scale, as
//      warp_affine_auto on a whole frame can ask for) the taps are read
//      from device memory with the same arithmetic.
//   3. One thread per output pixel (a warp per tile row) computes its
//      coordinates and its four tap weights once, reads each tap's
//      channels with one 16-byte load a four, and resamples them into a
//      shared-memory copy of the output tile, rounding two values to bf16
//      in one conversion.
//   4. Each warp writes whole tile rows (32 * C contiguous floats) with
//      16-byte stores; a ragged tile or an output row not 16-byte aligned
//      stores its partial words element by element.
// ---------------------------------------------------------------------------
constexpr int kWarpThreads = 256;
constexpr int kWarpWarps = kWarpThreads / 32;
constexpr int kWarpTileW = 32;  // output columns of a tile: one warp's pixels
constexpr int kStageRows = 4;   // box rows a warp loads before it stores them
constexpr int kTileRowsPerPass = kWarpThreads / kWarpTileW;  // tile rows the block resamples at once

// dst -> src coordinates of output pixel (i, j): a*j + b*i + c, in the TPU
// kernel's order.
__device__ __forceinline__ void warp_coords(const float* A, int i, int j, float* sx,
                                            float* sy) {
  *sx = __fadd_rn(__fadd_rn(__fmul_rn(A[0], (float)j), __fmul_rn(A[1], (float)i)), A[2]);
  *sy = __fadd_rn(__fadd_rn(__fmul_rn(A[3], (float)j), __fmul_rn(A[4], (float)i)), A[5]);
}

// Source rows [r_lo, r_hi] and columns [c_lo, c_hi] that a tap of any
// pixel of the tile can read (empty: hi < lo). Mirrored by warp_tile_box in
// ops/warp_kernel.py.
struct Box {
  int r_lo, r_hi, c_lo, c_hi;
};

__device__ __forceinline__ void box_axis(float lo, float hi, int n, int* first, int* last) {
  *first = 0;
  *last = -1;
  if (hi > -1.0f && lo < (float)n) {  // false for NaN: no tap has a weight
    *first = max(0, (int)floorf(fmaxf(lo, -1.0f)));
    *last = min(n - 1, (int)floorf(fminf(hi, (float)n)) + 1);
  }
}

__device__ __forceinline__ Box tile_box(const float* A, int i0, int j0, int th, int tw, int Hs,
                                        int Ws) {
  float x_lo = INFINITY, x_hi = -INFINITY, y_lo = INFINITY, y_hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float sx, sy;
    warp_coords(A, i0 + (k >> 1) * (th - 1), j0 + (k & 1) * (tw - 1), &sx, &sy);
    x_lo = fminf(x_lo, sx);
    x_hi = fmaxf(x_hi, sx);
    y_lo = fminf(y_lo, sy);
    y_hi = fmaxf(y_hi, sy);
  }
  Box b;
  box_axis(y_lo, y_hi, Hs, &b.r_lo, &b.r_hi);
  box_axis(x_lo, x_hi, Ws, &b.c_lo, &b.c_hi);
  return b;
}

// A source value as the warp's arithmetic takes it: the bf16 pixel widened
// to f32, or for kInt8 its shifted-s8 value q = clip(rint(px) - 128) (an
// integer, exact in f32: the products q * V and their two-term sums stay
// below 2^15, so the f32 sums equal the TPU kernel's s32 sums).
template <int kTaps>
__device__ __forceinline__ float source_value(__nv_bfloat16 v) {
  const float px = __bfloat162float(v);
  return kTaps == kInt8 ? (float)min(127, max(-128, __float2int_rn(px) - 128)) : px;
}

// Channels [4g, 4g + 4) of a source pixel (zeros beyond C). kStaged: pixel
// `pix` of the staged box, whose pixels hold G = ceil(C / 4) float4s; else
// the element offset of the pixel in the face's image in device memory.
template <int kTaps, bool kStaged>
__device__ __forceinline__ float4 source_px4(const void* src, int pix, int g, int G, int C) {
  if (kStaged) return reinterpret_cast<const float4*>(src)[pix * G + g];
  const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(src) + pix + 4 * g;
  const int n = C - 4 * g;
  return make_float4(source_value<kTaps>(p[0]), n > 1 ? source_value<kTaps>(p[1]) : 0.0f,
                     n > 2 ? source_value<kTaps>(p[2]) : 0.0f,
                     n > 3 ? source_value<kTaps>(p[3]) : 0.0f);
}

// Round a and b to bf16 in one conversion.
__device__ __forceinline__ void round_bf16x2(float* a, float* b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(*a, *b);
  *a = __low2float(h);
  *b = __high2float(h);
}

// One output value from its four taps' values: column k's vertical pass
// P_k = bf16(0 + V0 * x0k + V1 * x1k), then 0 + bf16(P_0 * H_0) +
// bf16(P_1 * H_1), each product and sum rounded on its own in the plain
// version's order (a zero weight adds a signed zero, which changes no sum);
// kInt8 adds the correction and scales by f32(1/127).
template <int kTaps>
__device__ __forceinline__ float resample_value(float x00, float x10, float x01, float x11,
                                                float v0, float v1, float h0, float h1,
                                                float corr) {
  float p0 = __fadd_rn(__fadd_rn(0.0f, __fmul_rn(v0, x00)), __fmul_rn(v1, x10));
  float p1 = __fadd_rn(__fadd_rn(0.0f, __fmul_rn(v0, x01)), __fmul_rn(v1, x11));
  round_bf16x2(&p0, &p1);
  float m0 = __fmul_rn(p0, h0), m1 = __fmul_rn(p1, h1);
  round_bf16x2(&m0, &m1);
  const float acc = __fadd_rn(__fadd_rn(0.0f, m0), m1);
  return kTaps == kInt8 ? __fmul_rn(__fadd_rn(acc, corr), 1.0f / 127.0f) : acc;
}

// The two taps of coordinate s, t = tf and tf + 1 (tf = floor(s), in f32),
// before and after their rounding to bf16 (one conversion for the pair):
// legacy max(0, 1 - |s - t|), rank-1 max(0, 1 - |(s + (1 - t)) - 1|). 1 - t
// is exact in f32, as the kernels' (float)(1 - t) is.
template <int kTaps>
__device__ __forceinline__ void tap_pair_bf16(float s, float tf, float* w0, float* w1) {
  float raw[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float t = tf + (float)k;
    const float d = kTaps == kLegacy ? __fsub_rn(s, t) : __fsub_rn(__fadd_rn(s, 1.0f - t), 1.0f);
    raw[k] = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d)));
  }
  *w0 = raw[0];
  *w1 = raw[1];
  round_bf16x2(w0, w1);
}

// Resample the tile's pixels into outS ([tile_h][kWarpTileW][C] f32), one
// thread per pixel, a warp per tile row: a thread keeps its column and
// steps down the tile's rows, so the column's product a*j (and d*j) and its
// conversion are made once. kStaged: src is the staged box (pixel (t, s) at
// (t - r_lo) * box_cols + s - c_lo); else src is the face's image in device
// memory. The conversions (float <-> int, floor, bf16) run at a fraction of
// the f32 rate and bound this loop: each pixel makes 2 floors, 2 float ->
// int conversions and 2 + C bf16 conversions of two values each.
template <int kTaps, bool kStaged>
__device__ __forceinline__ void resample_tile(const void* src, const float* A, int i0, int j0,
                                              int th, int tw, int Hs, int Ws, int C,
                                              const Box& b, float* outS) {
  const int G = (C + 3) / 4;
  const int box_cols = b.c_hi - b.c_lo + 1;
  const int lj = threadIdx.x % kWarpTileW;
  if (lj >= tw) return;
  const float jf = (float)(j0 + lj);
  const float aj = __fmul_rn(A[0], jf), dj = __fmul_rn(A[3], jf);
  float fi = (float)(i0 + threadIdx.x / kWarpTileW);  // exact: integer steps
  for (int li = threadIdx.x / kWarpTileW; li < th;
       li += kTileRowsPerPass, fi += (float)kTileRowsPerPass) {
    // a*j + b*i + c, d*j + e*i + f in the TPU kernel's order (warp_coords).
    const float sx = __fadd_rn(__fadd_rn(aj, __fmul_rn(A[1], fi)), A[2]);
    const float sy = __fadd_rn(__fadd_rn(dj, __fmul_rn(A[4], fi)), A[5]);
    float* dst = outS + (li * kWarpTileW + lj) * C;

    // The pixel's taps, once for all channels: weights (0 outside the
    // source) and the rows and columns they read.
    int ty = 0, tx = 0;
    float vw[2] = {0.0f, 0.0f}, hw[2] = {0.0f, 0.0f};
    bool vin[2] = {false, false}, hin[2] = {false, false};
    if (sy > -1.0f && sy < (float)Hs) {
      const float tf = floorf(sy);
      ty = (int)tf;
      vin[0] = ty >= 0;
      vin[1] = ty + 1 < Hs;
      if (kTaps == kInt8) {
        const float u0 = __fmul_rn(127.0f, sy);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float c = __fadd_rn(127.0f * (1.0f - (tf + (float)k)), 0.5f);  // exact
          const float u = __fadd_rn(u0, c);
          vw[k] = truncf(fmaxf(0.5f, __fsub_rn(127.5f, fabsf(__fsub_rn(u, 127.5f)))));
        }
      } else {
        tap_pair_bf16<kTaps>(sy, tf, &vw[0], &vw[1]);
      }
      if (!vin[0]) vw[0] = 0.0f;
      if (!vin[1]) vw[1] = 0.0f;
    }
    if (sx > -1.0f && sx < (float)Ws) {
      const float tf = floorf(sx);
      tx = (int)tf;
      hin[0] = tx >= 0;
      hin[1] = tx + 1 < Ws;
      tap_pair_bf16<kTaps == kInt8 ? kRank1 : kTaps>(sx, tf, &hw[0], &hw[1]);
      if (!hin[0]) hw[0] = 0.0f;
      if (!hin[1]) hw[1] = 0.0f;
    }
    if (!(vin[0] || vin[1]) || !(hin[0] || hin[1])) {  // every term is 0: so is the output
      for (int ch = 0; ch < C; ++ch) dst[ch] = 0.0f;
      continue;
    }
    // A tap outside the source has weight 0: it reads its in-source twin.
    const int r0 = vin[0] ? ty : ty + 1, r1 = vin[1] ? ty + 1 : ty;
    const int c0 = hin[0] ? tx : tx + 1, c1 = hin[1] ? tx + 1 : tx;
    const float corr =
        kTaps == kInt8 ? __fmul_rn(128.0f * __fadd_rn(vw[0], vw[1]), __fadd_rn(hw[0], hw[1]))
                       : 0.0f;
    int pix[2][2];  // [row][column]
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = q ? r1 : r0, s = k ? c1 : c0;
        pix[q][k] = kStaged ? (t - b.r_lo) * box_cols + (s - b.c_lo) : (t * Ws + s) * C;
      }
    }
    for (int g = 0; g < G; ++g) {
      const float4 a = source_px4<kTaps, kStaged>(src, pix[0][0], g, G, C);
      const float4 bq = source_px4<kTaps, kStaged>(src, pix[1][0], g, G, C);
      const float4 c = source_px4<kTaps, kStaged>(src, pix[0][1], g, G, C);
      const float4 d = source_px4<kTaps, kStaged>(src, pix[1][1], g, G, C);
      const float x00[4] = {a.x, a.y, a.z, a.w}, x10[4] = {bq.x, bq.y, bq.z, bq.w};
      const float x01[4] = {c.x, c.y, c.z, c.w}, x11[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (4 * g + k < C)
          dst[4 * g + k] = resample_value<kTaps>(x00[k], x10[k], x01[k], x11[k], vw[0], vw[1],
                                                 hw[0], hw[1], corr);
      }
    }
  }
}

// Dynamic shared memory: the output tile (tile_h * 32 * C f32), then
// box_budget bytes for the staged box, ceil(C / 4) float4s a source pixel
// (warp_plan in ops/warp_kernel.py). tile_branch, when not null, gets 1
// (staged) or 2 (device memory) per tile.
template <int kTaps>
__global__ void __launch_bounds__(kWarpThreads)
warp_tile_kernel(const __nv_bfloat16* __restrict__ img, const float* __restrict__ coef,
                 float* __restrict__ out, int* __restrict__ tile_branch, int Hs, int Ws, int C,
                 int Ho, int Wo, int tile_h, int box_budget) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* outS = reinterpret_cast<float*>(smem);
  float* boxS = outS + (size_t)tile_h * kWarpTileW * C;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * tile_h, j0 = blockIdx.x * kWarpTileW;
  const int th = min(tile_h, Ho - i0), tw = min(kWarpTileW, Wo - j0);
  float A[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) A[k] = coef[6 * n + k];
  const __nv_bfloat16* src = img + (size_t)n * Hs * Ws * C;

  // 1. The box, and whether it fits the budget.
  const Box b = tile_box(A, i0, j0, th, tw, Hs, Ws);
  const int rows = b.r_hi - b.r_lo + 1, cols = b.c_hi - b.c_lo + 1;
  const int G = (C + 3) / 4;
  const bool empty = rows <= 0 || cols <= 0;
  const bool staged = empty || (long long)rows * cols * G * 16 <= box_budget;
  if (tile_branch != nullptr && tid == 0)
    tile_branch[((size_t)n * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = staged ? 1 : 2;

  if (staged) {
    // 2. Stage: warp w takes box rows w, w + 8, w + 16, w + 24 in one pass
    //    (then the next 32 rows), lane l their columns l, l + 32, ...: each
    //    source pixel read once, widened (kInt8: quantized) and stored as G
    //    float4s. A pass issues all four rows' loads before it stores, so a
    //    tile waits about one round trip to device memory, not one a row.
    float4* box4 = reinterpret_cast<float4*>(boxS);
    for (int g = 0; g < G && !empty; ++g) {
      for (int r0 = warp; r0 < rows; r0 += kStageRows * kWarpWarps) {
        for (int s = lane; s < cols; s += 32) {
          float4 v[kStageRows];
#pragma unroll
          for (int k = 0; k < kStageRows; ++k) {
            const int r = r0 + k * kWarpWarps;
            if (r < rows)
              v[k] = source_px4<kTaps, false>(src, ((b.r_lo + r) * Ws + b.c_lo + s) * C, g, G, C);
          }
#pragma unroll
          for (int k = 0; k < kStageRows; ++k) {
            const int r = r0 + k * kWarpWarps;
            if (r < rows) box4[(r * cols + s) * G + g] = v[k];
          }
        }
      }
    }
    __syncthreads();
    // 3. Resample from the staged box.
    resample_tile<kTaps, true>(boxS, A, i0, j0, th, tw, Hs, Ws, C, b, outS);
  } else {
    resample_tile<kTaps, false>(src, A, i0, j0, th, tw, Hs, Ws, C, b, outS);
  }
  __syncthreads();

  // 4. Store: warp w writes tile rows w, w + 8, ...; lane q the q-th
  //    16-byte word of the output that the row's 32 * C floats touch.
  const int rowlen = tw * C;
  for (int li = warp; li < th; li += kWarpWarps) {
    const size_t e0 = (((size_t)n * Ho + i0 + li) * Wo + j0) * C;
    const int a = (int)(e0 & 3);  // the row starts a floats into its first word
    const int nq = (a + rowlen + 3) >> 2;
    float* g = out + (e0 - a);
    const float* s = outS + li * kWarpTileW * C;  // s[k - a] is g[k]
    for (int q = lane; q < nq; q += 32) {
      const int k0 = 4 * q;
      if (a == 0 && k0 + 4 <= rowlen) {  // streaming: nothing here is read again
        __stcs(reinterpret_cast<float4*>(g + k0), *reinterpret_cast<const float4*>(s + k0));
      } else {
        for (int k = max(k0, a); k < min(k0 + 4, a + rowlen); ++k) g[k] = s[k - a];
      }
    }
  }
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after the launch (0 when it was
// accepted). ``taps`` selects the construction: 0 legacy, 1 rank-1, 2 int8
// (the warp only).
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

// frame_idx may be null (the identity); frames must be 16-byte aligned and
// window * C a multiple of 8; vec: W * C is a multiple of 8 (every row shares
// its phase). band, stage_bytes, slot_bytes, out_rows and smem_bytes come
// from crop_pool_plan in ops/warp_kernel.py.
int dfv_crop_pool_bf16(const void* frames, void* out, const void* y0_l0, const void* x0,
                       const void* level, const void* frame_idx, int n_faces, int n_frames,
                       int H, int W, int C, int window, int vec, int band, int stage_bytes,
                       int slot_bytes, int out_rows, int smem_bytes, void* stream) {
  if (n_faces > 0) {
    auto kernel = vec ? crop_pool_band_kernel<true> : crop_pool_band_kernel<false>;
    if (smem_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid(n_faces, (window + band - 1) / band);
    kernel<<<grid, kPoolThreads, smem_bytes, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)frames, (__nv_bfloat16*)out, (const int*)y0_l0, (const int*)x0,
        (const int*)level, (const int*)frame_idx, n_frames, H, W, C, window, band, stage_bytes,
        slot_bytes, out_rows);
  }
  return (int)cudaGetLastError();
}

int dfv_warp_affine(const void* img, const void* coef, void* out, void* tile_branch, int n_img,
                    int Hs, int Ws, int C, int Ho, int Wo, int taps, int tile_h, int box_budget,
                    int smem_bytes, void* stream) {
  if (n_img > 0 && Ho > 0 && Wo > 0) {
    auto kernel = taps == kInt8    ? warp_tile_kernel<kInt8>
                  : taps == kRank1 ? warp_tile_kernel<kRank1>
                                   : warp_tile_kernel<kLegacy>;
    if (smem_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((Wo + kWarpTileW - 1) / kWarpTileW, (Ho + tile_h - 1) / tile_h, n_img);
    kernel<<<grid, kWarpThreads, smem_bytes, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)img, (const float*)coef, (float*)out, (int*)tile_branch, Hs, Ws,
        C, Ho, Wo, tile_h, box_budget);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
