// Fused EfficientNet early-stage kernels for Hopper (sm_90a): the stem
// convolution, a whole MBConv block, and the single-block prototype, all
// with BatchNorm folded into the weights (inference). bf16 activations in
// NHWC, f32 accumulation. Plain C interface, loaded with ctypes.
//
// What they replace (deepfake_vit_tpu/ops/pallas/):
//   fused_stem_kernel        <- fused_stages.py::_stem_kernel (run_stem)
//   fused_block_pass_kernel,
//   fused_se_kernel          <- fused_stages.py::_make_block_kernel (run_block)
//   the same two, PROTO=true <- fused_mbconv.py::_mbconv_kernel (fused_mbconv)
//
// The block computes, with these rounding points (f32 unless noted):
//   e   = bf16(silu(W_exp x + b_exp))    (no expand conv: e = x);  out of
//         the image e = 0, so the expand bias never leaks into the padding
//   d   = silu(depthwise_k(e) + b_dw)    f32 taps, zero padding; stride 2 on
//         even sizes pads (k-2)/2 before (TF "SAME")
//   se  = sigmoid(W_se2 silu(W_se1 mean(d) + b_se1) + b_se2), mean of f32 d
//   out = bf16(W_proj bf16(f32(bf16(d)) * se) + b_proj [+ x])
// The prototype keeps e in f32 and takes the mean from bf16(d).
//
// Design. On the TPU one core walks the channel groups of an image in order
// and parks all of d in on-chip memory; an H100 block has 227 KB and blocks
// run in no order, while d of one image is up to 885 KB (block 3 of B4 at
// 48x48). So the squeeze-excite mean, a reduction over the whole image
// between the depthwise and the projection, is taken by TWO PASSES THAT
// RECOMPUTE: pass 1 computes expand -> depthwise -> SiLU for an 8x8 output
// tile and writes only the tile's per-channel sums; fused_se_kernel adds the
// tiles' sums in a fixed order (no float atomics: their order would change
// a bf16 rounding of d*se from run to run) and does the two SE products;
// pass 2 runs the same device code again on the same tile, so it sees the
// same d bit for bit, scales, projects, adds the residual and writes the
// tile. Device memory sees the block's input twice (plus the halo) and its
// output once; e and d never leave the chip. Three launches per block.
//
// A block of 256 threads owns one tile of one image and walks the expanded
// channels in chunks of 32 (one warp lane per channel): the input tile with
// its halo is staged once in shared memory, the expand product is recomputed
// on the halo ((8+k-1)^2 input pixels at stride 1, (14+k)^2 at stride 2),
// the depthwise reads its neighbours from shared memory, and the projection
// accumulates over the chunks in registers (pixel x 4 interleaved output
// channels per thread). Any cout is taken: the projection's weights and
// output tile are staged for one group of at most 192 output channels at a
// time (b6's 200 and b7's 224 go in two), while the chunk's d stays in
// shared memory across the groups. The two 1x1 products are f32 FMAs over bf16 values
// widened to f32 when they are staged in shared memory: bf16 x bf16 is exact
// in f32, so only the order of a sum differs from the plain PyTorch version
// in ops/fused_stages.py. The
// depthwise taps, the tile sums and the two squeeze-excite products use
// separately rounded multiplies and adds (__fmul_rn / __fadd_rn: nvcc would
// contract them to FMAs) in an order the plain version repeats, so that given
// the same e both compute the same d and the same se bit for bit: a
// difference in se's last bit would flip a bf16 rounding of d*se now and then,
// and in the blocks without an expand conv one such term can be worth more
// than two bf16 steps of a small output.
//
// What bounds them on an H100: by bytes (input + output + weights once over
// 3.35 TB/s) and by operations (multiply-adds x 2 over the 989 TFLOP/s bf16
// tensor-core peak) every block shape here is bound at 4 to 34 microseconds
// for 128 images, by bytes down to 48x48 maps and by operations below.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, this first
// version takes 4x its bound for the stem, 19x for a block without an expand
// conv at 96x96, 120x to 230x for the expanding blocks at 96x96 to 24x24 and
// 350x for the widest block at 14x14 on 32 images (128 tiles for 132 SMs).
// It is bound by instruction issue, not by memory: scalar f32 FMAs fed by
// 16-byte shared-memory loads (staging the operands as f32 instead of
// unpacking bf16 in the inner loops made the 48x48 blocks 1.3x faster), the
// expand computed twice and on a halo of 1.6x to 2.3x the tile, each chunk's
// weights staged without overlap, and a precise expf and an IEEE division
// per SiLU, which at 24 to 56 input channels is of the order of the
// multiply-adds of the element it activates. mma.sync / wgmma products,
// cp.async or TMA staging, larger tiles and a cluster sharing d through
// distributed shared memory (one pass) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 8;              // output tile: TILE x TILE pixels
constexpr int NPIX = TILE * TILE;
constexpr int CH = 32;               // expanded channels per chunk, one per lane
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int PB = 4;                // halo pixels per warp step of the expand
constexpr int DROW = NPIX + 1;       // padded row of the scaled-d tile (conflict-free)
constexpr int XPAD = 4;              // pad of an input-tile row: rows stay 16-byte aligned
constexpr int MAX_SMEM = 232448;     // 227 KB: the most one block can ask for
constexpr int MAX_GROUP = 192;       // output channels of a projection group, at most

__device__ __forceinline__ float silu_f(float v) { return v / (1.0f + expf(-v)); }
__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// The two bf16 values of a packed word (little-endian: element 0 is low).
__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
// Eight bf16 values widened to f32 (exact) and stored as two 16-byte words.
__device__ __forceinline__ void widen8(float* dst, uint4 v) {
  *reinterpret_cast<float4*>(dst) = make_float4(lo_f(v.x), hi_f(v.x), lo_f(v.y), hi_f(v.y));
  *reinterpret_cast<float4*>(dst + 4) = make_float4(lo_f(v.z), hi_f(v.z), lo_f(v.w), hi_f(v.w));
}

// ---------------------------------------------------------------------------
// Stem: 3x3 stride-2 convolution on the NHWC image, TF "SAME" on even sizes
// (pad 0 before, 1 after: tap dy reads input row 2y + dy), + bias, SiLU.
// One thread per output pixel; the 27-value patch sits in registers and the
// weights in shared memory (every lane reads the same word: a broadcast).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
fused_stem_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ b, bf16* __restrict__ out,
                  int B, int H, int W, int cstem) {
  extern __shared__ __align__(16) unsigned char stem_smem[];
  float* wS = reinterpret_cast<float*>(stem_smem);  // (cstem, 27)
  float* bS = wS + cstem * 27;
  for (int i = threadIdx.x; i < cstem * 27; i += THREADS) wS[i] = __bfloat162float(w[i]);
  for (int i = threadIdx.x; i < cstem; i += THREADS) bS[i] = b[i];
  __syncthreads();

  const int Ho = H / 2, Wo = W / 2;
  const long long total = (long long)B * Ho * Wo;
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= total) return;
  const int xo = (int)(p % Wo);
  const int yo = (int)((p / Wo) % Ho);
  const int bi = (int)(p / ((long long)Wo * Ho));

  float patch[27];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int iy = 2 * yo + dy, ix = 2 * xo + dx;
      const bool ok = iy < H && ix < W;
      const bf16* px = x + (((size_t)bi * H + (ok ? iy : 0)) * W + (ok ? ix : 0)) * 3;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
        patch[(dy * 3 + dx) * 3 + ci] = ok ? __bfloat162float(px[ci]) : 0.0f;
    }
  }

  bf16* o = out + (size_t)p * cstem;
  for (int co0 = 0; co0 < cstem; co0 += 8) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int t = 0; t < 27; ++t) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(wS[(co0 + j) * 27 + t], patch[t], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = silu_f(acc[j] + bS[co0 + j]);
    uint4 v;
    v.x = pack2(acc[0], acc[1]);
    v.y = pack2(acc[2], acc[3]);
    v.z = pack2(acc[4], acc[5]);
    v.w = pack2(acc[6], acc[7]);
    *reinterpret_cast<uint4*>(o + co0) = v;
  }
}

// ---------------------------------------------------------------------------
// MBConv block, one pass over one 8x8 output tile of one image.
// ---------------------------------------------------------------------------

struct BlockArgs {
  const bf16* x;        // (B, H, W, cin)
  const bf16* w_exp;    // (cexp, cin)
  const float* b_exp;   // (cexp)
  const float* taps;    // (k*k, cexp)
  const float* b_dw;    // (cexp)
  const bf16* w_proj;   // (cout, cexp)
  const float* b_proj;  // (cout)
  const float* se;      // (B, cexp), read by pass 2
  float* partials;      // (B, tiles, cexp), written by pass 1
  bf16* out;            // (B, Ho, Wo, cout), written by pass 2
  int H, W, Ho, Wo, cin, cexp, cout, k, stride, pad, tin, tiles_x, tiles;
  int has_expand, residual;
  int gsize;  // output channels of a projection group (a multiple of 8, at most 192)
  int sweep;  // output channels a pass-2 sweep accumulates in registers (4 * NJ at most)
};

// Byte offsets of the shared-memory regions, each 16-byte aligned. Inputs,
// weights and intermediates are staged as f32 (widened once, when staged) so
// that the inner loops spend no instruction on unpacking bf16; values that
// the block rounds to bf16 are rounded before they are stored.
struct SmemLayout {
  size_t x, e, wexp, taps, vecs, red, inside, d, wproj, out, total;
};

inline size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }

SmemLayout smem_layout(const BlockArgs& a, int pass) {
  const size_t npin = (size_t)a.tin * a.tin;
  SmemLayout s;
  size_t off = 0;
  s.x = off;      off = align16(off + npin * (a.cin + XPAD) * 4);
  s.e = off;      off = align16(off + npin * CH * 4);
  s.wexp = off;   off = align16(off + (size_t)a.cin * CH * 4);
  s.taps = off;   off = align16(off + (size_t)a.k * a.k * CH * 4);
  s.vecs = off;   off = align16(off + 3 * CH * 4);
  s.red = off;    off = align16(off + NWARPS * CH * 4);
  s.inside = off; off = align16(off + npin);
  s.d = s.wproj = s.out = off;
  if (pass == 2) {
    s.d = off;     off = align16(off + (size_t)CH * DROW * 4);
    s.wproj = off; off = align16(off + (size_t)a.gsize * CH * 4);
    s.out = off;   off = align16(off + (size_t)NPIX * (a.gsize + 2) * 2);
  }
  s.total = off;
  return s;
}

// Stage the projection weights of output channels [g0, g0 + gn) for the
// chunk's expanded channels [c0, c0 + cn), widened to f32: wprojS[co - g0][c].
__device__ __forceinline__ void stage_wproj(float* wprojS, const bf16* w_proj, int cexp, int g0,
                                            int gn, int c0, int cn) {
  for (int idx = threadIdx.x; idx < gn * CH; idx += THREADS) {
    const int c = idx & (CH - 1), co = idx / CH;
    wprojS[idx] = c < cn ? __bfloat162float(w_proj[(size_t)(g0 + co) * cexp + c0 + c]) : 0.0f;
  }
}

// PASS 1: per-tile channel sums of d into a.partials. PASS 2: the block's
// output tile. NJ: output channels per thread of the projection (4 * NJ >=
// a.sweep). PROTO: the prototype's rounding points.
//
// Pass 2 accumulates the projection of a sweep of output channels in
// registers (thread: pixel pp, channels s0 + cg + 4j). A sweep is all of
// cout up to 256 channels (beyond, one group a sweep, and e and d are
// recomputed for each). Within a sweep the output channels go in groups of
// at most 192 (a.gsize): only one group's projection weights and output
// tile are in shared memory at a time, while the chunk's scaled d stays
// there across the groups. Each output channel still sums over cexp in
// chunk order, so the grouping changes no bit; one group (cout <= 192) is
// the single-group code path.
template <int PASS, int NJ, bool PROTO>
__global__ void __launch_bounds__(THREADS)
fused_block_pass_kernel(BlockArgs a, SmemLayout L) {
  extern __shared__ __align__(16) unsigned char block_smem[];
  float* xS = reinterpret_cast<float*>(block_smem + L.x);          // [npin][cin + XPAD]
  float* eS = reinterpret_cast<float*>(block_smem + L.e);          // [npin][CH]
  float4* wexpS = reinterpret_cast<float4*>(block_smem + L.wexp);  // [cin/4][CH], 4 inputs each
  float* tapsS = reinterpret_cast<float*>(block_smem + L.taps);    // [k*k][CH]
  float* bexpS = reinterpret_cast<float*>(block_smem + L.vecs);    // [CH]
  float* bdwS = bexpS + CH;
  float* seS = bdwS + CH;
  float* redS = reinterpret_cast<float*>(block_smem + L.red);      // [NWARPS][CH]
  unsigned char* insideS = block_smem + L.inside;                  // [npin]: pixel is on the image
  float* dS = reinterpret_cast<float*>(block_smem + L.d);          // [CH][DROW]
  float* wprojS = reinterpret_cast<float*>(block_smem + L.wproj);  // [gsize][CH]
  bf16* outS = reinterpret_cast<bf16*>(block_smem + L.out);        // [NPIX][gsize + 2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, bi = blockIdx.y;
  const int oy0 = (tile / a.tiles_x) * TILE, ox0 = (tile % a.tiles_x) * TILE;
  const int iy0 = oy0 * a.stride - a.pad, ix0 = ox0 * a.stride - a.pad;
  const int tin = a.tin, npin = tin * tin;
  const int xrow = a.cin + XPAD;
  const int S = a.stride, k = a.k;

  // 1. The input tile with its halo, zero outside the image.
  {
    const int vpp = a.cin / 8;
    const bf16* xb = a.x + (size_t)bi * a.H * a.W * a.cin;
    for (int idx = tid; idx < npin * vpp; idx += THREADS) {
      const int p = idx / vpp, v = idx - p * vpp;
      const int iy = iy0 + p / tin, ix = ix0 + p % tin;
      const bool inside = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (inside)
        val = *reinterpret_cast<const uint4*>(xb + ((size_t)iy * a.W + ix) * a.cin + v * 8);
      widen8(xS + (size_t)p * xrow + v * 8, val);
      if (v == 0) insideS[p] = inside;
    }
  }

  const int pp = tid & (NPIX - 1);  // projection: this thread's pixel ...
  const int cg = tid >> 6;          // ... and its output channels s0 + cg + 4 j
  const int sweeps_end = PASS == 2 ? a.cout : 1;  // pass 1 makes one trip
  for (int s0 = 0; s0 < sweeps_end; s0 += a.sweep) {
    const int send = min(s0 + a.sweep, a.cout);  // this sweep's channels: [s0, send)
    float acc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] = 0.0f;

    for (int c0 = 0; c0 < a.cexp; c0 += CH) {
      const int cn = min(CH, a.cexp - c0);
      const bool live = lane < cn;

      // 2. This chunk's weights, widened to f32.
      if (a.has_expand) {
        const int nq = a.cin / 8;
        const uint4* wsrc = reinterpret_cast<const uint4*>(a.w_exp + (size_t)c0 * a.cin);
        float* w = reinterpret_cast<float*>(wexpS);
        for (int idx = tid; idx < CH * nq; idx += THREADS) {
          const int c = idx & (CH - 1), kq = idx / CH;
          const uint4 v = c < cn ? wsrc[(size_t)c * nq + kq] : make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<float4*>(w + ((size_t)(2 * kq) * CH + c) * 4) =
              make_float4(lo_f(v.x), hi_f(v.x), lo_f(v.y), hi_f(v.y));
          *reinterpret_cast<float4*>(w + ((size_t)(2 * kq + 1) * CH + c) * 4) =
              make_float4(lo_f(v.z), hi_f(v.z), lo_f(v.w), hi_f(v.w));
        }
      }
      for (int idx = tid; idx < k * k * CH; idx += THREADS) {
        const int c = idx & (CH - 1), t = idx / CH;
        tapsS[idx] = c < cn ? a.taps[(size_t)t * a.cexp + c0 + c] : 0.0f;
      }
      if (tid < CH) {
        const bool ok = tid < cn;
        bexpS[tid] = (ok && a.has_expand) ? a.b_exp[c0 + tid] : 0.0f;
        bdwS[tid] = ok ? a.b_dw[c0 + tid] : 0.0f;
        seS[tid] = (ok && PASS == 2) ? a.se[(size_t)bi * a.cexp + c0 + tid] : 0.0f;
      }
      if (PASS == 2) stage_wproj(wprojS, a.w_proj, a.cexp, s0, min(a.gsize, send - s0), c0, cn);
      __syncthreads();

      // 3. e on the haloed tile: lane = channel, each warp PB pixels a step.
      if (a.has_expand) {
        // Four input channels a step: one 16-byte load of this lane's weights
        // and one 16-byte broadcast load per pixel feed 4 FMAs per pixel,
        // summed in channel order.
        const int n4 = a.cin / 4;
        const float4* xS4 = reinterpret_cast<const float4*>(xS);
        const int xrow4 = xrow / 4;
        for (int p0 = warp * PB; p0 < npin; p0 += NWARPS * PB) {
          float ae[PB];
          const float4* xr[PB];
#pragma unroll
          for (int i = 0; i < PB; ++i) {
            ae[i] = 0.0f;
            xr[i] = xS4 + (size_t)min(p0 + i, npin - 1) * xrow4;
          }
          for (int k4 = 0; k4 < n4; ++k4) {
            const float4 wv = wexpS[k4 * CH + lane];
#pragma unroll
            for (int i = 0; i < PB; ++i) {
              const float4 xv = xr[i][k4];
              ae[i] = fmaf(wv.x, xv.x, ae[i]);
              ae[i] = fmaf(wv.y, xv.y, ae[i]);
              ae[i] = fmaf(wv.z, xv.z, ae[i]);
              ae[i] = fmaf(wv.w, xv.w, ae[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < PB; ++i) {
            const int p = p0 + i;
            if (p < npin) {
              float v = (insideS[p] && live) ? silu_f(ae[i] + bexpS[lane]) : 0.0f;
              if (!PROTO) v = bf16_round(v);
              eS[(size_t)p * CH + lane] = v;
            }
          }
        }
      } else {
        for (int idx = tid; idx < npin * CH; idx += THREADS) {
          const int c = idx & (CH - 1), p = idx / CH;
          eS[idx] = c < cn ? xS[(size_t)p * xrow + c0 + c] : 0.0f;
        }
      }
      __syncthreads();

      // 4. Depthwise + SiLU: lane = channel, warp = tile row. Each tap is
      //    loaded once and applied to the row's 8 outputs; every output sums
      //    its taps in (dy, dx) order.
      float dsum = 0.0f;
      {
        const int yo = warp;
        float ad[TILE];
#pragma unroll
        for (int xo = 0; xo < TILE; ++xo) ad[xo] = 0.0f;
        for (int dy = 0; dy < k; ++dy) {
          const float* erow = eS + (size_t)(S * yo + dy) * tin * CH + lane;
          for (int dx = 0; dx < k; ++dx) {
            const float tap = tapsS[(dy * k + dx) * CH + lane];
#pragma unroll
            for (int xo = 0; xo < TILE; ++xo)
              ad[xo] = __fadd_rn(ad[xo], __fmul_rn(erow[(S * xo + dx) * CH], tap));
          }
        }
#pragma unroll
        for (int xo = 0; xo < TILE; ++xo) {
          const bool valid = (oy0 + yo < a.Ho) && (ox0 + xo < a.Wo) && live;
          float d = silu_f(ad[xo] + bdwS[lane]);
          float db = bf16_round(d);
          if (!valid) { d = 0.0f; db = 0.0f; }
          dsum += PROTO ? db : d;
          if (PASS == 2) dS[lane * DROW + yo * TILE + xo] = bf16_round(db * seS[lane]);
        }
      }

      if (PASS == 1) {
        // The tile's channel sums, warps added in a fixed order.
        redS[warp * CH + lane] = dsum;
        __syncthreads();
        if (warp == 0 && live) {
          float s = 0.0f;
#pragma unroll
          for (int w = 0; w < NWARPS; ++w) s += redS[w * CH + lane];
          a.partials[((size_t)bi * a.tiles + tile) * a.cexp + c0 + lane] = s;
        }
      } else {
        __syncthreads();
        // 5. Projection, accumulated over the chunks, group by group. Four
        //    expanded channels a step (cn is a multiple of 8): four values of
        //    d and one 16-byte broadcast load of weights per output channel.
        for (int g0 = s0;;) {
          const int gn = min(a.gsize, send - g0);
          const int jlo = (g0 - s0) / 4, jhi = (g0 - s0 + gn) / 4;  // this group's j
          for (int c = 0; c < cn; c += 4) {
            const float d0 = dS[(c + 0) * DROW + pp];
            const float d1 = dS[(c + 1) * DROW + pp];
            const float d2 = dS[(c + 2) * DROW + pp];
            const float d3 = dS[(c + 3) * DROW + pp];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              if (j >= jlo && j < jhi) {
                const int co = s0 + cg + 4 * j;
                const float4 wv = *reinterpret_cast<const float4*>(wprojS + (co - g0) * CH + c);
                acc[j] = fmaf(wv.x, d0, acc[j]);
                acc[j] = fmaf(wv.y, d1, acc[j]);
                acc[j] = fmaf(wv.z, d2, acc[j]);
                acc[j] = fmaf(wv.w, d3, acc[j]);
              }
            }
          }
          g0 += gn;
          if (g0 >= send) break;
          __syncthreads();  // every thread is done with the previous group's weights
          stage_wproj(wprojS, a.w_proj, a.cexp, g0, min(a.gsize, send - g0), c0, cn);
          __syncthreads();
        }
      }
      __syncthreads();  // the next chunk overwrites the staged weights, e and d
    }

    if (PASS == 2) {
      // 6. + bias (+ residual), round, and write the tile group by group
      //    through shared memory so that device memory sees 16-byte stores.
      const int yo = pp / TILE, xo = pp % TILE;
      for (int g0 = s0; g0 < send; g0 += a.gsize) {
        const int gn = min(a.gsize, send - g0);
        const int jlo = (g0 - s0) / 4, jhi = (g0 - s0 + gn) / 4;
        const int orow = gn + 2;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j >= jlo && j < jhi) {
            const int co = s0 + cg + 4 * j;
            float v = acc[j] + a.b_proj[co];
            if (a.residual) v += xS[((size_t)(yo + a.pad) * tin + xo + a.pad) * xrow + co];
            outS[pp * orow + co - g0] = __float2bfloat16_rn(v);
          }
        }
        __syncthreads();
        const int vpp = gn / 8;
        for (int idx = tid; idx < NPIX * vpp; idx += THREADS) {
          const int p = idx / vpp, v = idx - p * vpp;
          const int oy = oy0 + p / TILE, ox = ox0 + p % TILE;
          if (oy < a.Ho && ox < a.Wo) {
            const uint32_t* s = reinterpret_cast<const uint32_t*>(outS + (size_t)p * orow + v * 8);
            const uint4 val = make_uint4(s[0], s[1], s[2], s[3]);
            *reinterpret_cast<uint4*>(a.out + (((size_t)bi * a.Ho + oy) * a.Wo + ox) * a.cout +
                                      g0 + v * 8) = val;
          }
        }
        __syncthreads();  // the next group rewrites the output tile
      }
    }
  }
}

// Squeeze-excite of one image from the tiles' channel sums (fixed order).
__global__ void __launch_bounds__(THREADS)
fused_se_kernel(const float* __restrict__ partials, const float* __restrict__ w_se1,
                const float* __restrict__ b_se1, const float* __restrict__ w_se2,
                const float* __restrict__ b_se2, float* __restrict__ se,
                int tiles, int cexp, int cse, int npix) {
  extern __shared__ __align__(16) unsigned char se_smem[];
  float* mean = reinterpret_cast<float*>(se_smem);  // [cexp]
  float* s1 = mean + cexp;                          // [cse]
  const int bi = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < cexp; c += THREADS) {
    float s = 0.0f;
    for (int t = 0; t < tiles; ++t) s += partials[((size_t)bi * tiles + t) * cexp + c];
    mean[c] = s / (float)npix;
  }
  __syncthreads();
  for (int j = warp; j < cse; j += NWARPS) {
    float s = 0.0f;
    for (int c = lane; c < cexp; c += 32)
      s = __fadd_rn(s, __fmul_rn(w_se1[(size_t)j * cexp + c], mean[c]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) s1[j] = silu_f(s + b_se1[j]);
  }
  __syncthreads();
  for (int c = tid; c < cexp; c += THREADS) {
    float s = 0.0f;
    for (int j = 0; j < cse; ++j) s = __fadd_rn(s, __fmul_rn(w_se2[(size_t)c * cse + j], s1[j]));
    se[(size_t)bi * cexp + c] = sigmoid_f(s + b_se2[c]);
  }
}

template <int PASS, int NJ, bool PROTO>
cudaError_t launch_pass(const BlockArgs& a, int B, cudaStream_t st) {
  const SmemLayout L = smem_layout(a, PASS);
  if (L.total > (size_t)MAX_SMEM) return cudaErrorInvalidConfiguration;
  static bool raised = false;  // one flag per instantiation
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(fused_block_pass_kernel<PASS, NJ, PROTO>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  fused_block_pass_kernel<PASS, NJ, PROTO><<<dim3(a.tiles, B), THREADS, L.total, st>>>(a, L);
  return cudaGetLastError();
}

template <bool PROTO>
cudaError_t run_block(BlockArgs a, const float* w_se1, const float* b_se1, const float* w_se2,
                      const float* b_se2, float* se, int B, int cse, cudaStream_t st) {
  a.Ho = a.H / a.stride;
  a.Wo = a.W / a.stride;
  a.pad = a.stride == 1 ? a.k / 2 : (a.k - 2) / 2;
  a.tin = a.stride * (TILE - 1) + a.k;
  a.tiles_x = (a.Wo + TILE - 1) / TILE;
  a.tiles = a.tiles_x * ((a.Ho + TILE - 1) / TILE);
  a.se = se;
  if ((a.k != 3 && a.k != 5) || (a.stride != 1 && a.stride != 2) || a.cin % 8 || a.cexp % 8 ||
      a.cout % 8 || a.cout < 8 || (a.stride == 2 && (a.H % 2 || a.W % 2)) || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  // Projection groups of at most MAX_GROUP channels, as even as multiples of
  // 8 allow (200 -> 104 + 96, 224 -> 112 + 112); one sweep up to 4 * 64
  // channels, else one group a sweep (block_smem_bytes mirrors this).
  const int groups = (a.cout + MAX_GROUP - 1) / MAX_GROUP;
  a.gsize = ((a.cout + groups - 1) / groups + 7) / 8 * 8;
  a.sweep = a.cout <= 4 * 64 ? a.cout : a.gsize;

  cudaError_t err = launch_pass<1, 1, PROTO>(a, B, st);
  if (err != cudaSuccess) return err;
  fused_se_kernel<<<B, THREADS, (size_t)(a.cexp + cse) * 4, st>>>(
      a.partials, w_se1, b_se1, w_se2, b_se2, se, a.tiles, a.cexp, cse, a.Ho * a.Wo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.sweep <= 32) return launch_pass<2, 8, PROTO>(a, B, st);
  if (a.sweep <= 64) return launch_pass<2, 16, PROTO>(a, B, st);
  if (a.sweep <= 128) return launch_pass<2, 32, PROTO>(a, B, st);
  if (a.sweep <= 192) return launch_pass<2, 48, PROTO>(a, B, st);
  return launch_pass<2, 64, PROTO>(a, B, st);
}

BlockArgs block_args(const void* x, const void* w_exp, const void* b_exp, const void* taps,
                     const void* b_dw, const void* w_proj, const void* b_proj, void* partials,
                     void* out, int H, int W, int cin, int cexp, int cout, int k, int stride,
                     int has_expand, int residual) {
  BlockArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.w_exp = static_cast<const bf16*>(w_exp);
  a.b_exp = static_cast<const float*>(b_exp);
  a.taps = static_cast<const float*>(taps);
  a.b_dw = static_cast<const float*>(b_dw);
  a.w_proj = static_cast<const bf16*>(w_proj);
  a.b_proj = static_cast<const float*>(b_proj);
  a.partials = static_cast<float*>(partials);
  a.out = static_cast<bf16*>(out);
  a.H = H; a.W = W; a.cin = cin; a.cexp = cexp; a.cout = cout; a.k = k; a.stride = stride;
  a.has_expand = has_expand; a.residual = residual;
  return a;
}

}  // namespace

// x (B, H, W, 3) bf16, w (cstem, 27) bf16, b (cstem) f32 -> out (B, H/2, W/2, cstem) bf16.
extern "C" int dfv_fused_stem(const void* x, const void* w, const void* b, void* out, int B,
                              int H, int W, int cstem, void* stream) {
  if (H % 2 || W % 2 || cstem % 8 || cstem < 8 || B < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * (H / 2) * (W / 2);
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  fused_stem_kernel<<<blocks, THREADS, (size_t)cstem * 28 * 4, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(b),
      static_cast<bf16*>(out), B, H, W, cstem);
  return (int)cudaGetLastError();
}

// One MBConv block: pass 1, squeeze-excite, pass 2 (three launches).
// partials (B, tiles, cexp) f32 and se (B, cexp) f32 are scratch of the caller,
// tiles = ceil(Ho / 8) * ceil(Wo / 8).
extern "C" int dfv_fused_block(const void* x, const void* w_exp, const void* b_exp,
                               const void* taps, const void* b_dw, const void* w_se1,
                               const void* b_se1, const void* w_se2, const void* b_se2,
                               const void* w_proj, const void* b_proj, void* partials, void* se,
                               void* out, int B, int H, int W, int cin, int cexp, int cse,
                               int cout, int k, int stride, int has_expand, int residual,
                               void* stream) {
  BlockArgs a = block_args(x, w_exp, b_exp, taps, b_dw, w_proj, b_proj, partials, out, H, W, cin,
                           cexp, cout, k, stride, has_expand, residual);
  return (int)run_block<false>(a, static_cast<const float*>(w_se1), static_cast<const float*>(b_se1),
                               static_cast<const float*>(w_se2), static_cast<const float*>(b_se2),
                               static_cast<float*>(se), B, cse, static_cast<cudaStream_t>(stream));
}

// The single-block prototype (stride 1, 3x3): e stays f32, the SE mean is
// taken from bf16(d). Same scratch as dfv_fused_block.
extern "C" int dfv_fused_mbconv(const void* x, const void* w_exp, const void* b_exp,
                                const void* taps, const void* b_dw, const void* w_se1,
                                const void* b_se1, const void* w_se2, const void* b_se2,
                                const void* w_proj, const void* b_proj, void* partials, void* se,
                                void* out, int B, int H, int W, int cin, int cexp, int cse,
                                int cout, int has_expand, int residual, void* stream) {
  BlockArgs a = block_args(x, w_exp, b_exp, taps, b_dw, w_proj, b_proj, partials, out, H, W, cin,
                           cexp, cout, 3, 1, has_expand, residual);
  return (int)run_block<true>(a, static_cast<const float*>(w_se1), static_cast<const float*>(b_se1),
                              static_cast<const float*>(w_se2), static_cast<const float*>(b_se2),
                              static_cast<float*>(se), B, cse, static_cast<cudaStream_t>(stream));
}
