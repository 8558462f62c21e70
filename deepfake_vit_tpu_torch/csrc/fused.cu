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
// channels in chunks of 32: the input tile with its halo is staged once in
// shared memory as bf16, as it lies in device memory, the expand product is
// recomputed on the halo ((8+k-1)^2 input pixels at stride 1, (14+k)^2 at
// stride 2), the depthwise reads its neighbours from shared memory (lane =
// channel), and the projection accumulates over the chunks in registers. Both
// 1x1 products run on the tensor cores, bf16 mma.sync.m16n8k16 with f32
// accumulators: the expand takes the halo pixels (rows padded to 16) times
// cin (padded with zeros to 16) times the chunk's 32 channels, one function
// for both passes; the projection takes the 64 pixels of scaled d times the
// chunk's 32 channels times a group of output channels, each warp a row tile
// of 16 pixels and every other n8 tile. bf16 x bf16 is exact in f32, so only
// the order of a sum differs from the plain PyTorch version in
// ops/fused_stages.py. Any cout is taken: the projection's weights and output
// tile are staged for one group of at most 192 output channels at a time
// (b6's 200 and b7's 224 go in two), while the chunk's d stays in shared
// memory across the groups. The depthwise taps, the tile sums and the two
// squeeze-excite products use separately rounded multiplies and adds
// (__fmul_rn / __fadd_rn: nvcc would contract them to FMAs) in an order the
// plain version repeats, so that given the same e both compute the same d
// and the same se bit for bit: a difference in se's last bit would flip a
// bf16 rounding of d*se now and then, and in the blocks without an expand
// conv one such term can be worth more than two bf16 steps of a small output.
//
// What bounds them on an H100: by bytes (input + output + weights once over
// 3.35 TB/s) and by operations (multiply-adds x 2 over the 989 TFLOP/s bf16
// tensor-core peak) every block shape here is bound at 4 to 34 microseconds
// for 128 images, by bytes down to 48x48 maps and by operations below.
// Measured by tools/kernel_times.py on an NVIDIA H100 80GB HBM3 at 700 W,
// device time: 0.62 ms for the B4 block without an expand conv at 96x96
// (18x its bound), 0.69-1.50 ms for the expanding blocks at 96x96 to 24x24
// (67x-114x) and 0.52-0.82 ms for the widest at 14x14 on 32 images: 1.1x
// (no expand conv) to 3.1x faster than the first version's FMAs on the CUDA
// cores. They are bound by instruction issue on the CUDA cores, not by the
// tensor cores: taking the projection's products away saves 3-9 %, while a
// SiLU with __expf and __fdividef in place of the precise expf and IEEE
// division saves 8-25 %
// (tools/mma_variants.py); the rest is the depthwise taps, the halo of the
// recomputed expand, staging and the second pass. A faster SiLU, larger
// tiles, wgmma/TMA staging and a cluster sharing d through distributed
// shared memory (one pass) are later work.
//
// The stem (fused_stem_kernel, below) is bound by bytes on paper: 0.042 ms
// for 128 images at 192x192 (its 113 MB bf16 output is most of it). Its
// 27-term product runs on the tensor cores, so what bounds it is the precise
// SiLU of each output value on the CUDA cores: measured by
// tools/kernel_times.py on an NVIDIA
// H100 80GB HBM3 at 700 W, 0.102 ms at (128, 192, 192) and 0.042 ms at
// (32, 224, 224), 2.4x and 2.9x the bound, against 0.162 and 0.059 ms for
// the first version (one thread a pixel, 1,296 FMAs on the CUDA cores).
// tools/stem_pool_variants.py puts 0.045 ms of the 0.102 in the SiLU
// (0.057 ms with the SiLU taken away, 0.073 with __expf and __fdividef).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "dfv_common.cuh"

namespace {

using namespace dfv;

typedef __nv_bfloat16 bf16;

constexpr int TILE = 8;              // output tile: TILE x TILE pixels
constexpr int NPIX = TILE * TILE;
constexpr int CH = 32;               // expanded channels per chunk, one per lane
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int KS = 16;               // K of one bf16 mma.sync step
constexpr int ER = CH + 8;           // f32 row of e: fragment stores hit distinct banks
constexpr int DR = CH + 8;           // bf16 row of scaled d and of a projection weight row
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

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* smem_row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a . b, one m16n8k16 bf16 product with f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Stem: bf16(silu(W . patch + b)), a 3x3 stride-2 convolution on the NHWC
// image, TF "SAME" on even sizes (pad 0 before, 1 after: tap dy reads input
// row 2y + dy), with BatchNorm folded into w (cstem, 27) bf16, column
// (dy*3 + dx)*3 + ci, and b (cstem) f32.
//
// A work item is `rows` output rows by `seg` output columns of one image
// (the whole row up to 128 columns; stem_plan in ops/fused_stages.py sizes
// it). Persistent blocks, as many as the SMs hold, walk the items; a block
// loads its B fragments once and stages item i + 1 while it computes item i.
//   1. It stages the 2*rows + 1 input rows the band reads, each over the
//      segment's input columns and two more, with cp.async: 16-byte copies
//      when an image row is a multiple of 16 bytes (W % 8 == 0), else
//      4-byte copies. What lies past the bottom or the right edge of the
//      image is zero-filled by the copy itself (src-size), so the product
//      has no branch.
//   2. The 27-term product runs on the tensor cores, bf16 mma.sync.m16n8k16
//      with f32 accumulators: M = the block's pixels in row tiles of 16,
//      K = 32, N = the stem channels in n8 tiles (64 at a time). K column
//      c holds tap dy = c / 10, element off = c % 10 of the 9 contiguous
//      values (dx, ci) that row 2*yo + dy holds from element 6*xo on, off 9
//      and c >= 30 zero in both operands: every A register is one aligned
//      32-bit load of the staged row (at off 8 its upper half is masked
//      off). B, the folded weights in that order, stays in registers for
//      the whole block. bf16 x bf16 products are exact in f32, so only the
//      order of the 27-term sum differs from run_stem_plain.
//   3. + bias in f32, the precise SiLU (expf and an IEEE division, as
//      F.silu in f32 and jax.nn.silu), rounded to bf16 into a shared-memory
//      copy of the item's output; then 16-byte stores, each output row of
//      the item one contiguous span of NHWC.
// ---------------------------------------------------------------------------

constexpr int STEM_THREADS = 128;
constexpr int STEM_WARPS = STEM_THREADS / 32;
constexpr int STEM_NT = 8;  // n8 tiles of one channel group: 64 channels

// Dynamic shared memory: two buffers of staged input rows ([2*rows + 1][rs]
// bf16 each), then the block's output ([rows*seg][cstem + 8] bf16: the
// 8-element pad puts the eight pixels of a fragment store in distinct banks).
// A block is persistent: it walks the work items (image, band, segment)
// blockIdx.x, + gridDim.x, ..., staging item i + 1 while it computes item i.
// kNT: cstem / 8 when one channel group of at most STEM_NT n8 tiles holds
// every channel (its loops then have constant bounds and its fragments take
// only the registers they need), 0 for any cstem (groups of STEM_NT tiles).
// Only B4's 48 channels (kNT = 6) are instantiated so: on an NVIDIA H100
// 80GB HBM3 at 700 W it takes 0.103 ms at (128, 192, 192) and 0.043 at
// (32, 224, 224), the general instantiation 0.132 and 0.056
// (tools/stem_pool_variants.py, in one run). At most 96 registers a
// thread, so that five blocks share an SM: the precise SiLU is a chain of
// dependent instructions, and more warps hide it (tools/stem_pool_variants.py:
// 3, 4 or 6 blocks an SM, or no bound, are slower). The general
// instantiation (kNT = 0) spills a little at this bound; it serves no path.
template <int kCopy, int kNT>
__global__ void __launch_bounds__(STEM_THREADS, 5)
fused_stem_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ b, bf16* __restrict__ out, int H, int W, int cstem,
                  int rows, int seg, int rs, int segs, int bands, int items) {
  constexpr int NT = kNT ? kNT : STEM_NT;  // n8 tiles of a channel group
  extern __shared__ __align__(16) unsigned char stem_smem[];
  const int in_elems = (2 * rows + 1) * rs;
  bf16* inS[2] = {reinterpret_cast<bf16*>(stem_smem),
                  reinterpret_cast<bf16*>(stem_smem) + in_elems};
  bf16* outS = inS[1] + in_elems;
  const int orow = cstem + 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int Ho = H / 2, Wo = W / 2;
  const int rowb = W * 6;
  const int cpr = rs * 2 / kCopy;  // copies a staged row
  const unsigned rcp_cpr = recip32(cpr);

  // Item i: segment i % segs of band (i / segs) % bands of image i / (segs * bands).
  struct Item {
    int bi, y0, x0, wc, nrows;
  };
  auto item_of = [&](int i) {
    Item t;
    const int sg = i % segs, rest = i / segs;
    t.bi = rest / bands;
    t.y0 = (rest - t.bi * bands) * rows;
    t.x0 = sg * seg;
    t.wc = min(seg, Wo - t.x0);
    t.nrows = min(rows, Ho - t.y0);
    return t;
  };
  // 1. Stage input rows 2*y0 + r, r <= 2*rows, from pixel column 2*x0 on.
  auto stage = [&](const Item& t, bf16* dst) {
    const int col0b = t.x0 * 12;
    const int valid_b = min(rs * 2, rowb - col0b);  // bytes of a staged row on the image
    const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
    for (int idx = tid; idx < (2 * rows + 1) * cpr; idx += STEM_THREADS) {
      const int r = (int)div_by((unsigned)idx, (unsigned)cpr, rcp_cpr);
      const int off = (idx - r * cpr) * kCopy;
      const int iy = 2 * t.y0 + r;
      const int nb = iy < H ? min(kCopy, max(0, valid_b - off)) : 0;
      const unsigned char* src =
          nb > 0 ? xb + ((size_t)t.bi * H + iy) * rowb + col0b + off : xb;
      cp_async<kCopy>(reinterpret_cast<unsigned char*>(dst) + (size_t)r * rs * 2 + off,
                            src, nb);
    }
    cp_async_commit();
  };

  // This thread's K columns: pair h of k step s is c = 16s + 8h + 2*t4, at
  // element dy*rs + off of the pixel's staged patch; mask keeps what is on
  // the patch (0 from c >= 30, the low half at off 8).
  int roff[2][2];
  unsigned mask[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * s + 8 * h + 2 * t4, dy = c / 10, off = c % 10;
      roff[s][h] = dy < 3 ? dy * rs + off : 0;
      mask[s][h] = dy >= 3 ? 0u : off == 8 ? 0xffffu : 0xffffffffu;
    }
  }
  // B fragments of channel group cg: channel cg + 8j + g, K pair c, c + 1
  // of step s, half h; and the biases of this thread's output channels
  // cg + 8j + 2*t4 (+1). Loaded once when one group holds every channel.
  unsigned bfr[NT][2][2];
  float bias[NT][2];
  auto load_group = [&](int cg, int nt) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) continue;
      const bf16* wr = w + (size_t)(cg + 8 * j + g) * 27;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * s + 8 * h + 2 * t4, dy = c / 10, off = c % 10;
          unsigned lo = 0u, hi = 0u;
          if (dy < 3) {
            lo = __bfloat16_as_ushort(wr[dy * 9 + off]);
            if (off < 8) hi = __bfloat16_as_ushort(wr[dy * 9 + off + 1]);
          }
          bfr[j][s][h] = lo | (hi << 16);
        }
      }
      bias[j][0] = b[cg + 8 * j + 2 * t4];
      bias[j][1] = b[cg + 8 * j + 2 * t4 + 1];
    }
  };
  const bool one_group = kNT != 0 || cstem <= 8 * STEM_NT;
  if (one_group) load_group(0, kNT ? kNT : cstem / 8);

  int i = blockIdx.x;
  if (i < items) stage(item_of(i), inS[0]);
  for (int it = 0; i < items; ++it, i += gridDim.x) {
    const Item t = item_of(i);
    const bf16* in = inS[it & 1];
    if (i + (int)gridDim.x < items) {  // the next item's rows fly while this one computes
      stage(item_of(i + gridDim.x), inS[(it + 1) & 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // 2. The product, channel group by channel group, into outS.
    const int npix = t.nrows * t.wc, ntile = (npix + 15) / 16;
    const unsigned rcp_wc = recip32(t.wc);
    for (int cg = 0; cg < cstem; cg += 8 * NT) {
      const int nt = kNT ? kNT : min(STEM_NT, (cstem - cg) / 8);
      if (!one_group) load_group(cg, nt);
      for (int mt = warp; mt < ntile; mt += STEM_WARPS) {
        // Rows g and g + 8 of the tile; a pixel past the item reads pixel 0.
        int base[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int p = mt * 16 + 8 * m + g;
          const int pp = p < npix ? p : 0;
          const int yl = (int)div_by((unsigned)pp, (unsigned)t.wc, rcp_wc), xo = pp - yl * t.wc;
          base[m] = 2 * yl * rs + 6 * xo;
        }
        unsigned a[2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int m = 0; m < 2; ++m)  // a0/a2: row g, a1/a3: row g + 8
              a[s][2 * h + m] =
                  *reinterpret_cast<const uint32_t*>(in + base[m] + roff[s][h]) & mask[s][h];
          }
        }
        float acc[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
          if (j < nt) {
            mma_bf16(acc[j], a[0], bfr[j][0][0], bfr[j][0][1]);
            mma_bf16(acc[j], a[1], bfr[j][1][0], bfr[j][1][1]);
          }
        }
        // Fragment acc[j][2m + i]: pixel mt*16 + 8m + g, channel cg + 8j + 2*t4 + i.
        // + bias and the SiLU, then the fragment's two bf16 pairs.
        const int p0 = mt * 16 + g;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= nt) continue;
          float q[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) q[e] = silu_f(acc[j][e] + bias[j][e & 1]);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (p0 + 8 * m < npix)
              *reinterpret_cast<uint32_t*>(outS + (size_t)(p0 + 8 * m) * orow + cg + 8 * j +
                                           2 * t4) = pack2(q[2 * m], q[2 * m + 1]);
          }
        }
      }
    }
    __syncthreads();

    // 3. The item's output rows, 16-byte stores: pixel p = yl*wc + xo goes
    //    to (y0 + yl, x0 + xo) of image bi. The next item's product rewrites
    //    outS only after its first barrier.
    const int cpp = cstem / 8;
    const unsigned rcp_cpp = recip32(cpp);
    for (int idx = tid; idx < npix * cpp; idx += STEM_THREADS) {
      const int p = (int)div_by((unsigned)idx, (unsigned)cpp, rcp_cpp), q = idx - p * cpp;
      const int yl = (int)div_by((unsigned)p, (unsigned)t.wc, rcp_wc), xo = p - yl * t.wc;
      *reinterpret_cast<uint4*>(out + (((size_t)t.bi * Ho + t.y0 + yl) * Wo + t.x0 + xo) * cstem +
                                8 * q) = *reinterpret_cast<const uint4*>(outS + (size_t)p * orow + 8 * q);
    }
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
  int kpad;   // cin rounded up to KS: the expand's K, zero-padded
  int has_expand, residual;
  int gsize;  // output channels of a projection group (a multiple of 8, at most 192)
  int sweep;  // output channels a pass-2 sweep accumulates in registers (256 at most)
};

// Byte offsets of the shared-memory regions, each 16-byte aligned. The mma
// operands (the input tile, the chunk's expand weights, scaled d and the
// group's projection weights) are bf16, staged as they lie in device memory;
// e and the depthwise taps are f32.
struct SmemLayout {
  size_t x, e, wexp, taps, vecs, red, inside, d, wproj, out, total;
};

inline size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }

SmemLayout smem_layout(const BlockArgs& a, int pass) {
  const size_t npin = (size_t)a.tin * a.tin, mrows = (npin + 15) / 16 * 16;
  const size_t xrow = a.kpad + 8;  // bf16 row: ldmatrix rows hit distinct banks
  SmemLayout s;
  size_t off = 0;
  s.x = off;      off = align16(off + mrows * xrow * 2);
  s.e = off;      off = align16(off + npin * ER * 4);
  s.wexp = off;   off = align16(off + CH * xrow * 2);
  s.taps = off;   off = align16(off + (size_t)a.k * a.k * CH * 4);
  s.vecs = off;   off = align16(off + 3 * CH * 4);
  s.red = off;    off = align16(off + NWARPS * CH * 4);
  s.inside = off; off = align16(off + npin);
  s.d = s.wproj = s.out = off;
  if (pass == 2) {
    s.d = off;     off = align16(off + (size_t)NPIX * DR * 2);
    s.wproj = off; off = align16(off + (size_t)a.gsize * DR * 2);
    s.out = off;   off = align16(off + (size_t)NPIX * (a.gsize + 2) * 2);
  }
  s.total = off;
  return s;
}

// Stage the projection weights of output channels [g0, g0 + gn) for the
// chunk's expanded channels [c0, c0 + cn) as bf16 rows, zero beyond cn:
// wprojS[co - g0][c].
__device__ __forceinline__ void stage_wproj(bf16* wprojS, const bf16* w_proj, int cexp, int g0,
                                            int gn, int c0, int cn) {
  for (int idx = threadIdx.x; idx < gn * (CH / 8); idx += THREADS) {
    const int v = idx & (CH / 8 - 1), co = idx / (CH / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (v * 8 < cn)
      val = *reinterpret_cast<const uint4*>(w_proj + (size_t)(g0 + co) * cexp + c0 + v * 8);
    *reinterpret_cast<uint4*>(wprojS + co * DR + v * 8) = val;
  }
}

// e of the chunk's CH expanded channels on the haloed tile, into eS[p][c]:
// bf16(silu(W_exp x + b_exp)) (PROTO: kept f32), zero outside the image and
// for channels c >= cn. bf16 mma.sync m16n8k16 with f32 accumulators: A =
// the staged input pixels (rows padded to 16, K = cin padded to kpad with
// zeros), B = the chunk's W_exp rows; warp w takes the m16 row tiles w,
// w + 8, ... and all four n8 tiles. Pass 1 and pass 2 call this one
// function on one layout (the regions before d), so they compute e, and so
// d, bit for bit alike.
template <bool PROTO>
__device__ __forceinline__ void expand_chunk(const bf16* xS, const bf16* wexpS,
                                             const float* bexpS, const unsigned char* insideS,
                                             float* eS, int npin, int xrow, int ksteps, int cn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // ldmatrix row addresses: A rows mt*16 + (lane & 15), K halves by lane >> 4;
  // B rows (channels) 0-15 (+16 for n8 tiles 2-3), K halves by (lane >> 3) & 1.
  const bf16* brow = wexpS + (size_t)(((lane >> 4) << 3) + (lane & 7)) * xrow +
                     ((lane >> 3) & 1) * 8;
  for (int mt = warp; mt < (npin + 15) / 16; mt += NWARPS) {
    const bf16* arow = xS + (size_t)(mt * 16 + (lane & 15)) * xrow + (lane >> 4) * 8;
    float acc[4][4] = {};
    for (int ks = 0; ks < ksteps; ++ks) {
      unsigned af[4], b01[4], b23[4];
      ldmatrix_x4(af, arow + ks * KS);
      ldmatrix_x4(b01, brow + ks * KS);
      ldmatrix_x4(b23, brow + 16 * xrow + ks * KS);
      mma_bf16(acc[0], af, b01[0], b01[1]);
      mma_bf16(acc[1], af, b01[2], b01[3]);
      mma_bf16(acc[2], af, b23[0], b23[1]);
      mma_bf16(acc[3], af, b23[2], b23[3]);
    }
    // Fragment acc[nt][2h + j]: pixel mt*16 + 8h + g, channel nt*8 + 2*t4 + j.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + 8 * h + g;
      if (p >= npin) continue;
      const bool inside = insideS[p];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = nt * 8 + 2 * t4;  // cn is a multiple of 8: c and c + 1 live alike
        const bool on = inside && c < cn;
        float v0 = on ? silu_f(acc[nt][2 * h] + bexpS[c]) : 0.0f;
        float v1 = on ? silu_f(acc[nt][2 * h + 1] + bexpS[c + 1]) : 0.0f;
        if (!PROTO) {
          v0 = bf16_round(v0);
          v1 = bf16_round(v1);
        }
        *reinterpret_cast<float2*>(eS + (size_t)p * ER + c) = make_float2(v0, v1);
      }
    }
  }
}

// PASS 1: per-tile channel sums of d into a.partials. PASS 2: the block's
// output tile. NJ: n8 tiles of the projection per warp (2 * NJ * 8 >=
// a.sweep). PROTO: the prototype's rounding points.
//
// Pass 2 projects with bf16 mma.sync m16n8k16: warp w owns the 16 pixels of
// row tile w & 3 and the sweep's n8 tiles 2j + (w >> 2), whose f32
// accumulators stay in registers across the chunks. A sweep is all of cout
// up to 256 channels (beyond, one group a sweep, and e and d are recomputed
// for each). Within a sweep the output channels go in groups of at most 192
// (a.gsize): only one group's projection weights and output tile are in
// shared memory at a time, while the chunk's scaled d stays there across the
// groups. Each output channel still sums over cexp in chunk order, so the
// grouping changes no bit.
template <int PASS, int NJ, bool PROTO>
__global__ void __launch_bounds__(THREADS)
fused_block_pass_kernel(BlockArgs a, SmemLayout L) {
  extern __shared__ __align__(16) unsigned char block_smem[];
  bf16* xS = reinterpret_cast<bf16*>(block_smem + L.x);            // [rows to 16][kpad + 8]
  float* eS = reinterpret_cast<float*>(block_smem + L.e);          // [npin][ER]
  bf16* wexpS = reinterpret_cast<bf16*>(block_smem + L.wexp);      // [CH][kpad + 8]
  float* tapsS = reinterpret_cast<float*>(block_smem + L.taps);    // [k*k][CH]
  float* bexpS = reinterpret_cast<float*>(block_smem + L.vecs);    // [CH]
  float* bdwS = bexpS + CH;
  float* seS = bdwS + CH;
  float* redS = reinterpret_cast<float*>(block_smem + L.red);      // [NWARPS][CH]
  unsigned char* insideS = block_smem + L.inside;                  // [npin]: pixel is on the image
  bf16* dS = reinterpret_cast<bf16*>(block_smem + L.d);            // [NPIX][DR]
  bf16* wprojS = reinterpret_cast<bf16*>(block_smem + L.wproj);    // [gsize][DR]
  bf16* outS = reinterpret_cast<bf16*>(block_smem + L.out);        // [NPIX][gsize + 2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, bi = blockIdx.y;
  const int oy0 = (tile / a.tiles_x) * TILE, ox0 = (tile % a.tiles_x) * TILE;
  const int iy0 = oy0 * a.stride - a.pad, ix0 = ox0 * a.stride - a.pad;
  const int tin = a.tin, npin = tin * tin;
  const int xrow = a.kpad + 8;
  const int S = a.stride, k = a.k;

  // 1. The input tile with its halo as bf16, zero outside the image, in the
  //    rows that pad it to whole m16 tiles and in the channels up to kpad.
  {
    const int vpr = a.kpad / 8, vin = a.cin / 8;
    const bf16* xb = a.x + (size_t)bi * a.H * a.W * a.cin;
    for (int idx = tid; idx < (npin + 15) / 16 * 16 * vpr; idx += THREADS) {
      const int p = idx / vpr, v = idx - p * vpr;
      const int iy = iy0 + p / tin, ix = ix0 + p % tin;
      const bool inside = p < npin && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (inside && v < vin)
        val = *reinterpret_cast<const uint4*>(xb + ((size_t)iy * a.W + ix) * a.cin + v * 8);
      *reinterpret_cast<uint4*>(xS + (size_t)p * xrow + v * 8) = val;
      if (v == 0 && p < npin) insideS[p] = inside;
    }
  }

  const int pm = warp & 3, ph = warp >> 2;  // projection: row tile, n8 tile parity
  const int g = lane >> 2, t4 = lane & 3;
  const int sweeps_end = PASS == 2 ? a.cout : 1;  // pass 1 makes one trip
  for (int s0 = 0; s0 < sweeps_end; s0 += a.sweep) {
    const int send = min(s0 + a.sweep, a.cout);  // this sweep's channels: [s0, send)
    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

    for (int c0 = 0; c0 < a.cexp; c0 += CH) {
      const int cn = min(CH, a.cexp - c0);
      const bool live = lane < cn;

      // 2. This chunk's weights: the expand rows as bf16, zero beyond cn and
      //    cin.
      if (a.has_expand) {
        const int vpr = a.kpad / 8, vin = a.cin / 8;
        for (int idx = tid; idx < CH * vpr; idx += THREADS) {
          const int c = idx / vpr, v = idx - c * vpr;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (c < cn && v < vin)
            val = *reinterpret_cast<const uint4*>(a.w_exp + (size_t)(c0 + c) * a.cin + v * 8);
          *reinterpret_cast<uint4*>(wexpS + (size_t)c * xrow + v * 8) = val;
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

      // 3. e on the haloed tile.
      if (a.has_expand) {
        expand_chunk<PROTO>(xS, wexpS, bexpS, insideS, eS, npin, xrow, a.kpad / KS, cn);
      } else {
        for (int idx = tid; idx < npin * CH; idx += THREADS) {
          const int c = idx & (CH - 1), p = idx / CH;
          eS[(size_t)p * ER + c] =
              c < cn ? __bfloat162float(xS[(size_t)p * xrow + c0 + c]) : 0.0f;
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
          const float* erow = eS + (size_t)(S * yo + dy) * tin * ER + lane;
          for (int dx = 0; dx < k; ++dx) {
            const float tap = tapsS[(dy * k + dx) * CH + lane];
#pragma unroll
            for (int xo = 0; xo < TILE; ++xo)
              ad[xo] = __fadd_rn(ad[xo], __fmul_rn(erow[(S * xo + dx) * ER], tap));
          }
        }
#pragma unroll
        for (int xo = 0; xo < TILE; ++xo) {
          const bool valid = (oy0 + yo < a.Ho) && (ox0 + xo < a.Wo) && live;
          float d = silu_f(ad[xo] + bdwS[lane]);
          float db = bf16_round(d);
          if (!valid) { d = 0.0f; db = 0.0f; }
          dsum += PROTO ? db : d;
          if (PASS == 2) dS[(yo * TILE + xo) * DR + lane] = __float2bfloat16_rn(db * seS[lane]);
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
        // 5. Projection, accumulated over the chunks, group by group: A =
        //    this warp's 16 pixels of scaled d (two k16 steps over the chunk;
        //    zero beyond cn), B = the group's W_proj rows.
        unsigned da[2][4];
        const bf16* drow = dS + (pm * 16 + (lane & 15)) * DR + (lane >> 4) * 8;
        ldmatrix_x4(da[0], drow);
        ldmatrix_x4(da[1], drow + KS);
        for (int g0 = s0;;) {
          const int gn = min(a.gsize, send - g0);
          const int t_lo = (g0 - s0) / 8, t_hi = (g0 - s0 + gn) / 8;  // this group's n8 tiles
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int nt = 2 * j + ph;
            if (nt >= t_lo && nt < t_hi) {
              unsigned b[4];  // k16 step 0: b[0], b[1]; step 1: b[2], b[3]
              ldmatrix_x4(b, wprojS + ((nt - t_lo) * 8 + (lane & 7)) * DR + (lane >> 3) * 8);
              mma_bf16(acc[j], da[0], b[0], b[1]);
              mma_bf16(acc[j], da[1], b[2], b[3]);
            }
          }
          g0 += gn;
          if (g0 >= send) break;
          __syncthreads();  // every warp is done with the previous group's weights
          stage_wproj(wprojS, a.w_proj, a.cexp, g0, min(a.gsize, send - g0), c0, cn);
          __syncthreads();
        }
      }
      __syncthreads();  // the next chunk overwrites the staged weights, e and d
    }

    if (PASS == 2) {
      // 6. + bias (+ residual), round, and write the tile group by group
      //    through shared memory so that device memory sees 16-byte stores.
      //    Fragment acc[j][2h + i]: pixel pm*16 + 8h + g, channel
      //    s0 + (2j + ph)*8 + 2*t4 + i.
      for (int g0 = s0; g0 < send; g0 += a.gsize) {
        const int gn = min(a.gsize, send - g0);
        const int t_lo = (g0 - s0) / 8, t_hi = (g0 - s0 + gn) / 8;
        const int orow = gn + 2;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int nt = 2 * j + ph;
          if (nt >= t_lo && nt < t_hi) {
            const int co = s0 + nt * 8 + 2 * t4;
            const float b0 = a.b_proj[co], b1 = a.b_proj[co + 1];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int pp = pm * 16 + 8 * h + g;
              float v0 = acc[j][2 * h] + b0, v1 = acc[j][2 * h + 1] + b1;
              if (a.residual) {
                const int hp = (pp / TILE + a.pad) * tin + pp % TILE + a.pad;
                const uint32_t r =
                    *reinterpret_cast<const uint32_t*>(xS + (size_t)hp * xrow + co);
                v0 += lo_f(r);
                v1 += hi_f(r);
              }
              *reinterpret_cast<uint32_t*>(outS + pp * orow + co - g0) = pack2(v0, v1);
            }
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
  a.kpad = (a.cin + KS - 1) / KS * KS;
  a.se = se;
  if ((a.k != 3 && a.k != 5) || (a.stride != 1 && a.stride != 2) || a.cin % 8 || a.cexp % 8 ||
      a.cout % 8 || a.cout < 8 || (a.stride == 2 && (a.H % 2 || a.W % 2)) || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  // Projection groups of at most MAX_GROUP channels, as even as multiples of
  // 8 allow (200 -> 104 + 96, 224 -> 112 + 112); one sweep up to 256
  // channels, else one group a sweep (block_smem_bytes mirrors this).
  const int groups = (a.cout + MAX_GROUP - 1) / MAX_GROUP;
  a.gsize = ((a.cout + groups - 1) / groups + 7) / 8 * 8;
  a.sweep = a.cout <= 256 ? a.cout : a.gsize;

  cudaError_t err = launch_pass<1, 1, PROTO>(a, B, st);
  if (err != cudaSuccess) return err;
  fused_se_kernel<<<B, THREADS, (size_t)(a.cexp + cse) * 4, st>>>(
      a.partials, w_se1, b_se1, w_se2, b_se2, se, a.tiles, a.cexp, cse, a.Ho * a.Wo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Two warps share a row tile, each with every other n8 tile of the sweep.
  if (a.sweep <= 32) return launch_pass<2, 2, PROTO>(a, B, st);
  if (a.sweep <= 64) return launch_pass<2, 4, PROTO>(a, B, st);
  if (a.sweep <= 128) return launch_pass<2, 8, PROTO>(a, B, st);
  if (a.sweep <= 192) return launch_pass<2, 12, PROTO>(a, B, st);
  return launch_pass<2, 16, PROTO>(a, B, st);
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
// rows, seg, row_stride (rs), copy_bytes and smem_bytes come from stem_plan in
// ops/fused_stages.py; x must be 16-byte aligned.
extern "C" int dfv_fused_stem(const void* x, const void* w, const void* b, void* out, int B,
                              int H, int W, int cstem, int rows, int seg, int row_stride,
                              int copy_bytes, int smem_bytes, void* stream) {
  if (H % 2 || W % 2 || cstem % 8 || cstem < 8 || B < 1 || rows < 1 || seg < 1 ||
      row_stride % 8 || row_stride < 6 * seg + 6 || (copy_bytes != 16 && copy_bytes != 4) ||
      (copy_bytes == 16 && W % 8))
    return (int)cudaErrorInvalidValue;
  const int segs = (W / 2 + seg - 1) / seg, bands = (H / 2 + rows - 1) / rows;
  const long long items = (long long)B * segs * bands;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // B4's 48 channels at 16-byte copies, the one stem a served path runs,
  // have their own instantiation; every other shape takes the general one.
  auto kernel = copy_bytes == 4 ? fused_stem_kernel<4, 0>
                : cstem == 48   ? fused_stem_kernel<16, 6>
                                : fused_stem_kernel<16, 0>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  // Persistent blocks: as many as the SMs hold at once, at most one an item.
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, STEM_THREADS, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)std::min<long long>(items, (long long)std::max(1, sms * per_sm));
  kernel<<<blocks, STEM_THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(b),
      static_cast<bf16*>(out), H, W, cstem, rows, seg, row_stride, segs, bands, (int)items);
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
