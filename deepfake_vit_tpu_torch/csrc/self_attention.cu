// The transformers' attention core in inference (sm_90a): for each sequence
// and head, softmax(q kᵀ / √64) v, read straight from the QKV product's
// (B, L, 3W) rows and written as the (B, L, W) rows the output projection
// takes: the ViT's and the TimeSformer's spatial attention over 197 tokens
// (12 and 12 calls a served batch) and the TimeSformer's temporal attention
// over 8 frames (12 calls).
//
// It replaces no TPU kernel: XLA fused the attention in the JAX package.
// Eager PyTorch ran it as a scalar copy from pageable memory (1/√hd, a
// stream sync), a strided division of q, two batched products that copy K
// and V to contiguous tensors first, a softmax pass over bf16 scores and the
// copy of O back to (B, L, W): about ten passes over the scores and Q, K, V.
//
// What bounds it on an H100: bytes. Each call reads the QKV product once
// (B·L·3W bf16) and writes O once (B·L·W): 154.9 MB at the ViT's
// (128, 197, 2304), 0.046 ms at 3.35 TB/s. Its products are 15 GFLOP (0.016
// ms at the bf16 peak) and its exponentials 60 million: the design moves
// each byte once and keeps the scores in registers, where the eager path
// wrote and read them back about ten times.
//
//   Long plan, 16 < L <= 256 (long_attention_kernel): one block of 4 warps
//   a (sequence, head) pair. The block stages the pair's K and V (2 x L x 128
//   bytes, zero rows up to the next 16) into shared memory with cp.async;
//   each warp takes 16 query rows at a time, reads them straight from device
//   memory into mma.sync A fragments and walks the keys in blocks of 64: the
//   block's scores in float32 registers (8 n8 tiles), their max and the
//   running max, the earlier weights' sum and output rescaled once to it,
//   exp(s - max) rounded to bf16 for the ·V product, which reads V with
//   ldmatrix.trans. The float32 sum of the weights divides the output once.
//   A key block is a template on its 16-key slices, so that only the last
//   one is masked. A warp then holds 128 registers, so that four blocks (16
//   warps) share an SM and hide one another's latency; holding a row's 208
//   scores at once took 250 registers and two blocks an SM, and ran 1.8x
//   slower (0.170 against 0.094 ms at the ViT's shape).
//
//   Short plan, L <= 16 (short_attention_kernel<kLp>): one warp an m16 tile
//   of 16 / kLp pairs (two of 8 rows, with a block-diagonal mask, or one of
//   16), with no shared memory: Q, K and V come from device memory in 16-byte
//   vectors straight into registers, V is transposed by movmatrix, and the
//   output leaves in 16-byte vectors.
//
// Fragment layout. The product over the head's 64 values may take them in
// any order that Q and K share: lane (g, t) of a warp loads 16-byte chunks
// t and t + 4 of a row (8 words of two bf16), and k-slice ks of the m16n8k16
// product takes words 2ks and 2ks + 1 as its two registers, both for the A
// fragment (query rows g, g + 8) and the B fragment (key g). So a warp loads
// Q and K in 16-byte vectors, with no transposition. The short plan puts the
// same order on V's columns: word 4l + q of key g's chunks, transposed by
// movmatrix, is the B fragment of output columns 8κ + 2q + {0, 1} (κ = t +
// 4l), so that lane (g, t) ends up holding output chunks t and t + 4 of rows
// g and g + 8.
//
// Rounding: the scores stay float32 (eager PyTorch rounded them to bf16
// before the softmax); the scale 1/8 is exact and folds into exp2's factor
// log2(e) / 8; the weights exp(s - max) are rounded once to bf16 and summed
// in float32 before that rounding, the output is rounded once. The kernel
// lies closer to float32 attention on the same bf16 inputs than the eager
// path (tests/test_torch_gpu_kernels.py).
// Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "dfv_common.cuh"

namespace dfv {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kHd = 64;                     // head width; ops/self_attention.py::HEAD_DIM
constexpr int kLongWarps = 4;
constexpr int kLongThreads = 32 * kLongWarps;
constexpr int kLongBlocksPerSm = 4;
constexpr int kKeyBlock = 64;               // keys a warp's scores hold at a time
constexpr int kMaxSeq = 256;                // ops/self_attention.py::MAX_SEQ
constexpr int kShortWarps = 8;              // ops/self_attention.py::SHORT_WARPS
constexpr int kShortThreads = 32 * kShortWarps;

// c += a . b, one m16n8k16 bf16 product with f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem_row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The warp's 8 x 8 bf16 matrix (lane (g, t): row g, columns 2t and 2t + 1)
// transposed, in the same layout.
__device__ __forceinline__ unsigned movmatrix_trans(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// Chunks t and t + 4 of a 64-value row as 8 words (zeros where !valid).
__device__ __forceinline__ void load_row(const bf16* row, unsigned t, bool valid,
                                         unsigned (&w)[8]) {
  uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
  if (valid) {
    lo = __ldg(reinterpret_cast<const uint4*>(row) + t);
    hi = __ldg(reinterpret_cast<const uint4*>(row) + t + 4);
  }
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

// The max and the sum over a row's four lanes (t = 0..3 of one g).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x in one MUFU.EX2 (2 ulp; results below 2^-126 flush to 0); 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp((s - max) / 8) as 2^(s · c - max · c), c = log2(e) / 8.
__device__ __forceinline__ float weight(float s, float mc, float c) { return ex2(fmaf(s, c, -mc)); }

// One block of kN x 16 keys from k0 for a warp's 16 query rows (A
// fragments qf): the block's scores, its max and the running max (times c,
// mc0 and mc1 for rows g and g + 8), the earlier weights' sum (the lane's
// share, l0 and l1) and output o rescaled once to it, then exp(s - max)
// rounded to bf16 times V into o. Keys past L take no weight.
template <int kN>
__device__ __forceinline__ void key_block(const uint4* kS, const uint4* vS, unsigned k0,
                                          unsigned L, const unsigned (&qf)[4][4],
                                          float (&o)[8][4], float& mc0, float& mc1, float& l0,
                                          float& l1, float c, unsigned lane) {
  const unsigned g = lane >> 2, t = lane & 3u;
  float s[2 * kN][4];
#pragma unroll
  for (int nt = 0; nt < 2 * kN; ++nt) {
    const unsigned r = k0 + nt * 8u + g, sw = (r & 1u) << 2;
    const uint4 ka = kS[r * 8u + (t ^ sw)], kb = kS[r * 8u + ((t + 4u) ^ sw)];
    const unsigned kw[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      mma_bf16(s[nt], qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3], kw[2 * ks], kw[2 * ks + 1]);
  }
  if (k0 + 16u * kN > L) {
#pragma unroll
    for (int nt = 0; nt < 2 * kN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + nt * 8u + 2u * t + (e & 1) >= L) s[nt][e] = -INFINITY;
  }
  float bm0 = -INFINITY, bm1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 2 * kN; ++nt) {
    bm0 = fmaxf(bm0, fmaxf(s[nt][0], s[nt][1]));
    bm1 = fmaxf(bm1, fmaxf(s[nt][2], s[nt][3]));
  }
  bm0 = fmaxf(mc0, quad_max(bm0) * c);
  bm1 = fmaxf(mc1, quad_max(bm1) * c);
  // 2^(-inf) = 0 on the first block, whose running max is -inf.
  const float r0 = ex2(mc0 - bm0), r1 = ex2(mc1 - bm1);
  mc0 = bm0;
  mc1 = bm1;
  l0 *= r0;
  l1 *= r1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[j][0] *= r0; o[j][1] *= r0; o[j][2] *= r1; o[j][3] *= r1;
  }
  // ldmatrix.x4.trans: lanes 8i..8i+7 address matrix i = keys 16kk + 8(i & 1) + 0..7 of
  // chunk 2jp + (i >> 1); registers 0, 1 are the B fragment of output columns 16jp..+7,
  // registers 2, 3 of 16jp + 8..+15.
  const unsigned mi = lane >> 3, key_in = ((mi & 1u) << 3) + (lane & 7u);
#pragma unroll
  for (int kk = 0; kk < kN; ++kk) {
    unsigned p[4];  // the bf16 weights of keys k0 + 16kk.. +15: the A fragment
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* sv = s[2 * kk + half];
      const float w0 = weight(sv[0], mc0, c), w1 = weight(sv[1], mc0, c);
      const float w2 = weight(sv[2], mc1, c), w3 = weight(sv[3], mc1, c);
      p[2 * half] = pack_bf16(w0, w1);
      p[2 * half + 1] = pack_bf16(w2, w3);
      l0 += w0 + w1;
      l1 += w2 + w3;
    }
    const unsigned key = k0 + kk * 16u + key_in;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      unsigned bv[4];
      ldmatrix_x4_trans(bv, vS + key * 8u + ((2u * jp + (mi >> 1)) ^ (key & 7u)));
      mma_bf16(o[2 * jp], p[0], p[1], p[2], p[3], bv[0], bv[1]);
      mma_bf16(o[2 * jp + 1], p[0], p[1], p[2], p[3], bv[2], bv[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Long plan: block = one (sequence, head) pair, its K and V staged whole in
// shared memory (rows up to the next 16, zero past L). Each warp takes 16
// query rows at a time and walks the keys in blocks of kKeyBlock.
//
// Shared memory (16-byte chunks): K rows at r · 8 + (c ^ ((r & 1) << 2)),
// so that a warp's 16-byte reads of chunks t and t + 4 of rows n0 + g fill
// all 32 banks; V rows at r · 8 + (c ^ (r & 7)), so that ldmatrix's eight
// rows of one chunk do.
__global__ void __launch_bounds__(kLongThreads, kLongBlocksPerSm)
    long_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, unsigned heads,
                          unsigned L, unsigned batch_stride, unsigned row_stride, float c) {
  extern __shared__ uint4 smem[];
  const unsigned slices = (L + 15u) >> 4, rows = slices << 4;
  uint4* kS = smem;
  uint4* vS = smem + rows * 8u;
  const unsigned warp = threadIdx.x >> 5, lane = threadIdx.x & 31u, g = lane >> 2, t = lane & 3u;
  const unsigned width = heads * kHd;
  const unsigned b = blockIdx.x / heads, h = blockIdx.x - b * heads;
  const bf16* q_base = qkv + (size_t)b * batch_stride + h * kHd;
  bf16* o_base = out + (size_t)b * L * width + h * kHd;

  for (unsigned i = threadIdx.x; i < rows * 8u; i += kLongThreads) {
    const unsigned r = i >> 3, ch = i & 7u;
    const bf16* src = q_base + (size_t)(r < L ? r : 0u) * row_stride + ch * 8u;
    cp_async<16>(kS + r * 8u + (ch ^ ((r & 1u) << 2)), src + width, r < L ? 16 : 0);
    cp_async<16>(vS + r * 8u + (ch ^ (r & 7u)), src + 2u * width, r < L ? 16 : 0);
  }
  cp_async_commit();
  // The A fragments of the warp's 16 query rows, k-slice ks.
  unsigned qf[4][4];
  auto load_q = [&](unsigned mt) {
    const unsigned r0 = mt * 16u + g, r1 = r0 + 8u;
    unsigned qa[8], qb[8];
    load_row(q_base + (size_t)r0 * row_stride, t, r0 < L, qa);
    load_row(q_base + (size_t)r1 * row_stride, t, r1 < L, qb);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      qf[ks][0] = qa[2 * ks];
      qf[ks][1] = qb[2 * ks];
      qf[ks][2] = qa[2 * ks + 1];
      qf[ks][3] = qb[2 * ks + 1];
    }
  };
  if (warp < slices) load_q(warp);
  cp_async_wait<0>();
  __syncthreads();

  for (unsigned mt = warp; mt < slices; mt += kLongWarps) {
    if (mt != warp) load_q(mt);
    // Rows g (0) and g + 8 (1): the running max (times c), the lane's share of
    // the running sum of the weights, and o[j]: columns 8j + 2t + {0, 1}.
    float mc0 = -INFINITY, mc1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    for (unsigned k0 = 0; k0 < rows; k0 += kKeyBlock) {
      const unsigned n = min(rows - k0, (unsigned)kKeyBlock) >> 4;  // 16-key slices here
      if (n == kKeyBlock / 16)
        key_block<kKeyBlock / 16>(kS, vS, k0, L, qf, o, mc0, mc1, l0, l1, c, lane);
      else if (n == 3)
        key_block<3>(kS, vS, k0, L, qf, o, mc0, mc1, l0, l1, c, lane);
      else if (n == 2)
        key_block<2>(kS, vS, k0, L, qf, o, mc0, mc1, l0, l1, c, lane);
      else
        key_block<1>(kS, vS, k0, L, qf, o, mc0, mc1, l0, l1, c, lane);
    }
    const float inv0 = 1.0f / quad_sum(l0), inv1 = 1.0f / quad_sum(l1);
    const unsigned row0 = mt * 16u + g, row1 = row0 + 8u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (row0 < L)
        reinterpret_cast<unsigned*>(o_base + (size_t)row0 * width + 8 * j)[t] =
            pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
      if (row1 < L)
        reinterpret_cast<unsigned*>(o_base + (size_t)row1 * width + 8 * j)[t] =
            pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// Short plan: warp = one m16 tile of kPairs = 16 / kLp pairs. Slot s (a tile
// row, or a key of the tile's two n8 tiles) is row s % kLp of pair
// first + s / kLp; a score counts only within its own pair.
template <int kLp>
__global__ void __launch_bounds__(kShortThreads, 2)
    short_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, unsigned pairs,
                           unsigned heads, unsigned L, unsigned batch_stride,
                           unsigned row_stride, float c) {
  constexpr unsigned kPairs = 16 / kLp;
  const unsigned lane = threadIdx.x & 31u, g = lane >> 2, t = lane & 3u;
  const unsigned first = (blockIdx.x * kShortWarps + (threadIdx.x >> 5)) * kPairs;
  if (first >= pairs) return;
  const unsigned width = heads * kHd;
  unsigned q0[8], q1[8], k0[8], k1[8], v0[8], v1[8];
  size_t at[2], out_at[2];  // slots g and g + 8: the row's element in qkv and in out
  bool ok[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const unsigned s = g + 8u * x, pair = first + s / kLp, i = s % kLp;
    const unsigned b = pair / heads, h = pair - b * heads;
    ok[x] = pair < pairs && i < L;
    at[x] = (size_t)b * batch_stride + (size_t)i * row_stride + h * kHd;
    out_at[x] = ((size_t)b * L + i) * width + h * kHd;
  }
  load_row(qkv + at[0], t, ok[0], q0);
  load_row(qkv + at[1], t, ok[1], q1);
  load_row(qkv + at[0] + width, t, ok[0], k0);
  load_row(qkv + at[1] + width, t, ok[1], k1);
  load_row(qkv + at[0] + 2u * width, t, ok[0], v0);
  load_row(qkv + at[1] + 2u * width, t, ok[1], v1);

  float s[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    mma_bf16(s[0], q0[2 * ks], q1[2 * ks], q0[2 * ks + 1], q1[2 * ks + 1], k0[2 * ks],
             k0[2 * ks + 1]);
    mma_bf16(s[1], q0[2 * ks], q1[2 * ks], q0[2 * ks + 1], q1[2 * ks + 1], k1[2 * ks],
             k1[2 * ks + 1]);
  }
  // s[nt][e]: row slot g + 8(e >> 1), key slot 8nt + 2t + (e & 1).
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned row = g + 8u * (e >> 1), key = 8u * nt + 2u * t + (e & 1);
      if (row / kLp != key / kLp || key % kLp >= L) s[nt][e] = -INFINITY;
    }
    m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
    m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
  }
  const float mc0 = quad_max(m0) * c, mc1 = quad_max(m1) * c;
  unsigned p[4];
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const float w0 = weight(s[nt][0], mc0, c), w1 = weight(s[nt][1], mc0, c);
    const float w2 = weight(s[nt][2], mc1, c), w3 = weight(s[nt][3], mc1, c);
    p[2 * nt] = pack_bf16(w0, w1);
    p[2 * nt + 1] = pack_bf16(w2, w3);
    l0 += w0 + w1;
    l1 += w2 + w3;
  }
  // Slots past L or past the last pair hold zeros: their rows are computed
  // and not written.
  const float inv0 = 1.0f / quad_sum(l0), inv1 = 1.0f / quad_sum(l1);

  // Output n8 tile 4l + q: columns 8(t' + 4l) + 2q + {0, 1} for t' = 0..3.
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    mma_bf16(o[j], p[0], p[1], p[2], p[3], movmatrix_trans(v0[j]), movmatrix_trans(v1[j]));
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (!ok[x]) continue;
    const float inv = x ? inv1 : inv0;
    uint4 lo, hi;
    lo.x = pack_bf16(o[0][2 * x] * inv, o[0][2 * x + 1] * inv);
    lo.y = pack_bf16(o[1][2 * x] * inv, o[1][2 * x + 1] * inv);
    lo.z = pack_bf16(o[2][2 * x] * inv, o[2][2 * x + 1] * inv);
    lo.w = pack_bf16(o[3][2 * x] * inv, o[3][2 * x + 1] * inv);
    hi.x = pack_bf16(o[4][2 * x] * inv, o[4][2 * x + 1] * inv);
    hi.y = pack_bf16(o[5][2 * x] * inv, o[5][2 * x + 1] * inv);
    hi.z = pack_bf16(o[6][2 * x] * inv, o[6][2 * x + 1] * inv);
    hi.w = pack_bf16(o[7][2 * x] * inv, o[7][2 * x + 1] * inv);
    uint4* dst = reinterpret_cast<uint4*>(out + out_at[x]);
    dst[t] = lo;
    dst[t + 4] = hi;
  }
}

cudaError_t launch_long(const bf16* qkv, bf16* out, unsigned heads, unsigned L, unsigned bs,
                        unsigned rs, float c, int blocks, cudaStream_t st) {
  const size_t smem = (size_t)((L + 15u) >> 4) * 16u * kHd * 2u * 2u;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        long_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  long_attention_kernel<<<blocks, kLongThreads, smem, st>>>(qkv, out, heads, L, bs, rs, c);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dfv

extern "C" {

// Returns cudaGetLastError() after the launch (0 when it was accepted).
// qkv: batch x seq rows of 3 · heads · 64 bf16, row i of sequence b at
// element b · batch_stride + i · row_stride (both multiples of 8), 16-byte
// aligned; out: batch x seq x heads · 64 bf16, contiguous, 16-byte aligned.
// plan 0 (short): size = kLp (8 or 16, seq <= size), blocks of 8 warps, one
// warp a tile of 16 / size pairs; plan 1 (long, 16 < seq <= 256): one block
// a pair, size unused. The plan and blocks come from self_attention_plan in
// ops/self_attention.py. scale_log2e: log2(e) / √64.
int dfv_self_attention(const void* qkv, void* out, int batch, int seq, int heads,
                       int batch_stride, int row_stride, int plan, int size, int blocks,
                       float scale_log2e, void* stream) {
  if (batch <= 0 || seq <= 0) return (int)cudaGetLastError();
  if (heads <= 0 || blocks <= 0 || batch_stride < 0 || batch_stride % 8 || row_stride < 0 ||
      row_stride % 8)
    return (int)cudaErrorInvalidValue;
  const auto* x = static_cast<const dfv::bf16*>(qkv);
  auto* o = static_cast<dfv::bf16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned H = (unsigned)heads, L = (unsigned)seq, bs = (unsigned)batch_stride,
                 rs = (unsigned)row_stride, pairs = (unsigned)batch * H;
  if (plan == 0) {
    if (seq > size) return (int)cudaErrorInvalidValue;
    if (size == 8)
      dfv::short_attention_kernel<8><<<blocks, dfv::kShortThreads, 0, st>>>(x, o, pairs, H, L, bs,
                                                                            rs, scale_log2e);
    else if (size == 16)
      dfv::short_attention_kernel<16><<<blocks, dfv::kShortThreads, 0, st>>>(x, o, pairs, H, L, bs,
                                                                             rs, scale_log2e);
    else
      return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  if (plan != 1 || seq <= 16 || seq > dfv::kMaxSeq || blocks != batch * heads)
    return (int)cudaErrorInvalidValue;
  return (int)dfv::launch_long(x, o, H, L, bs, rs, scale_log2e, blocks, st);
}

}  // extern "C"
