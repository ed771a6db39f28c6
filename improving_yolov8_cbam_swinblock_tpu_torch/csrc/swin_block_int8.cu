// Int8 SwinBlock forward for Hopper (sm_90a), one thread block per 7x7 window.
//
// Replaces the TPU kernel `_swin_flat_int8_kernel` launched by
// `fused_swin_block_int8` (improving_yolov8_cbam_swinblock_tpu/ops/pallas/
// swin_kernel.py:469) and, with sm16=1, its experimental variant
// `_swin_int8_io_kernel` (tools/bench_swin_variants.py:53). Same function as
// the fast SwinBlock forward (csrc/swin_block_fwd.cu), with its four products
// (qkv, out-projection, MLP fc1, fc2) as int8 x int8 -> int32: each product's
// input is quantized here to its calibrated per-tensor scale,
// q8(t, s) = clamp(rint(t / s), -127, 127), the int8 products are summed
// exactly in int32, and the sum is dequantized in the epilogue as
// acc * (s * w_scale[n]) + bias[n] with per-output-channel weight scales.
//
// Layout. x and y are (B, H, W, C) contiguous (the NHWC view of a
// channels_last NCHW activation); tokens past H or W are zero tokens (the
// window pad of the reference), which take part in attention and are not
// written back. x is int8 levels of x_in_scale (in8), fp32 or bf16; y is int8
// levels of y_out_scale (out8) or the compute dtype. Weights are int8 in
// PyTorch Linear layout (out, in); scales, LayerNorm parameters and biases
// are fp32. The six activation scales (qkv, out, fc1, fc2, x_in, y_out) are
// read from device memory.
//
// Numerics follow the TPU kernel. The compute dtype (bf16 with int8 input or
// sm16, else x's dtype) holds the LN1 affine (each operation rounded), qkv,
// the probabilities and the tanh GELU (each operation rounded, its constants
// taken in the compute dtype); each head's a.v, the residual stream and the
// LN2 output stay fp32. sm16 takes the softmax's exp, its sum and the
// division in bf16, the max subtraction in fp32. The integer sums are exact,
// so the kernel differs from its plain version only by fp32 rounding order
// before a quantization (LN statistics, attention dots). Built with
// -fmad=false so that products and sums written apart round apart, as in the
// TPU kernel; the fp32 attention loops call fmaf explicitly.
//
// Bound. Per real token 24*C*C int8 operations (qkv 6C^2, out 2C^2, fc1 8C^2,
// fc2 8C^2) at 1979 TOP/s and 196*C bf16 FLOP of attention at 989 TFLOP/s;
// at (8, 40, 40, 256) 20.1 G int8 operations, 10.8 us, against 7.4 MB of
// int8 I/O and weights (2.2 us): bound by operations.
//
// Design, against the costs of the first version (a CUDA-core kernel):
// - The four products ran on __dp4a, the loop bound by shared-memory reads
//   (8 words per 16 dp4a). They now run on the tensor cores
//   (swin_mma_s8.cuh: mma.sync m16n8k32 s8 -> s32, the 49 tokens padded to
//   64 rows, 16 warps in a 4 x 4 grid of 16 x 32 warp tiles, fragments
//   through ldmatrix). The int32 sums are exact, so each accumulator equals
//   the first version's bit for bit.
// - Weight tiles were loaded synchronously between two barriers. They now
//   stream from L2 (0.8 MB of int8 weights at C=256, resident there) through
//   a 3-stage cp.async ring of 128 x 128-byte tiles (four k-steps a barrier;
//   64-byte tiles in fp32 compute), two in flight while one is multiplied.
// - qkv ran per head over 3*hd columns in 64-column passes; a head's qkv is
//   now one pipelined product of 128-column blocks (three whole blocks at
//   hd = 128).
// - The attention was scalar fp32 over an odd-strided fp32 q|k|v. In the bf16
//   compute dtype (the int8 path: in8 gives it) a head's q, k and v are
//   bf16 tiles (they were rounded to bf16 already), and the scores (q k^T)
//   and P.v run on bf16 mma.sync m16n8k16 (swin_mma.cuh product_smem), fp32
//   sums. P and v are padded to 64 keys with zeros. The softmax's arithmetic
//   is unchanged, over the 49 real keys. The fp32 compute dtype (fp32 I/O
//   without sm16; tests and the kernel phase only) keeps the CUDA-core fp32
//   attention loops; its int8 products run on the tensor cores too.
// - Epilogues read each scale and bias from global memory. The 9C
//   dequantize factors x_scale * w_scale[n] (the same fp32 product as
//   before) and the 9C biases are now staged in shared memory once.
// - The window was read one element per lane inside LN1, each load's latency
//   paid in turn. It is now gathered whole, 16 bytes per load, all in flight
//   together; the output is written from the fp32 residual stream 16 bytes
//   per store.
// Shared memory per block at C=256, 2 heads (bf16 compute): the fp32
// residual stream (49 x C), the staged factors and biases (18C fp32), the
// int8 product inputs (LN1 / LN2 output and the heads' outputs, 64 x C+16
// each), one head's bf16 q, k, v (3 x 64 x hd+8), over which (with the
// heads' outputs) the int8 MLP hidden (64 x 4C+16) later lies, and the ring,
// over which a head's scores and probabilities lie: 210,944 B, one block of
// 512 threads per SM.
//
// Wide windows (bf16 compute, from C=512 with 2 heads, where that layout
// would need 361 KB): one launch, the same products, roundings and exact
// int32 sums. Shared memory keeps the fp32 residual stream, the two int8
// product inputs, a 64-wide slice of a head's bf16 q and k (then v) with
// the head's fp32 scores, and a 3-stage ring of 64-byte-deep tiles; the
// factors and biases are read from global memory in the epilogues (the same
// fp32 products). A head's q.k^T sums its slices' products in fp32. The MLP
// runs in 128-column chunks of the hidden: fc1 quantizes a chunk of the
// hidden into int8, fc2 adds its int32 sums onto the block's int32
// accumulators, which take the residual stream's place in shared memory
// while the stream waits in a global scratch row block of the window; the
// last chunk dequantizes the whole sum once, as the TPU kernel does, and
// adds it to the stream. 226,704 B at C=512.
//
// Wide windows with the stream in global memory (from C=640 with 2 heads,
// where the wide layout would need 268 KB, 309,648 B at C=768): the same
// kernel with the fp32 residual stream kept in the window's global scratch
// row block for the whole block (gathered there, LN1 in place, the
// out-projection and the MLP added onto it there, stored from there), so
// shared memory holds only the two int8 product inputs, the slices and
// scores and the ring during attention (159,120 B at C=768). During the MLP
// fc2's int32 sums lie over the heads' outputs, the slices and that ring,
// followed by the hidden chunk and a 2-stage ring of 64-byte-deep tiles:
// 230,400 B at C=768. Every value is the same operation on the same
// operands as in the wide layout; only where the stream lives differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "swin_mma_s8.cuh"

namespace {

using swin_mma::bf16;
using swin_mma::MROWS;
using swin_mma::PAD;
using swin_mma::PAD8;

constexpr int WS = 7;
constexpr int NTOK = WS * WS;
constexpr int WN = 4;  // warp columns of the products: 16 warps in a 4 x 4 grid
constexpr int NTHREADS = 128 * WN;
constexpr int NWARPS = NTHREADS / 32;
constexpr int NT = 4;              // n8 tiles per warp: 128-column blocks
constexpr int P_LD = MROWS + PAD;  // row stride of the bf16 probabilities
constexpr int STG = 3;             // ring stages
constexpr float LN_EPS = 1e-5f;
static_assert(NTOK == swin_mma::NTOK, "one window per block");

// k depth (bytes) of a ring stage: four m16n8k32 steps in the bf16 compute
// dtype, two in fp32, whose larger q|k|v leaves less room
template <bool CBF>
constexpr int KT = CBF ? 128 : 64;
template <bool CBF>
constexpr size_t RING_BYTES = swin_mma::ring_bytes_s8<NT, WN, KT<CBF>, STG>();
static_assert(RING_BYTES<false> >= sizeof(float) * NTOK * NTOK && RING_BYTES<true> >= sizeof(float) * NTOK * NTOK &&
                  RING_BYTES<true> >= sizeof(bf16) * MROWS * P_LD,
              "the scores and the probabilities lie over the ring");

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use on sm_90
constexpr int KT_W = 64;             // k depth (bytes) of the wide kernel's ring stages
constexpr int DS = 64;               // head-dim slice of the wide kernel's attention
constexpr int DS_LD = DS + PAD;      // row stride of its bf16 q, k and v slices
constexpr int HC8 = 128;             // MLP hidden columns per chunk of the wide kernel
constexpr size_t WIDE_RING_BYTES = swin_mma::ring_bytes_s8<NT, WN, KT_W, STG>();
static_assert(DS_LD == P_LD, "the probabilities share the slices' row stride");

enum Kind { KIND_F32 = 0, KIND_BF16 = 1, KIND_I8 = 2 };

struct Args {
  const void* x;
  void* y;
  int x_kind, y_kind, H, W, C, heads;
  bool sm16;       // bf16 softmax
  float scale;     // 1 / sqrt(head dim)
  const float* xs; // activation scales: qkv, out, fc1, fc2, x_in, y_out
  const float *ln1w, *ln1b, *bqkv, *bout, *ln2w, *ln2b, *b1, *b2;
  const int8_t *wqkv, *wout, *w1, *w2;
  const float *sqkv, *sout, *s1, *s2;
};

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16(v)); }

template <bool CBF>
__device__ __forceinline__ float rc(float v) { return CBF ? bf(v) : v; }

// int8 level of t at scale s: clamp(round half to even(t / s), -127, 127)
__device__ __forceinline__ int q8(float t, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(t, s)), -127.f), 127.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Gather the window's tokens into res (NTOK x C, fp32; int8 levels times
// xs_in), zero past the edge, 16 bytes per load (x 16-byte aligned,
// C % 64 == 0); all loads of the window are in flight together
__device__ void gather_window(const void* x, int kind, float xs_in, int b, int wy, int wx, int H, int W, int C,
                              float* res) {
  const int V = kind == KIND_I8 ? 16 : kind == KIND_BF16 ? 8 : 4;
  const int cv = C / V;
  for (int e = threadIdx.x; e < NTOK * cv; e += NTHREADS) {
    const int t = e / cv, c = (e % cv) * V;
    const int h = wy * WS + t / WS;
    const int w = wx * WS + t % WS;
    const size_t i = (((size_t)b * H + h) * W + w) * C + c;
    uint4 v = make_uint4(0, 0, 0, 0);
    float* dst = res + t * C + c;
    if (kind == KIND_I8) {
      if (h < H && w < W) v = *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(x) + i);
      const int8_t* vt = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[j] = (float)vt[j] * xs_in;
    } else if (kind == KIND_BF16) {
      if (h < H && w < W) v = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(x) + i);
      const bf16* vt = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = __bfloat162float(vt[j]);
    } else {
      if (h < H && w < W) v = *reinterpret_cast<const uint4*>(static_cast<const float*>(x) + i);
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
  __syncthreads();
}

struct Identity {
  __device__ __forceinline__ int operator()(int n) const { return n; }
};

// dequantized product: acc * f + bias with f = x_scale * w_scale, each
// operation rounded
__device__ __forceinline__ float deq(int acc, float f, float b) { return __int2float_rn(acc) * f + b; }

// 0.5 pb (1 + tanh(0.7978845608 (pb + 0.044715 pb^3))), each operation
// rounded to the compute dtype, the constants taken in it
template <bool CBF>
__device__ __forceinline__ float gelu_tanh(float pb) {
  const float c1 = rc<CBF>(0.044715f), c2 = rc<CBF>(0.7978845608f);
  float t = rc<CBF>(c1 * pb);
  t = rc<CBF>(t * pb);
  t = rc<CBF>(t * pb);
  t = rc<CBF>(pb + t);
  t = rc<CBF>(c2 * t);
  t = rc<CBF>(tanhf(t));
  t = rc<CBF>(1.f + t);
  return rc<CBF>(rc<CBF>(0.5f * pb) * t);
}

__host__ __device__ inline size_t up16(size_t v) { return (v + 15) / 16 * 16; }

// Byte offsets of the kernel's shared memory; cbf: the bf16 compute dtype
// (exported as swin_block_int8_smem_bytes, repeated by ops/swin_int8.py)
struct Layout {
  size_t scl, a8, o8, head, ring, total;
  __host__ __device__ Layout(int C, int heads, bool cbf) {
    const int hd = C / heads;
    const size_t in8 = (size_t)MROWS * (C + PAD8);  // an int8 product input of C columns
    const size_t head_bytes = cbf ? sizeof(bf16) * 3 * MROWS * (hd + PAD) : sizeof(float) * NTOK * (3 * hd + 1);
    const size_t hid = (size_t)MROWS * (4 * C + PAD8);  // the int8 MLP hidden, over o8 and the head
    scl = sizeof(float) * NTOK * C;     // after the fp32 residual stream
    a8 = scl + sizeof(float) * 18 * C;  // after the 9C dequantize factors and the 9C biases
    o8 = a8 + in8;
    head = o8 + in8;
    ring = o8 + up16(in8 + head_bytes > hid ? in8 + head_bytes : hid);
    total = ring + (cbf ? RING_BYTES<true> : RING_BYTES<false>);
  }
};

// Softmax of each row of the scores sc (NTOK x NTOK fp32), one warp per row,
// into the bf16 probabilities p (MROWS x P_LD; zero past column and row
// NTOK), with the first version's arithmetic (sm16: exp, sum and division
// in bf16). p lies over sc: each warp holds its rows in registers across a
// barrier. Ends with a barrier.
__device__ void softmax_rows(const float* sc, bf16* p, bool sm16) {
  constexpr int RPW = (NTOK + NWARPS - 1) / NWARPS;  // rows per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool two = lane + 32 < NTOK;
  float p0[RPW], p1[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int t = warp + i * NWARPS;
    p0[i] = p1[i] = 0.f;
    if (t < NTOK) {  // warp-uniform
      const float v0 = sc[t * NTOK + lane];
      const float v1 = two ? sc[t * NTOK + lane + 32] : v0;
      const float m = warp_max(fmaxf(v0, v1));
      if (sm16) {
        const float e0 = bf(expf(bf(v0 - m)));
        const float e1 = two ? bf(expf(bf(v1 - m))) : 0.f;
        const float s = bf(warp_sum(e0 + e1));
        p0[i] = e0 / s;
        p1[i] = two ? e1 / s : 0.f;
      } else {
        const float e0 = expf(v0 - m);
        const float e1 = two ? expf(v1 - m) : 0.f;
        const float s = warp_sum(e0 + e1);
        p0[i] = e0 / s;
        p1[i] = two ? e1 / s : 0.f;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int t = warp + i * NWARPS;
    if (t < NTOK) {
      p[t * P_LD + lane] = __float2bfloat16(p0[i]);
      p[t * P_LD + lane + 32] = __float2bfloat16(p1[i]);
    }
  }
  for (int e = threadIdx.x; e < (MROWS - NTOK) * P_LD; e += NTHREADS) p[NTOK * P_LD + e] = __float2bfloat16(0.f);
  __syncthreads();
}

// One head's scores, softmax and a.v in fp32 on the CUDA cores (the fp32
// compute dtype), q|k|v in q_s (rows of ldq floats), the probabilities in
// p_s (NTOK x NTOK); each output quantized into o8 (row stride ld8) at
// columns col0..
__device__ void attention_f32(const float* q_s, int ldq, float* p_s, int hd, float scale, float xs_out, int8_t* o8,
                              int ld8, int col0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < NTOK * NTOK; e += NTHREADS) {
    const float* qi = q_s + (e / NTOK) * ldq;
    const float* kj = q_s + (e % NTOK) * ldq + hd;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(qi[d], kj[d], s);
    p_s[e] = s * scale;
  }
  __syncthreads();
  for (int i = warp; i < NTOK; i += NWARPS) {
    float* prow = p_s + i * NTOK;
    const bool two = lane + 32 < NTOK;
    const float v0 = prow[lane];
    const float v1 = two ? prow[lane + 32] : v0;
    const float m = warp_max(fmaxf(v0, v1));
    const float e0 = expf(v0 - m);
    const float e1 = two ? expf(v1 - m) : 0.f;
    const float s = warp_sum(e0 + e1);
    prow[lane] = e0 / s;
    if (two) prow[lane + 32] = e1 / s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < NTOK * hd; e += NTHREADS) {
    const int i = e / hd;
    const int d = e % hd;
    const float* prow = p_s + i * NTOK;
    const float* vcol = q_s + 2 * hd + d;
    float s = 0.f;
    for (int j = 0; j < NTOK; ++j) s = fmaf(prow[j], vcol[j * ldq], s);
    o8[i * ld8 + col0 + d] = (int8_t)q8(s, xs_out);
  }
  __syncthreads();
}

// Write the window's in-range tokens of the residual stream res to y in its
// kind (int8 levels of ys, bf16 or fp32), 16 bytes per store (C % 64 == 0)
__device__ void store_window(const float* res, void* y, int kind, float ys, int b, int wy, int wx, int H, int W,
                             int C) {
  const int V = kind == KIND_I8 ? 16 : kind == KIND_BF16 ? 8 : 4;
  const int cv = C / V;
  for (int e = threadIdx.x; e < NTOK * cv; e += NTHREADS) {
    const int t = e / cv, c = (e % cv) * V;
    const int h = wy * WS + t / WS;
    const int w = wx * WS + t % WS;
    if (h >= H || w >= W) continue;
    const float* src = res + t * C + c;
    const size_t i = (((size_t)b * H + h) * W + w) * C + c;
    uint4 v;
    if (kind == KIND_I8) {
      int8_t* vt = reinterpret_cast<int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) vt[j] = (int8_t)q8(src[j], ys);
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(y) + i) = v;
    } else if (kind == KIND_BF16) {
      bf16* vt = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[j] = __float2bfloat16(src[j]);
      *reinterpret_cast<uint4*>(static_cast<bf16*>(y) + i) = v;
    } else {
      *reinterpret_cast<uint4*>(static_cast<float*>(y) + i) = *reinterpret_cast<const uint4*>(src);
    }
  }
}

// LN1 of the gathered rows of res in place, one warp per token, with its
// affine in the compute dtype (each operation rounded); the result
// quantized into a8 (row stride ld8) for the qkv product. Ends with a barrier.
template <bool CBF>
__device__ void ln1_quant(float* res, int8_t* a8, int ld8, const Args& P) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = P.C;
  const float fc = (float)C, xs_qkv = P.xs[0];
  for (int t = warp; t < NTOK; t += NWARPS) {
    float* row = res + t * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) / fc;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      ss += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(ss) / fc + LN_EPS);
    for (int c = lane; c < C; c += 32) {
      const float n = (row[c] - mean) * rstd;
      const float xn = CBF ? bf(bf(bf(n) * bf(P.ln1w[c])) + bf(P.ln1b[c])) : n * P.ln1w[c] + P.ln1b[c];
      row[c] = xn;
      a8[t * ld8 + c] = (int8_t)q8(xn, xs_qkv);
    }
  }
  __syncthreads();
}

// LN2 (fp32 affine) of the residual stream res, one warp per token,
// quantized into a8 (row stride ld8) for fc1. Ends with a barrier.
__device__ void ln2_quant(const float* res, int8_t* a8, int ld8, const Args& P) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = P.C;
  const float fc = (float)C, xs_fc1 = P.xs[2];
  for (int t = warp; t < NTOK; t += NWARPS) {
    const float* row = res + t * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) / fc;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      ss += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(ss) / fc + LN_EPS);
    for (int c = lane; c < C; c += 32)
      a8[t * ld8 + c] = (int8_t)q8((row[c] - mean) * rstd * P.ln2w[c] + P.ln2b[c], xs_fc1);
  }
  __syncthreads();
}

template <bool CBF>
__global__ void __launch_bounds__(NTHREADS) swin_block_int8_kernel(Args P) {
  using swin_mma::product_smem;
  using swin_mma::product_stream_s8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = P.C;
  const int hd = C / P.heads;
  const Layout L(C, P.heads, CBF);
  const int ld8 = C + PAD8;       // bytes per row of a8 and o8
  const int ldh8 = 4 * C + PAD8;  // bytes per row of the MLP hidden
  float* res = reinterpret_cast<float*>(smem);          // normed tokens, then the fp32 residual stream
  float* fac = reinterpret_cast<float*>(smem + L.scl);  // x_scale * w_scale: qkv (3C), out (C), fc1 (4C), fc2 (C)
  float* bia = fac + 9 * C;                             // the biases in the same order
  int8_t* a8 = reinterpret_cast<int8_t*>(smem + L.a8);  // the qkv input, then the fc1 input
  int8_t* o8 = reinterpret_cast<int8_t*>(smem + L.o8);  // the heads' outputs: the out-projection input
  int8_t* h8 = o8;                                      // the MLP hidden, after the out-projection
  unsigned char* head = smem + L.head;                  // one head's q, k, v
  int8_t* ring = reinterpret_cast<int8_t*>(smem + L.ring);

  // zero the head's tiles once: pad rows are never stored, and v's must be
  // zero (the zero pad columns of P multiply them)
  for (size_t e = threadIdx.x; e < (L.ring - L.head) / 16; e += NTHREADS)
    reinterpret_cast<uint4*>(head)[e] = make_uint4(0, 0, 0, 0);

  const int H = P.H, W = P.W;
  const int nwh = (H + WS - 1) / WS;
  const int nww = (W + WS - 1) / WS;
  const int b = blockIdx.x / (nwh * nww);
  const int wy = (blockIdx.x / nww) % nwh;
  const int wx = blockIdx.x % nww;
  const float xs_qkv = P.xs[0], xs_out = P.xs[1], xs_fc1 = P.xs[2], xs_fc2 = P.xs[3];
  const float xs_in = P.xs[4], ys_out = P.xs[5];

  for (int e = threadIdx.x; e < 9 * C; e += NTHREADS) {
    float f, bv;
    if (e < 3 * C) f = xs_qkv * P.sqkv[e], bv = P.bqkv[e];
    else if (e < 4 * C) f = xs_out * P.sout[e - 3 * C], bv = P.bout[e - 3 * C];
    else if (e < 8 * C) f = xs_fc1 * P.s1[e - 4 * C], bv = P.b1[e - 4 * C];
    else f = xs_fc2 * P.s2[e - 8 * C], bv = P.b2[e - 8 * C];
    fac[e] = f;
    bia[e] = bv;
  }

  // ---- gather the window, LN1 and its affine, quantize the qkv input ----
  gather_window(P.x, P.x_kind, xs_in, b, wy, wx, H, W, C, res);
  ln1_quant<CBF>(res, a8, ld8, P);

  // ---- attention, one head at a time; each head's output quantized for the out-projection ----
  for (int hh = 0; hh < P.heads; ++hh) {
    // columns [0, hd) q, [hd, 2hd) k, [2hd, 3hd) v of this head
    auto qkv_row = [=](int n) {
      const int seg = (n >= hd) + (n >= 2 * hd);
      return seg * C + hh * hd + (n - seg * hd);
    };
    if constexpr (CBF) {
      const int ldq = hd + PAD;
      bf16* q_s = reinterpret_cast<bf16*>(head);
      bf16* k_s = q_s + MROWS * ldq;
      bf16* v_s = k_s + MROWS * ldq;
      product_stream_s8<NT, WN, KT<CBF>, STG>(a8, ld8, C, P.wqkv, C, 3 * hd, qkv_row, ring, [&](int r, int n, int acc) {
        const int seg = (n >= hd) + (n >= 2 * hd);
        const int m = qkv_row(n);
        q_s[seg * MROWS * ldq + r * ldq + (n - seg * hd)] = __float2bfloat16(deq(acc, fac[m], bia[m]));
      });
      float* sc = reinterpret_cast<float*>(ring);  // the scores, then the probabilities, over the ring
      bf16* p_s = reinterpret_cast<bf16*>(ring);
      product_smem<NT, false, WN>(q_s, ldq, k_s, ldq, hd, NTOK,
                                  [&](int r, int n, float acc) { sc[r * NTOK + n] = acc * P.scale; });
      softmax_rows(sc, p_s, P.sm16);
      product_smem<NT, true, WN>(p_s, P_LD, v_s, ldq, MROWS, hd, [&](int r, int n, float acc) {
        o8[r * ld8 + hh * hd + n] = (int8_t)q8(acc, xs_out);
      });
    } else {
      const int ldq = 3 * hd + 1;  // odd stride: rows of k and v fall in distinct banks
      float* q_s = reinterpret_cast<float*>(head);
      product_stream_s8<NT, WN, KT<CBF>, STG>(a8, ld8, C, P.wqkv, C, 3 * hd, qkv_row, ring, [&](int r, int n, int acc) {
        const int m = qkv_row(n);
        q_s[r * ldq + n] = deq(acc, fac[m], bia[m]);
      });
      attention_f32(q_s, ldq, reinterpret_cast<float*>(ring), hd, P.scale, xs_out, o8, ld8, hh * hd);
    }
  }

  // ---- out-projection; residual onto the normed tokens ----
  product_stream_s8<NT, WN, KT<CBF>, STG>(o8, ld8, C, P.wout, C, C, Identity(), ring, [&](int r, int n, int acc) {
    res[r * C + n] = res[r * C + n] + deq(acc, fac[3 * C + n], bia[3 * C + n]);
  });

  // ---- LN2 (fp32 affine), quantized for fc1 ----
  ln2_quant(res, a8, ld8, P);

  // ---- fc1 and the tanh GELU into the int8 hidden ----
  product_stream_s8<NT, WN, KT<CBF>, STG>(a8, ld8, C, P.w1, C, 4 * C, Identity(), ring, [&](int r, int n, int acc) {
    const float pb = rc<CBF>(deq(acc, fac[4 * C + n], bia[4 * C + n]));
    h8[r * ldh8 + n] = (int8_t)q8(gelu_tanh<CBF>(pb), xs_fc2);
  });

  // ---- fc2 onto the residual stream, written out for the window's in-range tokens ----
  product_stream_s8<NT, WN, KT<CBF>, STG>(h8, ldh8, 4 * C, P.w2, 4 * C, C, Identity(), ring, [&](int r, int n, int acc) {
    res[r * C + n] = res[r * C + n] + deq(acc, fac[8 * C + n], bia[8 * C + n]);
  });
  store_window(res, P.y, P.y_kind, ys_out, b, wy, wx, H, W, C);
}


constexpr int MLP_STG_G = 2;  // ring stages of the MLP where the stream lives in global memory
constexpr size_t WIDE_MLP_RING_BYTES = swin_mma::ring_bytes_s8<NT, WN, KT_W, MLP_STG_G>();

// Byte offsets of the wide kernels' shared memory (bf16 compute; exported
// through swin_block_int8_smem_bytes, repeated by ops/swin_int8.py). gres:
// the fp32 residual stream stays in the global scratch for the whole block.
struct WideLayout {
  size_t a8, o8, attn, ring, acc, h8, mring, total;
  __host__ __device__ WideLayout(int C, bool gres) {
    const size_t in8 = (size_t)MROWS * (C + PAD8);  // an int8 product input of C columns
    const size_t stream = sizeof(float) * NTOK * C;  // the fp32 residual stream, or fc2's int32 sums
    a8 = gres ? 0 : stream;  // after the fp32 residual stream where it is resident
    o8 = a8 + in8;
    attn = o8 + in8;  // the q and k (then v) slices and the scores (then probabilities)
    ring = attn + up16(sizeof(bf16) * 2 * MROWS * DS_LD + sizeof(float) * NTOK * NTOK);
    total = ring + WIDE_RING_BYTES;
    if (!gres) {  // fc2's sums take the resident stream's place; the hidden chunk lies over o8
      acc = 0, h8 = o8, mring = ring;
    } else {  // fc2's sums over o8, the slices and the ring, then the hidden chunk and the MLP's ring
      acc = o8;
      h8 = acc + stream;
      mring = h8 + (size_t)MROWS * (HC8 + PAD8);
      const size_t mlp_end = mring + WIDE_MLP_RING_BYTES;
      total = total > mlp_end ? total : mlp_end;
    }
  }
};

template <bool GRES>
__global__ void __launch_bounds__(NTHREADS) swin_block_int8_wide_kernel(Args P, float* __restrict__ scratch) {
  using swin_mma::product_smem;
  using swin_mma::product_stream_s8;
  constexpr int MLP_STG = GRES ? MLP_STG_G : STG;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = P.C;
  const int hd = C / P.heads;
  const WideLayout L(C, GRES);
  const int ld8 = C + PAD8;            // bytes per row of a8 and o8
  constexpr int ldh8 = HC8 + PAD8;     // bytes per row of an MLP hidden chunk
  float* y1g = scratch + (size_t)blockIdx.x * NTOK * C;  // the window's scratch row block
  // normed tokens, then the fp32 residual stream: in shared memory, or (GRES) in the scratch throughout
  float* res = GRES ? y1g : reinterpret_cast<float*>(smem);
  int* acc2 = reinterpret_cast<int*>(smem + L.acc);     // during the MLP: fc2's int32 sums
  int8_t* a8 = reinterpret_cast<int8_t*>(smem + L.a8);  // the qkv input, then the fc1 input
  int8_t* o8 = reinterpret_cast<int8_t*>(smem + L.o8);  // the heads' outputs: the out-projection input
  int8_t* h8 = reinterpret_cast<int8_t*>(smem + L.h8);  // an MLP hidden chunk, after the out-projection
  bf16* q_s = reinterpret_cast<bf16*>(smem + L.attn);   // a slice of q, then of v
  bf16* k_s = q_s + MROWS * DS_LD;                      // a slice of k
  float* sc = reinterpret_cast<float*>(k_s + MROWS * DS_LD);  // the head's scores, then its probabilities
  bf16* p_s = reinterpret_cast<bf16*>(sc);
  int8_t* ring = reinterpret_cast<int8_t*>(smem + L.ring);
  int8_t* mring = reinterpret_cast<int8_t*>(smem + L.mring);  // the MLP's ring

  // zero the slices once: pad rows are never stored, and v's must be zero
  // (the zero pad columns of P multiply them)
  for (size_t e = threadIdx.x; e < (L.ring - L.attn) / 16; e += NTHREADS)
    reinterpret_cast<uint4*>(smem + L.attn)[e] = make_uint4(0, 0, 0, 0);

  const int H = P.H, W = P.W;
  const int nwh = (H + WS - 1) / WS;
  const int nww = (W + WS - 1) / WS;
  const int b = blockIdx.x / (nwh * nww);
  const int wy = (blockIdx.x / nww) % nwh;
  const int wx = blockIdx.x % nww;
  const float xs_qkv = P.xs[0], xs_out = P.xs[1], xs_fc1 = P.xs[2], xs_fc2 = P.xs[3];
  const float xs_in = P.xs[4], ys_out = P.xs[5];

  gather_window(P.x, P.x_kind, xs_in, b, wy, wx, H, W, C, res);
  ln1_quant<true>(res, a8, ld8, P);

  // ---- attention, one head at a time, in slices of its dims ----
  for (int hh = 0; hh < P.heads; ++hh) {
    for (int d0 = 0; d0 < hd; d0 += DS) {
      const int dn = min(DS, hd - d0);
      const bool last = d0 + dn == hd;
      auto qk_row = [=](int n) { return n < dn ? hh * hd + d0 + n : C + hh * hd + d0 + (n - dn); };
      product_stream_s8<NT, WN, KT_W, STG>(a8, ld8, C, P.wqkv, C, 2 * dn, qk_row, ring, [&](int r, int n, int acc) {
        const int m = qk_row(n);
        bf16* dst = n < dn ? q_s + r * DS_LD + n : k_s + r * DS_LD + n - dn;
        *dst = __float2bfloat16(deq(acc, xs_qkv * P.sqkv[m], P.bqkv[m]));
      });
      product_smem<NT, false, WN>(q_s, DS_LD, k_s, DS_LD, dn, NTOK, [&](int r, int n, float acc) {
        float& s = sc[r * NTOK + n];
        const float t = d0 == 0 ? acc : s + acc;
        s = last ? t * P.scale : t;
      });
    }
    softmax_rows(sc, p_s, P.sm16);
    for (int d0 = 0; d0 < hd; d0 += DS) {
      const int dn = min(DS, hd - d0);
      const int c0 = hh * hd + d0;  // the slice's first column of v and of the heads' output
      product_stream_s8<NT, WN, KT_W, STG>(a8, ld8, C, P.wqkv, C, dn, [=](int n) { return 2 * C + c0 + n; }, ring,
                                          [&](int r, int n, int acc) {
                                            const int m = 2 * C + c0 + n;
                                            q_s[r * DS_LD + n] = __float2bfloat16(deq(acc, xs_qkv * P.sqkv[m], P.bqkv[m]));
                                          });
      product_smem<NT, true, WN>(p_s, P_LD, q_s, DS_LD, MROWS, dn, [&](int r, int n, float acc) {
        o8[r * ld8 + c0 + n] = (int8_t)q8(acc, xs_out);
      });
    }
  }

  // ---- out-projection; residual onto the normed tokens ----
  product_stream_s8<NT, WN, KT_W, STG>(o8, ld8, C, P.wout, C, C, Identity(), ring, [&](int r, int n, int acc) {
    res[r * C + n] = res[r * C + n] + deq(acc, xs_out * P.sout[n], P.bout[n]);
  });
  ln2_quant(res, a8, ld8, P);

  // fc2's int32 sums start at 0; a resident stream waits in the scratch, its shared memory taking the sums
  for (int e = threadIdx.x; e < NTOK * C / 4; e += NTHREADS) {
    if constexpr (!GRES) reinterpret_cast<float4*>(y1g)[e] = reinterpret_cast<const float4*>(res)[e];
    reinterpret_cast<int4*>(acc2)[e] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  // ---- MLP in hidden chunks: fc1 and the tanh GELU into an int8 chunk, fc2's sums over the chunks ----
  for (int h0 = 0; h0 < 4 * C; h0 += HC8) {
    product_stream_s8<NT, WN, KT_W, MLP_STG>(a8, ld8, C, P.w1, C, HC8, [=](int n) { return h0 + n; }, mring,
                                            [&](int r, int n, int acc) {
                                              const int m = h0 + n;
                                              const float pb = bf(deq(acc, xs_fc1 * P.s1[m], P.b1[m]));
                                              h8[r * ldh8 + n] = (int8_t)q8(gelu_tanh<true>(pb), xs_fc2);
                                            });
    const bool last = h0 + HC8 >= 4 * C;
    product_stream_s8<NT, WN, KT_W, MLP_STG>(h8, ldh8, HC8, P.w2 + h0, 4 * C, C, Identity(), mring,
                                            [&](int r, int n, int acc) {
                                              const int i = r * C + n;
                                              if (!last) {
                                                acc2[i] += acc;
                                              } else {  // the whole sum, dequantized once, onto the stream
                                                const int tot = acc2[i] + acc;
                                                res[i] = y1g[i] + deq(tot, xs_fc2 * P.s2[n], P.b2[n]);
                                              }
                                            });
  }
  store_window(res, P.y, P.y_kind, ys_out, b, wy, wx, H, W, C);
}

// the wide layout serves the bf16-compute shapes whose resident one exceeds
// the block's limit, with the stream in global memory where it exceeds it too
bool is_wide(int C, int heads, bool cbf) { return cbf && Layout(C, heads, true).total > MAX_SMEM; }

bool is_gres(int C, int heads, bool cbf) { return is_wide(C, heads, cbf) && WideLayout(C, false).total > MAX_SMEM; }

size_t smem_bytes(int C, int heads, bool cbf) {
  return is_wide(C, heads, cbf) ? WideLayout(C, is_gres(C, heads, cbf)).total : Layout(C, heads, cbf).total;
}

size_t scratch_bytes(int B, int H, int W, int C, int heads, bool cbf) {
  if (!is_wide(C, heads, cbf)) return 0;
  return (size_t)B * ((H + WS - 1) / WS) * ((W + WS - 1) / WS) * sizeof(float) * NTOK * C;
}

template <bool GRES>
int launch_wide(const Args& P, int B, float* scratch, cudaStream_t stream) {
  const size_t smem = WideLayout(P.C, GRES).total;
  cudaError_t err = cudaFuncSetAttribute(swin_block_int8_wide_kernel<GRES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * ((P.H + WS - 1) / WS) * ((P.W + WS - 1) / WS);
  swin_block_int8_wide_kernel<GRES><<<blocks, NTHREADS, smem, stream>>>(P, scratch);
  return (int)cudaGetLastError();
}

template <bool CBF>
int launch(const Args& P, int B, cudaStream_t stream) {
  const size_t smem = Layout(P.C, P.heads, CBF).total;
  cudaError_t err = cudaFuncSetAttribute(swin_block_int8_kernel<CBF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * ((P.H + WS - 1) / WS) * ((P.W + WS - 1) / WS);
  swin_block_int8_kernel<CBF><<<blocks, NTHREADS, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one block takes at this C and head count, in the
// bf16 (cbf = 1) or fp32 compute dtype.
size_t swin_block_int8_smem_bytes(int C, int heads, int cbf) { return smem_bytes(C, heads, cbf != 0); }

// Bytes of global scratch a launch at this shape needs (0 where the window
// stays in shared memory); the caller passes that many bytes as `scratch`.
size_t swin_block_int8_scratch_bytes(int B, int H, int W, int C, int heads, int cbf) {
  return scratch_bytes(B, H, W, C, heads, cbf != 0);
}

// x_kind, y_kind: 0 = float32, 1 = bfloat16, 2 = int8. cdt_bf16: the compute
// dtype is bf16. sm16: bf16 softmax (needs cdt_bf16). xs: the six activation
// scales on the card. Weights int8 (out, in); their scales, LayerNorm
// parameters and biases fp32. C % 64 == 0 and a head dim that is a multiple
// of 16 (the tensor-core tiles). scratch: swin_block_int8_scratch_bytes of
// device memory, or null where that is 0. Returns the CUDA error code of the
// launch (0 on success).
int swin_block_int8(int x_kind, int y_kind, int cdt_bf16, int sm16, const void* x, void* y, int B,
                    int H, int W, int C, int heads, float scale, const float* xs, const float* ln1w,
                    const float* ln1b, const float* bqkv, const float* bout, const float* ln2w,
                    const float* ln2b, const float* b1, const float* b2, const int8_t* wqkv,
                    const float* sqkv, const int8_t* wout, const float* sout, const int8_t* w1,
                    const float* s1, const int8_t* w2, const float* s2, float* scratch, void* stream) {
  if (x_kind < 0 || x_kind > 2 || y_kind < 0 || y_kind > 2 || C % 64 || C % heads || (C / heads) % 16 ||
      (sm16 && !cdt_bf16))
    return (int)cudaErrorInvalidValue;
  const bool wide = is_wide(C, heads, cdt_bf16 != 0);
  if (wide != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
  Args P{x, y, x_kind, y_kind, H, W, C, heads, sm16 != 0, scale, xs,
         ln1w, ln1b, bqkv, bout, ln2w, ln2b, b1, b2, wqkv, wout, w1, w2, sqkv, sout, s1, s2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) return is_gres(C, heads, true) ? launch_wide<true>(P, B, scratch, s)
                                            : launch_wide<false>(P, B, scratch, s);
  return cdt_bf16 ? launch<true>(P, B, s) : launch<false>(P, B, s);
}

}  // extern "C"
