// Fused SwinBlock forward for Hopper (sm_90a), one thread block per 7x7 window.
//
// Replaces the TPU kernel `_swin_flat_kernel` launched by `fused_swin_block`
// (improving_yolov8_cbam_swinblock_tpu/ops/pallas/swin_kernel.py). Same
// function: LN1 (fp32 statistics) -> QKV projection -> per-head softmax
// attention inside the window -> out-projection -> residual onto the NORMED
// tokens -> LN2 -> MLP (4C, GELU) -> residual.
//
// Layout. x and y are (B, H, W, C) contiguous: the NHWC view of a
// channels_last NCHW activation. The block gathers its 49 tokens straight from
// x; rows or columns past H or W are zero tokens (the window pad of the
// reference), which take part in attention, and are not written back. So the
// pad and the crop around the block cost no pass over device memory.
// Weights are in PyTorch Linear layout (out, in) and in the I/O dtype;
// LayerNorm parameters and biases are fp32.
//
// Numerics follow the TPU kernel. All products take operands rounded to the
// I/O dtype and accumulate in fp32. qkv, the probabilities, each head's output,
// the LN2 output and the MLP hidden are rounded to the I/O dtype; the residual
// stream stays fp32. fast=1 with bf16 I/O runs the LN1 affine in bf16 and the
// tanh GELU in bf16 (each operation rounded); otherwise the LN1 affine is fp32
// and the GELU is the exact erf form.
//
// Bound. Per real token 24*C^2 FLOP of products (qkv 6, out 2, fc1 8, fc2 8)
// and 4*49*C of attention (scores and a.v over the window's 49 keys), one
// pad row's k, v once (chip_smoke.py swin_bound): 22.9 GFLOP at
// (8, 40, 40, 256), 21 us at the bf16 dense peak, against 26 MB of
// activations and weights: bound by operations. The products are 97 % of it.
//
// bf16 (every path on the card): all six products of a window run on the
// tensor cores (swin_mma.cuh: mma.sync m16n8k16 bf16 -> fp32, the 49 tokens
// padded to 64 rows, 16 warps in a 4 x 4 grid of 16 x 32 warp tiles). Each
// product's A operand is staged in shared memory as bf16, already rounded
// where the function rounds it: the LN1 output, q, the probabilities, a
// head's output, the LN2 output and a 128-column chunk of the MLP hidden.
// The weights stream from L2 (1.5 MB at C=256, resident there) through a
// 4-stage cp.async ring of 128 x 32 tiles; k and v of a head are read where
// they lie. Epilogues run on the fp32 accumulators in registers: bias (the
// biases staged in shared memory), rounding, GELU, residual. The
// out-projection is split over heads (each head's output is multiplied by
// its hd columns of Wout and added to the fp32 residual stream), so that a
// head's output needs no C-wide buffer. The window is read and written 16
// bytes per thread. Shared memory per block: the fp32 residual stream
// (49 x C), the biases (9C), the bf16 LN output (64 x C), one head's q, k,
// v (3 x 64 x hd; the MLP hidden chunk later) and the ring, over which the
// scores and probabilities lie during attention: 182 KB at C=256, 2 heads,
// so one block per SM.
//
// Wide windows (bf16 from C=384 with 2 heads: the layout above would need
// 257 KB at C=384 and 469 KB at C=768, over a block's 227 KB). One launch,
// one block per window, the same products and roundings; what stays in
// shared memory is the fp32 residual stream (49 x C, 147 KB at C=768), the
// ring (4 stages of 64-row A tiles and 64 x 32 weight tiles) and a slice of
// the attention. The LN1 and LN2 outputs go to a global scratch row block
// of the window (bf16, 49 x C, L2-resident) and stream back through the
// ring as the A operand of the qkv and fc1 products. A head's attention
// runs in 64-wide slices of its head dim: q.k^T sums the slices' products
// into the fp32 scores; then each slice of v is computed, multiplied by the
// probabilities and sent through its rows of Wout onto the residual
// stream. The biases are read from global memory in the epilogues. Only
// the order of fp32 sums differs from the narrow layout: 214 KB at C=768.
//
// fp32 (the correctness cases only): the products run on the CUDA cores in
// fp32 (64x64 output tiles, 4x4 per thread, weight tiles staged through
// shared memory) over fp32 copies of the same operands: 194 KB at C=256.
// Where the two C-wide buffers do not fit (C >= 384 with 2 heads), the
// attention output / LN2 output and a head's q|k|v live in the window's
// global scratch instead, read by the same loops: 190 KB at C=768.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "swin_mma.cuh"

namespace {

using swin_mma::bf16;
using swin_mma::MROWS;
using swin_mma::PAD;

constexpr int WS = 7;
constexpr int NTOK = WS * WS;
constexpr int NTHREADS = 256;  // the fp32 kernel's block
constexpr int NWARPS = NTHREADS / 32;
constexpr int TILE_N = 64;
constexpr int TILE_K = 32;
constexpr int WT_LD = TILE_K + 1;
constexpr int HC = 128;           // MLP hidden columns per chunk
constexpr int P_LD = MROWS + PAD;  // row stride of the bf16 probabilities
constexpr int WN = 4;             // warp columns of the tensor-core products: 16 warps in a 4 x 4 grid
constexpr int MMA_THREADS = 128 * WN;
constexpr int NT = 4;             // n8 tiles per warp: 128-column blocks
constexpr size_t RING_BYTES = swin_mma::ring_bytes<NT, false, false, WN>();
constexpr float LN_EPS = 1e-5f;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use on sm_90
constexpr int WNT = 2;               // n8 tiles per warp of the wide kernel: 64-column blocks
constexpr int DS = 64;               // head-dim slice of the wide kernel's attention
constexpr int DS_LD = DS + PAD;      // row stride of its q, k, v and output slices
constexpr size_t WIDE_RING_BYTES = swin_mma::ring_bytes<WNT, true, false, WN>();
static_assert(NTOK == swin_mma::NTOK, "one window per block");
static_assert(DS_LD == P_LD, "the probabilities share the slices' row stride");
static_assert(RING_BYTES >= sizeof(float) * NTOK * NTOK && RING_BYTES >= sizeof(bf16) * MROWS * P_LD,
              "the scores and the probabilities lie over the ring");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// round to bf16 and back to fp32
__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16(v)); }

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

// MLP activation of the fc1 output: the tanh form at bf16 with every
// operation rounded (fast mode, bf16), else the exact erf form
__device__ __forceinline__ float gelu_fwd(float pre, bool bf16_fast) {
  if (!bf16_fast) return 0.5f * pre * (1.f + erff(pre * 0.70710678118654752f));
  const float pb = bf(pre);
  float t = bf(0.044715f * pb);
  t = bf(t * pb);
  t = bf(t * pb);
  t = bf(pb + t);
  t = bf(0.7978845608f * t);
  t = bf(tanhf(t));
  t = bf(1.f + t);
  return bf(0.5f * pb) * t;
}

// Gather the window's tokens into res (NTOK x C, fp32), zero past the edge;
// bf16 x 8 channels per 16-byte load (x 16-byte aligned, C % 8 == 0)
template <typename T>
__device__ void gather_window(const T* __restrict__ x, int b, int wy, int wx, int H, int W, int C, float* res) {
  constexpr int V = 16 / sizeof(T);
  const int cv = C / V;
  for (int e = threadIdx.x; e < NTOK * cv; e += blockDim.x) {
    const int t = e / cv, c = (e % cv) * V;
    const int h = wy * WS + t / WS;
    const int w = wx * WS + t % WS;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (h < H && w < W) v = *reinterpret_cast<const uint4*>(x + (((size_t)b * H + h) * W + w) * C + c);
    const T* vt = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < V; ++i) res[t * C + c + i] = to_f(vt[i]);
  }
  __syncthreads();
}

// LN1 of the gathered rows of res in place, one warp per token; if xn is
// given, the output rounded to bf16 into xn too (row stride ldx). The
// affine runs at bf16 with every operation rounded when bf16_fast, else in
// fp32.
__device__ void ln1_rows(float* res, int C, bool bf16_fast, const float* __restrict__ lw,
                         const float* __restrict__ lb, bf16* xn, int ldx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_c = 1.f / (float)C;
  for (int t = warp; t < NTOK; t += blockDim.x >> 5) {
    float* row = res + t * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) * inv_c;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      ss += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(ss) * inv_c + LN_EPS);
    for (int c = lane; c < C; c += 32) {
      const float n = (row[c] - mean) * rstd;
      const float v = bf16_fast ? bf(bf(bf(n) * bf(lw[c])) + bf(lb[c])) : n * lw[c] + lb[c];
      row[c] = v;
      if (xn) xn[t * ldx + c] = __float2bfloat16(v);
    }
  }
  __syncthreads();
}

// LN2 (fp32 affine) of the residual stream res, rounded to O, into out
// (row stride ldo), one warp per token
template <typename O>
__device__ void ln2_window(const float* res, int C, const float* __restrict__ lw, const float* __restrict__ lb,
                           O* out, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_c = 1.f / (float)C;
  for (int t = warp; t < NTOK; t += blockDim.x >> 5) {
    const float* row = res + t * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) * inv_c;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      ss += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(ss) * inv_c + LN_EPS);
    for (int c = lane; c < C; c += 32) out[t * ldo + c] = from_f<O>((row[c] - mean) * rstd * lw[c] + lb[c]);
  }
  __syncthreads();
}

// write the window's in-range tokens of the residual stream to y, 16 bytes
// per store (y 16-byte aligned, C % 8 == 0)
template <typename T>
__device__ void store_window(const float* res, T* __restrict__ y, int b, int wy, int wx, int H, int W, int C) {
  constexpr int V = 16 / sizeof(T);
  const int cv = C / V;
  for (int e = threadIdx.x; e < NTOK * cv; e += blockDim.x) {
    const int t = e / cv, c = (e % cv) * V;
    const int h = wy * WS + t / WS;
    const int w = wx * WS + t % WS;
    if (h >= H || w >= W) continue;
    uint4 v;
    T* vt = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < V; ++i) vt[i] = from_f<T>(res[t * C + c + i]);
    *reinterpret_cast<uint4*>(y + (((size_t)b * H + h) * W + w) * C + c) = v;
  }
}

struct Identity {
  __device__ __forceinline__ int operator()(int n) const { return n; }
};

// ---------------------------------------------------------------------------
// bf16: tensor-core products
// ---------------------------------------------------------------------------

// Byte offsets of the bf16 kernel's shared memory (smem_bytes repeats its total)
struct MmaLayout {
  size_t bias, xn, head, ring, total;
  __host__ __device__ MmaLayout(int C, int heads) {
    const int hd = C / heads;
    const int head_elems = 3 * MROWS * (hd + PAD) > MROWS * (HC + PAD) ? 3 * MROWS * (hd + PAD) : MROWS * (HC + PAD);
    bias = sizeof(float) * NTOK * C;               // after the fp32 residual stream
    xn = bias + sizeof(float) * 9 * C;             // after bqkv, bout, b1, b2 (fp32)
    head = xn + sizeof(bf16) * MROWS * (C + PAD);  // after the bf16 LN output
    ring = head + sizeof(bf16) * head_elems;
    total = ring + RING_BYTES;
  }
};

// Softmax of each row of the scores sc (NTOK x NTOK fp32), one warp per row,
// into the probabilities p (MROWS x P_LD bf16, rounded; zero past column and
// row NTOK). p lies over sc: each warp holds its rows in registers across a
// barrier. Ends with a barrier.
__device__ void softmax_rows(const float* sc, bf16* p) {
  constexpr int RPW = (NTOK + MMA_THREADS / 32 - 1) / (MMA_THREADS / 32);  // rows per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool two = lane + 32 < NTOK;
  float p0[RPW], p1[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int t = warp + i * (MMA_THREADS / 32);
    p0[i] = p1[i] = 0.f;
    if (t < NTOK) {  // warp-uniform
      const float v0 = sc[t * NTOK + lane];
      const float v1 = two ? sc[t * NTOK + lane + 32] : v0;
      const float m = warp_max(fmaxf(v0, v1));
      const float e0 = expf(v0 - m);
      const float e1 = two ? expf(v1 - m) : 0.f;
      const float s = warp_sum(e0 + e1);
      p0[i] = e0 / s;
      p1[i] = two ? e1 / s : 0.f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int t = warp + i * (MMA_THREADS / 32);
    if (t < NTOK) {
      p[t * P_LD + lane] = __float2bfloat16(p0[i]);
      p[t * P_LD + lane + 32] = __float2bfloat16(p1[i]);
    }
  }
  for (int e = threadIdx.x; e < (MROWS - NTOK) * P_LD; e += MMA_THREADS) p[NTOK * P_LD + e] = __float2bfloat16(0.f);
  __syncthreads();
}

__global__ void __launch_bounds__(MMA_THREADS)
    swin_block_fwd_mma_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int H, int W, int C, int heads,
                              int fast, float scale, const float* __restrict__ ln1w,
                              const float* __restrict__ ln1b, const bf16* __restrict__ wqkv,
                              const float* __restrict__ bqkv, const bf16* __restrict__ wout,
                              const float* __restrict__ bout, const float* __restrict__ ln2w,
                              const float* __restrict__ ln2b, const bf16* __restrict__ w1,
                              const float* __restrict__ b1, const bf16* __restrict__ w2,
                              const float* __restrict__ b2) {
  using swin_mma::product_smem;
  using swin_mma::product_stream;
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaLayout L(C, heads);
  const int hd = C / heads;
  const int ldx = C + PAD;   // row stride of the bf16 LN output
  const int ldh = hd + PAD;  // row stride of q, k, v and a head's output
  const int ldm = HC + PAD;  // row stride of the MLP hidden chunk
  float* res = reinterpret_cast<float*>(smem);         // LN1 output, then the residual stream (fp32)
  float* bqkv_s = reinterpret_cast<float*>(smem + L.bias);  // the biases, read by the epilogues
  float* bout_s = bqkv_s + 3 * C;
  float* b1_s = bout_s + C;
  float* b2_s = b1_s + 4 * C;
  bf16* xn = reinterpret_cast<bf16*>(smem + L.xn);     // LN1 output, then LN2 output (bf16)
  bf16* q_s = reinterpret_cast<bf16*>(smem + L.head);  // q, then the head's output
  bf16* k_s = q_s + MROWS * ldh;
  bf16* v_s = k_s + MROWS * ldh;
  bf16* hid = q_s;  // the MLP hidden chunk, after attention
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* sc = reinterpret_cast<float*>(ring);  // one head's scores, then its probabilities, between products
  bf16* p_s = ring;

  // zero everything once: pad rows are never stored, and v's must be zero
  // (the pad columns of p multiply them)
  for (size_t e = threadIdx.x; e < L.total / 16; e += MMA_THREADS) reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int nwh = (H + WS - 1) / WS;
  const int nww = (W + WS - 1) / WS;
  const int b = blockIdx.x / (nwh * nww);
  const int wy = (blockIdx.x / nww) % nwh;
  const int wx = blockIdx.x % nww;
  const bool bf16_fast = fast != 0;

  for (int e = threadIdx.x; e < 9 * C; e += MMA_THREADS)
    bqkv_s[e] = e < 3 * C ? bqkv[e] : e < 4 * C ? bout[e - 3 * C] : e < 8 * C ? b1[e - 4 * C] : b2[e - 8 * C];
  gather_window(x, b, wy, wx, H, W, C, res);
  ln1_rows(res, C, bf16_fast, ln1w, ln1b, xn, ldx);

  for (int hh = 0; hh < heads; ++hh) {
    // columns [0, hd) q, [hd, 2hd) k, [2hd, 3hd) v of this head
    auto qkv_row = [=](int n) {
      const int seg = (n >= hd) + (n >= 2 * hd);
      return seg * C + hh * hd + (n - seg * hd);
    };
    product_stream<NT, false, false, 0, WN>(xn, ldx, C, wqkv, C, 0, 3 * hd, qkv_row, ring,
                                             [&](int r, int n, float acc) {
                                               const int seg = (n >= hd) + (n >= 2 * hd);
                                               q_s[seg * MROWS * ldh + r * ldh + (n - seg * hd)] =
                                                   __float2bfloat16(acc + bqkv_s[qkv_row(n)]);
                                             });
    product_smem<NT, false, WN>(q_s, ldh, k_s, ldh, hd, NTOK,
                            [&](int r, int n, float acc) { sc[r * NTOK + n] = acc * scale; });
    softmax_rows(sc, p_s);
    product_smem<NT, true, WN>(p_s, P_LD, v_s, ldh, MROWS, hd,
                           [&](int r, int n, float acc) { q_s[r * ldh + n] = __float2bfloat16(acc); });
    // out-projection of this head's columns; residual onto the normed tokens
    product_stream<NT, false, false, 0, WN>(q_s, ldh, hd, wout, C, hh * hd, C, Identity(), ring,
                                             [&](int r, int n, float acc) {
                                               float& v = res[r * C + n];
                                               v = hh == 0 ? v + (acc + bout_s[n]) : v + acc;
                                             });
  }

  // the hidden chunk's pad rows lie where q, k, v were
  for (int e = threadIdx.x; e < (MROWS - NTOK) * ldm; e += MMA_THREADS) hid[NTOK * ldm + e] = __float2bfloat16(0.f);
  ln2_window(res, C, ln2w, ln2b, xn, ldx);

  // ---- MLP in hidden chunks; fc2 accumulates onto the residual stream ----
  for (int h0 = 0; h0 < 4 * C; h0 += HC) {
    product_stream<NT, false, false, 0, WN>(
        xn, ldx, C, w1, C, 0, HC, [=](int n) { return h0 + n; }, ring, [&](int r, int n, float acc) {
          hid[r * ldm + n] = __float2bfloat16(gelu_fwd(acc + b1_s[h0 + n], bf16_fast));
        });
    product_stream<NT, false, false, 0, WN>(hid, ldm, HC, w2, 4 * C, h0, C, Identity(), ring,
                                             [&](int r, int n, float acc) {
                                               res[r * C + n] += h0 == 0 ? acc + b2_s[n] : acc;
                                             });
  }
  store_window(res, y, b, wy, wx, H, W, C);
}

// ---------------------------------------------------------------------------
// bf16, wide windows: the LN outputs in global scratch, attention in slices
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t up16(size_t v) { return (v + 15) / 16 * 16; }

// Byte offsets of the wide kernel's shared memory (smem_bytes repeats its total)
struct WideLayout {
  size_t ring, attn, total;
  __host__ __device__ explicit WideLayout(int C) {
    const size_t qk = sizeof(bf16) * 2 * MROWS * DS_LD + sizeof(float) * NTOK * NTOK;  // q and k slices, scores
    const size_t hid = sizeof(bf16) * MROWS * (HC + PAD);                               // the MLP hidden chunk
    ring = sizeof(float) * NTOK * C;  // after the fp32 residual stream
    attn = ring + WIDE_RING_BYTES;
    total = attn + up16(qk > hid ? qk : hid);
  }
};

__global__ void __launch_bounds__(MMA_THREADS)
    swin_block_fwd_wide_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int H, int W, int C, int heads,
                               int fast, float scale, const float* __restrict__ ln1w,
                               const float* __restrict__ ln1b, const bf16* __restrict__ wqkv,
                               const float* __restrict__ bqkv, const bf16* __restrict__ wout,
                               const float* __restrict__ bout, const float* __restrict__ ln2w,
                               const float* __restrict__ ln2b, const bf16* __restrict__ w1,
                               const float* __restrict__ b1, const bf16* __restrict__ w2,
                               const float* __restrict__ b2, bf16* __restrict__ scratch) {
  using swin_mma::product_smem;
  using swin_mma::product_stream;
  extern __shared__ __align__(16) unsigned char smem[];
  const WideLayout L(C);
  const int hd = C / heads;
  constexpr int ldm = HC + PAD;  // row stride of the MLP hidden chunk
  float* res = reinterpret_cast<float*>(smem);  // LN1 output, then the residual stream (fp32)
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L.attn);       // a slice of q, then of v
  bf16* k_s = q_s + MROWS * DS_LD;                          // a slice of k, then of the head's output
  float* sc = reinterpret_cast<float*>(k_s + MROWS * DS_LD);  // the head's scores, then its probabilities
  bf16* p_s = reinterpret_cast<bf16*>(sc);
  bf16* hid = q_s;  // the MLP hidden chunk, after attention
  bf16* xg = scratch + (size_t)blockIdx.x * NTOK * C;  // the window's LN1, then LN2 output (bf16, 49 x C)

  // zero the attention slices once: pad rows are never stored, and v's must
  // be zero (the pad columns of p multiply them)
  for (size_t e = threadIdx.x; e < (L.total - L.attn) / 16; e += MMA_THREADS)
    reinterpret_cast<uint4*>(smem + L.attn)[e] = make_uint4(0, 0, 0, 0);

  const int nwh = (H + WS - 1) / WS;
  const int nww = (W + WS - 1) / WS;
  const int b = blockIdx.x / (nwh * nww);
  const int wy = (blockIdx.x / nww) % nwh;
  const int wx = blockIdx.x % nww;
  const bool bf16_fast = fast != 0;

  gather_window(x, b, wy, wx, H, W, C, res);
  ln1_rows(res, C, bf16_fast, ln1w, ln1b, xg, C);  // its barrier makes xg visible to the ring's copies

  for (int hh = 0; hh < heads; ++hh) {
    // scores: the slices' q.k^T summed in fp32, scaled after the last
    for (int d0 = 0; d0 < hd; d0 += DS) {
      const int dn = min(DS, hd - d0);
      const bool last = d0 + dn == hd;
      auto qk_row = [=](int n) { return n < dn ? hh * hd + d0 + n : C + hh * hd + d0 + (n - dn); };
      product_stream<WNT, true, false, 0, WN>(xg, C, C, wqkv, C, 0, 2 * dn, qk_row, ring,
                                               [&](int r, int n, float acc) {
                                                 bf16* dst = n < dn ? q_s + r * DS_LD + n : k_s + r * DS_LD + n - dn;
                                                 *dst = __float2bfloat16(acc + bqkv[qk_row(n)]);
                                               });
      product_smem<WNT, false, WN>(q_s, DS_LD, k_s, DS_LD, dn, NTOK, [&](int r, int n, float acc) {
        float& s = sc[r * NTOK + n];
        const float t = d0 == 0 ? acc : s + acc;
        s = last ? t * scale : t;
      });
    }
    softmax_rows(sc, p_s);
    // each slice of v: its output columns, then their share of the out-projection
    for (int d0 = 0; d0 < hd; d0 += DS) {
      const int dn = min(DS, hd - d0);
      const int c0 = hh * hd + d0;  // the slice's first column of v and of the heads' output
      product_stream<WNT, true, false, 0, WN>(xg, C, C, wqkv, C, 0, dn, [=](int n) { return 2 * C + c0 + n; }, ring,
                                               [&](int r, int n, float acc) {
                                                 q_s[r * DS_LD + n] = __float2bfloat16(acc + bqkv[2 * C + c0 + n]);
                                               });
      product_smem<WNT, true, WN>(p_s, P_LD, q_s, DS_LD, MROWS, dn,
                                  [&](int r, int n, float acc) { k_s[r * DS_LD + n] = __float2bfloat16(acc); });
      product_stream<WNT, false, false, 0, WN>(k_s, DS_LD, dn, wout, C, c0, C, Identity(), ring,
                                                [&](int r, int n, float acc) {
                                                  float& v = res[r * C + n];
                                                  v = c0 == 0 ? v + (acc + bout[n]) : v + acc;
                                                });
    }
  }

  // the hidden chunk's pad rows lie where the slices were
  for (int e = threadIdx.x; e < (MROWS - NTOK) * ldm; e += MMA_THREADS) hid[NTOK * ldm + e] = __float2bfloat16(0.f);
  ln2_window(res, C, ln2w, ln2b, xg, C);

  // ---- MLP in hidden chunks; fc2 accumulates onto the residual stream ----
  for (int h0 = 0; h0 < 4 * C; h0 += HC) {
    product_stream<WNT, true, false, 0, WN>(
        xg, C, C, w1, C, 0, HC, [=](int n) { return h0 + n; }, ring, [&](int r, int n, float acc) {
          hid[r * ldm + n] = __float2bfloat16(gelu_fwd(acc + b1[h0 + n], bf16_fast));
        });
    product_stream<WNT, false, false, 0, WN>(hid, ldm, HC, w2, 4 * C, h0, C, Identity(), ring,
                                              [&](int r, int n, float acc) {
                                                res[r * C + n] += h0 == 0 ? acc + b2[n] : acc;
                                              });
  }
  store_window(res, y, b, wy, wx, H, W, C);
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core products
// ---------------------------------------------------------------------------

// out[r, n] = sum_k A[r, k] * W[wrow(n) * ldw + koff + k] for r < NTOK,
// n < N, handed to epi(r, n, acc). A is in shared memory (lda), W in global
// memory. K is a multiple of TILE_K. Ends with a barrier, so the
// epilogue's writes are visible to the next phase.
template <typename RowMap, typename Epi>
__device__ void block_gemm(const float* A, int lda, int K, const float* __restrict__ W, int ldw, int koff, int N,
                           RowMap wrow, float* wt, Epi epi) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int n0 = 0; n0 < N; n0 += TILE_N) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += TILE_K) {
      __syncthreads();  // the previous tile has been consumed
      for (int e = threadIdx.x; e < TILE_N * TILE_K; e += NTHREADS) {
        const int c = e / TILE_K;
        const int kk = e % TILE_K;
        const int n = n0 + c;
        wt[c * WT_LD + kk] = n < N ? W[(size_t)wrow(n) * ldw + koff + k0 + kk] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < TILE_K; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
          a[i] = r < NTOK ? A[r * lda + k0 + kk] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = wt[(tx + 16 * j) * WT_LD + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (r < NTOK && n < N) epi(r, n, acc[i][j]);
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS)
    swin_block_fwd_f32_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W, int C, int heads,
                              float scale, const float* __restrict__ ln1w, const float* __restrict__ ln1b,
                              const float* __restrict__ wqkv, const float* __restrict__ bqkv,
                              const float* __restrict__ wout, const float* __restrict__ bout,
                              const float* __restrict__ ln2w, const float* __restrict__ ln2b,
                              const float* __restrict__ w1, const float* __restrict__ b1,
                              const float* __restrict__ w2, const float* __restrict__ b2, float* scratch) {
  extern __shared__ float smem_f[];
  const int hd = C / heads;
  const int ldq = 3 * hd + 1;  // odd stride: rows of k and v fall in distinct banks
  float* xn_s = smem_f;  // normed tokens, then the fp32 residual stream
  float *o_s, *p_s, *wt_s, *q_s, *hid_s;
  if (scratch == nullptr) {
    o_s = xn_s + NTOK * C;        // attention output, then the LN2 output
    p_s = o_s + NTOK * C;         // one head's probabilities
    wt_s = p_s + NTOK * NTOK;     // weight tile
    q_s = wt_s + TILE_N * WT_LD;  // one head's q|k|v, then an MLP hidden chunk
    hid_s = q_s;
  } else {  // wide: the attention / LN2 output and q|k|v in the window's global scratch
    p_s = xn_s + NTOK * C;
    wt_s = p_s + NTOK * NTOK;
    hid_s = wt_s + TILE_N * WT_LD;
    o_s = scratch + (size_t)blockIdx.x * NTOK * (C + ldq);
    q_s = o_s + NTOK * C;
  }

  const int nwh = (H + WS - 1) / WS;
  const int nww = (W + WS - 1) / WS;
  const int b = blockIdx.x / (nwh * nww);
  const int wy = (blockIdx.x / nww) % nwh;
  const int wx = blockIdx.x % nww;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  gather_window(x, b, wy, wx, H, W, C, xn_s);
  ln1_rows(xn_s, C, false, ln1w, ln1b, nullptr, 0);

  // ---- attention, one head at a time ----
  for (int hh = 0; hh < heads; ++hh) {
    // columns [0, hd) q, [hd, 2hd) k, [2hd, 3hd) v of this head
    auto qkv_row = [=](int n) {
      const int seg = n / hd;
      return seg * C + hh * hd + (n - seg * hd);
    };
    block_gemm(xn_s, C, C, wqkv, C, 0, 3 * hd, qkv_row, wt_s,
               [&](int r, int n, float acc) { q_s[r * ldq + n] = acc + bqkv[qkv_row(n)]; });
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
      o_s[i * C + hh * hd + d] = s;
    }
    __syncthreads();
  }

  // ---- out-projection; residual onto the normed tokens ----
  block_gemm(o_s, C, C, wout, C, 0, C, Identity(), wt_s,
             [&](int r, int n, float acc) { xn_s[r * C + n] = xn_s[r * C + n] + (acc + bout[n]); });

  ln2_window(xn_s, C, ln2w, ln2b, o_s, C);

  // ---- MLP in hidden chunks; fc2 accumulates onto the residual stream ----
  for (int h0 = 0; h0 < 4 * C; h0 += HC) {
    block_gemm(o_s, C, C, w1, C, 0, HC, [=](int n) { return h0 + n; }, wt_s,
               [&](int r, int n, float acc) { hid_s[r * HC + n] = gelu_fwd(acc + b1[h0 + n], false); });
    block_gemm(hid_s, HC, HC, w2, 4 * C, h0, C, Identity(), wt_s,
               [&](int r, int n, float acc) { xn_s[r * C + n] += h0 == 0 ? acc + b2[n] : acc; });
  }
  store_window(xn_s, y, b, wy, wx, H, W, C);
}

// bytes of shared memory per block of the narrow layouts, which keep the
// whole window resident
size_t narrow_smem_bytes(int dtype, int C, int heads) {
  if (dtype == 1) return MmaLayout(C, heads).total;
  const int hd = C / heads;
  const int q = NTOK * (3 * hd + 1) > NTOK * HC ? NTOK * (3 * hd + 1) : NTOK * HC;
  return sizeof(float) * ((size_t)2 * NTOK * C + NTOK * NTOK + TILE_N * WT_LD + q);
}

// the wide layout serves the shapes whose narrow one exceeds the block's limit
bool is_wide(int dtype, int C, int heads) { return narrow_smem_bytes(dtype, C, heads) > MAX_SMEM; }

// bytes of shared memory per block (exported as swin_block_fwd_smem_bytes)
size_t smem_bytes(int dtype, int C, int heads) {
  if (!is_wide(dtype, C, heads)) return narrow_smem_bytes(dtype, C, heads);
  if (dtype == 1) return WideLayout(C).total;
  return sizeof(float) * ((size_t)NTOK * C + NTOK * NTOK + TILE_N * WT_LD + NTOK * HC);
}

// bytes of global scratch per window (0 for the narrow layouts): bf16 the
// LN output (49 x C); fp32 the attention / LN2 output and one head's q|k|v
size_t scratch_bytes_per_window(int dtype, int C, int heads) {
  if (!is_wide(dtype, C, heads)) return 0;
  if (dtype == 1) return sizeof(bf16) * NTOK * C;
  return sizeof(float) * NTOK * ((size_t)C + 3 * (C / heads) + 1);
}

template <typename K, typename T, typename... Args>
int launch(K kernel, int threads, int dtype, const void* x, void* y, int B, int H, int W, int C, int heads,
           cudaStream_t stream, Args... args) {
  const size_t smem = smem_bytes(dtype, C, heads);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * ((H + WS - 1) / WS) * ((W + WS - 1) / WS);
  kernel<<<blocks, threads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(y), H, W, C, heads, args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one block of the kernel for this dtype (0 = float32,
// 1 = bfloat16) takes at this C and head count.
size_t swin_block_fwd_smem_bytes(int dtype, int C, int heads) { return smem_bytes(dtype, C, heads); }

// Bytes of global scratch a launch at this shape needs (0 where the window
// stays in shared memory); the caller passes that many bytes as `scratch`.
size_t swin_block_fwd_scratch_bytes(int dtype, int B, int H, int W, int C, int heads) {
  return (size_t)B * ((H + WS - 1) / WS) * ((W + WS - 1) / WS) * scratch_bytes_per_window(dtype, C, heads);
}

// dtype: 0 = float32, 1 = bfloat16 (x, y and the four weight matrices).
// scratch: swin_block_fwd_scratch_bytes of device memory, or null where that
// is 0. Returns the CUDA error code of the launch (0 on success).
int swin_block_fwd(int dtype, const void* x, void* y, int B, int H, int W, int C, int heads,
                   int fast, const float* ln1w, const float* ln1b, const void* wqkv,
                   const float* bqkv, const void* wout, const float* bout, const float* ln2w,
                   const float* ln2b, const void* w1, const float* b1, const void* w2,
                   const float* b2, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf((float)(C / heads));
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool wide = is_wide(dtype, C, heads);
  if (wide != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<decltype(&swin_block_fwd_f32_kernel), float>(
        swin_block_fwd_f32_kernel, NTHREADS, dtype, x, y, B, H, W, C, heads, s, scale, ln1w, ln1b,
        static_cast<const float*>(wqkv), bqkv, static_cast<const float*>(wout), bout, ln2w, ln2b,
        static_cast<const float*>(w1), b1, static_cast<const float*>(w2), b2, static_cast<float*>(scratch));
  if (C % 32 || (C / heads) % 16) return (int)cudaErrorInvalidValue;  // the tensor-core tiles
  if (wide)
    return launch<decltype(&swin_block_fwd_wide_kernel), bf16>(
        swin_block_fwd_wide_kernel, MMA_THREADS, dtype, x, y, B, H, W, C, heads, s, fast, scale, ln1w, ln1b,
        static_cast<const bf16*>(wqkv), bqkv, static_cast<const bf16*>(wout), bout, ln2w, ln2b,
        static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2, static_cast<bf16*>(scratch));
  return launch<decltype(&swin_block_fwd_mma_kernel), bf16>(
      swin_block_fwd_mma_kernel, MMA_THREADS, dtype, x, y, B, H, W, C, heads, s, fast, scale, ln1w, ln1b,
      static_cast<const bf16*>(wqkv), bqkv, static_cast<const bf16*>(wout), bout, ln2w, ln2b,
      static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2);
}

}  // extern "C"
