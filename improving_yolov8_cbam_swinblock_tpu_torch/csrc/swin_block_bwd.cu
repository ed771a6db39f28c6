// SwinBlock backward for Hopper (sm_90a): dx and the 12 parameter grads.
//
// Replaces the TPU kernel `_swin_flat_bwd_kernel` launched by
// `_fused_swin_bwd_call` under the custom_vjp `fused_swin_block_ad`
// (improving_yolov8_cbam_swinblock_tpu/ops/pallas/swin_kernel.py). Same
// function: recompute the exact forward (fp32 LN1 affine, erf GELU), then
// chain the grads through the MLP, LN2, the out-projection, the window
// attention, the QKV projection and LN1, with the JAX kernel's roundings: xn,
// qkv, the probabilities, head outputs, y1n and h, and gh, dpre, dout, do, ds
// and dqkv are rounded to the I/O dtype, every sum is fp32.
//
// Layout. x, g and dx are (B, H, W, C) contiguous (the NHWC view of a
// channels_last activation). One block per 7x7 window gathers its tokens
// straight from x; rows or columns past H or W are zero tokens with a zero
// incoming grad, exactly the zero pad the reference puts around the block.
// Pad tokens still act as keys and values of their window, so their k and v
// grads reach dWqkv, dbqkv and dln1_b; their dx is dropped.
//
// Launches:
//   1. swin_bwd_window_kernel, one block per window: forward recompute and the
//      chain of grads, with the window's activations in a global workspace
//      (one window at C=256 holds ~570 KB of fp32 state, far over a block's
//      227 KB of shared memory; shared memory holds the product tiles and one
//      head's q, k, v, do and probabilities). It writes dx, each token's
//      operands of the weight-grad products (in the I/O dtype, already
//      rounded) and each window's partial sums of the 8 vector grads.
//   2. the weight-grad kernel x4: dW = G^T X over all tokens of all windows
//      for wqkv, wout, w1 and w2, split over chunks of 1024 tokens, each
//      chunk's partial product written to its own slice (no atomics).
//   3. swin_bwd_sum_kernel x2: the chunks' and the windows' partials summed in a
//      fixed order. The result does not depend on the order in which blocks
//      run; it differs from the JAX kernel's band-sequential sum only in fp32
//      rounding.
//
// Bound. Per real token 64*C^2 FLOP of products (the forward recomputed as
// far as the grads need it, qkv, out and fc1: 16 C^2; the dX products
// gh W2, dpre W1, dout Wout, dqkv Wqkv: 24 C^2; the dW products over all
// tokens: 24 C^2) plus 12*49*C of window attention (scores, a.v, dv, da,
// dq, dk); pad tokens add their k, v work once (chip_smoke.py
// swin_bwd_bound). At B=16 and 40x40x256 that is 111 GFLOP: 0.11 ms at the
// bf16 dense peak, bound by operations. The products are 96 % of it.
//
// bf16 (the train path): every product runs on the tensor cores
// (swin_mma.cuh: mma.sync m16n8k16 bf16 -> fp32). The window kernel's seven
// products (qkv, out, fc1; gh W2, dpre W1, dout Wout, dqkv Wqkv) take their
// A operand from the window's bf16 workspace rows and their weights from L2,
// both through a 4-stage cp.async ring (64-row A tiles, 128-column B tiles,
// 32 deep; the TRANS products read the weights k-major through
// ldmatrix.trans); 8 warps in a 4 x 2 grid of 16 x 64 warp tiles. The
// epilogues' reads (biases, the fp32 pre-activation, the residual) are
// loaded for a whole fragment before its epilogue runs, so that their
// latencies overlap. The weight-grad products run as a GEMM of 128 x 128
// block tiles over each 1024-token chunk, both token-major operands through
// ldmatrix.trans. The attention's per-head products stay scalar fp32 loops
// (3.5 % of the FLOPs), over a head's dims in slices of up to 128 (HS):
// the scores and da sum the slices' dots in fp32, the other attention
// products take their slice's columns, so a head of any width fits in
// shared memory (121 KB at C=768 with 2 heads; one slice, and the same
// sums as before, where the head dim is at most 128). The workspace keeps
// its layout: 0.71 GB per launch at (16, 40, 40, 256), written once and
// read back.
//
// fp32 (the correctness cases only): the products run on the CUDA cores
// (64x64 output tiles, 4x4 per thread, operand tiles staged in shared
// memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "swin_mma.cuh"

namespace {

using swin_mma::PAD;

constexpr int WS = 7;
constexpr int NTOK = WS * WS;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TILE_N = 64;
constexpr int TILE_K = 32;
constexpr int LD = TILE_K + 1;
constexpr int TG_T = 32;        // tokens per tgemm tile
constexpr int TG_LD = 64 + 1;
constexpr int TG_CHUNK = 1024;  // tokens per tgemm split
constexpr int NT = 8;           // n8 tiles per warp in the window's tensor-core products
constexpr int RSTD = 2 * NTOK + 2;  // floats before the product tiles: LN1 and LN2 1/std, 16-byte aligned after
constexpr int HS = 128;         // widest slice of a head's dims in the attention's shared memory
constexpr int WG_TILE = 128;    // bf16 weight-grad block tile: 128 x 128 of dW
constexpr int WG_LD = WG_TILE + PAD;
constexpr int WG_STAGE = 2 * swin_mma::KT * WG_LD;  // a G tile and an X tile, KT tokens each
constexpr size_t WG_SMEM = sizeof(__nv_bfloat16) * swin_mma::STAGES * WG_STAGE;
static_assert(NTOK == swin_mma::NTOK && NTHREADS == swin_mma::NTHREADS, "one window per block of 256 threads");
static_assert(TG_CHUNK % swin_mma::KT == 0, "a token chunk is whole ring stages");
static_assert(swin_mma::ring_bytes<NT, true, false>() >= swin_mma::ring_bytes<NT, true, true>(),
              "the window's ring is sized for its n-major products");
constexpr float LN_EPS = 1e-5f;
constexpr float INV_SQRT2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.39894228040143268f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round to the I/O dtype and back to fp32
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

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

__device__ __forceinline__ float gelu(float x) { return 0.5f * x * (1.f + erff(x * INV_SQRT2)); }

__device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * INV_SQRT2)) + x * (expf(-0.5f * x * x) * INV_SQRT_2PI);
}

struct Identity {
  __device__ __forceinline__ int operator()(int n) const { return n; }
};

// out[r, n] = sum_k A[r * lda + k] * Wel(n, k) for r < NTOK, n < N, handed to
// epi(r, n, acc, side values...); Wel(n, k) = W[n * ldw + k], or
// W[k * ldw + n] with TRANS. The epilogue takes NSIDE side inputs s1, s2
// (swin_mma.cuh Side: a workspace row or a bias). A and W are in global
// memory; K is a multiple of TILE_K. bf16 runs on the tensor cores, both
// operands streamed through the cp.async ring at `tiles` (swin_mma.cuh),
// the side inputs of a fragment loaded together; fp32 on the CUDA cores,
// operand tiles converted in shared memory. Ends with a barrier.
template <bool TRANS, int NSIDE = 0, typename T, typename Epi>
__device__ void gemm49(const T* __restrict__ A, int lda, int K, const T* __restrict__ W, int ldw, int N,
                       float* tiles, Epi epi, swin_mma::Side s1 = swin_mma::Side(),
                       swin_mma::Side s2 = swin_mma::Side()) {
  if constexpr (sizeof(T) == 2) {
    swin_mma::product_stream<NT, true, TRANS, NSIDE>(
        A, lda, K, W, ldw, 0, N, Identity(), reinterpret_cast<T*>(tiles), epi, s1, s2);
  } else {
  float* as = tiles;
  float* wt = tiles + 64 * LD;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int n0 = 0; n0 < N; n0 += TILE_N) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += TILE_K) {
      __syncthreads();  // the previous tiles have been consumed
      for (int e = threadIdx.x; e < NTOK * TILE_K; e += NTHREADS) {
        const int r = e / TILE_K;
        const int kk = e % TILE_K;
        as[r * LD + kk] = to_f(A[(size_t)r * lda + k0 + kk]);
      }
      for (int e = threadIdx.x; e < TILE_N * TILE_K; e += NTHREADS) {
        const int c = TRANS ? e % TILE_N : e / TILE_K;
        const int kk = TRANS ? e / TILE_N : e % TILE_K;
        const int n = n0 + c;
        float v = 0.f;
        if (n < N) v = to_f(TRANS ? W[(size_t)(k0 + kk) * ldw + n] : W[(size_t)n * ldw + k0 + kk]);
        wt[c * LD + kk] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < TILE_K; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
          a[i] = r < NTOK ? as[r * LD + kk] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = wt[(tx + 16 * j) * LD + kk];
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
        if (r >= NTOK || n >= N) continue;
        if constexpr (NSIDE == 0) epi(r, n, acc[i][j]);
        else if constexpr (NSIDE == 1) epi(r, n, acc[i][j], s1.p[(size_t)r * s1.ld + n]);
        else epi(r, n, acc[i][j], s1.p[(size_t)r * s1.ld + n], s2.p[(size_t)r * s2.ld + n]);
      }
    }
  }
  __syncthreads();
  }
}

// Workspace of one launch. Token-major buffers hold row w*49 + t for token t
// of window w. The T buffers are the operands of the weight-grad products.
template <typename T>
struct Work {
  T *xn, *qkv, *o, *y1n, *h, *gh, *dpre, *dout, *dob, *dqkv;  // C, 3C, C, C, 4C, C, 4C, C, C, 3C
  float *yhat1, *y1, *yhat2, *pre, *dy1n, *dqkv32;           // C, C, C, 4C, C, 3C
  float *a32;    // (windows, heads, 49, 49) probabilities
  float *vpart;  // (windows, 13C) partial sums of the vector grads
};

// offsets of the vector grads in a 13C row
struct VOff {
  int ln1w, ln1b, bqkv, bout, ln2w, ln2b, b1, b2;
  __host__ __device__ explicit VOff(int C)
      : ln1w(0), ln1b(C), bqkv(2 * C), bout(5 * C), ln2w(6 * C), ln2b(7 * C), b1(8 * C), b2(12 * C) {}
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    swin_bwd_window_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx, int H, int W,
                      int C, int heads, float scale, const float* __restrict__ ln1w,
                      const float* __restrict__ ln1b, const T* __restrict__ wqkv,
                      const float* __restrict__ bqkv, const T* __restrict__ wout,
                      const float* __restrict__ bout, const float* __restrict__ ln2w,
                      const float* __restrict__ ln2b, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const float* __restrict__ b2, Work<T> wk) {
  extern __shared__ __align__(16) float smem[];
  const int hd = C / heads;
  const int hl = min(hd, HS) + 1;  // row stride of the attention's slices
  float* rstd1 = smem;
  float* rstd2 = smem + NTOK;
  float* big = smem + RSTD;
  float* q_s = big;            // attention: a slice of one head's q, k, v, do and two 49x49 planes
  float* k_s = q_s + NTOK * hl;
  float* v_s = k_s + NTOK * hl;
  float* d_s = v_s + NTOK * hl;
  float* pa_s = d_s + NTOK * hl;
  float* pb_s = pa_s + NTOK * NTOK;

  const int nwh = (H + WS - 1) / WS;
  const int nww = (W + WS - 1) / WS;
  const int win = blockIdx.x;
  const int b = win / (nwh * nww);
  const int wy = (win / nww) % nwh;
  const int wx = win % nww;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float inv_c = 1.f / (float)C;
  const int C3 = 3 * C, C4 = 4 * C;
  const VOff vo(C);

  const size_t t0 = (size_t)win * NTOK;
  T* xn = wk.xn + t0 * C;
  T* qkv = wk.qkv + t0 * C3;
  T* o = wk.o + t0 * C;
  T* y1n = wk.y1n + t0 * C;
  T* hb = wk.h + t0 * C4;
  T* gh = wk.gh + t0 * C;
  T* dpre = wk.dpre + t0 * C4;
  T* dout = wk.dout + t0 * C;
  T* dob = wk.dob + t0 * C;
  T* dqkv = wk.dqkv + t0 * C3;
  float* yhat1 = wk.yhat1 + t0 * C;
  float* y1 = wk.y1 + t0 * C;  // xn32, then y1, then dy1, then dxn
  float* yhat2 = wk.yhat2 + t0 * C;
  float* pre = wk.pre + t0 * C4;  // pre-activation, then dpre (fp32)
  float* dy1n = wk.dy1n + t0 * C;
  float* dqkv32 = wk.dqkv32 + t0 * C3;
  float* a32 = wk.a32 + (size_t)win * heads * NTOK * NTOK;
  float* vp = wk.vpart + (size_t)win * 13 * C;

  auto token_hw = [&](int t, int& h, int& w) {
    h = wy * WS + t / WS;
    w = wx * WS + t % WS;
    return h < H && w < W;
  };

  // ---- forward: LN1 (one warp per token) ----
  for (int t = warp; t < NTOK; t += NWARPS) {
    int h, w;
    const bool in = token_hw(t, h, w);
    const T* src = x + (((size_t)b * H + h) * W + w) * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += in ? to_f(src[c]) : 0.f;
    const float mean = warp_sum(s) * inv_c;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = (in ? to_f(src[c]) : 0.f) - mean;
      ss += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(ss) * inv_c + LN_EPS);
    if (lane == 0) rstd1[t] = rstd;
    for (int c = lane; c < C; c += 32) {
      const float yh = ((in ? to_f(src[c]) : 0.f) - mean) * rstd;
      const float v = yh * ln1w[c] + ln1b[c];
      yhat1[t * C + c] = yh;
      y1[t * C + c] = v;
      xn[t * C + c] = from_f<T>(v);
    }
  }
  __syncthreads();

  // ---- qkv = xn Wqkv^T + b, rounded ----
  gemm49<false, 1>(
      xn, C, C, wqkv, C, C3, big, [&](int r, int n, float acc, float b) { qkv[r * C3 + n] = from_f<T>(acc + b); },
      {bqkv, 0});

  // ---- attention, one head at a time, over slices of its dims ----
  for (int hh = 0; hh < heads; ++hh) {
    // scores: the slices' q.k^T dots summed in fp32
    for (int d0 = 0; d0 < hd; d0 += HS) {
      const int dn = min(HS, hd - d0);
      for (int e = threadIdx.x; e < NTOK * dn; e += NTHREADS) {
        const int i = e / dn, d = e % dn;
        q_s[i * hl + d] = to_f(qkv[i * C3 + hh * hd + d0 + d]);
        k_s[i * hl + d] = to_f(qkv[i * C3 + C + hh * hd + d0 + d]);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < NTOK * NTOK; e += NTHREADS) {
        const float* qi = q_s + (e / NTOK) * hl;
        const float* kj = k_s + (e % NTOK) * hl;
        float s = 0.f;
        for (int d = 0; d < dn; ++d) s = fmaf(qi[d], kj[d], s);
        pa_s[e] = d0 == 0 ? s : pa_s[e] + s;
      }
      __syncthreads();
    }
    float* ah = a32 + (size_t)hh * NTOK * NTOK;
    for (int i = warp; i < NTOK; i += NWARPS) {
      float* prow = pa_s + i * NTOK;
      const bool two = lane + 32 < NTOK;
      const float v0 = prow[lane] * scale;
      const float v1 = two ? prow[lane + 32] * scale : v0;
      const float m = warp_max(fmaxf(v0, v1));
      const float e0 = expf(v0 - m);
      const float e1 = two ? expf(v1 - m) : 0.f;
      const float s = warp_sum(e0 + e1);
      ah[i * NTOK + lane] = e0 / s;
      prow[lane] = rnd<T>(e0 / s);
      if (two) {
        ah[i * NTOK + lane + 32] = e1 / s;
        prow[lane + 32] = rnd<T>(e1 / s);
      }
    }
    __syncthreads();
    for (int d0 = 0; d0 < hd; d0 += HS) {
      const int dn = min(HS, hd - d0);
      for (int e = threadIdx.x; e < NTOK * dn; e += NTHREADS) {
        const int i = e / dn, d = e % dn;
        v_s[i * hl + d] = to_f(qkv[i * C3 + 2 * C + hh * hd + d0 + d]);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < NTOK * dn; e += NTHREADS) {
        const int i = e / dn, d = e % dn;
        const float* prow = pa_s + i * NTOK;
        float s = 0.f;
        for (int j = 0; j < NTOK; ++j) s = fmaf(prow[j], v_s[j * hl + d], s);
        o[i * C + hh * hd + d0 + d] = from_f<T>(s);
      }
      __syncthreads();
    }
  }

  // ---- y1 = xn32 + (o Wout^T + b) ----
  gemm49<false, 2>(
      o, C, C, wout, C, C, big, [&](int r, int n, float acc, float y, float b) { y1[r * C + n] = y + (acc + b); },
      {y1, C}, {bout, 0});

  // ---- LN2 ----
  for (int t = warp; t < NTOK; t += NWARPS) {
    const float* row = y1 + t * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) * inv_c;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      ss += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(ss) * inv_c + LN_EPS);
    if (lane == 0) rstd2[t] = rstd;
    for (int c = lane; c < C; c += 32) {
      const float yh = (row[c] - mean) * rstd;
      yhat2[t * C + c] = yh;
      y1n[t * C + c] = from_f<T>(yh * ln2w[c] + ln2b[c]);
    }
  }
  __syncthreads();

  // ---- pre = y1n W1^T + b1; h = gelu(pre), rounded ----
  gemm49<false, 1>(y1n, C, C, w1, C, C4, big, [&](int r, int n, float acc, float b) {
    const float p = acc + b;
    pre[r * C4 + n] = p;
    hb[r * C4 + n] = from_f<T>(gelu(p));
  }, {b1, 0});

  // ---- incoming grad; zero on pad tokens ----
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte copy (g 16-byte aligned, C % 8 == 0)
  for (int e = threadIdx.x; e < NTOK * C / V; e += NTHREADS) {
    int h, w;
    const int t = e / (C / V), c = (e % (C / V)) * V;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (token_hw(t, h, w)) v = *reinterpret_cast<const uint4*>(g + (((size_t)b * H + h) * W + w) * C + c);
    *reinterpret_cast<uint4*>(gh + t * C + c) = v;
  }
  __syncthreads();

  // ---- dpre = (gh W2) * gelu'(pre) ----
  gemm49<true, 1>(gh, C, C, w2, C4, C4, big, [&](int r, int n, float acc, float p) {
    const float dp = acc * gelu_grad(p);
    pre[r * C4 + n] = dp;
    dpre[r * C4 + n] = from_f<T>(dp);
  }, {pre, C4});
  for (int n = threadIdx.x; n < C4; n += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < NTOK; ++r) s += pre[r * C4 + n];
    vp[vo.b1 + n] = s;
  }
  for (int n = threadIdx.x; n < C; n += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < NTOK; ++r) s += to_f(gh[r * C + n]);
    vp[vo.b2 + n] = s;
  }

  // ---- dy1n = dpre_b W1 ----
  gemm49<true>(dpre, C4, C4, w1, C, C, big,
               [&](int r, int n, float acc) { dy1n[r * C + n] = acc; });
  for (int n = threadIdx.x; n < C; n += NTHREADS) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < NTOK; ++r) {
      s1 += dy1n[r * C + n] * yhat2[r * C + n];
      s2 += dy1n[r * C + n];
    }
    vp[vo.ln2w + n] = s1;
    vp[vo.ln2b + n] = s2;
  }
  // LN2 backward; dy1 = g + d(LN2 input)
  for (int t = warp; t < NTOK; t += NWARPS) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dyh = dy1n[t * C + c] * ln2w[c];
      s1 += dyh;
      s2 += dyh * yhat2[t * C + c];
    }
    const float m1 = warp_sum(s1) * inv_c;
    const float m2 = warp_sum(s2) * inv_c;
    for (int c = lane; c < C; c += 32) {
      const float dyh = dy1n[t * C + c] * ln2w[c];
      const float v = to_f(gh[t * C + c]) + rstd2[t] * (dyh - m1 - yhat2[t * C + c] * m2);
      y1[t * C + c] = v;
      dout[t * C + c] = from_f<T>(v);
    }
  }
  __syncthreads();
  for (int n = threadIdx.x; n < C; n += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < NTOK; ++r) s += y1[r * C + n];
    vp[vo.bout + n] = s;
  }

  // ---- do = dout Wout, rounded ----
  gemm49<true>(dout, C, C, wout, C, C, big,
               [&](int r, int n, float acc) { dob[r * C + n] = from_f<T>(acc); });

  // ---- attention backward, one head at a time, over slices of its dims ----
  for (int hh = 0; hh < heads; ++hh) {
    const float* ah = a32 + (size_t)hh * NTOK * NTOK;
    for (int e = threadIdx.x; e < NTOK * NTOK; e += NTHREADS) pa_s[e] = ah[e];
    // dv = a^T do (a rounded) for each slice; da = do v^T, the slices' dots summed in fp32
    for (int d0 = 0; d0 < hd; d0 += HS) {
      const int dn = min(HS, hd - d0);
      for (int e = threadIdx.x; e < NTOK * dn; e += NTHREADS) {
        const int i = e / dn, d = e % dn;
        v_s[i * hl + d] = to_f(qkv[i * C3 + 2 * C + hh * hd + d0 + d]);
        d_s[i * hl + d] = to_f(dob[i * C + hh * hd + d0 + d]);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < NTOK * dn; e += NTHREADS) {
        const int j = e / dn, d = e % dn;
        float s = 0.f;
        for (int i = 0; i < NTOK; ++i) s = fmaf(rnd<T>(pa_s[i * NTOK + j]), d_s[i * hl + d], s);
        const int col = 2 * C + hh * hd + d0 + d;
        dqkv32[j * C3 + col] = s;
        dqkv[j * C3 + col] = from_f<T>(s);
      }
      for (int e = threadIdx.x; e < NTOK * NTOK; e += NTHREADS) {
        const float* di = d_s + (e / NTOK) * hl;
        const float* vj = v_s + (e % NTOK) * hl;
        float s = 0.f;
        for (int d = 0; d < dn; ++d) s = fmaf(di[d], vj[d], s);
        pb_s[e] = d0 == 0 ? s : pb_s[e] + s;
      }
      __syncthreads();
    }
    // ds = a32 * (da - sum_j da * a32), rounded
    for (int i = warp; i < NTOK; i += NWARPS) {
      const float* pa = pa_s + i * NTOK;
      float* pb = pb_s + i * NTOK;
      const bool two = lane + 32 < NTOK;
      float s = pb[lane] * pa[lane];
      if (two) s += pb[lane + 32] * pa[lane + 32];
      s = warp_sum(s);
      pb[lane] = rnd<T>(pa[lane] * (pb[lane] - s));
      if (two) pb[lane + 32] = rnd<T>(pa[lane + 32] * (pb[lane + 32] - s));
    }
    __syncthreads();
    // dq = ds k * scale; dk = ds^T q * scale, slice by slice
    for (int d0 = 0; d0 < hd; d0 += HS) {
      const int dn = min(HS, hd - d0);
      for (int e = threadIdx.x; e < NTOK * dn; e += NTHREADS) {
        const int i = e / dn, d = e % dn;
        q_s[i * hl + d] = to_f(qkv[i * C3 + hh * hd + d0 + d]);
        k_s[i * hl + d] = to_f(qkv[i * C3 + C + hh * hd + d0 + d]);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < NTOK * dn; e += NTHREADS) {
        const int i = e / dn, d = e % dn;
        float sq = 0.f, sk = 0.f;
        for (int j = 0; j < NTOK; ++j) {
          sq = fmaf(pb_s[i * NTOK + j], k_s[j * hl + d], sq);
          sk = fmaf(pb_s[j * NTOK + i], q_s[j * hl + d], sk);
        }
        const int cq = hh * hd + d0 + d, ck = C + hh * hd + d0 + d;
        dqkv32[i * C3 + cq] = sq * scale;
        dqkv[i * C3 + cq] = from_f<T>(sq * scale);
        dqkv32[i * C3 + ck] = sk * scale;
        dqkv[i * C3 + ck] = from_f<T>(sk * scale);
      }
      __syncthreads();
    }
  }
  for (int n = threadIdx.x; n < C3; n += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < NTOK; ++r) s += dqkv32[r * C3 + n];
    vp[vo.bqkv + n] = s;
  }

  // ---- dxn = dy1 + dqkv_b Wqkv ----
  gemm49<true, 1>(
      dqkv, C3, C3, wqkv, C, C, big, [&](int r, int n, float acc, float y) { y1[r * C + n] = y + acc; }, {y1, C});
  for (int n = threadIdx.x; n < C; n += NTHREADS) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < NTOK; ++r) {
      s1 += y1[r * C + n] * yhat1[r * C + n];
      s2 += y1[r * C + n];
    }
    vp[vo.ln1w + n] = s1;
    vp[vo.ln1b + n] = s2;
  }
  // ---- LN1 backward; dx of the window's in-range tokens ----
  for (int t = warp; t < NTOK; t += NWARPS) {
    int h, w;
    const bool in = token_hw(t, h, w);
    if (!in) continue;  // warp-uniform
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dyh = y1[t * C + c] * ln1w[c];
      s1 += dyh;
      s2 += dyh * yhat1[t * C + c];
    }
    const float m1 = warp_sum(s1) * inv_c;
    const float m2 = warp_sum(s2) * inv_c;
    T* dst = dx + (((size_t)b * H + h) * W + w) * C;
    for (int c = lane; c < C; c += 32) {
      const float dyh = y1[t * C + c] * ln1w[c];
      dst[c] = from_f<T>(rstd1[t] * (dyh - m1 - yhat1[t * C + c] * m2));
    }
  }
}

// part[s * E + i * J + j] = sum over tokens t of chunk s of G[t, i] * X[t, j]
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    swin_bwd_wgrad_kernel(const T* __restrict__ G, const T* __restrict__ X, int N, int I, int J, size_t E,
                 float* __restrict__ part) {
  __shared__ float gs[TG_T * TG_LD];
  __shared__ float xs[TG_T * TG_LD];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int j0 = blockIdx.x * 64;
  const int i0 = blockIdx.y * 64;
  const int s = blockIdx.z;
  const int tbeg = s * TG_CHUNK;
  const int tend = min(N, tbeg + TG_CHUNK);
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  for (int tb = tbeg; tb < tend; tb += TG_T) {
    __syncthreads();
    for (int e = threadIdx.x; e < TG_T * 64; e += NTHREADS) {
      const int t = e / 64, c = e % 64;
      const size_t tok = (size_t)tb + t;
      const bool ok = tb + t < tend;
      gs[t * TG_LD + c] = ok && i0 + c < I ? to_f(G[tok * I + i0 + c]) : 0.f;
      xs[t * TG_LD + c] = ok && j0 + c < J ? to_f(X[tok * J + j0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < TG_T; ++t) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = gs[t * TG_LD + ty + 16 * q];
        b[q] = xs[t * TG_LD + tx + 16 * q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
  }
  float* out = part + (size_t)s * E;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx + 16 * q;
      if (i < I && j < J) out[(size_t)i * J + j] = acc[p][q];
    }
  }
}

// The same product for bf16 on the tensor cores: a 128 x 128 block tile of
// dW, 8 warps in a 4 x 2 grid of 32 x 64 warp tiles; the G and X tiles of
// KT tokens stream through a STAGES-deep cp.async ring and both enter the
// mma through ldmatrix.trans (they are token-major). Tokens past the chunk
// and rows past I or J are zero-filled.
__global__ void __launch_bounds__(NTHREADS)
    swin_bwd_wgrad_mma_kernel(const __nv_bfloat16* __restrict__ G, const __nv_bfloat16* __restrict__ X, int N,
                              int I, int J, size_t E, float* __restrict__ part) {
  using swin_mma::bf16;
  using swin_mma::KT;
  using swin_mma::STAGES;
  extern __shared__ __align__(16) unsigned char smem_wg[];
  bf16* ring = reinterpret_cast<bf16*>(smem_wg);
  const int j0 = blockIdx.x * WG_TILE;
  const int i0 = blockIdx.y * WG_TILE;
  const int s = blockIdx.z;
  const int tbeg = s * TG_CHUNK;
  const int tend = min(N, tbeg + TG_CHUNK);
  const int nk = (tend - tbeg + KT - 1) / KT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;

  auto load = [&](int it) {
    bf16* gt = ring + (it % STAGES) * WG_STAGE;
    bf16* xt = gt + KT * WG_LD;
    const int t0 = tbeg + it * KT;
    for (int e = threadIdx.x; e < KT * (WG_TILE / 8); e += NTHREADS) {
      const int tr = e / (WG_TILE / 8), c = (e % (WG_TILE / 8)) * 8;
      const size_t tok = (size_t)t0 + tr;
      const bool tok_ok = t0 + tr < tend;
      const bool gok = tok_ok && i0 + c < I, xok = tok_ok && j0 + c < J;
      swin_mma::cp_async16(gt + tr * WG_LD + c, gok ? G + tok * I + i0 + c : G, gok);
      swin_mma::cp_async16(xt + tr * WG_LD + c, xok ? X + tok * J + j0 + c : X, xok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st);
    swin_mma::cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    swin_mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < nk) load(it + STAGES - 1);
    swin_mma::cp_async_commit();
    const bf16* gt = ring + (it % STAGES) * WG_STAGE;
    const bf16* xt = gt + KT * WG_LD;
#pragma unroll
    for (int ks = 0; ks < KT; ks += 16) {
      // A[i][t] = G[t][i]: a 16 x 16 fragment from the token-major tile, transposed;
      // all fragments of the step are loaded before its products
      uint32_t a[2][4], b[4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        swin_mma::ldsm_x4_t(a[m], gt + (ks + (lane & 7) + ((lane >> 4) << 3)) * WG_LD + wm * 32 + m * 16 +
                            (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) swin_mma::load_b<true>(b[jp], xt, WG_LD, ks, wn * 64 + jp * 16, lane);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          swin_mma::mma_bf16(acc[m][2 * jp], a[m], b[jp][0], b[jp][1]);
          swin_mma::mma_bf16(acc[m][2 * jp + 1], a[m], b[jp][2], b[jp][3]);
        }
    }
  }
  swin_mma::cp_async_wait<0>();
  float* out = part + (size_t)s * E;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wm * 32 + m * 16 + (lane >> 2) + h * 8;
        const int jj = j0 + wn * 64 + j * 8 + (lane & 3) * 2;
        if (i < I && jj < J) {  // J is a multiple of 8: jj + 1 < J too
          out[(size_t)i * J + jj] = acc[m][j][2 * h];
          out[(size_t)i * J + jj + 1] = acc[m][j][2 * h + 1];
        }
      }
}

// out[e] = sum over r of in[r * cols + e], r ascending
__global__ void swin_bwd_sum_kernel(const float* __restrict__ in, int rows, size_t cols, float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += in[(size_t)r * cols + e];
  out[e] = s;
}

// bytes of shared memory of the window kernel (exported as swin_block_bwd_smem_bytes)
size_t smem_bytes(int dtype, int C, int heads) {
  const int hd = C / heads;
  const size_t tiles = dtype == 1 ? swin_mma::ring_bytes<NT, true, false>() / sizeof(float) : 2 * 64 * LD;
  const size_t attn = 4 * (size_t)NTOK * ((hd < HS ? hd : HS) + 1) + 2 * NTOK * NTOK;
  return sizeof(float) * (RSTD + (tiles > attn ? tiles : attn));
}

struct Sizes {
  size_t windows, tokens, chunks, t_elems, f_elems;
};

Sizes sizes(int B, int H, int W, int C, int heads) {
  Sizes z;
  z.windows = (size_t)B * ((H + WS - 1) / WS) * ((W + WS - 1) / WS);
  z.tokens = z.windows * NTOK;
  z.chunks = (z.tokens + TG_CHUNK - 1) / TG_CHUNK;
  z.t_elems = z.tokens * 20 * (size_t)C;
  z.f_elems = z.tokens * 11 * (size_t)C + z.windows * heads * NTOK * NTOK + z.windows * 13 * (size_t)C +
              z.chunks * 12 * (size_t)C * C;
  return z;
}

template <typename T>
int launch(const void* x, const void* g, void* dx, int B, int H, int W, int C, int heads,
           const float* ln1w, const float* ln1b, const void* wqkv, const float* bqkv, const void* wout,
           const float* bout, const float* ln2w, const float* ln2b, const void* w1, const float* b1,
           const void* w2, const float* b2, void* tws, float* fws, float* gout, cudaStream_t stream) {
  const Sizes z = sizes(B, H, W, C, heads);
  const size_t N = z.tokens, Cs = (size_t)C;
  Work<T> wk;
  T* tp = static_cast<T*>(tws);
  wk.xn = tp;
  wk.qkv = wk.xn + N * Cs;
  wk.o = wk.qkv + 3 * N * Cs;
  wk.y1n = wk.o + N * Cs;
  wk.h = wk.y1n + N * Cs;
  wk.gh = wk.h + 4 * N * Cs;
  wk.dpre = wk.gh + N * Cs;
  wk.dout = wk.dpre + 4 * N * Cs;
  wk.dob = wk.dout + N * Cs;
  wk.dqkv = wk.dob + N * Cs;
  wk.yhat1 = fws;
  wk.y1 = wk.yhat1 + N * Cs;
  wk.yhat2 = wk.y1 + N * Cs;
  wk.pre = wk.yhat2 + N * Cs;
  wk.dy1n = wk.pre + 4 * N * Cs;
  wk.dqkv32 = wk.dy1n + N * Cs;
  wk.a32 = wk.dqkv32 + 3 * N * Cs;
  wk.vpart = wk.a32 + z.windows * heads * NTOK * NTOK;
  float* wpart = wk.vpart + z.windows * 13 * Cs;

  constexpr bool MMA = sizeof(T) == 2;
  const size_t smem = smem_bytes(MMA ? 1 : 0, C, heads);
  cudaError_t err = cudaFuncSetAttribute(swin_bwd_window_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)(C / heads));
  swin_bwd_window_kernel<T><<<(int)z.windows, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx), H, W, C, heads, scale, ln1w,
      ln1b, static_cast<const T*>(wqkv), bqkv, static_cast<const T*>(wout), bout, ln2w, ln2b,
      static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2, wk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // weight grads in the output order wqkv (3C, C), wout (C, C), w1 (4C, C), w2 (C, 4C)
  const size_t E = 12 * Cs * Cs;
  struct Prod {
    const T* g;
    const T* x;
    int i, j;
  } prods[4] = {{wk.dqkv, wk.xn, 3 * C, C}, {wk.dout, wk.o, C, C}, {wk.dpre, wk.y1n, 4 * C, C},
                {wk.gh, wk.h, C, 4 * C}};
  if constexpr (MMA) {
    err = cudaFuncSetAttribute(swin_bwd_wgrad_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WG_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  size_t off = 0;
  for (const Prod& p : prods) {
    if constexpr (MMA) {
      const dim3 grid((p.j + WG_TILE - 1) / WG_TILE, (p.i + WG_TILE - 1) / WG_TILE, (unsigned)z.chunks);
      swin_bwd_wgrad_mma_kernel<<<grid, NTHREADS, WG_SMEM, stream>>>(p.g, p.x, (int)N, p.i, p.j, E, wpart + off);
    } else {
      const dim3 grid((p.j + 63) / 64, (p.i + 63) / 64, (unsigned)z.chunks);
      swin_bwd_wgrad_kernel<T><<<grid, NTHREADS, 0, stream>>>(p.g, p.x, (int)N, p.i, p.j, E, wpart + off);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    off += (size_t)p.i * p.j;
  }
  swin_bwd_sum_kernel<<<(int)((E + NTHREADS - 1) / NTHREADS), NTHREADS, 0, stream>>>(wpart, (int)z.chunks, E, gout);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t V = 13 * Cs;
  swin_bwd_sum_kernel<<<(int)((V + NTHREADS - 1) / NTHREADS), NTHREADS, 0, stream>>>(wk.vpart, (int)z.windows, V,
                                                                               gout + E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one block of the window kernel for this dtype
// (0 = float32, 1 = bfloat16) takes at this C and head count.
size_t swin_block_bwd_smem_bytes(int dtype, int C, int heads) { return smem_bytes(dtype, C, heads); }

// Elements of the two workspaces a launch at this shape needs: in the I/O
// dtype (t_elems) and in fp32 (f_elems).
void swin_block_bwd_workspace(int B, int H, int W, int C, int heads, size_t* t_elems, size_t* f_elems) {
  const Sizes z = sizes(B, H, W, C, heads);
  *t_elems = z.t_elems;
  *f_elems = z.f_elems;
}

// dtype: 0 = float32, 1 = bfloat16 (x, g, dx, the four weight matrices and
// the T workspace). gout (fp32, 12C^2 + 13C): dwqkv (3C, C), dwout (C, C),
// dw1 (4C, C), dw2 (C, 4C), then dln1_w, dln1_b, dbqkv (3C), dbout, dln2_w,
// dln2_b, db1 (4C), db2. Returns the first CUDA error of the launches.
int swin_block_bwd(int dtype, const void* x, const void* g, void* dx, int B, int H, int W, int C, int heads,
                   const float* ln1w, const float* ln1b, const void* wqkv, const float* bqkv,
                   const void* wout, const float* bout, const float* ln2w, const float* ln2b,
                   const void* w1, const float* b1, const void* w2, const float* b2, void* tws, float* fws,
                   float* gout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, g, dx, B, H, W, C, heads, ln1w, ln1b, wqkv, bqkv, wout, bout, ln2w, ln2b, w1, b1,
                         w2, b2, tws, fws, gout, s);
  if (dtype == 1 && C % 32 == 0)  // the tensor-core tiles
    return launch<__nv_bfloat16>(x, g, dx, B, H, W, C, heads, ln1w, ln1b, wqkv, bqkv, wout, bout, ln2w, ln2b,
                                 w1, b1, w2, b2, tws, fws, gout, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
