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
// exactly in int32 (__dp4a), and the sum is dequantized in the epilogue as
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
// TPU kernel; the attention dots call fmaf explicitly.
//
// Bound. Per real token 24*C*C int8 operations (qkv 6C^2, out 2C^2, fc1 8C^2,
// fc2 8C^2) at 1979 TOP/s and 196*C bf16 FLOP of attention at 989 TFLOP/s;
// at (8, 40, 40, 256) 20.1 G int8 operations, 10.2 us, against 7.4 MB of
// int8 I/O and weights (2.2 us): bound by operations. This first version runs
// its products on the CUDA cores with __dp4a (4 int8 products per
// instruction; 64x64 output tiles, 4x4 per thread, int8 weight tiles of 64
// bytes of depth staged through shared memory from L2, where the 0.8 MB of
// weights stay resident); mma.sync / wgmma int8 products are later work.
// Shared memory per block: the fp32 residual stream (49 x C), two int8
// product inputs (49 x C: the qkv / fc1 input and the heads' outputs), one
// head's q|k|v in fp32 with its 49x49 probabilities, which the int8 MLP
// hidden (49 x 4C) later reuses, and a weight tile: 165 KB at C=256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WS = 7;
constexpr int NTOK = WS * WS;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TILE_N = 64;             // output columns per pass
constexpr int TILE_KB = 64;            // int8 depth of a weight tile, bytes
constexpr int TILE_KW = TILE_KB / 4;   // the same in 32-bit words
constexpr int WT_LDW = TILE_KW + 1;    // odd word stride: tile rows in distinct banks
constexpr float LN_EPS = 1e-5f;
static_assert(NTHREADS == TILE_N * (TILE_KB / 16), "one 16-byte weight load per thread per tile");

enum Kind { KIND_F32 = 0, KIND_BF16 = 1, KIND_I8 = 2 };

struct Args {
  const void* x;
  void* y;
  int x_kind, y_kind, H, W, C, heads;
  bool cbf, sm16;  // compute dtype bf16; bf16 softmax
  float scale;     // 1 / sqrt(head dim)
  const float* xs; // activation scales: qkv, out, fc1, fc2, x_in, y_out
  const float *ln1w, *ln1b, *bqkv, *bout, *ln2w, *ln2b, *b1, *b2;
  const int8_t *wqkv, *wout, *w1, *w2;
  const float *sqkv, *sout, *s1, *s2;
};

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ float rc(float v, bool cbf) { return cbf ? bf(v) : v; }

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

__device__ __forceinline__ float load_x(const void* x, size_t i, int kind) {
  if (kind == KIND_I8) return (float)static_cast<const int8_t*>(x)[i];
  if (kind == KIND_BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  return static_cast<const float*>(x)[i];
}

// out[r, n] = sum_k A[r, k] * W[wrow(n), k] for r < NTOK, n < N, exact in
// int32, handed to epi(r, n, acc). A is int8 in shared memory, rows of lda
// 32-bit words; W is int8 in global memory, rows of ldw bytes. K is a multiple
// of TILE_KB. Ends with a barrier, so the epilogue's writes are visible to the
// next phase.
template <typename RowMap, typename Epi>
__device__ void gemm_i8(const int* A, int lda, int K, const int8_t* __restrict__ W, int ldw, int N,
                        RowMap wrow, int* wt, Epi epi) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int lc = threadIdx.x >> 2;  // weight tile row this thread loads
  const int lp = threadIdx.x & 3;   // and its 16-byte part
  for (int n0 = 0; n0 < N; n0 += TILE_N) {
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int k0 = 0; k0 < K; k0 += TILE_KB) {
      __syncthreads();  // the previous tile has been consumed
      int4 v = make_int4(0, 0, 0, 0);
      if (n0 + lc < N)
        v = *reinterpret_cast<const int4*>(W + (size_t)wrow(n0 + lc) * ldw + k0 + 16 * lp);
      int* dst = wt + lc * WT_LDW + 4 * lp;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
      __syncthreads();
      const int kw0 = k0 / 4;
#pragma unroll 4
      for (int kk = 0; kk < TILE_KW; ++kk) {
        int a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
          a[i] = r < NTOK ? A[r * lda + kw0 + kk] : 0;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = wt[(tx + 16 * j) * WT_LDW + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
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

struct Identity {
  __device__ __forceinline__ int operator()(int n) const { return n; }
};

// dequantized product: acc * (x_scale * w_scale) + bias, each operation rounded
__device__ __forceinline__ float deq(int acc, float xs, float ws, float b) {
  return __int2float_rn(acc) * (xs * ws) + b;
}

// 0.5 pb (1 + tanh(0.7978845608 (pb + 0.044715 pb^3))), each operation
// rounded to the compute dtype, the constants taken in it
__device__ __forceinline__ float gelu_tanh(float pb, bool cbf) {
  const float c1 = rc(0.044715f, cbf), c2 = rc(0.7978845608f, cbf);
  float t = rc(c1 * pb, cbf);
  t = rc(t * pb, cbf);
  t = rc(t * pb, cbf);
  t = rc(pb + t, cbf);
  t = rc(c2 * t, cbf);
  t = rc(tanhf(t), cbf);
  t = rc(1.f + t, cbf);
  return rc(rc(0.5f * pb, cbf) * t, cbf);
}

__host__ __device__ inline size_t up16(size_t v) { return (v + 15) / 16 * 16; }

// bytes of shared memory per block (the wrapper's smem_bytes repeats this)
__host__ __device__ inline size_t smem_bytes(int C, int heads) {
  const int hd = C / heads;
  const size_t attn = sizeof(float) * ((size_t)NTOK * (3 * hd + 1) + NTOK * NTOK);
  const size_t hid = (size_t)NTOK * (4 * C + 4);
  return up16(sizeof(float) * NTOK * C) + 2 * up16((size_t)NTOK * (C + 4)) +
         up16(attn > hid ? attn : hid) + sizeof(int) * TILE_N * WT_LDW;
}

__global__ void __launch_bounds__(NTHREADS) swin_block_int8_kernel(Args P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = P.C;
  const int hd = C / P.heads;
  const int ldq = 3 * hd + 1;  // odd stride: rows of k and v fall in distinct banks
  const int lda = C / 4 + 1;   // words per int8 row of a product input (odd)
  const int ldh = C + 1;       // words per int8 row of the MLP hidden (4C bytes, odd)
  float* xn_s = reinterpret_cast<float*>(smem);  // normed tokens, then the fp32 residual stream
  int8_t* a8_s = reinterpret_cast<int8_t*>(smem + up16(sizeof(float) * NTOK * C));  // qkv, then fc1 input
  int8_t* o8_s = a8_s + up16((size_t)NTOK * (C + 4));                                // out-projection input
  unsigned char* region = reinterpret_cast<unsigned char*>(o8_s + up16((size_t)NTOK * (C + 4)));
  float* q_s = reinterpret_cast<float*>(region);  // one head's q|k|v
  float* p_s = q_s + NTOK * ldq;                  // its probabilities
  int8_t* h8_s = reinterpret_cast<int8_t*>(region);  // the MLP hidden, after attention
  const size_t attn = sizeof(float) * ((size_t)NTOK * ldq + NTOK * NTOK);
  const size_t hid = (size_t)NTOK * (4 * C + 4);
  int* wt_s = reinterpret_cast<int*>(region + up16(attn > hid ? attn : hid));

  const int H = P.H, W = P.W;
  const int nwh = (H + WS - 1) / WS;
  const int nww = (W + WS - 1) / WS;
  const int b = blockIdx.x / (nwh * nww);
  const int wy = (blockIdx.x / nww) % nwh;
  const int wx = blockIdx.x % nww;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool cbf = P.cbf;
  const float xs_qkv = P.xs[0], xs_out = P.xs[1], xs_fc1 = P.xs[2], xs_fc2 = P.xs[3];
  const float xs_in = P.xs[4], ys_out = P.xs[5];
  const float fc = (float)C;

  // ---- gather the window, LN1 and its affine, quantize the qkv input (one warp per token) ----
  for (int t = warp; t < NTOK; t += NWARPS) {
    const int h = wy * WS + t / WS;
    const int w = wx * WS + t % WS;
    const bool inside = h < H && w < W;
    const size_t base = (((size_t)b * H + h) * W + w) * C;
    float* row = xn_s + t * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) {
      float v = inside ? load_x(P.x, base + c, P.x_kind) : 0.f;
      if (P.x_kind == KIND_I8) v = v * xs_in;
      row[c] = v;
      s += v;
    }
    const float mean = warp_sum(s) / fc;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      ss += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(ss) / fc + LN_EPS);
    for (int c = lane; c < C; c += 32) {
      const float n = (row[c] - mean) * rstd;
      const float xn = cbf ? bf(bf(bf(n) * bf(P.ln1w[c])) + bf(P.ln1b[c])) : n * P.ln1w[c] + P.ln1b[c];
      row[c] = xn;
      a8_s[t * 4 * lda + c] = (int8_t)q8(xn, xs_qkv);
    }
  }
  __syncthreads();

  // ---- attention, one head at a time; each head's output quantized for the out-projection ----
  for (int hh = 0; hh < P.heads; ++hh) {
    // columns [0, hd) q, [hd, 2hd) k, [2hd, 3hd) v of this head
    auto qkv_row = [=](int n) {
      const int seg = n / hd;
      return seg * C + hh * hd + (n - seg * hd);
    };
    gemm_i8(reinterpret_cast<const int*>(a8_s), lda, C, P.wqkv, C, 3 * hd, qkv_row, wt_s,
            [&](int r, int n, int acc) {
              const int m = qkv_row(n);
              q_s[r * ldq + n] = rc(deq(acc, xs_qkv, P.sqkv[m], P.bqkv[m]), cbf);
            });
    for (int e = threadIdx.x; e < NTOK * NTOK; e += NTHREADS) {
      const float* qi = q_s + (e / NTOK) * ldq;
      const float* kj = q_s + (e % NTOK) * ldq + hd;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qi[d], kj[d], s);
      p_s[e] = s * P.scale;
    }
    __syncthreads();
    for (int i = warp; i < NTOK; i += NWARPS) {
      float* prow = p_s + i * NTOK;
      const bool two = lane + 32 < NTOK;
      const float v0 = prow[lane];
      const float v1 = two ? prow[lane + 32] : v0;
      const float m = warp_max(fmaxf(v0, v1));
      float e0, e1;
      if (P.sm16) {
        e0 = bf(expf(bf(v0 - m)));
        e1 = two ? bf(expf(bf(v1 - m))) : 0.f;
        const float s = bf(warp_sum(e0 + e1));
        prow[lane] = bf(e0 / s);
        if (two) prow[lane + 32] = bf(e1 / s);
      } else {
        e0 = expf(v0 - m);
        e1 = two ? expf(v1 - m) : 0.f;
        const float s = warp_sum(e0 + e1);
        prow[lane] = rc(e0 / s, cbf);
        if (two) prow[lane + 32] = rc(e1 / s, cbf);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < NTOK * hd; e += NTHREADS) {
      const int i = e / hd;
      const int d = e % hd;
      const float* prow = p_s + i * NTOK;
      const float* vcol = q_s + 2 * hd + d;
      float s = 0.f;
      for (int j = 0; j < NTOK; ++j) s = fmaf(prow[j], vcol[j * ldq], s);
      o8_s[i * 4 * lda + hh * hd + d] = (int8_t)q8(s, xs_out);
    }
    __syncthreads();
  }

  // ---- out-projection; residual onto the normed tokens ----
  gemm_i8(reinterpret_cast<const int*>(o8_s), lda, C, P.wout, C, C, Identity(), wt_s,
          [&](int r, int n, int acc) {
            xn_s[r * C + n] = xn_s[r * C + n] + deq(acc, xs_out, P.sout[n], P.bout[n]);
          });

  // ---- LN2 (fp32 affine), quantized for fc1 ----
  for (int t = warp; t < NTOK; t += NWARPS) {
    const float* row = xn_s + t * C;
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
      a8_s[t * 4 * lda + c] = (int8_t)q8((row[c] - mean) * rstd * P.ln2w[c] + P.ln2b[c], xs_fc1);
  }
  __syncthreads();

  // ---- fc1 and the tanh GELU into the int8 hidden ----
  gemm_i8(reinterpret_cast<const int*>(a8_s), lda, C, P.w1, C, 4 * C, Identity(), wt_s,
          [&](int r, int n, int acc) {
            const float pb = rc(deq(acc, xs_fc1, P.s1[n], P.b1[n]), cbf);
            h8_s[r * 4 * ldh + n] = (int8_t)q8(gelu_tanh(pb, cbf), xs_fc2);
          });

  // ---- fc2 onto the residual stream, written out for the window's in-range tokens ----
  const int y_kind = P.y_kind;
  gemm_i8(reinterpret_cast<const int*>(h8_s), ldh, 4 * C, P.w2, 4 * C, C, Identity(), wt_s,
          [&](int r, int n, int acc) {
            const int h = wy * WS + r / WS;
            const int w = wx * WS + r % WS;
            if (h >= H || w >= W) return;
            const float y = xn_s[r * C + n] + deq(acc, xs_fc2, P.s2[n], P.b2[n]);
            const size_t i = (((size_t)b * H + h) * W + w) * C + n;
            if (y_kind == KIND_I8)
              static_cast<int8_t*>(P.y)[i] = (int8_t)q8(y, ys_out);
            else if (y_kind == KIND_BF16)
              static_cast<__nv_bfloat16*>(P.y)[i] = __float2bfloat16(y);
            else
              static_cast<float*>(P.y)[i] = y;
          });
}

}  // namespace

extern "C" {

// x_kind, y_kind: 0 = float32, 1 = bfloat16, 2 = int8. cdt_bf16: the compute
// dtype is bf16. sm16: bf16 softmax. xs: the six activation scales on the
// card. Weights int8 (out, in); their scales, LayerNorm parameters and biases
// fp32. Returns the CUDA error code of the launch (0 on success).
int swin_block_int8(int x_kind, int y_kind, int cdt_bf16, int sm16, const void* x, void* y, int B,
                    int H, int W, int C, int heads, float scale, const float* xs, const float* ln1w,
                    const float* ln1b, const float* bqkv, const float* bout, const float* ln2w,
                    const float* ln2b, const float* b1, const float* b2, const int8_t* wqkv,
                    const float* sqkv, const int8_t* wout, const float* sout, const int8_t* w1,
                    const float* s1, const int8_t* w2, const float* s2, void* stream) {
  if (x_kind < 0 || x_kind > 2 || y_kind < 0 || y_kind > 2 || C % TILE_KB || C % heads)
    return (int)cudaErrorInvalidValue;
  Args P{x, y, x_kind, y_kind, H, W, C, heads, cdt_bf16 != 0, sm16 != 0, scale, xs,
         ln1w, ln1b, bqkv, bout, ln2w, ln2b, b1, b2, wqkv, wout, w1, w2, sqkv, sout, s1, s2};
  const size_t smem = smem_bytes(C, heads);
  cudaError_t err = cudaFuncSetAttribute(swin_block_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * ((H + WS - 1) / WS) * ((W + WS - 1) / WS);
  swin_block_int8_kernel<<<blocks, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

}  // extern "C"
