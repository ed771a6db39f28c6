// Task-aligned assigner for Hopper (sm_90a), any number of GTs per image.
//
// Replaces the TPU kernel `_tal_kernel` launched by `tal_assign_fused`
// (improving_yolov8_cbam_swinblock_tpu/ops/pallas/tal_kernel.py). Same
// function: candidate gate (anchor centre strictly inside the GT), per-GT
// class score, pairwise CIoU with atan(w/h) once per box, align =
// sqrt(score) * overlap^6, top-k per GT with the first index winning ties,
// an anchor claimed by several GTs given to the argmax of overlaps over all
// GTs, target gather and the normalisation align * max_ovl / (max_align + eps).
//
// Design. The TPU kernel holds a whole (G, A) tile per image in VMEM; here
// that is 4.3 MB at G = 128 and does not fit a block's shared memory, and
// after mosaic G reaches 1200. So the work is split into four launches,
// none of which holds more than one row or column of the (G, A) plane:
//   1. tal_prep_kernel: atan of every box; per-anchor claim counters and per-GT maxima reset.
//   2. tal_topk_kernel: one block per (image, GT) streams the anchors, each thread
//              keeping its own top-k by (value descending, index ascending);
//              k rounds of a block-wide arg-best merge them. Each pick that
//              passes the candidate gate claims its anchor (atomic count and
//              atomic min of the GT index: both independent of order).
//   3. tal_resolve_kernel: one thread per (image, anchor) resolves its claims (a second
//              pass over all G only for anchors claimed more than once), keeps
//              the chosen pair's align and raises the GT's max align and max
//              overlap (atomicMax on the bits of non-negative floats: exact).
//   4. tal_final_kernel: one thread per (image, anchor) normalises and writes the targets.
// Every result is independent of the order in which blocks run.
//
// Numerics: fp32, built with -fmad=false, so each operation of the CIoU
// rounds as the plain version's separate PyTorch ops do and near ties pick
// the same anchors. Bound: one CIoU + align evaluation (~60 FLOP) per
// (image, GT, anchor), on the CUDA cores: at B=16, G=128, A=8400 that is
// 17 M pairs, ~15 us at 67 TFLOP/s; the bytes (predictions and targets) are
// a few MB. The kernel evaluates each pair once in launch 2 and again in
// launch 3 only for anchors claimed by several GTs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAXK = 16;
constexpr float CEPS = 1e-7f;
constexpr float CIOU_V = (float)(4.0 / (3.14159265358979323846 * 3.14159265358979323846));
constexpr float ONE_EPS = (float)(1.0 + 1e-7);
constexpr int BIG = 0x7fffffff;

struct Gt {
  float x1, y1, x2, y2, atan;
  int valid;
};

__device__ __forceinline__ Gt load_gt(const float* gbox, const float* gatan, const int* gmask, int bg) {
  Gt t;
  t.x1 = gbox[4 * bg];
  t.y1 = gbox[4 * bg + 1];
  t.x2 = gbox[4 * bg + 2];
  t.y2 = gbox[4 * bg + 3];
  t.atan = gatan[bg];
  t.valid = gmask[bg];
  return t;
}

__device__ __forceinline__ bool inside(const Gt& t, float ax, float ay, float eps) {
  return t.valid && (ax - t.x1 > eps) && (ay - t.y1 > eps) && (t.x2 - ax > eps) && (t.y2 - ay > eps);
}

// overlap (clipped CIoU, box1 = GT, box2 = prediction) and align of one pair
__device__ __forceinline__ void pair(const Gt& t, float ax, float ay, const float* pb, float patan,
                                     float score, float eps, float* ovl, float* align) {
  const float cf = inside(t, ax, ay, eps) ? 1.f : 0.f;
  const float px1 = pb[0], py1 = pb[1], px2 = pb[2], py2 = pb[3];
  const float w1 = t.x2 - t.x1, h1 = (t.y2 - t.y1) + CEPS;
  const float w2 = px2 - px1, h2 = (py2 - py1) + CEPS;
  const float iw = fmaxf(fminf(t.x2, px2) - fmaxf(t.x1, px1), 0.f);
  const float ih = fmaxf(fminf(t.y2, py2) - fmaxf(t.y1, py1), 0.f);
  const float inter = iw * ih;
  const float uni = ((w1 * h1 + w2 * h2) - inter) + CEPS;
  const float iou = inter / uni;
  const float cw = fmaxf(t.x2, px2) - fminf(t.x1, px1);
  const float ch = fmaxf(t.y2, py2) - fminf(t.y1, py1);
  const float c2 = (cw * cw + ch * ch) + CEPS;
  const float dx = ((px1 + px2) - t.x1) - t.x2;
  const float dy = ((py1 + py2) - t.y1) - t.y2;
  const float rho2 = (dx * dx + dy * dy) / 4.f;
  const float da = patan - t.atan;
  const float v = CIOU_V * (da * da);
  const float alpha = v / ((v - iou) + ONE_EPS);
  const float ciou = iou - (rho2 / c2 + v * alpha);
  const float o = fmaxf(ciou, 0.f) * cf;
  const float o2 = o * o;
  *ovl = o;
  *align = sqrtf(score * cf) * ((o2 * o2) * o2);
}

__global__ void tal_prep_kernel(int BA, int BG, const float* __restrict__ pbox, const float* __restrict__ gbox,
                            float* patan, float* gatan, int* claims, float* pos_align, float* pos_ovl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < BA) {
    const float* p = pbox + 4 * (size_t)i;
    patan[i] = atanf((p[2] - p[0]) / ((p[3] - p[1]) + CEPS));
    claims[2 * (size_t)i] = 0;
    claims[2 * (size_t)i + 1] = BIG;
  } else if (i < BA + BG) {
    const int j = i - BA;
    const float* p = gbox + 4 * (size_t)j;
    gatan[j] = atanf((p[2] - p[0]) / ((p[3] - p[1]) + CEPS));
    pos_align[j] = 0.f;
    pos_ovl[j] = 0.f;
  }
}

__global__ void __launch_bounds__(NT)
    tal_topk_kernel(int A, int G, int nc, int K, float eps, const float* __restrict__ scores,
                const float* __restrict__ pbox, const float* __restrict__ anc,
                const float* __restrict__ patan, const int* __restrict__ glab,
                const float* __restrict__ gbox, const float* __restrict__ gatan,
                const int* __restrict__ gmask, int* picks, int* claims) {
  __shared__ float sv[NT];
  __shared__ int si[NT];
  __shared__ int st[NT];
  __shared__ int spick[MAXK];
  const int bg = blockIdx.x;
  const int b = bg / G;
  const int g = bg % G;
  const int tid = threadIdx.x;
  const Gt t = load_gt(gbox, gatan, gmask, bg);
  int* out = picks + (size_t)bg * K;
  if (!t.valid) {  // no anchor is a candidate of an invalid GT
    for (int k = tid; k < K; k += NT) out[k] = -1;
    return;
  }
  const int lab = glab[bg];
  float lv[MAXK];
  int li[MAXK];
  for (int k = 0; k < K; ++k) {
    lv[k] = -INFINITY;
    li[k] = BIG;
  }
  for (int a = tid; a < A; a += NT) {
    const size_t ba = (size_t)b * A + a;
    float o, val;
    pair(t, anc[2 * a], anc[2 * a + 1], pbox + 4 * ba, patan[ba], scores[ba * nc + lab], eps, &o, &val);
    if (val > lv[K - 1]) {  // this thread's anchors come in ascending order: ties keep the earlier one
      int j = K - 1;
      while (j > 0 && val > lv[j - 1]) {
        lv[j] = lv[j - 1];
        li[j] = li[j - 1];
        --j;
      }
      lv[j] = val;
      li[j] = a;
    }
  }
  int head = 0;
  for (int r = 0; r < K; ++r) {
    sv[tid] = head < K ? lv[head] : -INFINITY;
    si[tid] = head < K ? li[head] : BIG;
    st[tid] = tid;
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
      if (tid < s) {
        const float vo = sv[tid + s];
        const int io = si[tid + s];
        if (vo > sv[tid] || (vo == sv[tid] && io < si[tid])) {
          sv[tid] = vo;
          si[tid] = io;
          st[tid] = st[tid + s];
        }
      }
      __syncthreads();
    }
    if (tid == 0) spick[r] = si[0];
    if (tid == st[0]) ++head;
    __syncthreads();
  }
  if (tid < K) {
    const int a = spick[tid];
    out[tid] = a;
    if (a >= 0 && a < A && inside(t, anc[2 * a], anc[2 * a + 1], eps)) {
      int* c = claims + 2 * ((size_t)b * A + a);
      atomicAdd(c, 1);
      atomicMin(c + 1, g);
    }
  }
}

__global__ void tal_resolve_kernel(int B, int A, int G, int nc, float eps, const float* __restrict__ scores,
                              const float* __restrict__ pbox, const float* __restrict__ anc,
                              const float* __restrict__ patan, const int* __restrict__ glab,
                              const float* __restrict__ gbox, const float* __restrict__ gatan,
                              const int* __restrict__ gmask, const int* __restrict__ claims,
                              int* idx, bool* fg, float* align_sel, float* pos_align, float* pos_ovl) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * A) return;
  const int b = (int)(i / A);
  const int a = (int)(i % A);
  const int cnt = claims[2 * i];
  const float ax = anc[2 * a], ay = anc[2 * a + 1];
  const float* pb = pbox + 4 * i;
  int tg = 0;
  if (cnt == 1) {
    tg = claims[2 * i + 1];
  } else if (cnt > 1) {  // highest overlap over ALL GTs, first index on ties
    float best = -1.f;
    for (int g = 0; g < G; ++g) {
      const int bg = b * G + g;
      float o, al;
      pair(load_gt(gbox, gatan, gmask, bg), ax, ay, pb, patan[i], scores[i * nc + glab[bg]], eps, &o, &al);
      if (o > best) {
        best = o;
        tg = g;
      }
    }
  }
  idx[i] = tg;
  fg[i] = cnt > 0;
  float al = 0.f;
  if (cnt > 0) {
    const int bg = b * G + tg;
    float o;
    pair(load_gt(gbox, gatan, gmask, bg), ax, ay, pb, patan[i], scores[i * nc + glab[bg]], eps, &o, &al);
    atomicMax(reinterpret_cast<int*>(pos_align + bg), __float_as_int(al));
    atomicMax(reinterpret_cast<int*>(pos_ovl + bg), __float_as_int(o));
  }
  align_sel[i] = al;
}

__global__ void tal_final_kernel(int B, int A, int G, int ncls, float eps, const int* __restrict__ glab,
                             const float* __restrict__ gbox, const int* __restrict__ idx,
                             const bool* __restrict__ fg, const float* __restrict__ align_sel,
                             const float* __restrict__ pos_align, const float* __restrict__ pos_ovl,
                             int* labels, float* boxes, float* tscores) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * A) return;
  const int bg = (int)(i / A) * G + idx[i];
  const float norm = fg[i] ? align_sel[i] * pos_ovl[bg] / (pos_align[bg] + eps) : 0.f;
  const int lab = glab[bg];
  labels[i] = lab;
  for (int c = 0; c < 4; ++c) boxes[4 * i + c] = gbox[4 * (size_t)bg + c];
  float* s = tscores + i * ncls;
  for (int c = 0; c < ncls; ++c) s[c] = (fg[i] && c == lab) ? norm : 0.f;
}

inline int blocks_for(size_t n) { return (int)((n + NT - 1) / NT); }

}  // namespace

extern "C" {

// Inputs: scores (B, A, nc), pbox (B, A, 4) xyxy, anc (A, 2), glab (B, G)
// int32 already clipped to [0, nc-1], gbox (B, G, 4) xyxy, gmask (B, G) int32.
// Outputs: labels (B, A) int32, boxes (B, A, 4), tscores (B, A, ncls),
// fg (B, A) bool, idx (B, A) int32. Scratch: patan (B, A), gatan, pos_align,
// pos_ovl (B, G), picks (B, G, K) int32, claims (B, A, 2) int32, align_sel (B, A).
// Returns the first CUDA error of the four launches (0 on success).
int tal_assign(int B, int A, int G, int nc, int ncls, int K, float eps, const float* scores,
               const float* pbox, const float* anc, const int* glab, const float* gbox,
               const int* gmask, int* labels, float* boxes, float* tscores, bool* fg, int* idx,
               float* patan, float* gatan, int* picks, float* pos_align, float* pos_ovl, int* claims,
               float* align_sel, void* stream) {
  if (K < 1 || K > MAXK || G < 1 || A < K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t ba = (size_t)B * A, bg = (size_t)B * G;
  tal_prep_kernel<<<blocks_for(ba + bg), NT, 0, s>>>((int)ba, (int)bg, pbox, gbox, patan, gatan, claims,
                                                  pos_align, pos_ovl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tal_topk_kernel<<<(int)bg, NT, 0, s>>>(A, G, nc, K, eps, scores, pbox, anc, patan, glab, gbox, gatan, gmask,
                                    picks, claims);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tal_resolve_kernel<<<blocks_for(ba), NT, 0, s>>>(B, A, G, nc, eps, scores, pbox, anc, patan, glab, gbox, gatan,
                                              gmask, claims, idx, fg, align_sel, pos_align, pos_ovl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tal_final_kernel<<<blocks_for(ba), NT, 0, s>>>(B, A, G, ncls, eps, glab, gbox, idx, fg, align_sel, pos_align,
                                             pos_ovl, labels, boxes, tscores);
  return (int)cudaGetLastError();
}

}  // extern "C"
