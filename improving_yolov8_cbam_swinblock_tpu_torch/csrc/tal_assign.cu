// Task-aligned assigner for Hopper (sm_90a): one launch over the candidate anchors only.
//
// Replaces the TPU kernel `_tal_kernel` launched by `tal_assign_fused`
// (improving_yolov8_cbam_swinblock_tpu/ops/pallas/tal_kernel.py). Same
// function: candidate gate (anchor centre strictly inside a valid GT), per-GT
// class score, pairwise CIoU with atan(w/h) once per box, align =
// sqrt(score) * overlap^6, top-k per GT with the first index winning ties,
// an anchor claimed by several GTs given to the argmax of overlaps over all
// GTs, target gather and the normalisation align * max_ovl / (max_align + eps).
//
// Bound. Only a pair whose anchor centre lies inside a valid GT can have a
// nonzero align or overlap; every other pair is 0. So the operations are
// ~67 FLOP per candidate pair (a few percent of B*G*A on the train path), and
// the least time is that of the bytes: scores, predicted boxes, anchors and
// GTs read once, labels, boxes, scores, fg and GT index written once (6.7 MB,
// about 2 us at B=16, A=8400, G=128, nc=1 on the H100).
//
// Design: one launch; an image is one thread-block cluster of `cs` blocks of
// 1024 threads (choose_cs: the largest cs <= 8 of which the card holds all B
// clusters at once; 6 at B=16 on the H100, 96 SMs), and its state stays in
// the cluster's shared memory:
//   - every block holds the image's GT table (box, atan, clamped label, valid);
//   - block r owns the anchors [r*chunk, (r+1)*chunk): their claim (none, one
//     GT, or several) and their selected align; and the GTs g % cs == r: their
//     max align and max overlap over positives (atomicMax on the bits of
//     non-negative floats). Other blocks reach them through distributed
//     shared memory. Cluster barriers separate the phases; no global atomics,
//     no scratch in device memory, and no result depends on the order in
//     which blocks or warps run.
// Phases:
//   0. The GT table; each block checks that its anchors are the grid's cell
//      centres (i + 0.5) * stride, bit for bit. The grid only narrows the
//      scan: where some anchor of the image is not its cell's centre, every
//      anchor is a slot of each GT (slower, same result).
//   1. The candidate rectangles of the block's GTs (per level of the anchor
//      grid, h, w and stride per level; rect_of), concatenated, are cut into
//      32 equal ranges, one per warp, so that large and small GTs cost the
//      warps alike. Each anchor in them is gated by the exact inside() test on
//      the anchor values given. A warp keeps the top K (<= 16) of each GT
//      segment of its range spread over its lanes, lane j the j-th best by
//      (value desc, index asc); 32 candidates go in at a time by ballot and
//      shuffles, in registers. Then one warp per GT merges its segments'
//      lists, and the picks claim their anchors. When fewer than K anchors
//      have align > 0, the plain version's first-index argmax fills the
//      remaining picks with the lowest anchor indices outside that set (all
//      below 32): those claim too where the anchor is a candidate.
//   2. Per owned anchor: one claim gives its GT; several give the argmax of
//      overlap over the GTs that contain the anchor, found by a warp, or GT 0
//      when that overlap is 0 (the plain argmax over all GTs, first index on
//      ties: GT 0 wins even where it does not contain the anchor). The chosen
//      pair's align is kept, and its GT's maxima raised.
//   3. Per owned anchor the normalised score; then labels, boxes, scores, fg
//      and GT index are written once, with coalesced stores.
// What the earlier four-launch design lost, and what this does about it:
// dense work over all B*G*A pairs (here only the candidate rectangles),
// every (image, GT) block reading its image's inputs again (here each
// candidate's inputs once per GT that contains it, from L2), per-thread
// top-k lists in local memory and barrier-heavy merges (here lists in
// registers across lanes), and four launches with host-side casts and seven
// scratch tensors (here one launch that reads the labels and mask as given).
// What sets its pace (`chip_smoke.py --k2`: the same launch on inputs that
// take one cost away at a time, at B=16, A=8400, G=128 on the H100): about a
// fifth is fixed (every GT masked out: the GT table, the grid check, the
// barriers, the stores), a little over half is the scan of the candidate
// rectangles with its loads and CIoU (scores 0: no insertions), the rest the
// top-k insertions, merges and claims. How the scan splits between its loads
// and its CIoU is not measured.
//
// Numerics: fp32, built with -fmad=false, so each operation of the CIoU
// rounds as the plain version's separate PyTorch ops do and near ties pick
// the same anchors.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;
constexpr int NW = NT / 32;
constexpr int MAXK = 16;
constexpr int MAXL = 8;    // levels of the anchor grid
constexpr int MAXCS = 8;   // blocks of a cluster (the portable limit)
constexpr float CEPS = 1e-7f;
constexpr float CIOU_V = (float)(4.0 / (3.14159265358979323846 * 3.14159265358979323846));
constexpr float ONE_EPS = (float)(1.0 + 1e-7);
constexpr int BIG = 0x7fffffff;
constexpr int NONE = -1;   // claim states: no GT, a GT index, or several GTs
constexpr int MULTI = -2;
constexpr unsigned FULL = 0xffffffffu;

enum { LAB_I32 = 0, LAB_F32 = 1 };

struct Params {
  int A, G, nc, ncls, K, cs, chunk, gchunk;
  float eps;
  const float* scores;
  long long ssb, ssa, ssc;  // scores' strides in elements: any layout
  const float4* pbox;
  const float2* anc;
  const void* glab;
  int lab_kind;
  const float* gmask;
  const float4* gbox;
  int nlev;
  int lev_h[MAXL], lev_w[MAXL], lev_off[MAXL];
  float lev_s[MAXL];
  int* labels;
  float4* boxes;
  float* tscores;
  bool* fg;
  int* idx;
};

struct Gt {
  float x1, y1, x2, y2, atan;
  int valid;
};

__device__ __forceinline__ bool inside(const Gt& t, float ax, float ay, float eps) {
  return t.valid && (ax - t.x1 > eps) && (ay - t.y1 > eps) && (t.x2 - ax > eps) && (t.y2 - ay > eps);
}

__device__ __forceinline__ float box_atan(float4 p) { return atanf((p.z - p.x) / ((p.w - p.y) + CEPS)); }

// overlap (clipped CIoU, box1 = GT, box2 = prediction) and align of one pair
__device__ __forceinline__ void pair(const Gt& t, float ax, float ay, float4 pb, float patan, float score,
                                     float eps, float* ovl, float* align) {
  const float cf = inside(t, ax, ay, eps) ? 1.f : 0.f;
  const float px1 = pb.x, py1 = pb.y, px2 = pb.z, py2 = pb.w;
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

__device__ __forceinline__ int read_label(const Params& p, size_t i) {
  // as the plain version: .long() (truncation), then clamp to [0, nc-1]
  if (p.lab_kind == LAB_I32) return min(max(__ldg(static_cast<const int*>(p.glab) + i), 0), p.nc - 1);
  const float x = __ldg(static_cast<const float*>(p.glab) + i);
  return x >= (float)(p.nc - 1) ? p.nc - 1 : (x >= 1.f ? (int)x : 0);
}

struct Smem {
  float4* box;               // [G] GT boxes
  float* atan;               // [G] their atan(w/h)
  int* lab;                  // [G] clamped label, or ~label for a masked-out GT
  int* claim;                // [chunk] owned anchors: NONE, a GT, MULTI; after phase 2 the target GT or NONE
  float* sal;                // [chunk] owned anchors: selected align, then the normalised score
  float* pal;                // [gchunk] owned GTs: max align over positives
  float* pov;                // [gchunk] owned GTs: max overlap over positives
  int* multi;                // [chunk + 1] owned anchors claimed by several GTs, then their count
  int* spre;                 // [gchunk + 1] slot prefix of the block's GTs
  float* lv;                 // [(NW + gchunk) * K] the segments' top-k lists
  int* li;
  int* off_grid;             // [1] some owned anchor is not its grid cell's centre
  bool dense;                // some anchor of the image is not: every anchor is a slot
};

__device__ __forceinline__ Gt gt_at(const Smem& s, int g) {
  const float4 b = s.box[g];
  return {b.x, b.y, b.z, b.w, s.atan[g], s.lab[g] >= 0};
}

__device__ __forceinline__ int gt_label(const Smem& s, int g) {
  const int l = s.lab[g];
  return l >= 0 ? l : ~l;
}

__device__ __forceinline__ float score_at(const Params& p, int b, int a, int lab) {
  return __ldg(p.scores + (long long)b * p.ssb + (long long)a * p.ssa + (long long)lab * p.ssc);
}

// (v1, a1) ranks before (v2, a2): value descending, index ascending
__device__ __forceinline__ bool beats(float v1, int a1, float v2, int a2) { return v1 > v2 || (v1 == v2 && a1 < a2); }

// Candidate rectangle of a GT on level l: the centres (i + 0.5) * st
// strictly inside (x1, x2) have i in (x1/st - 0.5, x2/st - 0.5). The range
// is widened by RECT_MARGIN of a cell (and eps) on each side, which covers
// the rounding of these few fp32 operations and of the anchor values many
// times over; inside() then decides. fmaxf/fminf clamp before the casts, so a
// NaN or huge coordinate gives a valid (maybe empty) range. This holds only
// where the anchors are the grid's cell centres; for an image whose anchors
// are not (s.dense), every anchor is a slot of level 0 and inside() decides.
constexpr float RECT_MARGIN = 1.f / 64;

struct Rect {
  int c0, r0, ncol, n;
};

__device__ __forceinline__ Rect rect_of(const Params& p, const Smem& s, const Gt& t, int l) {
  if (s.dense) return l == 0 ? Rect{0, 0, p.A, p.A} : Rect{0, 0, 0, 0};
  const float st = p.lev_s[l];
  const float m = RECT_MARGIN + fabsf(p.eps) / st;
  const float w1 = (float)(p.lev_w[l] - 1), h1 = (float)(p.lev_h[l] - 1);
  const int c0 = (int)fminf(fmaxf(floorf(t.x1 / st - 0.5f - m) + 1.f, 0.f), w1);
  const int c1 = (int)fminf(fmaxf(ceilf(t.x2 / st - 0.5f + m) - 1.f, 0.f), w1);
  const int r0 = (int)fminf(fmaxf(floorf(t.y1 / st - 0.5f - m) + 1.f, 0.f), h1);
  const int r1 = (int)fminf(fmaxf(ceilf(t.y2 / st - 0.5f + m) - 1.f, 0.f), h1);
  const int ncol = max(c1 - c0 + 1, 0);
  return {c0, r0, ncol, ncol * max(r1 - r0 + 1, 0)};
}

// the slots of a valid GT: its rectangles' cells over all levels
__device__ __forceinline__ int gt_slots(const Params& p, const Smem& s, const Gt& t) {
  int n = 0;
  for (int l = 0; l < p.nlev; ++l) n += rect_of(p, s, t, l).n;
  return n;
}

// anchor a is picked by GT g: none -> g, g' -> several
__device__ __forceinline__ void claim_anchor(const Params& p, const Smem& s, int a, int g) {
  const int owner = a / p.chunk;
  int* c = cg::this_cluster().map_shared_rank(s.claim, owner) + (a - owner * p.chunk);
  if (atomicCAS(c, NONE, g) != NONE) atomicExch(c, MULTI);
}

// (nv, na) goes into the warp's list (lane j < K holds the j-th best) if it
// beats the K-th; warp-uniform arguments
__device__ __forceinline__ void insert(int K, int lane, float nv, int na, float& lv, int& li) {
  const int pos = __popc(__ballot_sync(FULL, lane < K && beats(lv, li, nv, na)));
  const float uv = __shfl_up_sync(FULL, lv, 1);
  const int ui = __shfl_up_sync(FULL, li, 1);
  if (pos < K) {
    if (lane > pos && lane < K) {
      lv = uv;
      li = ui;
    }
    if (lane == pos) {
      lv = nv;
      li = na;
    }
  }
}

// (v, a) of each lane with v > 0 go into the warp's list (lv, li) where
// they beat its K-th entry
__device__ __forceinline__ void insert_batch(int K, int lane, float v, int a, float& lv, int& li) {
  float tv = __shfl_sync(FULL, lv, K - 1);
  int ti = __shfl_sync(FULL, li, K - 1);
  unsigned acc = __ballot_sync(FULL, v > 0.f && beats(v, a, tv, ti));
  while (acc) {
    const int src = __ffs(acc) - 1;
    const float nv = __shfl_sync(FULL, v, src);
    const int na = __shfl_sync(FULL, a, src);
    insert(K, lane, nv, na, lv, li);
    tv = __shfl_sync(FULL, lv, K - 1);
    ti = __shfl_sync(FULL, li, K - 1);
    acc &= (acc - 1) & __ballot_sync(FULL, beats(v, a, tv, ti));
  }
}

// Slots [u0, u1) of GT g (its rectangles level after level, row-major: the
// anchor index ascends with the slot) go into the warp's list (lv, li), those
// with align > 0 only, 32 slots at a time.
__device__ void scan_segment(const Params& p, const Smem& s, int b, int g, int u0, int u1, int lane, float& lv,
                             int& li) {
  const Gt t = gt_at(s, g);
  const int lab = gt_label(s, g);
  const int K = p.K;
  const float4* pbox = p.pbox + (size_t)b * p.A;
  int lo = 0;
  for (int l = 0; l < p.nlev && lo < u1; ++l) {
    const Rect rc = rect_of(p, s, t, l);
    const int first = max(u0 - lo, 0), last = min(u1 - lo, rc.n);
    const int off = p.lev_off[l] + rc.r0 * p.lev_w[l] + rc.c0;
    const float inv = 1.f / (float)max(rc.ncol, 1);
    for (int base = first; base < last; base += 32) {
      const int tt = base + lane;
      int a = BIG;
      float v = 0.f, o;
      if (tt < last) {
        int rr = (int)(((float)tt + 0.5f) * inv);  // tt / ncol, then corrected to exact
        rr -= rr * rc.ncol > tt;
        rr += (rr + 1) * rc.ncol <= tt;
        a = off + rr * p.lev_w[l] + (tt - rr * rc.ncol);
        const float2 ap = __ldg(p.anc + a);  // the three loads go out together, then the gate
        const float4 pb = __ldg(pbox + a);
        const float sc = score_at(p, b, a, lab);
        if (inside(t, ap.x, ap.y, p.eps)) pair(t, ap.x, ap.y, pb, box_atan(pb), sc, p.eps, &o, &v);
      }
      insert_batch(K, lane, v, a, lv, li);
    }
    lo += rc.n;
  }
}

// The picks that come from the zero fill: when only cnt < K anchors have
// align > 0 (`in_p`: those of them below 32), the plain top-k takes the
// K - cnt lowest indices outside that set; each claims where it is a candidate.
__device__ __forceinline__ void zero_fill(const Params& p, const Smem& s, int g, int cnt, unsigned in_p, int lane) {
  const bool free_ = !((in_p >> lane) & 1u) && lane < p.A;
  const unsigned fr = __ballot_sync(FULL, free_);
  if (free_ && __popc(fr & ((1u << lane) - 1u)) < p.K - cnt) {
    const float2 ap = __ldg(p.anc + lane);
    if (inside(gt_at(s, g), ap.x, ap.y, p.eps)) claim_anchor(p, s, lane, g);
  }
}

__global__ void __launch_bounds__(NT, 1) tal_assign_kernel(const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / p.cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G, K = p.K, cs = p.cs;
  const int ng = (G - r + cs - 1) / cs;  // this block's GTs: g = r + cs * j, j < ng

  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s;
  s.box = reinterpret_cast<float4*>(smem_raw);
  s.atan = reinterpret_cast<float*>(s.box + G);
  s.lab = reinterpret_cast<int*>(s.atan + G);
  s.claim = s.lab + G;
  s.sal = reinterpret_cast<float*>(s.claim + p.chunk);
  s.pal = s.sal + p.chunk;
  s.pov = s.pal + p.gchunk;
  s.multi = reinterpret_cast<int*>(s.pov + p.gchunk);
  s.spre = s.multi + p.chunk + 1;
  s.lv = reinterpret_cast<float*>(s.spre + p.gchunk + 1);
  s.li = reinterpret_cast<int*>(s.lv + (NW + p.gchunk) * K);
  s.off_grid = s.li + (NW + p.gchunk) * K;

  // phase 0: the image's GT table; owned state reset; whether each owned
  // anchor is its grid cell's centre (exactly); the slots of this block's GTs
  for (int g = tid; g < G; g += NT) {
    const size_t bg = (size_t)b * G + g;
    const float4 bx = __ldg(p.gbox + bg);
    s.box[g] = bx;
    s.atan[g] = box_atan(bx);
    const int lab = read_label(p, bg);
    s.lab[g] = __ldg(p.gmask + bg) > 0.f ? lab : ~lab;
  }
  for (int i = tid; i < p.chunk; i += NT) s.claim[i] = NONE;
  if (tid == 0) s.multi[p.chunk] = 0;
  for (int i = tid; i < p.gchunk; i += NT) s.pal[i] = s.pov[i] = 0.f;
  const int a0 = r * p.chunk;
  const int na = max(0, min(p.A - a0, p.chunk));
  bool off_grid = false;
  for (int i = tid; i < na; i += NT) {
    const int a = a0 + i;
    int l = 0;
    while (l + 1 < p.nlev && a >= p.lev_off[l + 1]) ++l;
    const int c = a - p.lev_off[l], row = c / p.lev_w[l], col = c - row * p.lev_w[l];
    const float2 ap = __ldg(p.anc + a);
    off_grid |= !(ap.x == ((float)col + 0.5f) * p.lev_s[l] && ap.y == ((float)row + 0.5f) * p.lev_s[l]);
  }
  off_grid = __syncthreads_or(off_grid);
  if (tid == 0) *s.off_grid = off_grid;
  cluster.sync();
  s.dense = false;
  for (int q = 0; q < cs; ++q) s.dense |= *cluster.map_shared_rank(s.off_grid, q) != 0;
  for (int j = tid; j < ng; j += NT) {
    const Gt t = gt_at(s, r + cs * j);
    s.spre[j + 1] = t.valid ? gt_slots(p, s, t) : 0;
  }
  __syncthreads();
  if (warp == 0) {  // inclusive prefix of the slot counts
    int carry = 0;
    for (int base = 0; base < ng; base += 32) {
      const int j = base + lane;
      int v = j < ng ? s.spre[j + 1] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += u;
      }
      if (j < ng) s.spre[j + 1] = v + carry;
      carry += __shfl_sync(FULL, v, 31);
    }
    if (lane == 0) s.spre[0] = 0;
  }
  __syncthreads();

  // phase 1a: the block's slots, GT after GT, cut into NW equal ranges of
  // whole batches, one per warp; each GT segment of a range leaves its top-k
  // list at slot j + warp (unique: j and warp both ascend along the slots)
  const int T = s.spre[ng];
  const int per = max(((T + NW - 1) / NW + 31) & ~31, 32);
  {
    int s0 = min(T, warp * per);
    const int s1 = min(T, s0 + per);
    int lo = 0, hi = ng;  // the GT j of slot s0: spre[j] <= s0 < spre[j + 1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (s.spre[mid] <= s0) lo = mid;
      else hi = mid;
    }
    for (int j = lo; s0 < s1; ++j) {
      const int e = min(s1, s.spre[j + 1]);
      if (e <= s0) continue;  // a GT without slots
      float lv = -1.f;
      int li = BIG;
      scan_segment(p, s, b, r + cs * j, s0 - s.spre[j], e - s.spre[j], lane, lv, li);
      if (lane < K) {
        s.lv[(j + warp) * K + lane] = lv;
        s.li[(j + warp) * K + lane] = li;
      }
      s0 = e;
    }
  }
  __syncthreads();

  // phase 1b: per GT, one warp merges its segments' lists; the picks claim their anchors
  for (int j = warp; j < ng; j += NW) {
    if (s.spre[j + 1] == s.spre[j]) continue;  // masked out: no candidate
    const int g = r + cs * j;
    const int w0 = s.spre[j] / per, w1 = (s.spre[j + 1] - 1) / per;
    float lv = lane < K ? s.lv[(j + w0) * K + lane] : -1.f;
    int li = lane < K ? s.li[(j + w0) * K + lane] : BIG;
    for (int w = w0 + 1; w <= w1; ++w)
      insert_batch(K, lane, lane < K ? s.lv[(j + w) * K + lane] : -1.f, lane < K ? s.li[(j + w) * K + lane] : BIG,
                   lv, li);
    const int cnt = __popc(__ballot_sync(FULL, lane < K && li != BIG));
    if (lane < cnt) claim_anchor(p, s, li, g);
    if (cnt < K) zero_fill(p, s, g, cnt, __reduce_or_sync(FULL, (lane < cnt && li < 32) ? (1u << li) : 0u), lane);
  }
  cluster.sync();

  // phase 2: each owned anchor's target GT, its align, and that GT's maxima. One
  // claim gives the GT; several go to the highest overlap over all GTs, first
  // index, which a warp finds over the GTs that contain the anchor (GT 0 if
  // that overlap is 0).
  for (int i = tid; i < na; i += NT) {
    const int a = a0 + i;
    const int c = s.claim[i];
    float al = 0.f, o = 0.f;
    if (c >= 0) {
      const float2 ap = __ldg(p.anc + a);
      const float4 pb = __ldg(p.pbox + (size_t)b * p.A + a);
      pair(gt_at(s, c), ap.x, ap.y, pb, box_atan(pb), score_at(p, b, a, gt_label(s, c)), p.eps, &o, &al);
      const int owner = c % cs;
      atomicMax(reinterpret_cast<int*>(cluster.map_shared_rank(s.pal, owner) + c / cs), __float_as_int(al));
      atomicMax(reinterpret_cast<int*>(cluster.map_shared_rank(s.pov, owner) + c / cs), __float_as_int(o));
    } else if (c == MULTI) {
      s.multi[atomicAdd(&s.multi[p.chunk], 1)] = i;  // in any order: each anchor's result is its own
    }
    s.sal[i] = al;
  }
  __syncthreads();
  for (int m = warp; m < s.multi[p.chunk]; m += NW) {
    const int i = s.multi[m], a = a0 + i;
    const float2 ap = __ldg(p.anc + a);
    const float4 pb = __ldg(p.pbox + (size_t)b * p.A + a);
    const float pat = box_atan(pb);
    float o = 0.f, al = 0.f;
    int tg = BIG;
    for (int g = lane; g < G; g += 32) {  // ascending: a lane keeps its first best
      const Gt t = gt_at(s, g);
      if (!inside(t, ap.x, ap.y, p.eps)) continue;
      float og, ag;
      pair(t, ap.x, ap.y, pb, pat, score_at(p, b, a, gt_label(s, g)), p.eps, &og, &ag);
      if (og > o) {
        o = og;
        al = ag;
        tg = g;
      }
    }
    for (int d = 16; d > 0; d >>= 1) {  // (overlap desc, index asc) over the lanes
      const float oo = __shfl_xor_sync(FULL, o, d), ao = __shfl_xor_sync(FULL, al, d);
      const int go = __shfl_xor_sync(FULL, tg, d);
      if (oo > o || (oo == o && go < tg)) {
        o = oo;
        al = ao;
        tg = go;
      }
    }
    if (lane == 0) {
      if (tg == BIG) {  // overlap 0 with every GT: GT 0
        tg = 0;
      } else {
        const int owner = tg % cs;
        atomicMax(reinterpret_cast<int*>(cluster.map_shared_rank(s.pal, owner) + tg / cs), __float_as_int(al));
        atomicMax(reinterpret_cast<int*>(cluster.map_shared_rank(s.pov, owner) + tg / cs), __float_as_int(o));
      }
      s.claim[i] = tg;
      s.sal[i] = al;
    }
  }
  cluster.sync();

  // phase 3: the normalised scores (the maxima may live in another block), then every output once
  for (int i = tid; i < na; i += NT) {
    const int tg = s.claim[i];
    if (tg >= 0) {
      const int owner = tg % cs;
      const float pa = cluster.map_shared_rank(s.pal, owner)[tg / cs];
      const float po = cluster.map_shared_rank(s.pov, owner)[tg / cs];
      s.sal[i] = s.sal[i] * po / (pa + p.eps);
    }
  }
  cluster.sync();  // no block leaves while another may still read its maxima
  const size_t o0 = (size_t)b * p.A + a0;
  for (int i = tid; i < na; i += NT) {
    const int c = s.claim[i];
    const int tg = max(c, 0);
    p.labels[o0 + i] = gt_label(s, tg);
    p.idx[o0 + i] = tg;
    p.fg[o0 + i] = c >= 0;
    p.boxes[o0 + i] = s.box[tg];
  }
  const int ncls = p.ncls;
  for (int e = tid; e < na * ncls; e += NT) {
    const int i = e / ncls;
    const int c = s.claim[i];
    p.tscores[o0 * ncls + e] = (c >= 0 && e - i * ncls == gt_label(s, c)) ? s.sal[i] : 0.f;
  }
}

size_t smem_bytes(int A, int G, int cs, int K) {
  const size_t chunk = (A + cs - 1) / cs, gchunk = (G + cs - 1) / cs;
  return (size_t)G * (16 + 4 + 4) + chunk * (4 + 4 + 4) + 4 + gchunk * (4 + 4 + 4) + 4 + (NW + gchunk) * K * 8 + 4;
}

// The cluster size (blocks per image) for (B, A, G, K): the largest up to 8
// whose shared memory fits and of whose clusters the card can hold all B at
// once (not only powers of 2: the card's SMs come in groups that 8 does not
// always divide), else the largest that fits at all; 0 if none. Remembers
// its last answer.
int choose_cs(int B, int A, int G, int K, size_t* smem, int* active) {
  static int last_B = -1, last_A = -1, last_G = -1, last_K = -1, last_cs = 0, last_active = 0;
  static size_t last_smem = 0;
  if (B == last_B && A == last_A && G == last_G && K == last_K) {
    *smem = last_smem;
    *active = last_active;
    return last_cs;
  }
  int dev, optin;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (cudaFuncSetAttribute(tal_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin) != cudaSuccess)
    return 0;
  int pick = 0, fallback = 0, held[MAXCS + 1] = {};
  for (int cs = MAXCS; cs >= 1 && !pick; --cs) {
    if (smem_bytes(A, G, cs, K) > (size_t)optin) continue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem_bytes(A, G, cs, K);
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = cs;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, tal_assign_kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    held[cs] = clusters;
    if (clusters >= 1 && !fallback) fallback = cs;
    if (clusters >= B) pick = cs;
  }
  if (!pick) pick = fallback;
  if (!pick) return 0;
  last_B = B, last_A = A, last_G = G, last_K = K, last_cs = pick, last_smem = smem_bytes(A, G, pick, K);
  last_active = held[pick];
  *smem = last_smem;
  *active = last_active;
  return pick;
}

}  // namespace

extern "C" {

// The cluster size, shared memory per block and the clusters of that shape
// the card can hold at once, as tal_assign would use them (0 if none fits).
int tal_assign_config(int B, int A, int G, int K, size_t* smem, int* active) {
  return choose_cs(B, A, G, K, smem, active);
}

// Inputs: scores (B, A, nc) fp32 with element strides (ssb, ssa, ssc), pbox
// (B, A, 4) xyxy, anc (A, 2) the anchor points, glab (B, G) int32 or
// float32 (lab_kind 0, 1), gbox (B, G, 4) xyxy, gmask (B, G) float32; the
// grid, one (h, w, stride) per level, sum h*w == A, whose cell centres
// (i + 0.5) * stride, level after level, row-major, the anchor points are
// (an image whose anchors are not is scanned over every anchor). Outputs: labels (B, A) int32, boxes
// (B, A, 4), tscores (B, A, ncls), fg (B, A) bool, idx (B, A) int32. One
// launch on `stream`; returns its CUDA error, cudaErrorInvalidValue for
// arguments it does not take, or -1 when no cluster of this shape fits the card.
int tal_assign(int B, int A, int G, int nc, int ncls, int K, float eps, const float* scores, long long ssb,
               long long ssa, long long ssc, const float* pbox, const float* anc, const void* glab, int lab_kind,
               const float* gmask, const float* gbox, int nlev, const int* lev_h, const int* lev_w,
               const float* lev_s, int* labels, float* boxes, float* tscores, bool* fg, int* idx, void* stream) {
  if (K < 1 || K > MAXK || G < 1 || A < K || B < 1 || nc < 1 || ncls < nc || nlev < 1 || nlev > MAXL ||
      lab_kind < LAB_I32 || lab_kind > LAB_F32)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  int off = 0;
  for (int l = 0; l < nlev; ++l) {
    if (lev_h[l] < 1 || lev_w[l] < 1 || !(lev_s[l] > 0.f)) return (int)cudaErrorInvalidValue;
    p.lev_h[l] = lev_h[l];
    p.lev_w[l] = lev_w[l];
    p.lev_s[l] = lev_s[l];
    p.lev_off[l] = off;
    off += lev_h[l] * lev_w[l];
  }
  if (off != A) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  int active = 0;
  const int cs = choose_cs(B, A, G, K, &smem, &active);
  if (cs == 0) return -1;
  p.A = A, p.G = G, p.nc = nc, p.ncls = ncls, p.K = K, p.cs = cs, p.eps = eps;
  p.chunk = (A + cs - 1) / cs;
  p.gchunk = (G + cs - 1) / cs;
  p.scores = scores, p.ssb = ssb, p.ssa = ssa, p.ssc = ssc;
  p.pbox = reinterpret_cast<const float4*>(pbox);
  p.anc = reinterpret_cast<const float2*>(anc);
  p.glab = glab, p.lab_kind = lab_kind, p.gmask = gmask;
  p.gbox = reinterpret_cast<const float4*>(gbox);
  p.nlev = nlev;
  p.labels = labels, p.boxes = reinterpret_cast<float4*>(boxes), p.tscores = tscores, p.fg = fg, p.idx = idx;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cs);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, tal_assign_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
