// Block-level bf16 tensor-core products of one 7x7 window, shared by the
// SwinBlock forward (swin_block_fwd.cu) and backward (swin_block_bwd.cu).
//
// Every product is C[r, n] = sum_k A[r, k] * B(k, n) for the window's 49
// token rows, padded to MROWS = 64 (four m16 tiles). It runs on
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: bf16 operands, fp32
// accumulation, the function of the TPU kernels' bf16 x bf16 -> fp32
// jnp.dot; only the order of the fp32 sums differs. Operand fragments come
// from bf16 tiles in shared memory through ldmatrix (.trans for an operand
// stored k-major). A tile row holds 16*m + PAD elements, an odd number of
// 16-byte units, so the eight rows an ldmatrix phase reads fall in distinct
// banks.
//
// A block of 128 * WN threads computes the output in column blocks of
// BN = 8 * NT * WN: its warps form a 4 x WN grid, each warp 16 rows x
// 8 * NT columns (NT m16n8 tiles). Each output element is handed once to
// epi(r, n, value) for r < NTOK and n < N: the epilogue runs on the fp32
// accumulators in registers.
//
// B is either in shared memory as a whole (product_smem), or it streams
// from global memory (weights, L2-resident) through a STAGES-deep cp.async
// ring of KT-deep tiles (product_stream); A is either resident in shared
// memory or streams through the same ring. Rows past the window are
// zero-filled by the copy and never stored.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace swin_mma {

using bf16 = __nv_bfloat16;

constexpr int NTOK = 49;      // tokens of a 7x7 window
constexpr int MROWS = 64;     // rows of a product: NTOK padded to four m16 tiles
constexpr int NTHREADS = 256;  // threads of a block with the default WN = 2 warp columns
constexpr int KT = 32;        // k depth of one ring stage
constexpr int STAGES = 4;     // ring depth: three stages in flight while one is multiplied
constexpr int PAD = 8;        // bf16 elements added to each tile row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src is not read then)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A fragment (16 rows x 16 k) of a row-major bf16 tile at rows m0.., columns k0..
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int ld, int m0, int k0, int lane) {
  ldsm_x4(a, t + (m0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}

// B fragments of two n8 tiles (n0.., n0+8..) x 16 k: b[0], b[1] for the
// first, b[2], b[3] for the second. KN: the tile is stored k-major (row k,
// n contiguous); otherwise n-major (row n, k contiguous: PyTorch's
// (out, in) weight layout).
template <bool KN>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* t, int ld, int k0, int n0, int lane) {
  if constexpr (KN)
    ldsm_x4_t(b, t + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 + ((lane >> 4) << 3));
  else
    ldsm_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + (((lane >> 3) & 1) << 3));
}

// acc += A[wm's 16 rows, 0:16*KS] B[0:16*KS, n] for the k-steps below
// kvalid, over the warp's pairs of n8 tiles, from column nw of the tile,
// that start below nvalid. The fragments of step s + 1 are loaded before
// the products of step s are issued, so that their shared-memory latency
// overlaps the tensor cores' work.
template <int NT, bool KN, int KS>
__device__ __forceinline__ void mma_ksteps(float (&acc)[NT][4], const bf16* at, int lda, const bf16* bt, int ldb,
                                           int kvalid, int nw, int nvalid, int wm, int lane) {
  uint32_t a[2][4], b[2][NT / 2][4];
  auto load = [&](int s, int buf) {
    load_a(a[buf], at, lda, wm * 16, s * 16, lane);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp)
      if (nw + jp * 16 < nvalid) load_b<KN>(b[buf][jp], bt, ldb, s * 16, nw + jp * 16, lane);
  };
  load(0, 0);
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (s * 16 >= kvalid) break;
    if (s + 1 < KS && (s + 1) * 16 < kvalid) load(s + 1, (s + 1) & 1);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      if (nw + jp * 16 < nvalid) {
        mma_bf16(acc[2 * jp], a[s & 1], b[s & 1][jp][0], b[s & 1][jp][1]);
        mma_bf16(acc[2 * jp + 1], a[s & 1], b[s & 1][jp][2], b[s & 1][jp][3]);
      }
    }
  }
}

// A side input of an epilogue: element (r, n) is p[r * ld + n] (ld = 0: a
// vector over n, such as a bias).
struct Side {
  const float* p = nullptr;
  int ld = 0;
};

// Hand each in-range accumulator of a column block at n0 to
// epi(r, n, value, side values...), then zero it. The NSIDE side inputs of
// the whole fragment are loaded before any epilogue runs, so that their
// latencies overlap instead of queueing behind the epilogues' stores.
template <int NT, int NSIDE, typename Epi>
__device__ __forceinline__ void drain(float (&acc)[NT][4], int n0, int N, int wm, int wn, int lane, Epi& epi,
                                      Side s1, Side s2) {
  const int r = wm * 16 + (lane >> 2);
  float v1[NT][4], v2[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r + (i >> 1) * 8;
      const int nn = n0 + wn * 8 * NT + j * 8 + (lane & 3) * 2 + (i & 1);
      const bool ok = rr < NTOK && nn < N;
      v1[j][i] = NSIDE > 0 && ok ? s1.p[(size_t)rr * s1.ld + nn] : 0.f;
      v2[j][i] = NSIDE > 1 && ok ? s2.p[(size_t)rr * s2.ld + nn] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn * 8 * NT + j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r + (i >> 1) * 8;
      const int nn = n + (i & 1);
      if (rr < NTOK && nn < N) {
        if constexpr (NSIDE == 0) epi(rr, nn, acc[j][i]);
        else if constexpr (NSIDE == 1) epi(rr, nn, acc[j][i], v1[j][i]);
        else epi(rr, nn, acc[j][i], v1[j][i], v2[j][i]);
      }
      acc[j][i] = 0.f;
    }
  }
}

// C = A B with A (MROWS x K, row stride lda) and B both in shared memory:
// B is K x N stored k-major (KN) or N x K stored n-major, row stride ldb,
// with at least N rounded up to 16 rows (n-major) readable. K is a multiple
// of 16. Ends with a barrier.
template <int NT, bool KN, int WN = 2, typename Epi>
__device__ void product_smem(const bf16* A, int lda, const bf16* B, int ldb, int K, int N, Epi epi) {
  constexpr int BN = 8 * NT * WN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int n0 = 0; n0 < N; n0 += BN) {
    const bf16* bt = KN ? B + n0 : B + (size_t)n0 * ldb;
    for (int k0 = 0; k0 < K; k0 += 64)
      mma_ksteps<NT, KN, 4>(acc, A + k0, lda, KN ? bt + (size_t)k0 * ldb : bt + k0, ldb, K - k0, wn * 8 * NT,
                            N - n0, wm, lane);
    drain<NT, 0>(acc, n0, N, wm, wn, lane, epi, Side(), Side());
  }
  __syncthreads();
}

// bf16 elements of one ring stage of product_stream
template <int NT, bool A_GLOBAL, bool KN, int WN = 2>
__host__ __device__ constexpr int stage_elems() {
  return (A_GLOBAL ? MROWS * (KT + PAD) : 0) + (KN ? KT * (8 * NT * WN + PAD) : 8 * NT * WN * (KT + PAD));
}

template <int NT, bool A_GLOBAL, bool KN, int WN = 2>
__host__ __device__ constexpr size_t ring_bytes() {
  return sizeof(bf16) * STAGES * stage_elems<NT, A_GLOBAL, KN, WN>();
}

// C = A B with B in global memory, streamed through the ring: element
// (k, n) of B is W[(koff + k) * ldw + n] when KN, else
// W[wrow(n) * ldw + koff + k]. A is resident in shared memory (MROWS x K,
// row stride lda) or, with A_GLOBAL, streams through the ring from global
// rows A[r * lda + k], r < NTOK. K is a multiple of 16, N of 8; the ring
// holds ring_bytes<NT, A_GLOBAL, KN, WN>(): STAGES stages of KT-deep tiles,
// STAGES - 1 of them in flight while one is multiplied. The k-tiles of all
// column blocks form one pipeline, so the ring does not drain between
// blocks. The epilogue takes NSIDE side inputs, s1 and s2 (see drain).
// Ends with a barrier; the caller ends any use of the ring's memory with a
// barrier before the call.
template <int NT, bool A_GLOBAL, bool KN, int NSIDE = 0, int WN = 2, typename RowMap, typename Epi>
__device__ void product_stream(const bf16* A, int lda, int K, const bf16* __restrict__ W, int ldw, int koff, int N,
                               RowMap wrow, bf16* ring, Epi epi, Side s1 = Side(), Side s2 = Side()) {
  constexpr int BN = 8 * NT * WN;
  constexpr int T = 128 * WN;  // threads
  constexpr int A_LD = KT + PAD;
  constexpr int A_TILE = A_GLOBAL ? MROWS * A_LD : 0;
  constexpr int B_LD = KN ? BN + PAD : KT + PAD;
  constexpr int STAGE = stage_elems<NT, A_GLOBAL, KN, WN>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int nk = (K + KT - 1) / KT;
  const int total = nk * ((N + BN - 1) / BN);

  auto load = [&](int it) {
    bf16* st = ring + (it % STAGES) * STAGE;
    const int nb = (it / nk) * BN, k0 = (it % nk) * KT;
    if constexpr (A_GLOBAL) {
      for (int e = threadIdx.x; e < MROWS * (KT / 8); e += T) {
        const int r = e / (KT / 8), c = (e % (KT / 8)) * 8;
        const bool ok = r < NTOK && k0 + c < K;
        cp_async16(st + r * A_LD + c, ok ? A + (size_t)r * lda + k0 + c : A, ok);
      }
    }
    bf16* bt = st + A_TILE;
    if constexpr (KN) {
      for (int e = threadIdx.x; e < KT * (BN / 8); e += T) {
        const int kr = e / (BN / 8), c = (e % (BN / 8)) * 8;
        const bool ok = nb + c < N && k0 + kr < K;
        cp_async16(bt + kr * B_LD + c, ok ? W + (size_t)(koff + k0 + kr) * ldw + nb + c : W, ok);
      }
    } else {
      for (int e = threadIdx.x; e < BN * (KT / 8); e += T) {
        const int nr = e / (KT / 8), c = (e % (KT / 8)) * 8;
        const bool ok = nb + nr < N && k0 + c < K;
        cp_async16(bt + nr * B_LD + c, ok ? W + (size_t)wrow(nb + nr) * ldw + koff + k0 + c : W, ok);
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile `it` has landed for every thread; tile it-1 is consumed
    if (it + STAGES - 1 < total) load(it + STAGES - 1);
    cp_async_commit();
    const bf16* st = ring + (it % STAGES) * STAGE;
    const int nb = (it / nk) * BN, k0 = (it % nk) * KT;
    const bf16* at = A_GLOBAL ? st : A + k0;
    const int a_ld = A_GLOBAL ? A_LD : lda;
    mma_ksteps<NT, KN, KT / 16>(acc, at, a_ld, st + A_TILE, B_LD, K - k0, wn * 8 * NT, N - nb, wm, lane);
    if (it % nk == nk - 1) drain<NT, NSIDE>(acc, nb, N, wm, wn, lane, epi, s1, s2);
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace swin_mma
