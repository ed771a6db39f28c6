// Block-level int8 tensor-core products of one 7x7 window, for the int8
// SwinBlock (swin_block_int8.cu); the int8 counterparts of the bf16
// routines in swin_mma.cuh, whose layout conventions they share.
//
// Every product is C[r, n] = sum_k A[r, k] * W[wrow(n), k] for the window's
// 49 token rows, padded to MROWS = 64 (four m16 tiles), with int8 A and W
// and an exact int32 sum: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.
// |sum| <= K * 127^2 < 2^31 for K < 133,000, so any order gives the same
// bits. A is resident in shared memory; W (int8 in PyTorch's (out, in)
// layout, the "col" operand as it lies) streams from global memory through
// a cp.async ring like product_stream's, of STG stages of KT-byte-deep tiles.
//
// Fragments. A 32-byte int8 row is, to ldmatrix and to the m16n8k32
// fragment layout, a row of 16 b16 elements: thread t holds bytes
// 4 (t % 4) .. +3 of row t / 4 of each 8x8 b16 matrix, which is where
// m16n8k32 wants k = 4 (t % 4) .. +3 of A's row (and of B's column) t / 4.
// So load_a and load_b<false> of swin_mma.cuh fetch int8 fragments with
// row strides and k offsets counted in byte pairs. The int32 accumulators lie
// as m16n8k16's fp32 ones do. Tile rows are an odd number of 16-byte units
// long, so the eight rows an ldmatrix phase reads fall in distinct banks.

#pragma once

#include "swin_mma.cuh"

namespace swin_mma {

constexpr int PAD8 = 16;  // bytes added to each int8 tile row: KT + PAD8 is an odd number of 16-byte units

// c += a (16x32, row) * b (32x8, col), int8 -> int32
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src is not read then)
__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src, bool valid) {
  cp_async16(reinterpret_cast<bf16*>(dst), reinterpret_cast<const bf16*>(src), valid);
}

// A fragment (16 rows x 32 k) of a row-major int8 tile, row stride ld bytes,
// at rows m0.., bytes k0..
__device__ __forceinline__ void load_a_s8(uint32_t (&a)[4], const int8_t* t, int ld, int m0, int k0, int lane) {
  load_a(a, reinterpret_cast<const bf16*>(t), ld / 2, m0, k0 / 2, lane);
}

// B fragments of two n8 tiles (n0.., n0+8..) x 32 k of an n-major int8 tile
// (row n, k contiguous, row stride ld bytes): b[0], b[1] for the first,
// b[2], b[3] for the second
__device__ __forceinline__ void load_b_s8(uint32_t (&b)[4], const int8_t* t, int ld, int k0, int n0, int lane) {
  load_b<false>(b, reinterpret_cast<const bf16*>(t), ld / 2, k0 / 2, n0, lane);
}

// acc += A[wm's 16 rows, 0:32*KS] B[0:32*KS, n] for the k-steps below kvalid
// bytes, over the warp's pairs of n8 tiles from column nw of the tile that
// start below nvalid; the fragments of step s + 1 are loaded before the
// products of step s are issued
template <int NT, int KS>
__device__ __forceinline__ void mma_ksteps_s8(int (&acc)[NT][4], const int8_t* at, int lda, const int8_t* bt, int ldb,
                                              int kvalid, int nw, int nvalid, int wm, int lane) {
  uint32_t a[2][4], b[2][NT / 2][4];
  auto load = [&](int s, int buf) {
    load_a_s8(a[buf], at, lda, wm * 16, s * 32, lane);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp)
      if (nw + jp * 16 < nvalid) load_b_s8(b[buf][jp], bt, ldb, s * 32, nw + jp * 16, lane);
  };
  load(0, 0);
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (s * 32 >= kvalid) break;
    if (s + 1 < KS && (s + 1) * 32 < kvalid) load(s + 1, (s + 1) & 1);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      if (nw + jp * 16 < nvalid) {
        mma_s8(acc[2 * jp], a[s & 1], b[s & 1][jp][0], b[s & 1][jp][1]);
        mma_s8(acc[2 * jp + 1], a[s & 1], b[s & 1][jp][2], b[s & 1][jp][3]);
      }
    }
  }
}

// Hand each in-range int32 accumulator of a column block at n0 to
// epi(r, n, acc), then zero it
template <int NT, typename Epi>
__device__ __forceinline__ void drain_s32(int (&acc)[NT][4], int n0, int N, int wm, int wn, int lane, Epi& epi) {
  const int r = wm * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn * 8 * NT + j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r + (i >> 1) * 8;
      const int nn = n + (i & 1);
      if (rr < NTOK && nn < N) epi(rr, nn, acc[j][i]);
      acc[j][i] = 0;
    }
  }
}

// bytes of the ring of product_stream_s8<NT, WN, KT, STG>
template <int NT, int WN, int KT, int STG>
__host__ __device__ constexpr size_t ring_bytes_s8() {
  return (size_t)STG * 8 * NT * WN * (KT + PAD8);
}

// C = A W^T with A resident in shared memory (MROWS x K int8, row stride
// lda bytes, an odd number of 16-byte units) and W in global memory:
// element (k, n) of the product's right operand is W[wrow(n) * ldw + k].
// K is a multiple of 32 and ldw of 16. A block of 128 * WN threads computes
// the output in column blocks of BN = 8 * NT * WN, its warps in a 4 x WN
// grid of 16 x 8 * NT tiles. The ring holds ring_bytes_s8<NT, WN, KT, STG>():
// STG stages of KT-deep tiles (KT a multiple of 32), STG - 1 of them in
// flight while one is multiplied; the k-tiles of all column blocks form one
// pipeline. Each output's exact int32
// sum goes once to epi(r, n, acc), r < NTOK, n < N. Ends with a barrier;
// the caller ends any use of the ring's memory with a barrier before the call.
template <int NT, int WN, int KT, int STG, typename RowMap, typename Epi>
__device__ void product_stream_s8(const int8_t* A, int lda, int K, const int8_t* __restrict__ W, int ldw, int N,
                                  RowMap wrow, int8_t* ring, Epi epi) {
  constexpr int BN = 8 * NT * WN;
  constexpr int T = 128 * WN;
  constexpr int B_LD = KT + PAD8;
  static_assert(KT % 32 == 0 && (B_LD / 16) % 2 == 1, "whole k-steps; rows of an odd number of 16-byte units");
  constexpr int STAGE = BN * B_LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int total = (K + KT - 1) / KT * ((N + BN - 1) / BN);

  // the next tile to load (column block ln, k offset lk, ring stage ls) and
  // the tile to multiply (nb, k0, cs), advanced by counters: no division
  int ln = 0, lk = 0, ls = 0;
  auto load_next = [&]() {
    int8_t* bt = ring + ls * STAGE;
    for (int e = threadIdx.x; e < BN * (KT / 16); e += T) {
      const int nr = e / (KT / 16), c = (e % (KT / 16)) * 16;
      const bool ok = ln + nr < N && lk + c < K;
      cp_async16(bt + nr * B_LD + c, ok ? W + (size_t)wrow(ln + nr) * ldw + lk + c : W, ok);
    }
    ls = ls + 1 == STG ? 0 : ls + 1;
    lk += KT;
    if (lk >= K) lk = 0, ln += BN;
  };

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
#pragma unroll
  for (int s = 0; s < STG - 1; ++s) {
    if (s < total) load_next();
    cp_async_commit();
  }
  int nb = 0, k0 = 0, cs = 0;
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STG - 2>();
    __syncthreads();  // tile `it` has landed for every thread; tile it-1 is consumed
    if (it + STG - 1 < total) load_next();
    cp_async_commit();
    mma_ksteps_s8<NT, KT / 32>(acc, A + k0, lda, ring + cs * STAGE, B_LD, K - k0, wn * 8 * NT, N - nb, wm, lane);
    cs = cs + 1 == STG ? 0 : cs + 1;
    k0 += KT;
    if (k0 >= K) {
      drain_s32<NT>(acc, nb, N, wm, wn, lane, epi);
      k0 = 0, nb += BN;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace swin_mma
