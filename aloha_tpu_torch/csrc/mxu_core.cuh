// Device code of the 4-step int8 tensor-core NTT, shared by csrc/ntt_mxu.cu
// (the transform) and csrc/probe_mxu.cu (its cost probes).
//
// The arithmetic, the table layouts and the bounds are explained in
// csrc/ntt_mxu.cu and aloha_tpu_torch/ops/ntt_mxu.py.  The row and lane
// products take a compile-time epilogue: FOLD, the transform's own (fold
// the 8 accumulators into a residue, then `finish`), or XOR, the products-
// only probe's (tools/probe_mxu_parts.py:46-69): e = e_0 ^ ... ^ e_7, stored
// as u32(e) | u32(e + 1) << 32 after the row product and as
// u32(e) | u32(e ^ 3) << 32 after the lane product.
#pragma once

#include "modarith.cuh"

namespace {

typedef unsigned int u32;

constexpr int LANES = 128;
constexpr int NDIG = 8;              // base-256 digits of a u64
constexpr int MXU_THREADS = 256;
constexpr int NWARPS = MXU_THREADS / 32;
constexpr int PAD = 16;              // bytes of padding per digit row
constexpr int ROW_NT = 2;            // 8-lane n-tiles per warp block, row product
constexpr int LANE_MT = 2;           // 16-row m-tiles per warp block, lane product
constexpr int LANE_BITS = 24;        // accumulator bias exponent at K = 1024
constexpr u64 MASK59 = (1ull << 59) - 1;

enum Epilogue { FOLD = 0, XOR = 1 };

__device__ __forceinline__ void mma_s8(int (&c)[4], u32 a0, u32 a1, u32 a2, u32 a3, u32 b0,
                                       u32 b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// V = sum_j 2^(8j) (e_j + 2^b) + c  (|e_j| <= 2^b, c < q, so V < 2^82)
// -> W == V (mod q) with W = (V mod 2^59) + 20q - (V >> 59) delta < 20q + 2^59
// (the host checks (V >> 59) delta <= 20q for the modulus).  WIDE takes any
// int32 e_j (V < 2^89, so the sum of the low five terms can carry out of 64
// bits) and returns the same formula mod 2^64: the integer-only probe's
// accumulators are not bounded by 2^b.
template <bool WIDE = false>
__device__ __forceinline__ u64 fold59(const int (&e)[NDIG], int b, u64 c, u64 q, u64 delta) {
  u64 u[NDIG];
#pragma unroll
  for (int j = 0; j < NDIG; ++j) u[j] = (u64)((u32)e[j] + (1u << b));
  u64 lo, carry = 0;
  if constexpr (WIDE) {
    const u64 lo4 = u[0] + (u[1] << 8) + (u[2] << 16) + (u[3] << 24);  // < 2^57
    lo = lo4 + (u[4] << 32);
    carry = lo < lo4;
  } else {
    lo = u[0] + (u[1] << 8) + (u[2] << 16) + (u[3] << 24) + (u[4] << 32);  // < 2^58
  }
  const u64 hi = u[5] + (u[6] << 8) + (u[7] << 16);  // < 2^42 (2^49 WIDE), weight 2^40
  const u64 v1 = lo + (hi << 40);
  const u64 v2 = v1 + c;
  const u64 vhi = (hi >> 24) + carry + (v1 < lo) + (v2 < v1);
  const u64 a = (vhi << 5) | (v2 >> 59);
  return (v2 & MASK59) + 20 * q - a * delta;
}

// W < 2^64 from fold59 -> [0, q): (W mod 2^59) + q - (W >> 59) delta < 2q.
__device__ __forceinline__ u64 fold_final(u64 w, u64 q, u64 delta) {
  return condsub((w & MASK59) + q - (w >> 59) * delta, q);
}

// What an output word becomes after its fold: MID applies the middle
// twiddle (Shoup, any u64 in, [0, 2q) out); otherwise the last transform
// of a launch folds to [0, q) and the others keep the lazy window.
template <bool MID>
__device__ __forceinline__ u64 finish(u64 w, int idx, const u64* __restrict__ tw,
                                      const u64* __restrict__ tws, bool fin, u64 q, u64 delta) {
  if (MID) return shoup_mul(w, tw[idx], tws[idx], q);
  return fin ? fold_final(w, q, delta) : w;
}

// The XOR epilogue's e_0 ^ ... ^ e_7 (as u32, so that e + 1 wraps) and its word.
__device__ __forceinline__ u32 xor_fold(const int (&e)[NDIG]) {
  u32 x = (u32)e[0];
#pragma unroll
  for (int j = 1; j < NDIG; ++j) x ^= (u32)e[j];
  return x;
}

__device__ __forceinline__ u64 pack32(u32 lo, u32 hi) { return (u64)lo | ((u64)hi << 32); }

// Digit planes for the row product (data as the B operand, K-contiguous per
// column): dig[(kk * 128 + l) * (R + PAD) + r] = digit kk of sh[r][l].
__device__ __forceinline__ void split_rows(const u64* sh, unsigned char* dig, int R) {
  const int SB = R + PAD;
  for (int idx = threadIdx.x; idx < (R / 4) * LANES; idx += MXU_THREADS) {
    const int l = idx % LANES, r0 = (idx / LANES) * 4;
    u64 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = sh[(r0 + i) * LANES + l] ^ 0x8080808080808080ull;
#pragma unroll
    for (int kk = 0; kk < NDIG; ++kk) {
      u32 w = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) w |= (u32)((v[i] >> (8 * kk)) & 0xff) << (8 * i);
      *(u32*)(dig + (kk * LANES + l) * SB + r0) = w;
    }
  }
}

// Digit planes for the lane product (data as the A operand, K-contiguous per
// row): dig[r * (1024 + PAD) + kk * 128 + l] = digit kk of sh[r][l].
__device__ __forceinline__ void split_lanes(const u64* sh, unsigned char* dig, int R) {
  const int SA = NDIG * LANES + PAD;
  for (int idx = threadIdx.x; idx < R * (LANES / 4); idx += MXU_THREADS) {
    const int r = idx / (LANES / 4), l0 = (idx % (LANES / 4)) * 4;
    u64 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = sh[r * LANES + l0 + i] ^ 0x8080808080808080ull;
#pragma unroll
    for (int kk = 0; kk < NDIG; ++kk) {
      u32 w = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) w |= (u32)((v[i] >> (8 * kk)) & 0xff) << (8 * i);
      *(u32*)(dig + r * SA + kk * LANES + l0) = w;
    }
  }
}

// Row product: out[i][l] = fold(sum_k A_j[i][k] S[k][l]), K = 8R, k = kk R + r.
// af: A_j in fragment order [j][R/16][8R/32][lane] of uint4 (the m16n8k32
// A registers a0..a3 of each lane).  One warp block: 16 rows x 8 ROW_NT lanes.
template <bool MID, int EPI = FOLD>
__device__ __forceinline__ void row_step(const unsigned char* dig, u64* sh, int R,
                                         const uint4* __restrict__ af,
                                         const u64* __restrict__ crow,
                                         const u64* __restrict__ tw,
                                         const u64* __restrict__ tws, bool fin, u64 q,
                                         u64 delta) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int SB = R + PAD, KS = NDIG * R / 32, mtiles = R / 16;
  constexpr int ngroups = LANES / (8 * ROW_NT);
  const int b = __ffs(NDIG * R) - 1 + 14;
  for (int blk = warp; blk < mtiles * ngroups; blk += NWARPS) {
    const int mt = blk / ngroups, ng = blk % ngroups;
    int acc[NDIG][ROW_NT][4];
#pragma unroll
    for (int j = 0; j < NDIG; ++j)
#pragma unroll
      for (int nt = 0; nt < ROW_NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][nt][c] = 0;
    for (int ks = 0; ks < KS; ++ks) {
      const int kk = (ks * 32) / R, r0 = ks * 32 - kk * R;  // 32 | R: one plane per step
      u32 bf[ROW_NT][2];
#pragma unroll
      for (int nt = 0; nt < ROW_NT; ++nt) {
        const unsigned char* p =
            dig + (kk * LANES + (ng * ROW_NT + nt) * 8 + g) * SB + r0 + 4 * t;
        bf[nt][0] = *(const u32*)p;
        bf[nt][1] = *(const u32*)(p + 16);
      }
#pragma unroll
      for (int j = 0; j < NDIG; ++j) {
        const uint4 a = __ldg(af + ((j * mtiles + mt) * KS + ks) * 32 + lane);
#pragma unroll
        for (int nt = 0; nt < ROW_NT; ++nt)
          mma_s8(acc[j][nt], a.x, a.y, a.z, a.w, bf[nt][0], bf[nt][1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < ROW_NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = mt * 16 + g + 8 * h, l = (ng * ROW_NT + nt) * 8 + 2 * t + c;
          int e[NDIG];
#pragma unroll
          for (int j = 0; j < NDIG; ++j) e[j] = acc[j][nt][2 * h + c];
          const int idx = i * LANES + l;
          if constexpr (EPI == XOR) {
            const u32 x = xor_fold(e);
            sh[idx] = pack32(x, x + 1);
          } else {
            sh[idx] = finish<MID>(fold59(e, b, crow[i], q, delta), idx, tw, tws, fin, q, delta);
          }
        }
  }
}

// Lane product: out[i][l] = fold(sum_k S'[i][k] T_j[k][l]), K = 1024, k = kk 128 + l'.
// tf: T_j in fragment order [j][128/8][1024/32][lane] of uint2 (the m16n8k32
// B registers b0, b1 of each lane).  One warp block: 16 LANE_MT rows x 8 lanes.
template <bool MID, int EPI = FOLD>
__device__ __forceinline__ void lane_step(const unsigned char* dig, u64* sh, int R,
                                          const uint2* __restrict__ tf,
                                          const u64* __restrict__ ccol,
                                          const u64* __restrict__ tw,
                                          const u64* __restrict__ tws, bool fin, u64 q,
                                          u64 delta) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int SA = NDIG * LANES + PAD, KS = NDIG * LANES / 32, ntiles = LANES / 8;
  const int mgroups = R / (16 * LANE_MT);
  for (int blk = warp; blk < mgroups * ntiles; blk += NWARPS) {
    const int mg = blk / ntiles, nt = blk % ntiles;
    int acc[NDIG][LANE_MT][4];
#pragma unroll
    for (int j = 0; j < NDIG; ++j)
#pragma unroll
      for (int mi = 0; mi < LANE_MT; ++mi)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][mi][c] = 0;
    for (int ks = 0; ks < KS; ++ks) {
      u32 a[LANE_MT][4];
#pragma unroll
      for (int mi = 0; mi < LANE_MT; ++mi) {
        const unsigned char* p = dig + ((mg * LANE_MT + mi) * 16 + g) * SA + ks * 32 + 4 * t;
        a[mi][0] = *(const u32*)p;
        a[mi][1] = *(const u32*)(p + 8 * SA);
        a[mi][2] = *(const u32*)(p + 16);
        a[mi][3] = *(const u32*)(p + 8 * SA + 16);
      }
#pragma unroll
      for (int j = 0; j < NDIG; ++j) {
        const uint2 bb = __ldg(tf + ((j * ntiles + nt) * KS + ks) * 32 + lane);
#pragma unroll
        for (int mi = 0; mi < LANE_MT; ++mi)
          mma_s8(acc[j][mi], a[mi][0], a[mi][1], a[mi][2], a[mi][3], bb.x, bb.y);
      }
    }
#pragma unroll
    for (int mi = 0; mi < LANE_MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = (mg * LANE_MT + mi) * 16 + g + 8 * h, l = nt * 8 + 2 * t + c;
          int e[NDIG];
#pragma unroll
          for (int j = 0; j < NDIG; ++j) e[j] = acc[j][mi][2 * h + c];
          const int idx = i * LANES + l;
          if constexpr (EPI == XOR) {
            const u32 x = xor_fold(e);
            sh[idx] = pack32(x, x ^ 3);
          } else {
            sh[idx] = finish<MID>(fold59(e, LANE_BITS, ccol[l], q, delta), idx, tw, tws, fin, q,
                                  delta);
          }
        }
  }
}

// Dynamic shared memory of a CTA holding one polynomial of 2^logn words
// and the larger of its two digit-plane buffers.
inline size_t mxu_smem_bytes(int logn) {
  const int R = (1 << logn) / LANES;
  const int da = R * (NDIG * LANES + PAD), db = NDIG * LANES * (R + PAD);
  return (sizeof(u64) << logn) + (da > db ? da : db);
}

}  // namespace
