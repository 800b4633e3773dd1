// Device code of the 4-step int8 tensor-core NTT on warpgroup products
// (wgmma), shared by csrc/ntt_mxu.cu (the transform) and csrc/probe_mxu.cu
// (its parts probe): the table ring, the digit splits, the product step
// and the loop of transforms.
//
// The arithmetic, the layouts and the bounds are explained in
// csrc/ntt_mxu.cu and aloha_tpu_torch/ops/ntt_mxu.py.  The product step
// takes a compile-time epilogue: FOLD, the transform's own (fold59 a digit
// at a time, then `finish`), or XOR, the products-only probe's
// (tools/probe_mxu_parts.py:46-69): x = e_0 ^ ... ^ e_7, stored as
// u32(x) | u32(x + 1) << 32 after the row product and as
// u32(x) | u32(x ^ 3) << 32 after the lane product.
#pragma once

#include "modarith.cuh"
#include "wgmma_s8.cuh"

namespace {

typedef unsigned int u32;

constexpr int LANES = 128;
constexpr int NDIG = 8;                        // base-256 digits of a u64
constexpr int LANE_BITS = 24;                  // accumulator bias exponent at K = 1024
constexpr u64 MASK59 = (1ull << 59) - 1;
constexpr int TF_WGS = 2;                      // warpgroups a CTA
constexpr int TF_THREADS = TF_WGS * 128;
constexpr int TF_WARPS = TF_THREADS / 32;      // arrivals on an `empty` mbarrier
constexpr int SLOTS = 4;                       // table ring slots
constexpr unsigned TILE = 16384;               // bytes of a slot and of a stage in the stream
constexpr unsigned KBLOCK = LANES * LANES;     // a 128-row k-block of 128 bytes
constexpr int LANE_STAGES = NDIG * NDIG;       // (j, plane kk)

enum Epilogue { FOLD = 0, XOR = 1 };

constexpr int log2i(int v) { return v > 1 ? 1 + log2i(v / 2) : 0; }

// bias_bits(8R) of the row product (18 at R = 2 .. 24 at R = 128),
// bias_bits(1024) of the lane product
template <int R, bool ROWS>
constexpr int BIAS_BITS = ROWS ? log2i(NDIG * R) + 14 : LANE_BITS;

// The tail of fold59.  With the digits of V = sum_j 2^(8j) (e_j + 2^b) + c
// (|e_j| <= 2^b, c < q, so V < 2^82) summed as lo = sum_{j<5} 2^(8j) u_j
// and hi = sum_{j>=5} 2^(8(j-5)) u_j, u_j = e_j + 2^b: W == V (mod q) with
// W = (V mod 2^59) + 20q - (V >> 59) delta < 20q + 2^59 (the host checks
// (V >> 59) delta <= 20q for the modulus).  The same formula mod 2^64 for
// the parts probe's fake accumulators, which are not bounded by 2^b: there
// lo can pass 2^64, and each carry is added to hi as 2^24 (2^64 = 2^24 2^40).
__device__ __forceinline__ u64 fold59(u64 lo, u64 hi, u64 c, u64 q, u64 delta) {
  const u64 v1 = lo + (hi << 40), v2 = v1 + c;
  const u64 vhi = (hi >> 24) + (v1 < lo) + (v2 < v1);
  return (v2 & MASK59) + 20 * q - ((vhi << 5) | (v2 >> 59)) * delta;
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

__device__ __forceinline__ u64 pack32(u32 lo, u32 hi) { return (u64)lo | ((u64)hi << 32); }

// Where a product step's accumulator o of this thread lands: d[4 blk + 2h
// + e] of lane 4 gq + t in warp w of warpgroup wg holds row (lane) m = 64 wg
// + 16 w + gq + 8h, column i = 8 blk + 2t + e (csrc/wgmma_s8.cuh): word
// i 128 + m.
struct Places {
  int m0, t;
  __device__ __forceinline__ explicit Places(int wg)
      : m0(wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2)),
        t(threadIdx.x & 3) {}
  __device__ __forceinline__ int lane(int o) const { return m0 + 8 * ((o >> 1) & 1); }
  __device__ __forceinline__ int row(int o) const { return 8 * (o >> 2) + 2 * t + (o & 1); }
};

// The geometry of ring R = n / 128 (csrc/ntt_mxu.cu): a CTA's words are RK
// rows of 128, P polynomials of R rows (R < 32: the 64 rows of n = 8192,
// whose row tables the host lays out block-diagonal); a product step takes
// its RK output columns in HALVES products of N columns (wgmma N), each
// with its own accumulators and table stages; the words live in shared
// memory up to RK = 64 and in y (global memory, L2-resident) at RK = 128.
template <int R>
struct Ring {
  static constexpr int RK = R < 32 ? 64 : R;
  static constexpr int P = RK / R;
  static constexpr int N = RK < 64 ? RK : 64;
  static constexpr int HALVES = RK / N;
  static constexpr bool SMEM_WORDS = RK <= 64;
  static constexpr int ROW_STAGES = HALVES * NDIG * RK / 32;  // (half, j, pair of k-blocks)
  static constexpr int LANE_STAGES_ALL = HALVES * LANE_STAGES;  // (half, j, plane kk)
  static constexpr int STAGES = ROW_STAGES + LANE_STAGES_ALL;
  static constexpr unsigned ROW_BYTES = 2 * N * LANES;
  static constexpr unsigned PLANES = NDIG * RK * LANES;
  static constexpr unsigned WORD_BYTES = SMEM_WORDS ? sizeof(u64) * RK * LANES : 0;
  // planes, ring, words, mbarriers, and 1 KiB to align the swizzle atoms
  static constexpr size_t SMEM = SW128_ATOM + PLANES + SLOTS * TILE + WORD_BYTES +
                                 sizeof(unsigned long long) * 2 * SLOTS;
  static_assert(SMEM <= 232448, "one CTA's shared memory");
  static_assert(ROW_BYTES <= TILE && P * R == RK, "a row stage fills at most a slot");

  unsigned char* slots;
  unsigned long long* full;    // per slot: the stage's bytes have landed
  unsigned long long* empty;   // per slot: every warp is done with it
  const signed char* stream;   // this modulus's stages, TILE bytes apart
  int row_first;               // first row stage (0 forward, LANE_STAGES inverse)
  int total;                   // stages of the launch: k x STAGES
  bool leader;

  // stage g of the launch into slot g mod SLOTS (when the leader)
  __device__ __forceinline__ void load(int g) const {
    const int s = g % STAGES, slot = g % SLOTS;
    const bool row = s >= row_first && s < row_first + ROW_STAGES;
    bulk_load(slots + slot * TILE, stream + (size_t)s * TILE, row ? ROW_BYTES : TILE,
              full + slot, leader);
  }

  // this warp is done with stage g; the leader refills its slot once all are
  __device__ __forceinline__ void release(int g) const {
    const int slot = g % SLOTS;
    mbar_arrive(empty + slot, (threadIdx.x & 31) == 0);
    if (g + SLOTS < total) {
      mbar_wait_if(empty + slot, (g / SLOTS) & 1, leader);
      load(g + SLOTS);
    }
  }
};

// byte i of d[k] = byte k of x[i] (a 4 x 4 byte transpose)
__device__ __forceinline__ void transpose4(const u32 (&x)[4], u32* d) {
  const u32 a = __byte_perm(x[0], x[1], 0x5140), b = __byte_perm(x[0], x[1], 0x7362);
  const u32 c = __byte_perm(x[2], x[3], 0x5140), e = __byte_perm(x[2], x[3], 0x7362);
  d[0] = __byte_perm(a, c, 0x5410);
  d[1] = __byte_perm(a, c, 0x7632);
  d[2] = __byte_perm(b, e, 0x5410);
  d[3] = __byte_perm(b, e, 0x7632);
}

// byte i of d[kk] = biased digit kk of v[i]
__device__ __forceinline__ void digits4(const u64 (&v)[4], u32 (&d)[NDIG]) {
  u32 lo[4], hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = (u32)v[i] ^ 0x80808080u;
    hi[i] = (u32)(v[i] >> 32) ^ 0x80808080u;
  }
  transpose4(lo, d);
  transpose4(hi, d + 4);
}

// The rows product's A over RK rows of words (Ring<R>::RK): k-block kb (128
// rows of 128 bytes) holds, in row l, bytes 128 kb .. 128 kb + 127 of k =
// kk RK + r.  A thread takes lane l and rows r0 .. r0 + 15, so each plane's
// 16 bytes are one swizzled chunk.
template <int RK>
__device__ __forceinline__ void split_rows_sw(const u64* sh, unsigned char* planes) {
  for (int it = threadIdx.x; it < (RK / 16) * LANES; it += TF_THREADS) {
    const int l = it % LANES, r0 = (it / LANES) * 16;
    u32 d[4][NDIG];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      u64 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = sh[(r0 + 4 * g + i) * LANES + l];
      digits4(v, d[g]);
    }
#pragma unroll
    for (int kk = 0; kk < NDIG; ++kk) {
      const int k = kk * RK + r0;
      *(uint4*)(planes + (k >> 7) * KBLOCK + l * LANES + ((((k & 127) >> 4) ^ (l & 7)) << 4)) =
          make_uint4(d[0][kk], d[1][kk], d[2][kk], d[3][kk]);
    }
  }
}

// The lanes product's B: k-block kk (RK x 128 bytes) holds row r, byte l of
// k = kk 128 + l.  A thread takes row r and lanes l0 .. l0 + 3.
template <int RK>
__device__ __forceinline__ void split_lanes_sw(const u64* sh, unsigned char* planes) {
  for (int it = threadIdx.x; it < RK * (LANES / 4); it += TF_THREADS) {
    const int r = it / (LANES / 4), l0 = (it % (LANES / 4)) * 4;
    const ulonglong2 a = *(const ulonglong2*)(sh + r * LANES + l0);
    const ulonglong2 b = *(const ulonglong2*)(sh + r * LANES + l0 + 2);
    const u64 v[4] = {a.x, a.y, b.x, b.y};
    u32 d[NDIG];
    digits4(v, d);
    unsigned char* row = planes + r * LANES + ((((l0 >> 4) ^ (r & 7))) << 4) + (l0 & 15);
#pragma unroll
    for (int kk = 0; kk < NDIG; ++kk) *(u32*)(row + kk * (RK * LANES)) = d[kk];
  }
}

// One product step (ROWS: the rows, else the lanes) over its table stages,
// starting at stage g of the launch: Ring<R>::HALVES products of N output
// columns each (half h: output rows h N .. h N + N - 1 of the words; the
// rows' B is the stage's tile of those table rows, the lanes' B the
// planes' rows h N ..).  FOLD: the folded words go to sh, through
// finish<MID>; cvec: crow (ROWS) or ccol.  XOR: the words of the
// accumulators' xor go to sh; cvec, tw and tws are not read.
template <int R, bool ROWS, bool MID, int EPI = FOLD>
__device__ __forceinline__ void product_step(unsigned planes, u64* sh, const Ring<R>& ring,
                                             int& g, const u64* __restrict__ cvec,
                                             const u64* __restrict__ tw,
                                             const u64* __restrict__ tws, bool fin, u64 q,
                                             u64 delta, int wg) {
  using RingR = Ring<R>;
  constexpr int N = RingR::N;
  constexpr int NACC = N / 2;                   // accumulators of m64nNk32
  constexpr int PARTS = ROWS ? RingR::RK / 32 : NDIG;  // stages per digit j
  constexpr int KB = ROWS ? 2 : 1;              // k-blocks per stage
  constexpr unsigned BLK = RingR::RK * LANES;   // a k-block of the lanes' B (the RK rows)
  constexpr unsigned TBLK = N * LANES;          // a k-block of the rows' B (a tile of N rows)
  constexpr int b = BIAS_BITS<R, ROWS>;
  static_assert(ROWS ? NDIG * R << 14 == 1 << b : true, "row bias");
  const unsigned wrow = wg * 64 * LANES;        // the warpgroup's 64 rows of a 128-row operand
#pragma unroll 1
  for (int h = 0; h < RingR::HALVES; ++h) {
    u64 lo[NACC], hi[NACC];
    u32 x[NACC];  // XOR: e_0 ^ ... ^ e_j
    int acc[NACC];
#pragma unroll
    for (int o = 0; o < NACC; ++o) {
      lo[o] = hi[o] = 0;
      x[o] = 0;
      acc[o] = 0;  // never read: the first product of each j does not accumulate
    }
    int pend = -1;  // a stage whose products may still run, its slot not yet released
#pragma unroll 1
    for (int j = 0; j < NDIG; ++j) {
#pragma unroll 1
      for (int p = 0; p < PARTS; ++p, ++g) {
        const int slot = g % SLOTS;
        mbar_wait(ring.full + slot, (g / SLOTS) & 1);
        const unsigned tile = smem_u32(ring.slots + slot * TILE);
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            const unsigned a = ROWS ? planes + (p * KB + kb) * KBLOCK + wrow + 32 * kc
                                    : tile + wrow + 32 * kc;
            const unsigned bb = ROWS ? tile + kb * TBLK + 32 * kc
                                     : planes + p * BLK + h * TBLK + 32 * kc;
            wgmma_m64k32_s8(acc, sw128_desc(a), sw128_desc(bb), p | kb | kc);
          }
        wgmma_commit();
        if (p < PARTS - 1) {
          wgmma_wait<1>();
          if (pend >= 0) ring.release(pend);
          pend = g;
          continue;
        }
        wgmma_wait<0>();
        fence_operands(acc);
        if (pend >= 0) ring.release(pend);
        ring.release(g);
        pend = -1;
        if constexpr (EPI == XOR) {
#pragma unroll
          for (int o = 0; o < NACC; ++o) x[o] ^= (u32)acc[o];
        } else {
          // fold59's two halves, digit j at a time
          const u32 bias = 1u << b;
          if (j < 5) {
#pragma unroll
            for (int o = 0; o < NACC; ++o) lo[o] += (u64)((u32)acc[o] + bias) << (8 * j);
          } else {
#pragma unroll
            for (int o = 0; o < NACC; ++o) hi[o] += (u64)((u32)acc[o] + bias) << (8 * (j - 5));
          }
        }
      }
    }
    const Places at(wg);
#pragma unroll
    for (int o = 0; o < NACC; ++o) {
      const int m = at.lane(o), i = at.row(o) + h * N;
      const int idx = i * LANES + m;
      if constexpr (EPI == XOR) {
        sh[idx] = pack32(x[o], ROWS ? x[o] + 1 : x[o] ^ 3);
      } else {
        const u64 w = fold59(lo[o], hi[o], ROWS ? cvec[i] : cvec[m], q, delta);
        sh[idx] = finish<MID>(w, idx, tw, tws, fin, q, delta);
      }
    }
  }
}

// k transforms of the words in sh (shared memory, or at RK = 128 the
// output's global memory), forward (rows, twiddle, lanes) or inverse
// (lanes, twiddle, rows), the table stream running on from stage 0 of the
// launch: csrc/ntt_mxu.cu's kernel body.  The last transform folds
// to [0, q), every one when FOLD_EACH (the parts probe's full variant);
// XOR puts the products-only epilogue in place of the folds and the
// twiddle.  ptxas serialises the wgmma of this loop (C7518) when the
// direction is known at compile time: the parts probe passes it at run
// time as the transform does.
template <int R, int EPI = FOLD, bool FOLD_EACH = false>
__device__ __forceinline__ void transforms(unsigned char* planes, u64* sh, const Ring<R>& ring,
                                           const u64* __restrict__ tw,
                                           const u64* __restrict__ tws,
                                           const u64* __restrict__ crow,
                                           const u64* __restrict__ ccol, u64 q, u64 delta, int wg,
                                           int k, int inverse) {
  const unsigned paddr = smem_u32(planes);
  int g = 0;
  for (int it = 0; it < k; ++it) {
    const bool fin = FOLD_EACH || it == k - 1;
    if (!inverse) {
      split_rows_sw<Ring<R>::RK>(sh, planes);
      fence_async_shared();
      __syncthreads();
      product_step<R, true, true, EPI>(paddr, sh, ring, g, crow, tw, tws, fin, q, delta, wg);
      __syncthreads();
      split_lanes_sw<Ring<R>::RK>(sh, planes);
      fence_async_shared();
      __syncthreads();
      product_step<R, false, false, EPI>(paddr, sh, ring, g, ccol, tw, tws, fin, q, delta, wg);
      __syncthreads();
    } else {
      split_lanes_sw<Ring<R>::RK>(sh, planes);
      fence_async_shared();
      __syncthreads();
      product_step<R, false, true, EPI>(paddr, sh, ring, g, ccol, tw, tws, fin, q, delta, wg);
      __syncthreads();
      split_rows_sw<Ring<R>::RK>(sh, planes);
      fence_async_shared();
      __syncthreads();
      product_step<R, true, false, EPI>(paddr, sh, ring, g, crow, tw, tws, fin, q, delta, wg);
      __syncthreads();
    }
  }
}

}  // namespace
