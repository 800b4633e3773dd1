// 4-step negacyclic NTT/INTT as exact int8 tensor-core products; k
// data-dependent transforms per launch.
//
// Replaces the TPU kernels ntt_mxu._mxu_call (aloha_tpu/ops/ntt_mxu.py:653,
// via ntt_planes/intt_planes: k = 1) and ntt_mxu.ntt_chain_planes (:860,
// bodies _chain_body :701 and _chain_ways_body :742: k > 1).  It computes
// what aloha_tpu_torch/ops/ntt_mxu.py's transform_plain computes; the
// tables, their fragment order and the arithmetic are explained there.
//
// With R = n / 128 and the polynomial as an (R x 128) matrix, a forward
// transform is
//   split   8 biased digit planes (byte ^ 0x80 read as int8) of the data
//   rows    8 int32 accumulators e_j = A_j (R x 8R) . S (8R x 128)
//   fold    V = sum_j 2^(8j) (e_j + 2^b) + c_row < 2^82, folded once
//           through 2^59 = -(q - 2^59) (mod q) into a u64 W
//   twiddle Shoup multiply by D[i][l] -> [0, 2q)
//   split, lanes  e_j = S' (R x 1024) . T_j (1024 x 128), fold with c_col
//   final   one more sparse fold and a conditional subtract -> [0, q)
// and the inverse runs lanes -> twiddle -> rows.  Between the transforms of
// a chain the words stay in the fold's lazy window W < 20q + 2^59 (any u64
// is a valid input to the split); only the last transform folds to [0, q).
//
// Shape: one CTA of 8 warps per (polynomial, modulus); grid (nb, M).  The
// polynomial's n u64 words (64 KiB at n = 8192) stay in dynamic shared
// memory for all k transforms, beside one buffer for its 8 digit planes
// (n bytes each, rows padded by 16 bytes so that fragment loads spread over
// the banks: 80 KiB at n = 8192).  The digit products are
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32: every sum is at most K 2^14 <=
// 2^24 in magnitude (K = 8R or 1024), so plain int32 accumulation is exact.
// The data side of each product is read from shared memory, the table side
// (prepared on the host in per-lane fragment order, so a warp reads 512 or
// 256 contiguous bytes) from global memory, where L2 holds it.  The 8
// accumulators of an output tile are combined into a u64 residue in
// registers, in the epilogue of the product: the full (64 x 128) x 8 int32
// accumulator set would be 256 KiB, the whole register file of an SM.
//
// Bound on Hopper (an estimate, to check on the card): per direction and
// modulus the tables hold 1.25 MiB of int8 (A 256 KiB, T 1 MiB).  A warp
// reuses each table fragment over 2 output tiles, so one transform pulls
// 4 MiB of table through L2 for about 1.0e8 int8 MACs (33.6 M in the rows,
// 67.1 M in the lanes; 24,576 mma.sync), and the CTA's 144 KiB of shared
// memory leaves one CTA per SM.  So the kernel is bound by L2 table traffic
// and mma.sync issue latency, not by HBM (16 bytes per coefficient in and
// out).  Sharing each table fragment across several polynomials of a CTA is
// the later fix.
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
// (the host checks (V >> 59) delta <= 20q for the modulus).
__device__ __forceinline__ u64 fold59(const int (&e)[NDIG], int b, u64 c, u64 q, u64 delta) {
  u64 u[NDIG];
#pragma unroll
  for (int j = 0; j < NDIG; ++j) u[j] = (u64)(u32)(e[j] + (1 << b));
  const u64 lo = u[0] + (u[1] << 8) + (u[2] << 16) + (u[3] << 24) + (u[4] << 32);  // < 2^58
  const u64 hi = u[5] + (u[6] << 8) + (u[7] << 16);  // < 2^42, weight 2^40
  const u64 v1 = lo + (hi << 40);
  const u64 v2 = v1 + c;
  const u64 vhi = (hi >> 24) + (v1 < lo) + (v2 < v1);
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
template <bool MID>
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
          sh[idx] = finish<MID>(fold59(e, b, crow[i], q, delta), idx, tw, tws, fin, q, delta);
        }
  }
}

// Lane product: out[i][l] = fold(sum_k S'[i][k] T_j[k][l]), K = 1024, k = kk 128 + l'.
// tf: T_j in fragment order [j][128/8][1024/32][lane] of uint2 (the m16n8k32
// B registers b0, b1 of each lane).  One warp block: 16 LANE_MT rows x 8 lanes.
template <bool MID>
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
          sh[idx] = finish<MID>(fold59(e, LANE_BITS, ccol[l], q, delta), idx, tw, tws, fin, q,
                                delta);
        }
  }
}

__global__ void __launch_bounds__(MXU_THREADS, 1)
ntt_mxu_kernel(const u64* __restrict__ x, u64* __restrict__ y, const uint4* __restrict__ af,
               const uint2* __restrict__ tf, const u64* __restrict__ tw,
               const u64* __restrict__ tws, const u64* __restrict__ crow,
               const u64* __restrict__ ccol, const u64* __restrict__ qs, int nb, int logn, int k,
               int inverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 1 << logn, R = n / LANES, m = blockIdx.y;
  u64* sh = (u64*)smem;
  unsigned char* dig = smem + (size_t)n * sizeof(u64);
  const u64 q = qs[m], delta = q - (1ull << 59);
  af += (size_t)m * (NDIG * R * NDIG * R / 16);
  tf += (size_t)m * (NDIG * NDIG * LANES * LANES / 8);
  tw += (size_t)m * n;
  tws += (size_t)m * n;
  crow += (size_t)m * R;
  ccol += (size_t)m * LANES;
  const size_t off = ((size_t)m * nb + blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += MXU_THREADS) sh[i] = x[off + i];
  __syncthreads();
  for (int it = 0; it < k; ++it) {
    const bool fin = it == k - 1;
    if (!inverse) {
      split_rows(sh, dig, R);
      __syncthreads();
      row_step<true>(dig, sh, R, af, crow, tw, tws, fin, q, delta);
      __syncthreads();
      split_lanes(sh, dig, R);
      __syncthreads();
      lane_step<false>(dig, sh, R, tf, ccol, tw, tws, fin, q, delta);
      __syncthreads();
    } else {
      split_lanes(sh, dig, R);
      __syncthreads();
      lane_step<true>(dig, sh, R, tf, ccol, tw, tws, fin, q, delta);
      __syncthreads();
      split_rows(sh, dig, R);
      __syncthreads();
      row_step<false>(dig, sh, R, af, crow, tw, tws, fin, q, delta);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += MXU_THREADS) y[off + i] = sh[i];
}

}  // namespace

// x, y: (M, nb, 2^logn) int64; af: (M, 8 * R * 8R) int8 and tf: (M, 8 * 1024 *
// 128) int8 in fragment order; tw, tws: (M, 2^logn); crow: (M, R); ccol:
// (M, 128); qs: (M,).  R = 2^logn / 128 must be a multiple of 32.
extern "C" int aloha_ntt_mxu(int device, const void* x, void* y, const void* af, const void* tf,
                             const void* tw, const void* tws, const void* crow,
                             const void* ccol, const void* qs, int M, int nb, int logn, int k,
                             int inverse, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int R = (1 << logn) / LANES;
  const int da = R * (NDIG * LANES + PAD), db = NDIG * LANES * (R + PAD);
  const size_t smem = (sizeof(u64) << logn) + (da > db ? da : db);
  err = cudaFuncSetAttribute(ntt_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb, M);
  ntt_mxu_kernel<<<grid, MXU_THREADS, smem, (cudaStream_t)stream>>>(
      (const u64*)x, (u64*)y, (const uint4*)af, (const uint2*)tf, (const u64*)tw,
      (const u64*)tws, (const u64*)crow, (const u64*)ccol, (const u64*)qs, nb, logn, k, inverse);
  return (int)cudaGetLastError();
}
