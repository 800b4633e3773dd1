// Cost probes of csrc/ntt_mxu.cu's tensor-core transform, on resident data.
//
// Replaces two TPU kernels:
//   tools/probe_mxu.py:58 (`kernel` :30-49): the int8 matmul rate of the
//     4-step core -> aloha_probe_mxu_rate.  x (8, M, 128) int8 digit planes,
//     w (8, 128, 128) int8; one repetition computes acc_j = sum_k x_k w_j
//     (all 64 digit-pair products, j, k = 0..7), s = acc_0 +
//     sum_{j>=1} acc_j << (j mod 4) (int32, wrapping), and the next x:
//     x_0 = int8(s), x_k = int8(s >> k) (arithmetic shift);
//   tools/probe_mxu_parts.py:123 (`build(variant)` -> `body` :96, variants
//     of `make_stages` :39-88): one forward 4-step transform per repetition
//     -> aloha_probe_mxu_parts, in three variants:
//       full  ntt_mxu.cu's own steps (csrc/mxu_core.cuh), canonical after
//             every repetition (the TPU's _fwd_stages(lazy=False));
//       mxu   the digit splits and both products, with the XOR epilogue in
//             place of the folds and the twiddle: the products' share;
//       vpu   no products: each word's fake accumulators e_j = int32(lo32(x)
//             ^ j) folded with b_row and crow[r], the Shoup product by
//             tw[r][l], then e_j = int32(lo32(y) ^ hi32(y) ^ j) folded with
//             b_lane and ccol[l], then fold_final: the integer work's share.
//             Its accumulators are not bounded by 2^b, so it takes the WIDE
//             fold (one more carry), and its Shoup is the exact one (the
//             TPU's 16-bit-limb quotient is q too large on about 1 word in
//             10^5).
//
// Both repeat in one launch on data that stays in shared memory; the
// marginal over REPS is the cost of one repetition (probes/common.py).
//
// Layout of the rate probe: a CTA of 256 threads owns 64 rows of x in all 8
// planes (rows padded by 16 bytes, so that fragment loads spread over the
// banks, as in ntt_mxu.cu's lane product) and an int32 buffer of its 64 x
// 128 sums s; 104 KiB.  Launch bounds of one CTA per SM, as ntt_mxu.cu's:
// capped at two (128 registers) the accumulators spilled and the rate fell
// by a third (PERF.md §6).  A warp block is 32 rows x 8
// columns (two m16n8k32 m-tiles): for each of the 32 K-steps (plane k,
// 32-column chunk) it loads its A fragments from shared memory, and per
// accumulator j one B fragment of w_j from global memory (L2; the host lays
// w out with ntt_mxu.frag_lanes), as ntt_mxu.cu's lane product does.
//
// Bound on Hopper: the rate probe is int8 tensor-core work, 2 * 64 * M *
// 128 * 128 operations per repetition over 1,979 TOP/s (the dense wgmma
// peak, which mma.sync is not expected to reach).  Of the parts, full and
// mxu carry 1.007e8 int8 MACs per transform; vpu only integer instructions
// (probes/probe_mxu_parts.OPS).
#include "mxu_core.cuh"

namespace {

constexpr int RATE_TM = 64;                 // rows of x per CTA
constexpr int RATE_SX = LANES + PAD;        // bytes per row of a plane in shared memory
constexpr int RATE_PLANE = RATE_TM * RATE_SX;
constexpr int RATE_KS = NDIG * LANES / 32;  // K-steps: 8 planes x 4 chunks of 32
constexpr size_t RATE_SMEM = (size_t)NDIG * RATE_PLANE + sizeof(int) * RATE_TM * LANES;
constexpr int PARTS_LOGN = 13;              // the parts probe runs at n = 8192

enum PartsVariant { PART_FULL = 0, PART_MXU = 1, PART_VPU = 2 };

// x, y: (8, M, 128) int8; wf: frag_lanes(w), [j][16][4][lane] of uint2.
__global__ void __launch_bounds__(MXU_THREADS, 1)
mxu_rate_kernel(const signed char* __restrict__ x, signed char* __restrict__ y,
                const uint2* __restrict__ wf, int M, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem;                              // [8][TM][SX]
  int* ss = (int*)(smem + (size_t)NDIG * RATE_PLANE);    // [TM][128]
  const int m0 = blockIdx.x * RATE_TM;
  constexpr int V = LANES / 16;  // uint4 per row
  for (int idx = threadIdx.x; idx < NDIG * RATE_TM * V; idx += MXU_THREADS) {
    const int k = idx / (RATE_TM * V), i = (idx / V) % RATE_TM, v = idx % V;
    *(uint4*)(xs + k * RATE_PLANE + i * RATE_SX + 16 * v) =
        *(const uint4*)(x + ((size_t)k * M + m0 + i) * LANES + 16 * v);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int ntiles = LANES / 8, mgroups = RATE_TM / (16 * LANE_MT);
  for (int rep = 0; rep < reps; ++rep) {
    for (int blk = warp; blk < mgroups * ntiles; blk += NWARPS) {
      const int mg = blk / ntiles, nt = blk % ntiles;
      int acc[NDIG][LANE_MT][4];
#pragma unroll
      for (int j = 0; j < NDIG; ++j)
#pragma unroll
        for (int mi = 0; mi < LANE_MT; ++mi)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][mi][c] = 0;
      for (int ks = 0; ks < RATE_KS; ++ks) {
        const int kk = ks >> 2, kc = ks & 3;  // plane, 32-column chunk
        u32 a[LANE_MT][4];
#pragma unroll
        for (int mi = 0; mi < LANE_MT; ++mi) {
          const unsigned char* p = xs + kk * RATE_PLANE + ((mg * LANE_MT + mi) * 16 + g) * RATE_SX +
                                   kc * 32 + 4 * t;
          a[mi][0] = *(const u32*)p;
          a[mi][1] = *(const u32*)(p + 8 * RATE_SX);
          a[mi][2] = *(const u32*)(p + 16);
          a[mi][3] = *(const u32*)(p + 8 * RATE_SX + 16);
        }
#pragma unroll
        for (int j = 0; j < NDIG; ++j) {
          const uint2 bb = __ldg(wf + ((j * ntiles + nt) * 4 + kc) * 32 + lane);
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
            u32 s = (u32)acc[0][mi][2 * h + c];
#pragma unroll
            for (int j = 1; j < NDIG; ++j) s += (u32)acc[j][mi][2 * h + c] << (j & 3);
            ss[i * LANES + l] = (int)s;
          }
    }
    __syncthreads();
    // the next x: byte k of each row of 4 sums, k = 0..7
    for (int idx = threadIdx.x; idx < RATE_TM * (LANES / 4); idx += MXU_THREADS) {
      const int i = idx / (LANES / 4), l0 = (idx % (LANES / 4)) * 4;
      const int4 s = *(const int4*)(ss + i * LANES + l0);
#pragma unroll
      for (int k = 0; k < NDIG; ++k) {
        const u32 w = ((u32)(s.x >> k) & 0xff) | (((u32)(s.y >> k) & 0xff) << 8) |
                      (((u32)(s.z >> k) & 0xff) << 16) | ((u32)(s.w >> k) << 24);
        *(u32*)(xs + k * RATE_PLANE + i * RATE_SX + l0) = w;
      }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < NDIG * RATE_TM * V; idx += MXU_THREADS) {
    const int k = idx / (RATE_TM * V), i = (idx / V) % RATE_TM, v = idx % V;
    *(uint4*)(y + ((size_t)k * M + m0 + i) * LANES + 16 * v) =
        *(const uint4*)(xs + k * RATE_PLANE + i * RATE_SX + 16 * v);
  }
}

// The vpu variant's repetition of one word at position idx = r * 128 + l,
// b_row the row product's bias exponent.
__device__ __forceinline__ u64 vpu_word(u64 x, int idx, int b_row, const u64* __restrict__ tw,
                                        const u64* __restrict__ tws,
                                        const u64* __restrict__ crow,
                                        const u64* __restrict__ ccol, u64 q, u64 delta) {
  int e[NDIG];
  const int lo = (int)(u32)x;
#pragma unroll
  for (int j = 0; j < NDIG; ++j) e[j] = lo ^ j;
  const u64 w = fold59<true>(e, b_row, crow[idx / LANES], q, delta);
  const u64 y = shoup_mul(w, tw[idx], tws[idx], q);
  const int lo2 = (int)((u32)y ^ (u32)(y >> 32));
#pragma unroll
  for (int j = 0; j < NDIG; ++j) e[j] = lo2 ^ j;
  return fold_final(fold59<true>(e, LANE_BITS, ccol[idx % LANES], q, delta), q, delta);
}

// x, y: (nb, 2^logn) int64; the forward tables of ntt_mxu.cu at modulus q.
// The ring comes in at run time, as to ntt_mxu_kernel, so that the steps
// compile as they do there (a compile-time R unrolls them differently).
template <int VARIANT>
__global__ void __launch_bounds__(MXU_THREADS, 1)
mxu_parts_kernel(const u64* __restrict__ x, u64* __restrict__ y, const uint4* __restrict__ af,
                 const uint2* __restrict__ tf, const u64* __restrict__ tw,
                 const u64* __restrict__ tws, const u64* __restrict__ crow,
                 const u64* __restrict__ ccol, u64 q, int logn, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 1 << logn, R = n / LANES;
  u64* sh = (u64*)smem;
  unsigned char* dig = smem + (size_t)n * sizeof(u64);
  const u64 delta = q - (1ull << 59);
  const size_t off = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += MXU_THREADS) sh[i] = x[off + i];
  __syncthreads();
  for (int it = 0; it < reps; ++it) {
    if constexpr (VARIANT == PART_VPU) {
      // elementwise: each thread keeps to its own words, no barrier
      const int b_row = __ffs(NDIG * R) - 1 + 14;
      for (int i = threadIdx.x; i < n; i += MXU_THREADS)
        sh[i] = vpu_word(sh[i], i, b_row, tw, tws, crow, ccol, q, delta);
    } else {
      constexpr int EPI = VARIANT == PART_FULL ? FOLD : XOR;
      split_rows(sh, dig, R);
      __syncthreads();
      row_step<true, EPI>(dig, sh, R, af, crow, tw, tws, true, q, delta);
      __syncthreads();
      split_lanes(sh, dig, R);
      __syncthreads();
      lane_step<false, EPI>(dig, sh, R, tf, ccol, tw, tws, true, q, delta);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += MXU_THREADS) y[off + i] = sh[i];
}

template <int VARIANT>
cudaError_t launch_parts(const void* x, void* y, const void* af, const void* tf, const void* tw,
                         const void* tws, const void* crow, const void* ccol, u64 q, int nb,
                         int reps, cudaStream_t s) {
  const size_t smem = mxu_smem_bytes(PARTS_LOGN);
  cudaError_t err = cudaFuncSetAttribute(mxu_parts_kernel<VARIANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mxu_parts_kernel<VARIANT><<<nb, MXU_THREADS, smem, s>>>(
      (const u64*)x, (u64*)y, (const uint4*)af, (const uint2*)tf, (const u64*)tw,
      (const u64*)tws, (const u64*)crow, (const u64*)ccol, q, PARTS_LOGN, reps);
  return cudaGetLastError();
}

}  // namespace

// x, y: (8, M, 128) int8 with M a multiple of 64; wf: (8 * 128 * 128,) int8,
// w in ntt_mxu.frag_lanes order; reps >= 0.
extern "C" int aloha_probe_mxu_rate(int device, const void* x, void* y, const void* wf, int M,
                                    int reps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || M % RATE_TM) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(mxu_rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)RATE_SMEM);
  if (err != cudaSuccess) return (int)err;
  mxu_rate_kernel<<<M / RATE_TM, MXU_THREADS, RATE_SMEM, (cudaStream_t)stream>>>(
      (const signed char*)x, (signed char*)y, (const uint2*)wf, M, reps);
  return (int)cudaGetLastError();
}

// x, y: (nb, 8192) int64; af, tf, tw, tws, crow, ccol: ntt_mxu.cu's forward
// tables of q (one modulus); variant: 0 full, 1 mxu, 2 vpu; reps >= 0.
extern "C" int aloha_probe_mxu_parts(int device, const void* x, void* y, const void* af,
                                     const void* tf, const void* tw, const void* tws,
                                     const void* crow, const void* ccol, u64 q, int variant,
                                     int nb, int reps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case PART_FULL:
      return (int)launch_parts<PART_FULL>(x, y, af, tf, tw, tws, crow, ccol, q, nb, reps, s);
    case PART_MXU:
      return (int)launch_parts<PART_MXU>(x, y, af, tf, tw, tws, crow, ccol, q, nb, reps, s);
    case PART_VPU:
      return (int)launch_parts<PART_VPU>(x, y, af, tf, tw, tws, crow, ccol, q, nb, reps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
