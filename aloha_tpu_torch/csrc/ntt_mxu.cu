// 4-step negacyclic NTT/INTT as exact int8 warpgroup products (wgmma) on
// Hopper; k data-dependent transforms per launch.
//
// Replaces the TPU kernels ntt_mxu._mxu_call (aloha_tpu/ops/ntt_mxu.py:653,
// via ntt_planes/intt_planes: k = 1) and ntt_mxu.ntt_chain_planes (:860,
// bodies _chain_body :701 and _chain_ways_body :742: k > 1).  It computes
// what aloha_tpu_torch/ops/ntt_mxu.py's transform_plain computes; the
// tables and the arithmetic are explained there.
//
// With R = n / 128 and the polynomial as an (R x 128) matrix, a forward
// transform is
//   split   8 biased digit planes (byte ^ 0x80 read as int8) of the data
//   rows    8 int32 accumulators e_j = A_j (R x 8R) . S (8R x 128)
//   fold    V = sum_j 2^(8j) (e_j + 2^b) + c_row < 2^82, folded once
//           through 2^59 = -(q - 2^59) (mod q) into a u64 W (fold59)
//   twiddle Shoup multiply by D[i][l] -> [0, 2q)
//   split, lanes  e_j = S' (R x 1024) . T_j (1024 x 128), fold with c_col
//   final   one more sparse fold and a conditional subtract -> [0, q)
// and the inverse runs lanes -> twiddle -> rows.  Between the transforms of
// a chain the words stay in the fold's lazy window W < 20q + 2^59 (any u64
// is a valid input to the split); only the last transform folds to [0, q).
//
// Both products in the transposed form, so that M is always the 128 lanes
// (integer wgmma takes M = 64 a warpgroup and no transpose; R is only 32 at
// n = 4096):
//   rows   e_j^T (128 x R) = S^T (128 x 8R) . A_j^T (8R x R): A = the data,
//          lane l's row holds k = kk R + r; B = the table, column i = row i
//          of A_j, K-major as tables_np(...).row holds it;
//   lanes  e_j^T (128 x R) = T_j^T (128 x 1024) . S'^T (1024 x R): A = the
//          table, row c = column c of T_j; B = the data, column r holds
//          k = kk 128 + l.
// Warpgroup w owns lanes 64w .. 64w + 63 and runs wgmma m64nNk32 (N = 32
// or 64: one kernel, instantiated per ring).  Every operand lies K-major
// in 128-byte k-blocks with the 128-byte swizzle of csrc/wgmma_s8.cuh (byte
// kb of row r at 128 r + 16 ((kb / 16) ^ (r mod 8)) + kb mod 16, atoms
// 1024-aligned); a k32 step is a 32-byte offset of the descriptor's start.
//
// Shape: one CTA of two warpgroups per (P polynomials, modulus); grid
// (ceil(nb / P), M).  A CTA's words are RK rows of 128 (Ring<R> in
// csrc/mxu_core.cuh), and each product takes them in RK / N column halves
// of N = min(RK, 64), each with its own 32 (N = 64) or 16 accumulators:
//   R = 32, 64    one polynomial, RK = R, N = R (the layout below);
//   R = 2 .. 16   P = 64 / R polynomials side by side as n = 8192's 64
//                 rows (RK = 64): the lane product is n = 8192's, each lane
//                 tile read once for P polynomials; the row product is
//                 n = 8192's with the host's block-diagonal table (A_j on
//                 each polynomial's R x 8R block, zero digits elsewhere: P
//                 times the row MACs the function needs, which stays below
//                 half the lanes'), the bias b the ring's, and the
//                 twiddles and c_row repeated P times; the last CTA's
//                 missing polynomials are zeros and are not stored;
//   R = 128       one polynomial, RK = 128 in two halves of N = 64: the rows
//                 read all 8 k-blocks of the planes and one half of A_j's
//                 rows a half, the lanes the planes' rows of the half and
//                 every lane tile once a half.
// Shared memory (RK = 64): the CTA's words (64 KiB, resident for all k
// transforms: the epilogue writes the folded word there, the next split
// reads it), their 8 digit planes (64 KiB: the split writes them swizzled,
// fence.proxy.async and a barrier, then the products read them), and a ring
// of SLOTS 16 KiB table slots.  At RK = 128 the planes (128 KiB) and the
// ring fill 193 KiB, and the words live in y (global memory; 128 KiB a
// CTA, L2-resident): copied in from x, read by each split and written by
// each epilogue, __syncthreads between the two as between the planes'
// writes and the products' reads.
//
// The tables stream through the ring.  The host lays each (modulus,
// direction) out once as the exact bytes of every shared-memory tile, in the
// order the kernel reads them (ntt_mxu.table_stream): a row stage is the
// (N x 128-byte) tiles of two k-blocks of one A_j's rows of a half (16 KiB
// at N = 64), a lane stage the (128 x 128-byte) tile of one (j, plane) of
// T_j^T, every stage once a half; 16 + 64 stages per transform at RK = 64
// (1.25 MiB a CTA: 1.25 / P MiB a polynomial), 8 + 64 at R = 32 (1.125
// MiB), 64 + 128 at R = 128 (3 MiB).  One 1-D
// bulk copy (cp.async.bulk, no tensor map) lands a stage ready for the
// descriptors and completes on the slot's `full` mbarrier.  Thread 0 issues
// the copies, predicated inside the PTX (no producer warp: a third
// warpgroup spilled and serialised the rate kernel's wgmma, PERF.md).
// A slot is refilled once every warp of both warpgroups has seen the
// products that read it complete (wgmma.wait_group) and arrived on the
// slot's `empty` mbarrier: the products of a stage overlap the wait for the
// previous one (wait_group 1), and the copy of stage g + SLOTS has SLOTS - 1
// stages of products to land.  Four slots: six, and waiting for every
// stage's products in full, measured no different (PERF.md), so neither the
// ring's depth nor that overlap is what bounds the kernel.
//
// The fold stays fold59, word for word.  The 8 accumulator sets of an
// output do not fit the registers together (8 x 32 a thread at R = 64), so
// each digit j is folded in as it completes: lo += u_j << 8j (j < 5), hi +=
// u_j << 8(j - 5) (j >= 5), u_j = e_j + 2^b, exact in u64 (lo < 2^58, hi <
// 2^42) as in fold59; after j = 7 the tail of fold59 gives W.  So the words,
// the lazy window and check_modulus's bound are the earlier kernel's.
// Registers at N = 64: 32 outputs a thread x 4 of (lo, hi), 32 accumulators.
//
// Bound on Hopper: a transform is 8192 R^2 + 1,048,576 R int8 MACs (at R =
// 64, 33.55 M in the rows and 67.11 M in the lanes), 2.15 ns a polynomial
// at n = 256, 101.7 at 8192 and 271.3 at 16384 at the dense peak of 1,979
// TOP/s over the card.  A CTA streams each table byte from L2 once per
// transform and half (and 8 RK 128 bytes of twiddles).  Measured at R = 64
// (PERF.md; csrc/probe_mxu.cu's parts probe runs these steps with and
// without the folds): the table stream, the products and the integer work
// (splits, folds, epilogue) add with little overlap, and sharing each tile
// across a cluster of two CTAs by multicast, which halves the L2 reads,
// made it slower: the limit is inside the SM.  The likely one (an
// estimate: no counter here reads it) is shared memory's 128 bytes a
// clock: a wgmma at N = 64 reads 4 KiB of operands in its 32 clocks, so
// the ring's copies, the splits and the epilogue's stores wait for the
// products' operand reads.
#include "device_once.cuh"
#include "mxu_core.cuh"  // the transform's device code

namespace {

// x, y: (M, nb, R 128) u64; stream: per modulus Ring<R>::STAGES x TILE bytes
// (ntt_mxu.table_stream); tw, tws: (M, RK 128); crow: (M, RK); ccol: (M,
// 128), the constants of R < 32 repeated over the CTA's P polynomials
// (ntt_mxu.kernel_tables).  CTA (b, m) takes polynomials b P .. b P + P - 1
// of group m; the last CTA's missing ones are zeros, and are not stored.
template <int R>
__global__ void __launch_bounds__(TF_THREADS, 1)
ntt_mxu_kernel(const u64* __restrict__ x, u64* __restrict__ y, const signed char* __restrict__ stream,
               const u64* __restrict__ tw, const u64* __restrict__ tws,
               const u64* __restrict__ crow, const u64* __restrict__ ccol,
               const u64* __restrict__ qs, int nb, int k, int inverse) {
  using RingR = Ring<R>;
  constexpr int n = RingR::RK * LANES;  // the CTA's words
  constexpr int P = RingR::P;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + (SW128_ATOM - smem_u32(smem_raw) % SW128_ATOM) % SW128_ATOM;
  unsigned char* const planes = smem;
  unsigned char* const slots = planes + RingR::PLANES;
  u64* const words = (u64*)(slots + SLOTS * TILE);
  unsigned long long* const bars = (unsigned long long*)(slots + SLOTS * TILE + RingR::WORD_BYTES);
  const int m = blockIdx.y;
  const u64 q = qs[m], delta = q - (1ull << 59);
  tw += (size_t)m * n;
  tws += (size_t)m * n;
  crow += (size_t)m * RingR::RK;
  ccol += (size_t)m * LANES;
  // the warpgroup, warp-uniform to the compiler (as CUTLASS takes it)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const RingR ring{slots, bars, bars + SLOTS, stream + (size_t)m * RingR::STAGES * TILE,
                   inverse ? RingR::LANE_STAGES_ALL : 0, k * RingR::STAGES, threadIdx.x == 0};
  if (ring.leader) {
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(ring.full + i, 1);
      mbar_init(ring.empty + i, TF_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  for (int g = 0; g < SLOTS && g < ring.total; ++g) ring.load(g);
  const size_t off = ((size_t)m * nb + (size_t)blockIdx.x * P) * (R * LANES);
  // the words of this CTA's polynomials (all n but in the last CTA of R < 32)
  const int valid = P == 1 ? n : min(P, nb - (int)blockIdx.x * P) * (R * LANES);
  u64* const sh = RingR::SMEM_WORDS ? words : y + off;
  for (int i = threadIdx.x; i < n; i += TF_THREADS) sh[i] = i < valid ? x[off + i] : 0;
  __syncthreads();
  transforms<R>(planes, sh, ring, tw, tws, crow, ccol, q, delta, wg, k, inverse);
  if constexpr (RingR::SMEM_WORDS)
    for (int i = threadIdx.x; i < valid; i += TF_THREADS) y[off + i] = sh[i];
}

template <int R>
cudaError_t launch(int device, const void* x, void* y, const void* stream, const void* tw,
                   const void* tws, const void* crow, const void* ccol, const void* qs, int M,
                   int nb, int k, int inverse, cudaStream_t s) {
  static bool attribute_set[MAX_DEVICES];  // per device: the kernel's shared-memory size
  const cudaError_t err = smem_once(ntt_mxu_kernel<R>, (int)Ring<R>::SMEM, device, attribute_set);
  if (err != cudaSuccess) return err;
  constexpr int P = Ring<R>::P;
  ntt_mxu_kernel<R><<<dim3((nb + P - 1) / P, M), TF_THREADS, Ring<R>::SMEM, s>>>(
      (const u64*)x, (u64*)y, (const signed char*)stream, (const u64*)tw, (const u64*)tws,
      (const u64*)crow, (const u64*)ccol, (const u64*)qs, nb, k, inverse);
  return cudaGetLastError();
}

}  // namespace

// x, y: (M, nb, 2^logn) int64, logn 8 .. 14 (R = 2 .. 128); stream: (M,
// Ring<R>::STAGES x 16384) int8 (ntt_mxu.table_stream of the direction),
// 16-byte aligned; tw, tws: (M, RK 128); crow: (M, RK); ccol: (M, 128);
// qs: (M,); k >= 1.
extern "C" int aloha_ntt_mxu(int device, const void* x, void* y, const void* stream,
                             const void* tw, const void* tws, const void* crow,
                             const void* ccol, const void* qs, int M, int nb, int logn, int k,
                             int inverse, void* cuda_stream) {
  if (device < 0 || device >= MAX_DEVICES || k < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  switch (logn) {
    case 8:
      return (int)launch<2>(device, x, y, stream, tw, tws, crow, ccol, qs, M, nb, k, inverse, s);
    case 9:
      return (int)launch<4>(device, x, y, stream, tw, tws, crow, ccol, qs, M, nb, k, inverse, s);
    case 10:
      return (int)launch<8>(device, x, y, stream, tw, tws, crow, ccol, qs, M, nb, k, inverse, s);
    case 11:
      return (int)launch<16>(device, x, y, stream, tw, tws, crow, ccol, qs, M, nb, k, inverse, s);
    case 12:
      return (int)launch<32>(device, x, y, stream, tw, tws, crow, ccol, qs, M, nb, k, inverse, s);
    case 13:
      return (int)launch<64>(device, x, y, stream, tw, tws, crow, ccol, qs, M, nb, k, inverse, s);
    case 14:
      return (int)launch<128>(device, x, y, stream, tw, tws, crow, ccol, qs, M, nb, k, inverse, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
