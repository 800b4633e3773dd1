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
// Warpgroup w owns lanes 64w .. 64w + 63 and issues wgmma m64nRk32 (N = R =
// 64 or 32: one kernel, instantiated per ring).  Every operand lies K-major
// in 128-byte k-blocks with the 128-byte swizzle of csrc/wgmma_s8.cuh (byte
// kb of row r at 128 r + 16 ((kb / 16) ^ (r mod 8)) + kb mod 16, atoms
// 1024-aligned); a k32 step is a 32-byte offset of the descriptor's start.
//
// Shape: one CTA of two warpgroups per (polynomial, modulus); grid (nb, M).
// Shared memory (R = 64): the polynomial's words (64 KiB, resident for all k
// transforms: the epilogue writes the folded word there, the next split
// reads it), its 8 digit planes (64 KiB: the split writes them swizzled,
// fence.proxy.async and a barrier, then the products read them), and a ring
// of SLOTS 16 KiB table slots.
//
// The tables stream through the ring.  The host lays each (modulus,
// direction) out once as the exact bytes of every shared-memory tile, in the
// order the kernel reads them (ntt_mxu.table_stream): a row stage is the
// (R x 128-byte) tiles of two k-blocks of one A_j (16 KiB at R = 64), a
// lane stage the (128 x 128-byte) tile of one (j, plane) of T_j^T; 16 + 64
// stages per transform at R = 64 (1.25 MiB), 8 + 64 at R = 32.  One 1-D
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
// Registers at R = 64: 32 outputs a thread x 4 of (lo, hi), 32 accumulators.
//
// Bound on Hopper: a transform is 1.0066e8 int8 MACs (33.55 M in the rows,
// 67.11 M in the lanes), 101.7 ns a polynomial at the dense peak of 1,979
// TOP/s over the card.  A CTA streams each table byte from L2 once per
// transform (1.25 MiB of digits and 128 KiB of twiddles, against 4 MiB of
// fragments for the mma.sync design).  Measured (PERF.md): the table
// stream, the products and the integer work (splits, folds, epilogue) add
// with little overlap, and sharing each tile across a cluster of two CTAs
// by multicast, which halves the L2 reads, made it slower: the limit is
// inside the SM.  The likely one (an estimate: no counter here reads it) is
// shared memory's 128 bytes a clock: a wgmma at N = 64 reads 4 KiB of
// operands in its 32 clocks, so the ring's copies, the splits and the
// epilogue's stores wait for the products' operand reads.
#include "mxu_core.cuh"  // fold59's constants, fold_final, finish
#include "wgmma_s8.cuh"

namespace {

constexpr int TF_WGS = 2;                      // warpgroups a CTA
constexpr int TF_THREADS = TF_WGS * 128;
constexpr int TF_WARPS = TF_THREADS / 32;      // arrivals on an `empty` mbarrier
constexpr int SLOTS = 4;                       // table ring slots
constexpr unsigned TILE = 16384;               // bytes of a slot and of a stage in the stream
constexpr unsigned KBLOCK = LANES * LANES;     // a 128-row k-block of 128 bytes
constexpr int LANE_STAGES = NDIG * NDIG;       // (j, plane kk)
constexpr int MAX_DEVICES = 64;

template <int R>
struct Ring {
  static constexpr int ROW_STAGES = NDIG * R / 32;  // (j, pair of k-blocks)
  static constexpr int STAGES = ROW_STAGES + LANE_STAGES;
  static constexpr unsigned ROW_BYTES = 2 * R * LANES;
  static constexpr unsigned PLANES = NDIG * R * LANES;
  // planes, ring, words, mbarriers, and 1 KiB to align the swizzle atoms
  static constexpr size_t SMEM = SW128_ATOM + PLANES + SLOTS * TILE + sizeof(u64) * R * LANES +
                                 sizeof(unsigned long long) * 2 * SLOTS;
  static_assert(SMEM <= 232448, "one CTA's shared memory");

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

// The rows product's A: k-block kb (128 rows of 128 bytes) holds, in row
// l, bytes 128 kb .. 128 kb + 127 of k = kk R + r.  A thread takes lane l
// and rows r0 .. r0 + 15, so each plane's 16 bytes are one swizzled chunk.
template <int R>
__device__ __forceinline__ void split_rows_sw(const u64* sh, unsigned char* planes) {
  for (int it = threadIdx.x; it < (R / 16) * LANES; it += TF_THREADS) {
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
      const int k = kk * R + r0;
      *(uint4*)(planes + (k >> 7) * KBLOCK + l * LANES + ((((k & 127) >> 4) ^ (l & 7)) << 4)) =
          make_uint4(d[0][kk], d[1][kk], d[2][kk], d[3][kk]);
    }
  }
}

// The lanes product's B: k-block kk (R x 128 bytes) holds row r, byte l of
// k = kk 128 + l.  A thread takes row r and lanes l0 .. l0 + 3.
template <int R>
__device__ __forceinline__ void split_lanes_sw(const u64* sh, unsigned char* planes) {
  for (int it = threadIdx.x; it < R * (LANES / 4); it += TF_THREADS) {
    const int r = it / (LANES / 4), l0 = (it % (LANES / 4)) * 4;
    const ulonglong2 a = *(const ulonglong2*)(sh + r * LANES + l0);
    const ulonglong2 b = *(const ulonglong2*)(sh + r * LANES + l0 + 2);
    const u64 v[4] = {a.x, a.y, b.x, b.y};
    u32 d[NDIG];
    digits4(v, d);
    unsigned char* row = planes + r * LANES + ((((l0 >> 4) ^ (r & 7))) << 4) + (l0 & 15);
#pragma unroll
    for (int kk = 0; kk < NDIG; ++kk) *(u32*)(row + kk * (R * LANES)) = d[kk];
  }
}

// One product step (ROWS: the rows, else the lanes) over its table stages,
// starting at stage g of the launch; the folded words go to sh, through
// finish<MID>.  cvec: crow (ROWS) or ccol.
template <int R, bool ROWS, bool MID>
__device__ __forceinline__ void product_step(unsigned planes, u64* sh, const Ring<R>& ring,
                                             int& g, const u64* __restrict__ cvec,
                                             const u64* __restrict__ tw,
                                             const u64* __restrict__ tws, bool fin, u64 q,
                                             u64 delta, int wg) {
  constexpr int NACC = R / 2;                   // accumulators of m64nRk32
  constexpr int PARTS = ROWS ? R / 32 : NDIG;   // stages per digit j
  constexpr int KB = ROWS ? 2 : 1;              // k-blocks per stage
  constexpr unsigned BLK = R * LANES;           // a k-block of the R-row operand
  constexpr int b = ROWS ? (R == 64 ? 23 : 22) : LANE_BITS;  // bias_bits(8R), bias_bits(1024)
  static_assert(ROWS ? NDIG * R << 14 == 1 << b : true, "row bias");
  const unsigned wrow = wg * 64 * LANES;        // the warpgroup's 64 rows of a 128-row operand
  u64 lo[NACC], hi[NACC];
  int acc[NACC];
#pragma unroll
  for (int o = 0; o < NACC; ++o) {
    lo[o] = hi[o] = 0;
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
          const unsigned bb = ROWS ? tile + kb * BLK + 32 * kc : planes + p * BLK + 32 * kc;
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
  // d[4 blk + 2h + e] of lane 4 gq + t in warp w: row (lane) m = 64 wg + 16 w
  // + gq + 8h, column i = 8 blk + 2t + e (csrc/wgmma_s8.cuh); word i 128 + m
  const int lane = threadIdx.x & 31, m0 = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int t = lane & 3;
#pragma unroll
  for (int o = 0; o < NACC; ++o) {
    const int m = m0 + 8 * ((o >> 1) & 1), i = 8 * (o >> 2) + 2 * t + (o & 1);
    const int idx = i * LANES + m;
    // the tail of fold59: V = lo + hi 2^40 + c, W = (V mod 2^59) + 20q - (V >> 59) delta
    const u64 c = ROWS ? cvec[i] : cvec[m];
    const u64 v1 = lo[o] + (hi[o] << 40), v2 = v1 + c;
    const u64 vhi = (hi[o] >> 24) + (v1 < lo[o]) + (v2 < v1);
    const u64 w = (v2 & MASK59) + 20 * q - ((vhi << 5) | (v2 >> 59)) * delta;
    sh[idx] = finish<MID>(w, idx, tw, tws, fin, q, delta);
  }
}

// x, y: (M, nb, R 128) u64; stream: per modulus Ring<R>::STAGES x TILE bytes
// (ntt_mxu.table_stream); tw, tws: (M, R 128); crow: (M, R); ccol: (M, 128).
template <int R>
__global__ void __launch_bounds__(TF_THREADS, 1)
ntt_mxu_kernel(const u64* __restrict__ x, u64* __restrict__ y, const signed char* __restrict__ stream,
               const u64* __restrict__ tw, const u64* __restrict__ tws,
               const u64* __restrict__ crow, const u64* __restrict__ ccol,
               const u64* __restrict__ qs, int nb, int k, int inverse) {
  using RingR = Ring<R>;
  constexpr int n = R * LANES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + (SW128_ATOM - smem_u32(smem_raw) % SW128_ATOM) % SW128_ATOM;
  unsigned char* const planes = smem;
  unsigned char* const slots = planes + RingR::PLANES;
  u64* const sh = (u64*)(slots + SLOTS * TILE);
  unsigned long long* const bars = (unsigned long long*)(sh + n);
  const int m = blockIdx.y;
  const u64 q = qs[m], delta = q - (1ull << 59);
  tw += (size_t)m * n;
  tws += (size_t)m * n;
  crow += (size_t)m * R;
  ccol += (size_t)m * LANES;
  // the warpgroup, warp-uniform to the compiler (as CUTLASS takes it)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const RingR ring{slots, bars, bars + SLOTS, stream + (size_t)m * RingR::STAGES * TILE,
                   inverse ? LANE_STAGES : 0, k * RingR::STAGES, threadIdx.x == 0};
  if (ring.leader) {
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(ring.full + i, 1);
      mbar_init(ring.empty + i, TF_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  for (int g = 0; g < SLOTS && g < ring.total; ++g) ring.load(g);
  const size_t off = ((size_t)m * nb + blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += TF_THREADS) sh[i] = x[off + i];
  __syncthreads();
  const unsigned paddr = smem_u32(planes);
  int g = 0;
  for (int it = 0; it < k; ++it) {
    const bool fin = it == k - 1;
    if (!inverse) {
      split_rows_sw<R>(sh, planes);
      fence_async_shared();
      __syncthreads();
      product_step<R, true, true>(paddr, sh, ring, g, crow, tw, tws, fin, q, delta, wg);
      __syncthreads();
      split_lanes_sw<R>(sh, planes);
      fence_async_shared();
      __syncthreads();
      product_step<R, false, false>(paddr, sh, ring, g, ccol, tw, tws, fin, q, delta, wg);
      __syncthreads();
    } else {
      split_lanes_sw<R>(sh, planes);
      fence_async_shared();
      __syncthreads();
      product_step<R, false, true>(paddr, sh, ring, g, ccol, tw, tws, fin, q, delta, wg);
      __syncthreads();
      split_rows_sw<R>(sh, planes);
      fence_async_shared();
      __syncthreads();
      product_step<R, true, false>(paddr, sh, ring, g, crow, tw, tws, fin, q, delta, wg);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += TF_THREADS) y[off + i] = sh[i];
}

template <int R>
cudaError_t launch(int device, const void* x, void* y, const void* stream, const void* tw,
                   const void* tws, const void* crow, const void* ccol, const void* qs, int M,
                   int nb, int k, int inverse, cudaStream_t s) {
  static bool attribute_set[MAX_DEVICES];  // per device: the kernel's shared-memory size
  if (!attribute_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_mxu_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Ring<R>::SMEM);
    if (err != cudaSuccess) return err;
    attribute_set[device] = true;
  }
  ntt_mxu_kernel<R><<<dim3(nb, M), TF_THREADS, Ring<R>::SMEM, s>>>(
      (const u64*)x, (u64*)y, (const signed char*)stream, (const u64*)tw, (const u64*)tws,
      (const u64*)crow, (const u64*)ccol, (const u64*)qs, nb, k, inverse);
  return cudaGetLastError();
}

}  // namespace

// x, y: (M, nb, 2^logn) int64, logn 12 or 13; stream: (M, STAGES x 16384)
// int8 (ntt_mxu.table_stream of the direction), 16-byte aligned; tw, tws:
// (M, 2^logn); crow: (M, R); ccol: (M, 128); qs: (M,); k >= 1.
extern "C" int aloha_ntt_mxu(int device, const void* x, void* y, const void* stream,
                             const void* tw, const void* tws, const void* crow,
                             const void* ccol, const void* qs, int M, int nb, int logn, int k,
                             int inverse, void* cuda_stream) {
  if (device < 0 || device >= MAX_DEVICES || k < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  switch (logn) {
    case 12:
      return (int)launch<32>(device, x, y, stream, tw, tws, crow, ccol, qs, M, nb, k, inverse, s);
    case 13:
      return (int)launch<64>(device, x, y, stream, tw, tws, crow, ccol, qs, M, nb, k, inverse, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
