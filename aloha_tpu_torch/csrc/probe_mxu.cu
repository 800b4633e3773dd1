// Cost probes of the tensor-core transform, on resident data: the parts
// run csrc/ntt_mxu.cu's own device code (csrc/mxu_core.cuh) with and
// without its folds, the rate the wgmma products alone.
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
//       full  the transform's steps (split_rows_sw, product_step over the
//             rows with the twiddle, split_lanes_sw, product_step over the
//             lanes), with the final fold after every repetition, so the
//             words are canonical each time (the TPU's
//             _fwd_stages(lazy=False); the chain folds at its end only);
//       mxu   the same splits, table stream and wgmma steps, with the XOR
//             epilogue in place of the folds and the twiddle: the products'
//             and the stream's share;
//       vpu   no split, no wgmma, no ring: each thread takes its 32 words of
//             each epilogue at product_step's places, reads and writes them
//             in shared memory once per epilogue, and folds fake
//             accumulators e_j = int32(lo32(x) ^ j) a digit at a time with
//             the row bias, takes the tail with crow[r] and the Shoup
//             product by tw[r][l] (y), then e_j = int32(lo32(y) ^ hi32(y) ^
//             j) with the lane bias and ccol[l], then fold_final: the
//             integer work's share.  Its accumulators are not bounded by
//             2^b, so lo can pass 2^64 at digit 4 and carries into hi (the
//             WIDE fold), and its Shoup is the exact one (the TPU's
//             16-bit-limb quotient is q too large on about 1 word in 10^5).
// Every variant is one CTA of two warpgroups a polynomial, asks for the
// transform's shared memory (Ring<64>::SMEM) and takes __launch_bounds__(256,
// 1), so all three run at the transform's one CTA an SM and their times
// compare.  The table stream runs on across repetitions (stage g of the
// launch, 0 .. 80 reps - 1), as in the chain.
//
// Both probes repeat in one launch on data that stays in shared memory; the
// marginal over REPS is the cost of one repetition (probes/common.py).
//
// The rate probe on wgmma (the rate a wgmma transform can reach; an
// mma.sync product loop reached 467.8-470.9 T-MAC/s on the same products,
// PERF.md).  A CTA owns a tile of 128 rows of x in all 8 planes:
// two warpgroups of 64 rows each (the wgmma M), each on its own with its
// own rows, w ring and mbarriers.  The whole tile is resident for all
// repetitions; BP = 256 (M = 16384) makes 128 CTAs, one wave on 132 SMs.
//   in:   each warpgroup's 8 x 64 rows arrive by one 3-D TMA copy (box 128
//         bytes x 64 rows x 8 planes, 128-byte swizzle: the K-major layout
//         of csrc/wgmma_s8.cuh) completing on the warpgroup's mbarrier.
//         TMA rather than threads writing the swizzle: one thread issues
//         64 KiB with no index arithmetic (a loop of 16-byte loads with
//         divisions per step was bound by latency), and the same map
//         takes the swizzle off again on the way out;
//   w:    the host lays w out once (probes/probe_mxu.w_image): per j, w_j^T
//         (row n = column n of w_j, K contiguous, since integer wgmma takes
//         no transpose), swizzled as the descriptors read it, 16 KiB.  The
//         warpgroup's leader streams w_0 .. w_7 of every repetition from L2
//         into a ring of 3 slots by 1-D bulk copies: step t's slot takes
//         w of step t+2 once step t-1's products have completed, so a copy
//         has two steps to land;
//   step: for each j, the 32 products acc_j += x_k[:, 32kc..] . w_j[32kc..,
//         :] (8 planes x 4 k32 steps) by wgmma.mma_async m64n128k32 s8 into
//         one of two register accumulator sets, committed as one group;
//         while they run, wgmma.wait_group 1 closes step j-1 and its
//         accumulators are shifted and added into s in registers;
//   next: after w_7, byte k of each word of s (int8(s >> k)) is written
//         into plane k of the warpgroup's own rows at its swizzled place,
//         then fence.proxy.async and a warpgroup barrier before the next
//         repetition's wgmma reads them.  No buffer of sums in shared
//         memory, no barrier across the CTA;
//   out:  after the last repetition one 3-D TMA store per warpgroup.
// A producer warp would make 288 threads, which ptxas counts as three
// warpgroups: 168 registers, spills, and wgmma serialised (a first build
// on the H100).  Here 256 threads leave up to 255 registers for the two
// accumulator sets and s (3 x 64 a thread), and the leader's copies are
// predicated inside their instructions, so the wgmma path never diverges.
// Shared memory: per warpgroup x 64 KiB + 3 x 16 KiB of ring + 32 bytes of
// mbarriers, and 1 KiB to align the swizzle atoms: 230,464 of 232,448.
//
// Bound on Hopper: the rate probe is int8 tensor-core work, 2 * 64 * M *
// 128 * 128 operations per repetition over 1,979 TOP/s (the dense wgmma
// peak).  Of the parts, full and mxu carry 1.007e8 int8 MACs per
// transform; vpu only integer instructions (probes/probe_mxu_parts.OPS).
#include "device_once.cuh"
#include "mxu_core.cuh"

namespace {

constexpr int PARTS_R = 64;                 // the parts probe runs at n = 8192

enum PartsVariant { PART_FULL = 0, PART_MXU = 1, PART_VPU = 2 };

// ------------------------------------------------------------ rate kernel
constexpr int RATE_WGS = 2;                        // warpgroups per CTA
constexpr int RATE_ROWS = 64;                      // rows of x per warpgroup (the wgmma M)
constexpr int RATE_TILE = RATE_WGS * RATE_ROWS;    // rows of x per CTA
constexpr int RATE_THREADS = RATE_WGS * 128;
constexpr int RATE_SLOTS = 3;                      // slots of a warpgroup's w ring
constexpr unsigned RATE_PLANE = RATE_ROWS * LANES; // a warpgroup's rows of one plane: 8 KiB
constexpr unsigned RATE_X = NDIG * RATE_PLANE;     // a warpgroup's x: 64 KiB
constexpr unsigned RATE_W = LANES * LANES;         // one w_j image: 16 KiB
constexpr unsigned RATE_WG = RATE_X + RATE_SLOTS * RATE_W;  // a warpgroup's x and ring
constexpr size_t RATE_SMEM = SW128_ATOM + RATE_WGS * RATE_WG +
                             sizeof(unsigned long long) * RATE_WGS * (1 + RATE_SLOTS);
static_assert(RATE_SMEM <= 232448, "one CTA's shared memory");

// s = acc_0 (J = 0) or s + acc_J << (J mod 4), int32 wrapping
template <int J>
__device__ __forceinline__ void combine(const int (&a)[64], int (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i)
    s[i] = J == 0 ? a[i] : (int)((unsigned)s[i] + ((unsigned)a[i] << (J & 3)));
}

// A warpgroup's w ring: the slot the next step reads and the parity of
// that slot's use.
struct WRing {
  unsigned char* base;        // RATE_SLOTS slots of RATE_W bytes
  unsigned long long* full;   // one mbarrier per slot
  unsigned slot, phase;
};

// Step J of a repetition for one warpgroup: the 32 products of w_J into
// acc; once step J-1's products have completed, its slot takes w of step
// J+2 (none past the last repetition) and its accumulators `prev` go into s.
template <int J>
__device__ __forceinline__ void rate_step(int (&acc)[64], int (&prev)[64], int (&s)[64],
                                          unsigned xaddr, WRing& r, const signed char* wimg,
                                          bool leader, bool last_rep) {
  mbar_wait(r.full + r.slot, r.phase);
  const unsigned waddr = smem_u32(r.base + r.slot * RATE_W);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < NDIG; ++k)
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_m64n128k32_s8(acc, sw128_desc(xaddr + k * RATE_PLANE + 32 * kc),
                          sw128_desc(waddr + 32 * kc), k | kc);
  wgmma_commit();
  if constexpr (J > 0) {
    wgmma_wait<1>();  // step J-1's products have completed
    fence_operands(prev);
  }
  // step J-1 (at J = 0 the previous repetition's last, waited for in full) read slot
  // (slot - 1) mod 3, which is (slot + 2) mod 3: w of step J+2 goes there
  const unsigned next = r.slot == 0 ? RATE_SLOTS - 1 : r.slot - 1;
  bulk_load(r.base + next * RATE_W, wimg + (J + 2) % NDIG * RATE_W, RATE_W, r.full + next,
            leader && (!last_rep || J + 2 < NDIG));
  if constexpr (J > 0) combine<J - 1>(prev, s);
  r.slot = r.slot == RATE_SLOTS - 1 ? 0 : r.slot + 1;
  r.phase ^= r.slot == 0;
}

// The next x: byte k of each word of s (this thread's rows and columns in
// the accumulator layout) into plane k of the warpgroup's rows, swizzled.
__device__ __forceinline__ void write_planes(unsigned char* xs, const int (&s)[64], int tid) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned char* row = xs + (16 * warp + g + 8 * h) * LANES + 2 * t;  // row mod 8 = g
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // columns 8i + 2t, +1: chunk i/2 of the row, at chunk (i/2) ^ g
      const int off = (((i >> 1) ^ g) << 4) + ((i & 1) << 3);
      const int a = s[4 * i + 2 * h], b = s[4 * i + 2 * h + 1];
#pragma unroll
      for (int k = 0; k < NDIG; ++k)
        *(unsigned short*)(row + k * RATE_PLANE + off) =
            (unsigned short)__byte_perm(a >> k, b >> k, 0x0040);
    }
  }
}

// xmap, ymap: x and y (8, M, 128) int8 as encode_planes_map lays them out
// (box 8 x 64 x 128); wimg: w_image(w), 8 x 16 KiB.
__global__ void __launch_bounds__(RATE_THREADS, 1)
mxu_rate_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
                const signed char* __restrict__ wimg, int M, int reps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + (SW128_ATOM - smem_u32(smem_raw) % SW128_ATOM) % SW128_ATOM;
  // the warpgroup, warp-uniform to the compiler (as CUTLASS takes it)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0), tid = threadIdx.x % 128;
  const int row0 = blockIdx.x * RATE_TILE + wg * RATE_ROWS;
  if (row0 >= M) return;  // the second warpgroup of a last tile of 64 rows
  unsigned char* const xs = smem + wg * RATE_WG;
  unsigned long long* const bars =
      (unsigned long long*)(smem + RATE_WGS * RATE_WG) + wg * (1 + RATE_SLOTS);
  WRing ring{xs + RATE_X, bars + 1, 0, 0};
  const bool leader = tid == 0;
  if (leader) {
    for (int i = 0; i < 1 + RATE_SLOTS; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
  }
  named_barrier(1 + wg, 128);
  tma_load_3d(xs, &xmap, 0, row0, 0, RATE_X, bars, leader);
  bulk_load(ring.base, wimg, RATE_W, ring.full, leader && reps > 0);  // w_0, w_1
  bulk_load(ring.base + RATE_W, wimg + RATE_W, RATE_W, ring.full + 1, leader && reps > 0);
  mbar_wait(bars, 0);
  int acc0[64], acc1[64], s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;
  const unsigned xaddr = smem_u32(xs);
  for (int rep = 0; rep < reps; ++rep) {
    const bool last = rep == reps - 1;
    rate_step<0>(acc0, acc1, s, xaddr, ring, wimg, leader, last);
    rate_step<1>(acc1, acc0, s, xaddr, ring, wimg, leader, last);
    rate_step<2>(acc0, acc1, s, xaddr, ring, wimg, leader, last);
    rate_step<3>(acc1, acc0, s, xaddr, ring, wimg, leader, last);
    rate_step<4>(acc0, acc1, s, xaddr, ring, wimg, leader, last);
    rate_step<5>(acc1, acc0, s, xaddr, ring, wimg, leader, last);
    rate_step<6>(acc0, acc1, s, xaddr, ring, wimg, leader, last);
    rate_step<7>(acc1, acc0, s, xaddr, ring, wimg, leader, last);
    wgmma_wait<0>();
    fence_operands(acc1);
    combine<NDIG - 1>(acc1, s);
    write_planes(xs, s, tid);
    fence_async_shared();
    named_barrier(1 + wg, 128);
  }
  if (leader) {
    tma_store_3d(&ymap, xs, 0, row0, 0);
    bulk_wait_read_all();
  }
}

// The vpu variant's epilogue of one product step (ROWS: the rows, then the
// twiddle; else the lanes, then the final fold) at product_step's places:
// fake accumulators e_j = int32(v ^ j), v = lo32(x) (ROWS) or lo32(x) ^
// hi32(x), folded a digit at a time as product_step folds (lo for j < 5,
// hi for j >= 5, the j loop not unrolled), with the WIDE carry at j = 4.
template <int R, bool ROWS>
__device__ __forceinline__ void vpu_step(u64* sh, const u64* __restrict__ cvec,
                                         const u64* __restrict__ tw,
                                         const u64* __restrict__ tws, u64 q, u64 delta,
                                         int wg) {
  constexpr int NACC = R / 2;
  constexpr u32 bias = 1u << BIAS_BITS<R, ROWS>;
  const Places at(wg);
  u32 v[NACC];
  u64 lo[NACC], hi[NACC];
#pragma unroll
  for (int o = 0; o < NACC; ++o) {
    const u64 w = sh[at.row(o) * LANES + at.lane(o)];
    v[o] = ROWS ? (u32)w : (u32)w ^ (u32)(w >> 32);
    lo[o] = hi[o] = 0;
  }
#pragma unroll 1
  for (int j = 0; j < NDIG; ++j) {
    if (j < 4) {
#pragma unroll
      for (int o = 0; o < NACC; ++o) lo[o] += (u64)((v[o] ^ j) + bias) << (8 * j);
    } else if (j == 4) {
      // lo < 2^57 so far; lo + u_4 2^32 can pass 2^64
#pragma unroll
      for (int o = 0; o < NACC; ++o) {
        const u64 t = lo[o] + ((u64)((v[o] ^ 4) + bias) << 32);
        hi[o] = (u64)(t < lo[o]) << 24;
        lo[o] = t;
      }
    } else {
#pragma unroll
      for (int o = 0; o < NACC; ++o) hi[o] += (u64)((v[o] ^ j) + bias) << (8 * (j - 5));
    }
  }
#pragma unroll
  for (int o = 0; o < NACC; ++o) {
    const int m = at.lane(o), i = at.row(o);
    const int idx = i * LANES + m;
    const u64 w = fold59(lo[o], hi[o], ROWS ? cvec[i] : cvec[m], q, delta);
    sh[idx] = finish<ROWS>(w, idx, tw, tws, true, q, delta);
  }
}

// x, y: (nb, 8192) u64; stream: ntt_mxu.table_stream of q's forward tables
// (80 stages of TILE bytes); tw, tws: (8192,); crow: (64,); ccol: (128,).
// The shared memory is carved as csrc/ntt_mxu.cu's kernel carves it.
// inverse: 0 (the forward transform), given at run time so that full and
// mxu compile the transform's own loop (mxu_core.cuh's `transforms`).
template <int VARIANT>
__global__ void __launch_bounds__(TF_THREADS, 1)
mxu_parts_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                 const signed char* __restrict__ stream, const u64* __restrict__ tw,
                 const u64* __restrict__ tws, const u64* __restrict__ crow,
                 const u64* __restrict__ ccol, u64 q, int reps, int inverse) {
  using RingR = Ring<PARTS_R>;
  constexpr int n = PARTS_R * LANES;
  constexpr bool RING = VARIANT != PART_VPU;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + (SW128_ATOM - smem_u32(smem_raw) % SW128_ATOM) % SW128_ATOM;
  unsigned char* const planes = smem;
  unsigned char* const slots = planes + RingR::PLANES;
  u64* const sh = (u64*)(slots + SLOTS * TILE);
  unsigned long long* const bars = (unsigned long long*)(sh + n);
  const u64 delta = q - (1ull << 59);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const RingR ring{slots, bars, bars + SLOTS, stream, inverse ? LANE_STAGES : 0,
                   RING ? reps * RingR::STAGES : 0, threadIdx.x == 0};
  if (RING && ring.leader) {
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(ring.full + i, 1);
      mbar_init(ring.empty + i, TF_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  for (int g = 0; g < SLOTS && g < ring.total; ++g) ring.load(g);
  const size_t off = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += TF_THREADS) sh[i] = x[off + i];
  __syncthreads();
  if constexpr (RING) {
    transforms<PARTS_R, VARIANT == PART_FULL ? FOLD : XOR, true>(planes, sh, ring, tw, tws, crow,
                                                                 ccol, q, delta, wg, reps,
                                                                 inverse);
  } else {
    // each thread keeps to its own words, no barrier; the clobbers keep the
    // words' round trip through shared memory in each epilogue
    for (int it = 0; it < reps; ++it) {
      vpu_step<PARTS_R, true>(sh, crow, tw, tws, q, delta, wg);
      asm volatile("" ::: "memory");
      vpu_step<PARTS_R, false>(sh, ccol, tw, tws, q, delta, wg);
      asm volatile("" ::: "memory");
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += TF_THREADS) y[off + i] = sh[i];
}

template <int VARIANT>
cudaError_t launch_parts(int device, const void* x, void* y, const void* stream, const void* tw,
                         const void* tws, const void* crow, const void* ccol, u64 q, int nb,
                         int reps, cudaStream_t s) {
  static bool attribute_set[MAX_DEVICES];  // per device: the kernel's shared-memory size
  const cudaError_t err =
      smem_once(mxu_parts_kernel<VARIANT>, (int)Ring<PARTS_R>::SMEM, device, attribute_set);
  if (err != cudaSuccess) return err;
  mxu_parts_kernel<VARIANT><<<nb, TF_THREADS, Ring<PARTS_R>::SMEM, s>>>(
      (const u64*)x, (u64*)y, (const signed char*)stream, (const u64*)tw, (const u64*)tws,
      (const u64*)crow, (const u64*)ccol, q, reps, 0);
  return cudaGetLastError();
}

}  // namespace

// x, y: (8, M, 128) int8 with M a positive multiple of 64, 16-byte aligned;
// wimg: w_image(w), (8 * 128 * 128,) int8, 16-byte aligned; reps >= 0.
extern "C" int aloha_probe_mxu_rate(int device, const void* x, void* y, const void* wimg, int M,
                                    int reps, void* stream) {
  static bool attribute_set[MAX_DEVICES];  // per device: the kernel's shared-memory size
  if (M <= 0 || M % RATE_ROWS || device < 0 || device >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess ||
      (err = smem_once(mxu_rate_kernel, (int)RATE_SMEM, device, attribute_set)) != cudaSuccess)
    return (int)err;
  CUtensorMap xmap, ymap;
  if ((err = encode_planes_map(&xmap, x, NDIG, M, NDIG, RATE_ROWS)) != cudaSuccess ||
      (err = encode_planes_map(&ymap, y, NDIG, M, NDIG, RATE_ROWS)) != cudaSuccess)
    return (int)err;
  mxu_rate_kernel<<<(M + RATE_TILE - 1) / RATE_TILE, RATE_THREADS, RATE_SMEM,
                    (cudaStream_t)stream>>>(xmap, ymap, (const signed char*)wimg, M, reps);
  return (int)cudaGetLastError();
}

// x, y: (nb, 8192) int64, nb >= 1; stream, tw, tws, crow, ccol:
// ntt_mxu.kernel_tables' forward operands of q (one modulus), the stream
// 16-byte aligned; variant: 0 full, 1 mxu, 2 vpu; reps >= 0.
extern "C" int aloha_probe_mxu_parts(int device, const void* x, void* y, const void* stream,
                                     const void* tw, const void* tws, const void* crow,
                                     const void* ccol, u64 q, int variant, int nb, int reps,
                                     void* cuda_stream) {
  if (device < 0 || device >= MAX_DEVICES || nb < 1 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  switch (variant) {
    case PART_FULL:
      return (int)launch_parts<PART_FULL>(device, x, y, stream, tw, tws, crow, ccol, q, nb, reps,
                                          s);
    case PART_MXU:
      return (int)launch_parts<PART_MXU>(device, x, y, stream, tw, tws, crow, ccol, q, nb, reps,
                                         s);
    case PART_VPU:
      return (int)launch_parts<PART_VPU>(device, x, y, stream, tw, tws, crow, ccol, q, nb, reps,
                                         s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
