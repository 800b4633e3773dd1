// Stage loops with a runtime stage index, on (64, 128) blocks of 32-bit
// words held in registers.
//
// Replaces two TPU kernels, each a fori_loop whose traced index sets the
// roll distance, the partner mask and (for the lanes) the table row:
//   tools/probe_dynstage.py:38 (`body` :17-35): lane stages s = 6..12,
//     t = 8192 >> (s + 1) = 64 .. 1 -> aloha_probe_dynstage;
//   tools/probe_dynsub.py:30 (`body` :13-27): row stages s = 0..5,
//     t = 64 >> (s + 1) = 32 .. 1, no table -> aloha_probe_dynsub.
// A stage takes, for bit = (index & t) != 0, the partner p at index + t if
// bit, else at index - t (mod 128 lanes or 64 rows: the TPU's two rolls),
// and writes bit ? p - a w : a + p w (w = w[s][r][l] for the lanes, 1 for
// the rows), all mod 2^32.  The partner wraps around and is not index ^ t:
// that is the TPU scripts' function (and their NumPy oracles'), ported as
// it is.  Lanes l and l + t (bit set in l) are each other's partners.
//
// The stage index stays a runtime value, as the TPU's traced one: the stage
// loop is not unrolled (#pragma unroll 1), and one switch on s a stage,
// uniform across the CTA, picks a body compiled for its t, so every
// register index is known at compile time (a register array indexed by a
// runtime t would go to local memory).
//
// aloha_probe_dynstage: one persistent CTA of 512 threads an SM walks the
// blocks b = blockIdx.x, + gridDim.x, ...  Thread tid = 8 r + i holds lanes
// 8 j + i (register j, 16 words) of row r: a roll by t >= 8 moves register
// j to (j +- t / 8) mod 16 in the same thread, and the bit is j & (t / 8),
// both known at compile time; t = 4, 2, 1 take one __shfl_sync a word
// among the row's 8 threads, partner thread (i +- t) mod 8, and the
// sender offers register j, j - 1 or j + 1 by its own carry of i +- t
// out of 0..7.  w's rows 6-12 (7 x 32 KiB; the TPU holds the table in VMEM
// for the call) are staged once per CTA into dynamic shared memory, in the
// owner map's order: stage k's quad q of thread tid is the 16 bytes at
// (k 2048 + q 512 + tid) 16 (w[6 + k][r][8 (4q + e) + i] at word e), so a
// quarter-warp's 16-byte loads hit 8 distinct bank quads.  No global load
// in the stage loop, no barrier after the staging.
//
// aloha_probe_dynsub: one CTA of 128 threads a block, thread l holds column
// l (64 words, register r = row r): a row stage's partner is in the same
// thread, register (r +- t) mod 64, bit r & t, so all six stages run in
// registers, each pair (r, r + t) once: no shared memory, no barrier, no
// division.
//
// Bound on Hopper, per block per repetition (probes/probe_dynstage.py and
// probe_dynsub.py): the INT32 work the function needs (a product and a sum
// or difference a word a lane stage; a sum or difference a word a row
// stage) over the integer issue peak.  The lanes' table, 229,376 bytes a
// block a repetition over shared memory's 128 bytes a clock an SM, is the
// floor of this design (registers cannot hold 224 KiB of table beside the
// block), twice the operations' time, but not the function's: w is the
// same for every block, and a thread holding the same lanes of two blocks
// would read each table word once for both.
#include <cuda_runtime.h>

#include "device_once.cuh"

namespace {

typedef unsigned int u32;

constexpr int ROWS = 64, LANES = 128, WORDS = ROWS * LANES;
constexpr unsigned FULL_WARP = 0xffffffffu;

// ---------------------------------------------------------- lane stages
constexpr int DS_TPR = 8;                  // threads a row
constexpr int DS_R = LANES / DS_TPR;       // words a thread: register j holds lane DS_TPR j + i
constexpr int DS_THREADS = ROWS * DS_TPR;  // one CTA a block
constexpr int DS_FIRST = 6, DS_LAST = 12;  // stages s, t = WORDS >> (s + 1)
constexpr int DS_STAGES = DS_LAST - DS_FIRST + 1;
constexpr int DS_QUADS = DS_R / 4;  // 16-byte table loads a thread a stage
constexpr int DS_SMEM = (int)sizeof(u32) * DS_STAGES * WORDS;  // w's rows 6-12: 224 KiB
static_assert(DS_TPR <= 32 && DS_R % 4 == 0, "a row's threads lie in one warp");

// One lane stage at distance T on a thread's words; tw: the thread's quad
// 0 of the stage's table image; i: the thread's index in its row.
template <int T>
__device__ __forceinline__ void lane_stage(u32 (&a)[DS_R], const uint4* tw, int i) {
  u32 w[DS_R], b[DS_R];
#pragma unroll
  for (int q = 0; q < DS_QUADS; ++q) {
    const uint4 v = tw[q * DS_THREADS];
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  if constexpr (T >= DS_TPR) {
    constexpr int D = T / DS_TPR;  // the partner's register distance
#pragma unroll
    for (int j = 0; j < DS_R; ++j) {
      if (j & D)
        b[j] = a[(j + D) % DS_R] - a[j] * w[j];
      else
        b[j] = a[j] + a[(j + DS_R - D) % DS_R] * w[j];
    }
  } else {
    const bool bit = (i & T) != 0;
    const int ip = bit ? i + T : i - T;  // the partner thread, before the wrap
    const int carry = ip >= DS_TPR ? 1 : (ip < 0 ? -1 : 0);
    const int src = ip & (DS_TPR - 1);
#pragma unroll
    for (int j = 0; j < DS_R; ++j) {
      // the partner wants register j - carry of this thread (its carry is -carry)
      const u32 offer =
          carry > 0 ? a[(j + DS_R - 1) % DS_R] : (carry < 0 ? a[(j + 1) % DS_R] : a[j]);
      const u32 p = __shfl_sync(FULL_WARP, offer, src, DS_TPR);
      b[j] = bit ? p - a[j] * w[j] : a[j] + p * w[j];
    }
  }
#pragma unroll
  for (int j = 0; j < DS_R; ++j) a[j] = b[j];
}

// x, y: (nb, 64, 128) u32; w: (13, 64, 128) u32
__global__ void __launch_bounds__(DS_THREADS, 1)
dynstage_kernel(const u32* __restrict__ x, u32* __restrict__ y, const u32* __restrict__ w,
                int nb, int reps) {
  extern __shared__ uint4 tbl[];  // w's rows DS_FIRST..DS_LAST in the owner map's order
  const int tid = threadIdx.x, i = tid % DS_TPR;
  // stage w's rows 6-12: word g (lane l of a row) to its owner's slot; a
  // warp's 32 stores (32 adjacent lanes) fall on 32 distinct banks
  u32* image = reinterpret_cast<u32*>(tbl);
#pragma unroll 4
  for (int g = tid; g < DS_STAGES * WORDS; g += DS_THREADS) {
    const int k = g / WORDS, row = g / LANES % ROWS, l = g % LANES, j = l / DS_TPR;
    const int owner = row * DS_TPR + l % DS_TPR;
    image[k * WORDS + ((j / 4) * DS_THREADS + owner) * 4 + j % 4] = __ldg(w + DS_FIRST * WORDS + g);
  }
  __syncthreads();
  for (int blk = blockIdx.x; blk < nb; blk += gridDim.x) {
    const size_t off = (size_t)blk * WORDS + (size_t)(tid / DS_TPR) * LANES + i;
    u32 a[DS_R];
#pragma unroll
    for (int j = 0; j < DS_R; ++j) a[j] = x[off + DS_TPR * j];
    for (int rep = 0; rep < reps; ++rep) {
#pragma unroll 1
      for (int s = DS_FIRST; s <= DS_LAST; ++s) {
        const uint4* tw = tbl + (s - DS_FIRST) * (WORDS / 4) + tid;
        switch (s) {
          case 6: lane_stage<64>(a, tw, i); break;
          case 7: lane_stage<32>(a, tw, i); break;
          case 8: lane_stage<16>(a, tw, i); break;
          case 9: lane_stage<8>(a, tw, i); break;
          case 10: lane_stage<4>(a, tw, i); break;
          case 11: lane_stage<2>(a, tw, i); break;
          case 12: lane_stage<1>(a, tw, i); break;
          default: __trap();
        }
      }
    }
#pragma unroll
    for (int j = 0; j < DS_R; ++j) y[off + DS_TPR * j] = a[j];
  }
}

// ----------------------------------------------------------- row stages
constexpr int SUB_THREADS = LANES;  // one thread a column
constexpr int SUB_STAGES = 6;       // t = ROWS >> (s + 1) = 32 .. 1

// One row stage at distance T on a thread's column: each pair (r, r + T),
// bit set in r, once.
template <int T>
__device__ __forceinline__ void row_stage(u32 (&a)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r & T) {
      const int r2 = (r + T) % ROWS;
      const u32 u = a[r], v = a[r2];
      a[r] = v - u;
      a[r2] = v + u;
    }
  }
}

// x, y: (nb, 64, 128) u32
__global__ void __launch_bounds__(SUB_THREADS)
dynsub_kernel(const u32* __restrict__ x, u32* __restrict__ y, int reps) {
  const size_t off = (size_t)blockIdx.x * WORDS + threadIdx.x;
  u32 a[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) a[r] = x[off + r * LANES];
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll 1
    for (int s = 0; s < SUB_STAGES; ++s) {
      switch (s) {
        case 0: row_stage<32>(a); break;
        case 1: row_stage<16>(a); break;
        case 2: row_stage<8>(a); break;
        case 3: row_stage<4>(a); break;
        case 4: row_stage<2>(a); break;
        case 5: row_stage<1>(a); break;
        default: __trap();
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) y[off + r * LANES] = a[r];
}

}  // namespace

// x, y: (nb, 64, 128) int32 (u32 bit patterns); w: (13, 64, 128) int32;
// nb >= 1, reps >= 0.  min(nb, SMs) CTAs.
extern "C" int aloha_probe_dynstage(int device, const void* x, void* y, const void* w, int nb,
                                    int reps, void* stream) {
  static bool attribute_set[MAX_DEVICES];  // per device: the kernel's shared-memory size
  if (device < 0 || device >= MAX_DEVICES || nb < 1 || reps < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  int sms = 0;
  if (err != cudaSuccess ||
      (err = smem_once(dynstage_kernel, DS_SMEM, device, attribute_set)) != cudaSuccess ||
      (err = sm_count(device, &sms)) != cudaSuccess)
    return (int)err;
  const int grid = nb < sms ? nb : sms;  // persistent CTAs, one an SM
  dynstage_kernel<<<grid, DS_THREADS, DS_SMEM, (cudaStream_t)stream>>>(
      (const u32*)x, (u32*)y, (const u32*)w, nb, reps);
  return (int)cudaGetLastError();
}

// x, y: (nb, 64, 128) int32 (u32 bit patterns); nb >= 1, reps >= 0.
extern "C" int aloha_probe_dynsub(int device, const void* x, void* y, int nb, int reps,
                                  void* stream) {
  if (device < 0 || device >= MAX_DEVICES || nb < 1 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dynsub_kernel<<<nb, SUB_THREADS, 0, (cudaStream_t)stream>>>((const u32*)x, (u32*)y, reps);
  return (int)cudaGetLastError();
}
