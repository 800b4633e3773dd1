// Stage-loop probes of csrc/ntt.cu's forward transform on resident data.
//
// Replaces three TPU kernels, each a body that repeats stage loops on a
// block held in VMEM with no DMA:
//   tools/stream_prof.py:81 (`make_body(mode)`): the 13-stage loop, REPS
//     times, in three modes -> aloha_probe_stage_modes:
//       full       ntt_smem (real butterflies, canonical output), one load,
//                  REPS transforms, one store: also the port of
//                  tools/stream_prof3.py:29 (`make(reps)`, REPS forward
//                  transforms; probes/stream_prof3.fwd_reps);
//       rollsonly  the partner exchange and an add, no multiply: the TPU's
//                  six sublane stages (distance 4096 .. 128) and seven lane
//                  stages (32 .. 1, then 32), both words of a pair set to
//                  their sum with the 32-bit halves added separately, as
//                  the TPU body adds its u32 planes;
//       noroll     the butterfly with partner = self, x <- condsub(x, 2q) +
//                  x w_s(i), no exchange;
//   tools/stream_prof2.py:64 (`make_body(mode, nstages)`): nstages lane
//     stages (distance 8192 >> (s mod 7 + 7), twiddle row s mod 13), REPS
//     times, in four modes -> aloha_probe_lane_stages:
//       full    the Harvey butterfly, each word with the twiddle of its own
//               position (the TPU applies its table row elementwise);
//       statT   table row 0 (one twiddle in registers: no table load);
//       statS   the distance fixed at 16 (a compile-time constant);
//       nobfly  exchange and add only, as in rollsonly.
// Twiddle row s of element i is w[2^s + (i >> (13 - s))] of the compact
// forward tables: the TPU's per-element table row s (ntt_pallas._tables_np).
//
// Layouts.
//   aloha_probe_stage_modes: one CTA of ALOHA_THREADS per polynomial with
//     its 8192 words in dynamic shared memory for the whole launch; each
//     stage reads and writes shared memory and ends in a barrier.  It
//     measures ntt_smem, the stage loop csrc/ntt.cu ran until it moved to
//     the register passes of csrc/ntt_regs.cuh (no user path runs it now).
//   aloha_probe_lane_stages: a lane stage's pairs never leave their aligned
//     128-word group, so 16 lanes of a warp hold one group in registers for
//     the whole launch, 8 words a lane (nb * 32 warps, 4 a CTA).  The
//     distances 64 and 32 pair two registers of a lane for good; before a
//     stage at 16 .. 1 whose bit no register holds, lanes lane and lane ^
//     2^p trade half their words by __shfl_xor_sync, which moves the bit
//     into register bit 0.  Every butterfly is a whole pair in one lane; no
//     shared memory, no barrier.  Its cost per stage is that of
//     register-resident stages and of the trades.
//
// Bound on Hopper: integer issue (INT32 instructions per stage, counted in
// probes/stream_prof*.OPS); then, for the stage modes, shared-memory
// bandwidth and barriers, for the lane stages the trades' shuffles (a
// trade moves half the words, two 32-bit shuffles each; one warp shuffle
// a clock an SM).
#include <climits>

#include "modarith.cuh"

namespace {

constexpr int LOGN = 13;
constexpr int N = 1 << LOGN;
constexpr size_t SMEM = sizeof(u64) * N;

enum StageMode { FULL = 0, ROLLSONLY = 1, NOROLL = 2 };
enum LaneMode { LANE_FULL = 0, STAT_T = 1, STAT_S = 2, NOBFLY = 3 };

__device__ __forceinline__ void load(u64* a, const u64* __restrict__ x) {
  const size_t off = (size_t)blockIdx.x * N;
  for (int i = threadIdx.x; i < N; i += ALOHA_THREADS) a[i] = x[off + i];
  __syncthreads();
}

__device__ __forceinline__ void store(u64* __restrict__ y, const u64* a) {
  const size_t off = (size_t)blockIdx.x * N;
  for (int i = threadIdx.x; i < N; i += ALOHA_THREADS) y[off + i] = a[i];
}

template <int MODE>
__global__ void __launch_bounds__(ALOHA_THREADS)
stage_modes_kernel(const u64* __restrict__ x, u64* __restrict__ y, const u64* __restrict__ w,
                   const u64* __restrict__ ws, u64 q, int reps) {
  extern __shared__ u64 a[];
  load(a, x);
  for (int r = 0; r < reps; ++r) {
    if constexpr (MODE == FULL) {
      ntt_smem(a, LOGN, w, ws, q);
    } else {
      for (int s = 0; s < LOGN; ++s) {
        if constexpr (MODE == ROLLSONLY) {
          const int sh = s < 6 ? 12 - s : 5 - (s - 6) % 6;
          const int d = 1 << sh;
          for (int b = threadIdx.x; b < N / 2; b += ALOHA_THREADS) {
            const int i = ((b >> sh) << (sh + 1)) + (b & (d - 1));
            const u64 v = add32x2(a[i], a[i + d]);
            a[i] = v;
            a[i + d] = v;
          }
        } else {
          for (int i = threadIdx.x; i < N; i += ALOHA_THREADS) {
            const int k = (1 << s) + (i >> (LOGN - s));
            const u64 v = a[i];
            a[i] = condsub(v, 2 * q) + shoup_mul(v, w[k], ws[k], q);
          }
        }
        __syncthreads();
      }
    }
  }
  store(y, a);
}

// The lane kernel's layout.  Stage s pairs words i and i + t with t = 64 >>
// (s mod 7), so no pair leaves its aligned 128-word group: a polynomial is
// N / GROUP independent groups over every stage of every repetition.  A
// group lives in 16 lanes of one warp, 8 words a lane.  Register bits 1
// and 2 of a word (bits 1 and 2 of m in a[m]) are its index bits 5 and 6
// for good; register bit 0 is index bit r0, and the lane bits hold the rest.  A stage at a bit no register bit holds first trades that
// bit's lane bit with register bit 0, so every butterfly pairs two
// registers of one lane, and the words' places are tracked at run time.
constexpr int GROUP = 128;
constexpr int GROUP_BITS = 7;
constexpr int LANE_WORDS = 8;                       // words a lane holds
constexpr int LANE_BITS = 4;                        // index bits a lane's place holds
constexpr int GROUP_LANES = 1 << LANE_BITS;         // lanes a group
constexpr int WARP_GROUPS = 32 / GROUP_LANES;       // groups a warp
constexpr int LANE_WARPS = 4;                       // warps a CTA
static_assert(LANE_WORDS << LANE_BITS == GROUP, "a group is 16 lanes of 8 words");

// Where a lane's words sit in their group (the same in every lane but lane_i).
struct Layout {
  int r0;        // the index bit of register bit 0
  unsigned pos;  // 3 bits an index bit b < LANE_BITS + 1: the lane bit holding it
  int lane_i;    // the lane's part of its words' indices in the group
};

__device__ __forceinline__ u64 shfl_xor64(u64 x, int t) {
  const unsigned lo = __shfl_xor_sync(0xffffffffu, (unsigned)x, t);
  const unsigned hi = __shfl_xor_sync(0xffffffffu, (unsigned)(x >> 32), t);
  return ((u64)hi << 32) | lo;
}

// x, its value hidden from the compiler.
__device__ __forceinline__ u64 opaque(u64 x) {
  asm("mov.b64 %0, %0;" : "+l"(x));
  return x;
}

// Index in the group of register m's word.
__device__ __forceinline__ int word_index(const Layout& L, int m) {
  return L.lane_i + ((m & 1) << L.r0) + ((m >> 1) << (LANE_BITS + 1));
}

// Brings index bit b into register bit 0: lanes lane and lane ^ 2^pos(b)
// swap half their words (for each register pair m, m + 1: the lane with
// that bit clear sends m + 1, the other m), and bit r0 takes lane bit pos(b).
__device__ __forceinline__ void trade(u64 (&a)[LANE_WORDS], Layout& L, int lane, int b) {
  const int p = (L.pos >> (3 * b)) & 7;
  const bool upper = (lane >> p) & 1;
#pragma unroll
  for (int m = 0; m < LANE_WORDS; m += 2) {
    const u64 got = shfl_xor64(upper ? a[m] : a[m + 1], 1 << p);
    a[m] = upper ? got : a[m];
    a[m + 1] = upper ? a[m + 1] : got;
  }
  L.lane_i += upper ? (1 << L.r0) - (1 << b) : 0;
  L.pos = (L.pos & ~(7u << (3 * L.r0))) | ((unsigned)p << (3 * L.r0));
  L.r0 = b;
}

// The butterflies of a stage whose bit register bit J holds: pairs m, m +
// 2^J of each lane, twiddle row `row` (UNIFORM: row <= LOGN - 7, where one
// twiddle serves the whole group; above it each word loads its own).
template <int J, bool UNIFORM, int MODE>
__device__ __forceinline__ void butterflies(u64 (&a)[LANE_WORDS], const Layout& L, int gbase,
                                            int row, const u64* __restrict__ w,
                                            const u64* __restrict__ ws, u64 w1, u64 ws1, u64 q) {
  constexpr int D = 1 << J;
  const u64 q2 = 2 * q;
  const int sh = LOGN - row;
  u64 wu = w1, wsu = ws1;
  if (MODE == LANE_FULL || MODE == STAT_S) {
    if (UNIFORM) {
      const int k = (1 << row) + (gbase >> sh);
      wu = __ldg(w + k);
      wsu = __ldg(ws + k);
    }
  }
#pragma unroll
  for (int m = 0; m < LANE_WORDS; ++m) {
    if (m & D) continue;
    if constexpr (MODE == NOBFLY) {
      a[m] = a[m + D] = add32x2(a[m], a[m + D]);
    } else if constexpr (MODE == STAT_T) {  // one product: both words take w[1]
      const u64 x2 = condsub(a[m], q2), y = shoup_mul(a[m + D], w1, ws1, q);
      a[m] = x2 + y;
      a[m + D] = x2 + q2 - y;
    } else {
      u64 wi, wsi, wj, wsj;
      if (UNIFORM) {
        // each word its own product, as the TPU applies its row
        // elementwise: the pair's equal twiddles are not merged
        wi = wu;
        wsi = wsu;
        wj = opaque(wu);
        wsj = opaque(wsu);
      } else {
        const int ki = (1 << row) + ((gbase + word_index(L, m)) >> sh);
        const int kj = (1 << row) + ((gbase + word_index(L, m + D)) >> sh);
        wi = __ldg(w + ki);
        wsi = __ldg(ws + ki);
        wj = __ldg(w + kj);
        wsj = __ldg(ws + kj);
      }
      const u64 x2 = condsub(a[m], q2), v = a[m + D];
      a[m] = x2 + shoup_mul(v, wi, wsi, q);
      a[m + D] = x2 + q2 - shoup_mul(v, wj, wsj, q);
    }
  }
}

// The same, UNIFORM read from the row (a branch uniform across the warp).
template <int J, int MODE>
__device__ __forceinline__ void butterflies(u64 (&a)[LANE_WORDS], const Layout& L, int gbase,
                                            int row, const u64* __restrict__ w,
                                            const u64* __restrict__ ws, u64 w1, u64 ws1, u64 q) {
  if (MODE == LANE_FULL || MODE == STAT_S) {
    if (LOGN - row < GROUP_BITS) {
      butterflies<J, false, MODE>(a, L, gbase, row, w, ws, w1, ws1, q);
      return;
    }
  }
  butterflies<J, true, MODE>(a, L, gbase, row, w, ws, w1, ws1, q);
}

// One lane stage at distance 2^b with twiddle row `row`: bits 5 and 6 sit
// in register bits 1 and 2 for good; any other is traded into register bit
// 0 unless it is there already.  Every branch is uniform across the warp.
template <int MODE>
__device__ __forceinline__ void lane_stage(u64 (&a)[LANE_WORDS], Layout& L, int lane, int b,
                                           int gbase, int row, const u64* __restrict__ w,
                                           const u64* __restrict__ ws, u64 w1, u64 ws1, u64 q) {
  switch (b) {
    case 5: butterflies<1, MODE>(a, L, gbase, row, w, ws, w1, ws1, q); break;
    case 6: butterflies<2, MODE>(a, L, gbase, row, w, ws, w1, ws1, q); break;
    default:
      if (L.r0 != b) trade(a, L, lane, b);
      butterflies<0, MODE>(a, L, gbase, row, w, ws, w1, ws1, q);
  }
}

// One group a 16 lanes: one load, reps x nstages stages in
// registers (stage s at distance 64 >> (s mod 7); statS 16 always), one
// store at the layout the stages left.  No shared memory, no barrier.
template <int MODE>
__global__ void __launch_bounds__(32 * LANE_WARPS)
lane_stages_kernel(const u64* __restrict__ x, u64* __restrict__ y, const u64* __restrict__ w,
                   const u64* __restrict__ ws, u64 q, int groups, int reps, int nstages) {
  const int lane = threadIdx.x % 32;
  const int grp = (blockIdx.x * LANE_WARPS + threadIdx.x / 32) * WARP_GROUPS + lane / GROUP_LANES;
  if (grp >= groups) return;  // whole warps: groups is a multiple of WARP_GROUPS
  const int gbase = grp % (N / GROUP) * GROUP;
  const size_t goff = (size_t)grp * GROUP;
  Layout L{LANE_BITS, 0u, lane % GROUP_LANES};
#pragma unroll
  for (int b = 0; b < LANE_BITS; ++b) L.pos |= (unsigned)b << (3 * b);
  u64 a[LANE_WORDS];
#pragma unroll
  for (int m = 0; m < LANE_WORDS; ++m) a[m] = x[goff + word_index(L, m)];
  const u64 w1 = __ldg(w + 1), ws1 = __ldg(ws + 1);
  for (int r = 0; r < reps; ++r) {
    for (int s = 0, b = GROUP_BITS - 1, row = 0; s < nstages; ++s) {
      lane_stage<MODE>(a, L, lane, MODE == STAT_S ? 4 : b, gbase, row, w, ws, w1, ws1, q);
      b = b == 0 ? GROUP_BITS - 1 : b - 1;
      row = row == LOGN - 1 ? 0 : row + 1;
    }
  }
#pragma unroll
  for (int m = 0; m < LANE_WORDS; ++m) y[goff + word_index(L, m)] = a[m];
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
}

}  // namespace

// Every entry: x, y (nb, 8192) int64; w, ws the compact forward tables
// (8192,) of q; reps >= 0.

// mode: 0 full, 1 rollsonly, 2 noroll
extern "C" int aloha_probe_stage_modes(int device, const void* x, void* y, const void* w,
                                       const void* ws, u64 q, int mode, int nb, int reps,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const u64 *px = (const u64*)x, *pw = (const u64*)w, *pws = (const u64*)ws;
  u64* py = (u64*)y;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case FULL:
      if ((err = allow_smem(stage_modes_kernel<FULL>)) != cudaSuccess) return (int)err;
      stage_modes_kernel<FULL><<<nb, ALOHA_THREADS, SMEM, s>>>(px, py, pw, pws, q, reps);
      break;
    case ROLLSONLY:
      if ((err = allow_smem(stage_modes_kernel<ROLLSONLY>)) != cudaSuccess) return (int)err;
      stage_modes_kernel<ROLLSONLY><<<nb, ALOHA_THREADS, SMEM, s>>>(px, py, pw, pws, q, reps);
      break;
    case NOROLL:
      if ((err = allow_smem(stage_modes_kernel<NOROLL>)) != cudaSuccess) return (int)err;
      stage_modes_kernel<NOROLL><<<nb, ALOHA_THREADS, SMEM, s>>>(px, py, pw, pws, q, reps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// mode: 0 full, 1 statT, 2 statS, 3 nobfly; nstages >= 0 lane stages per repetition
extern "C" int aloha_probe_lane_stages(int device, const void* x, void* y, const void* w,
                                       const void* ws, u64 q, int mode, int nb, int reps,
                                       int nstages, void* stream) {
  if (nb < 1 || nb > INT_MAX / (N / GROUP)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const u64 *px = (const u64*)x, *pw = (const u64*)w, *pws = (const u64*)ws;
  u64* py = (u64*)y;
  cudaStream_t s = (cudaStream_t)stream;
  const int groups = nb * (N / GROUP);
  const int warps = groups / WARP_GROUPS;
  const int ctas = (warps + LANE_WARPS - 1) / LANE_WARPS;
  constexpr int threads = 32 * LANE_WARPS;
  switch (mode) {
    case LANE_FULL:
      lane_stages_kernel<LANE_FULL><<<ctas, threads, 0, s>>>(px, py, pw, pws, q, groups, reps,
                                                             nstages);
      break;
    case STAT_T:
      lane_stages_kernel<STAT_T><<<ctas, threads, 0, s>>>(px, py, pw, pws, q, groups, reps,
                                                          nstages);
      break;
    case STAT_S:
      lane_stages_kernel<STAT_S><<<ctas, threads, 0, s>>>(px, py, pw, pws, q, groups, reps,
                                                          nstages);
      break;
    case NOBFLY:
      lane_stages_kernel<NOBFLY><<<ctas, threads, 0, s>>>(px, py, pw, pws, q, groups, reps,
                                                          nstages);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
