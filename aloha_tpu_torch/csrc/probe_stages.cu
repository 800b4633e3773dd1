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
// Layout: one CTA of ALOHA_THREADS per polynomial with its 8192 words in
// dynamic shared memory for the whole launch, as csrc/ntt.cu: each stage
// reads and writes shared memory and ends in a barrier, so the marginal
// cost per repetition is directly the cost of ntt.cu's stages.
//
// Bound on Hopper: integer issue (INT32 instructions per stage, counted in
// probes/stream_prof*.OPS), then shared-memory bandwidth and barriers.
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

template <int MODE>
__global__ void __launch_bounds__(ALOHA_THREADS)
lane_stages_kernel(const u64* __restrict__ x, u64* __restrict__ y, const u64* __restrict__ w,
                   const u64* __restrict__ ws, u64 q, int reps, int nstages) {
  extern __shared__ u64 a[];
  load(a, x);
  const u64 w1 = w[1], ws1 = ws[1];
  for (int r = 0; r < reps; ++r) {
    for (int s = 0; s < nstages; ++s) {
      const int sh = MODE == STAT_S ? 4 : 6 - s % 7;
      const int t = 1 << sh;
      const int row = s % LOGN;
      for (int b = threadIdx.x; b < N / 2; b += ALOHA_THREADS) {
        const int i = ((b >> sh) << (sh + 1)) + (b & (t - 1));
        const int j = i + t;
        const u64 u = a[i], v = a[j];
        if constexpr (MODE == NOBFLY) {
          const u64 z = add32x2(u, v);
          a[i] = z;
          a[j] = z;
        } else {
          u64 wi = w1, wsi = ws1, wj = w1, wsj = ws1;
          if constexpr (MODE != STAT_T) {
            const int ki = (1 << row) + (i >> (LOGN - row));
            const int kj = (1 << row) + (j >> (LOGN - row));
            wi = w[ki];
            wsi = ws[ki];
            wj = w[kj];
            wsj = ws[kj];
          }
          const u64 x2 = condsub(u, 2 * q);
          a[i] = x2 + shoup_mul(v, wi, wsi, q);
          a[j] = x2 + 2 * q - shoup_mul(v, wj, wsj, q);
        }
      }
      __syncthreads();
    }
  }
  store(y, a);
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const u64 *px = (const u64*)x, *pw = (const u64*)w, *pws = (const u64*)ws;
  u64* py = (u64*)y;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case LANE_FULL:
      if ((err = allow_smem(lane_stages_kernel<LANE_FULL>)) != cudaSuccess) return (int)err;
      lane_stages_kernel<LANE_FULL><<<nb, ALOHA_THREADS, SMEM, s>>>(px, py, pw, pws, q, reps,
                                                                    nstages);
      break;
    case STAT_T:
      if ((err = allow_smem(lane_stages_kernel<STAT_T>)) != cudaSuccess) return (int)err;
      lane_stages_kernel<STAT_T><<<nb, ALOHA_THREADS, SMEM, s>>>(px, py, pw, pws, q, reps,
                                                                 nstages);
      break;
    case STAT_S:
      if ((err = allow_smem(lane_stages_kernel<STAT_S>)) != cudaSuccess) return (int)err;
      lane_stages_kernel<STAT_S><<<nb, ALOHA_THREADS, SMEM, s>>>(px, py, pw, pws, q, reps,
                                                                 nstages);
      break;
    case NOBFLY:
      if ((err = allow_smem(lane_stages_kernel<NOBFLY>)) != cudaSuccess) return (int)err;
      lane_stages_kernel<NOBFLY><<<nb, ALOHA_THREADS, SMEM, s>>>(px, py, pw, pws, q, reps,
                                                                 nstages);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
