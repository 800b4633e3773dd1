// Marginal-cost probe of the NTT's building blocks: 15 variants v0 .. v14.
//
// Replaces the TPU kernel of tools/op_probe.py:263 (`make(fn, reps)` ->
// `body`, variants at :50-236): REPS data-dependent repetitions of one
// building block of the streaming NTT on a resident polynomial, launched at
// two REPS so that the launch, the loads and the stores drop out of the
// difference.  The TPU variants work on u32 (lo, hi) planes; here each runs
// the u64 operation it stands for (modarith.cuh).  The ones that measured
// the plane split (v2, v4, v10 - v14) keep their names:
//   v0  one Harvey CT stage at a runtime distance t = 32 inside each
//       128-word row, stage-5 twiddles (the structure of ntt_smem's stage)
//   v1  shoup_mul             v2  __umul64hi(x, ws)     v3  x * w (low 64)
//   v4  (x & 2^32-1) * (x >> 32), the 32x32 -> 64 product of the halves
//   v5  lo*hi, hi+lo on the 32-bit halves (each mod 2^32)
//   v6  cyclic roll by 32 along the 128-word row
//   v7  condsub(x, 4q)        v8  x + swap32(x)
//   v9  lane bit 32 ? x : swap32(x)
//   v10 = v2 and v11 = v1 (the u64 forms of the TPU's 16-bit limb variants)
//   v12 shoup_mul with t*q as shift-adds over q0's set bits
//   v13 v0's stage at the compile-time distance 32 with v12's product
//   v14 v0's stage at the compile-time distance 32 with shoup_mul
// Element i is coefficient i: row i >> 7, lane i & 127 of the TPU's
// (64, 128) tile; the twiddles are row 5 of the forward tables,
// w[32 + (i >> 8)] of the compact tables (ntt_torch.twiddles_np).
//
// Layout: one CTA of ALOHA_THREADS per polynomial, its 8192 words in
// dynamic shared memory for the whole launch, as csrc/ntt.cu holds them.
// One repetition is one stage of ntt.cu's kind: every thread reads its
// words from shared memory, applies the step, writes them back, and the
// CTA synchronises (v6 reads all, synchronises, writes, synchronises).
// Differences of the variants' marginals split a stage's cost: v7 is the
// shared-memory round trip and the barrier with a trivial step; v1 - v7
// the Shoup product; v6 - v7 the exchange; v0 - v14 the runtime index
// arithmetic.
//
// Bound on Hopper: integer issue, the step's INT32 instructions over the
// SMs' INT32 lanes (probes/op_probe.OPS); no HBM traffic per repetition.
#include "modarith.cuh"

namespace {

constexpr int N = 8192;
constexpr int PER_THREAD = N / ALOHA_THREADS;
constexpr int ROW = 128;
constexpr size_t SMEM = sizeof(u64) * N;
// q0 = 2^59 + 2^36 + 2^32 + 1, the only modulus of v12 / v13
constexpr u64 Q0 = 0x0800001100000001ull;

__device__ __forceinline__ int tw_index(int i) { return 32 + (i >> 8); }

template <int V>
__device__ __forceinline__ u64 elem_step(u64 x, int i, u64 w, u64 ws, u64 q) {
  if constexpr (V == 1 || V == 11) {
    return shoup_mul(x, w, ws, q);
  } else if constexpr (V == 2 || V == 10) {
    return __umul64hi(x, ws);
  } else if constexpr (V == 3) {
    return x * w;
  } else if constexpr (V == 4) {
    return (x & 0xffffffffull) * (x >> 32);
  } else if constexpr (V == 5) {
    const unsigned lo = (unsigned)x, hi = (unsigned)(x >> 32);
    return ((u64)(hi + lo) << 32) | (unsigned)(lo * hi);
  } else if constexpr (V == 7) {
    return condsub(x, 4 * q);
  } else if constexpr (V == 8) {
    return x + swap32(x);
  } else if constexpr (V == 9) {
    return (i & 32) ? x : swap32(x);
  } else {
    static_assert(V == 12, "elementwise variants: 1-5, 7-12");
    return shoup_mul_sparse<32, 36, 59>(x, w, ws);
  }
}

// One CT stage at distance 2^sh: pairs (i, i + t) with bit sh of i clear.
template <int V>
__device__ __forceinline__ void stage_step(u64* a, int sh, const u64* __restrict__ w,
                                           const u64* __restrict__ ws, u64 q) {
  const int t = 1 << sh;
  for (int b = threadIdx.x; b < N / 2; b += ALOHA_THREADS) {
    const int i = ((b >> sh) << (sh + 1)) + (b & (t - 1));
    const int k = tw_index(i);
    const u64 u = condsub(a[i], 2 * q);
    const u64 y = V == 13 ? shoup_mul_sparse<32, 36, 59>(a[i + t], w[k], ws[k])
                          : shoup_mul(a[i + t], w[k], ws[k], q);
    a[i] = u + y;
    a[i + t] = u + 2 * q - y;
  }
}

template <int V>
__global__ void __launch_bounds__(ALOHA_THREADS)
probe_ops_kernel(const u64* __restrict__ x, u64* __restrict__ y, const u64* __restrict__ w,
                 const u64* __restrict__ ws, u64 q, int reps, int sh) {
  extern __shared__ u64 a[];
  const size_t off = (size_t)blockIdx.x * N;
  for (int i = threadIdx.x; i < N; i += ALOHA_THREADS) a[i] = x[off + i];
  __syncthreads();
  for (int r = 0; r < reps; ++r) {
    if constexpr (V == 0 || V == 13 || V == 14) {
      stage_step<V>(a, V == 0 ? sh : 5, w, ws, q);
    } else if constexpr (V == 6) {
      u64 v[PER_THREAD];
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const int i = threadIdx.x + j * ALOHA_THREADS;
        v[j] = a[(i & ~(ROW - 1)) | ((i - 32) & (ROW - 1))];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) a[threadIdx.x + j * ALOHA_THREADS] = v[j];
    } else {
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const int i = threadIdx.x + j * ALOHA_THREADS;
        const int k = tw_index(i);
        a[i] = elem_step<V>(a[i], i, w[k], ws[k], q);
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < N; i += ALOHA_THREADS) y[off + i] = a[i];
}

template <int V>
int launch(const u64* x, u64* y, const u64* w, const u64* ws, u64 q, int nb, int reps,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(probe_ops_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  probe_ops_kernel<V><<<nb, ALOHA_THREADS, SMEM, stream>>>(x, y, w, ws, q, reps, 5);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (nb, 8192) int64; w, ws: the compact forward tables (8192,) of q;
// variant 0 .. 14; reps >= 0.  v12 and v13 take q = q0 only.
extern "C" int aloha_probe_ops(int device, const void* x, void* y, const void* w, const void* ws,
                               u64 q, int variant, int nb, int reps, void* stream) {
  if ((variant == 12 || variant == 13) && q != Q0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const u64* px = (const u64*)x;
  u64* py = (u64*)y;
  const u64* pw = (const u64*)w;
  const u64* pws = (const u64*)ws;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0: return launch<0>(px, py, pw, pws, q, nb, reps, s);
    case 1: return launch<1>(px, py, pw, pws, q, nb, reps, s);
    case 2: return launch<2>(px, py, pw, pws, q, nb, reps, s);
    case 3: return launch<3>(px, py, pw, pws, q, nb, reps, s);
    case 4: return launch<4>(px, py, pw, pws, q, nb, reps, s);
    case 5: return launch<5>(px, py, pw, pws, q, nb, reps, s);
    case 6: return launch<6>(px, py, pw, pws, q, nb, reps, s);
    case 7: return launch<7>(px, py, pw, pws, q, nb, reps, s);
    case 8: return launch<8>(px, py, pw, pws, q, nb, reps, s);
    case 9: return launch<9>(px, py, pw, pws, q, nb, reps, s);
    case 10: return launch<10>(px, py, pw, pws, q, nb, reps, s);
    case 11: return launch<11>(px, py, pw, pws, q, nb, reps, s);
    case 12: return launch<12>(px, py, pw, pws, q, nb, reps, s);
    case 13: return launch<13>(px, py, pw, pws, q, nb, reps, s);
    case 14: return launch<14>(px, py, pw, pws, q, nb, reps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
