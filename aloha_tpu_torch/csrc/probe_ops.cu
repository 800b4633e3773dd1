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
//       128-word row, stage-5 twiddles
//   v1  shoup_mul             v2  __umul64hi(x, ws)     v3  x * w (low 64)
//   v4  (x & 2^32-1) * (x >> 32), the 32x32 -> 64 product of the halves
//   v5  lo*hi, hi+lo on the 32-bit halves (each mod 2^32)
//   v6  cyclic roll by 32 along the 128-word row
//   v7  condsub(x, 4q)
//   v8  x + swap32(x)
//   v9  bit 5 of the index (a runtime bit) ? x : swap32(x)
//   v10 = v2 and v11 = v1 (the u64 forms of the TPU's 16-bit limb variants)
//   v12 shoup_mul with t*q as shift-adds over q0's set bits
//   v13 v0's stage at the compile-time distance 32 with v12's product
//   v14 v0's stage at the compile-time distance 32 with shoup_mul
// Element i is coefficient i: row i >> 7, lane i & 127 of the TPU's
// (64, 128) tile; the twiddles are row 5 of the forward tables,
// w[32 + (i >> 8)] of the compact tables (ntt_torch.twiddles_np).
//
// Layout: csrc/ntt.cu's register owner map of forward pass 1 at n = 8192
// (ntt_regs::Geometry<13>): one CTA of T = 512 threads a polynomial, R = 16
// words a thread in registers for the whole launch.  Register bit b holds
// index bit 5 + b; the thread's bits fill index bits 0-4 (the lane) and
// 9-12 (the warp).  Each register of a warp is 32 consecutive words, so the
// one load and the one store are coalesced.  A repetition is the step on
// the thread's 16 words, as in a register-resident stage of ntt.cu:
//   - v0, v13, v14: the pairs (i, i + 32) are registers r and r ^ 1 of one
//     thread, 8 butterflies a thread.  v0's distance is the kernel's
//     runtime argument sh (the C entry passes 5); a switch uniform across
//     the CTA, once a repetition, picks the body of its register bit
//     (sh = 5 .. 8), where ntt.cu's distances are compile-time constants;
//   - word i's twiddle w[32 + (i >> 8)]: bit 8 is register bit 3 and bits
//     9-12 are the thread's, so a thread loads two (w, ws) pairs, once;
//   - v9 tests bit sh of i, sh the same runtime argument, so that its
//     select is not compiled into a renaming of registers;
//   - v6's roll touches only index bits 5-6, register bits 0-1, so in
//     registers it would be a free permutation.  It goes through shared
//     memory, as an exchange of ntt.cu does: each thread writes word i to
//     slot roll(i), one barrier, reads the slots of its own words, and a
//     second barrier before the next write.  The slot is the index: a
//     warp's 32 words of a register are consecutive on both sides, so every
//     access is free of bank conflicts without a swizzle.
// No other variant touches shared memory or runs a barrier.  Two CTAs an
// SM (at most 64 registers a thread) as in ntt.cu, but for the variants
// whose 64-register build spills (v1, v2, v10-v14: the products) and for
// v0, which does not spill there but runs as v14 does so that v0 - v14
// prices the dispatch alone: these run one CTA an SM with no spill.  Differences of
// the variants' marginals split the cost of a register-resident stage:
// v1 - v7 the Shoup product, v14 a whole CT stage with its twiddles, v0 -
// v14 the dispatch on a runtime distance, v6 one exchange of ntt.cu's kind
// (a shared-memory round trip and two barriers).
//
// Bound on Hopper: integer issue, the step's INT32 instructions over the
// SMs' INT32 lanes (probes/op_probe.OPS); no HBM traffic per repetition.
#include "device_once.cuh"
#include "ntt_regs.cuh"

namespace {

using G = ntt_regs::Geometry<13>;
constexpr int N = 1 << 13;
constexpr int R = G::R;
constexpr int P = 1;  // the owner map of forward pass 1
constexpr int SH = 5;  // the distance 2^5 the C entry passes
constexpr size_t SMEM = sizeof(u64) * N;  // v6's exchange
static_assert(G::T == ALOHA_THREADS && R == 16 && G::regbit(P, 0) == SH &&
                  G::regbit(P, 3) == 8 && G::off(P, 1) == 32,
              "16 words a thread, register bit b at index bit 5 + b");
// q0 = 2^59 + 2^36 + 2^32 + 1, the only modulus of v12 / v13
constexpr u64 Q0 = 0x0800001100000001ull;

// A thread's two row-5 twiddles: registers 0-7 take (w0, ws0), 8-15 (w1, ws1).
struct Twiddles {
  u64 w0, ws0, w1, ws1;
  __device__ __forceinline__ u64 w(int r) const { return r & 8 ? w1 : w0; }
  __device__ __forceinline__ u64 ws(int r) const { return r & 8 ? ws1 : ws0; }
};

// One CT stage at distance 2^(5 + J): the pairs (r, r + 2^J), bit J of r
// clear, each with the twiddle of its top word.
template <int J, bool SPARSE>
__device__ __forceinline__ void stage(u64 (&a)[R], const Twiddles& t, u64 q) {
  constexpr int D = 1 << J;
  const u64 q2 = 2 * q;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r & D) continue;
    const u64 u = condsub(a[r], q2);
    const u64 y = SPARSE ? shoup_mul_sparse<32, 36, 59>(a[r + D], t.w(r), t.ws(r))
                         : shoup_mul(a[r + D], t.w(r), t.ws(r), q);
    a[r] = u + y;
    a[r + D] = u + q2 - y;
  }
}

template <int V>
__device__ __forceinline__ u64 elem_step(u64 x, bool bit, u64 w, u64 ws, u64 q) {
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
    return bit ? x : swap32(x);
  } else {
    static_assert(V == 12, "elementwise variants: 1-5, 7-12");
    return shoup_mul_sparse<32, 36, 59>(x, w, ws);
  }
}

// Register r's word after v6's roll by 32 in its row: index bits 5-6 + 1.
__host__ __device__ constexpr int rolled(int r) { return (r & ~3) | ((r + 1) & 3); }

// One repetition of variant V on a thread's words; base: its index bits.
template <int V>
__device__ __forceinline__ void step(u64 (&a)[R], u64* sm, int base, int sh, const Twiddles& t,
                                     u64 q) {
  if constexpr (V == 0) {
    switch (sh) {
      case 5: stage<0, false>(a, t, q); break;
      case 6: stage<1, false>(a, t, q); break;
      case 7: stage<2, false>(a, t, q); break;
      case 8: stage<3, false>(a, t, q); break;
      default: __trap();
    }
  } else if constexpr (V == 13 || V == 14) {
    stage<0, V == 13>(a, t, q);
  } else if constexpr (V == 6) {
#pragma unroll
    for (int r = 0; r < R; ++r) sm[base | G::off(P, rolled(r))] = a[r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = sm[base | G::off(P, r)];
    __syncthreads();
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool bit = V == 9 && (((base | G::off(P, r)) >> sh) & 1);
      a[r] = elem_step<V>(a[r], bit, t.w(r), t.ws(r), q);
    }
  }
}

// CTAs an SM: 2 (at most 64 registers a thread), 1 where that spills.
constexpr int min_blocks(int V) { return V <= 2 || V >= 10 ? 1 : 2; }

// One CTA a polynomial: one coalesced load into ntt.cu's pass-1 map, reps
// steps in registers, one store.  sh: v0's distance and v9's bit, 5 .. 8.
template <int V>
__global__ void __launch_bounds__(G::T, min_blocks(V))
probe_ops_kernel(const u64* __restrict__ x, u64* __restrict__ y, const u64* __restrict__ w,
                 const u64* __restrict__ ws, u64 q, int reps, int sh) {
  extern __shared__ u64 sm[];  // v6 only
  const int base = G::base(P, threadIdx.x);
  const size_t off = (size_t)blockIdx.x * N + base;
  u64 a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = x[off + G::off(P, r)];
  const int k = 32 + (base >> 8);  // bit 8 of base is clear: register bit 3 adds 1
  const Twiddles t{__ldg(w + k), __ldg(ws + k), __ldg(w + k + 1), __ldg(ws + k + 1)};
  for (int rep = 0; rep < reps; ++rep) step<V>(a, sm, base, sh, t, q);
#pragma unroll
  for (int r = 0; r < R; ++r) y[off + G::off(P, r)] = a[r];
}

template <int V>
int launch(int device, const u64* x, u64* y, const u64* w, const u64* ws, u64 q, int nb,
           int reps, cudaStream_t stream) {
  constexpr size_t smem = V == 6 ? SMEM : 0;
  if constexpr (V == 6) {
    static bool attribute_set[MAX_DEVICES];  // per device: the kernel's shared-memory size
    const cudaError_t err = smem_once(probe_ops_kernel<V>, (int)smem, device, attribute_set);
    if (err != cudaSuccess) return (int)err;
  }
  probe_ops_kernel<V><<<nb, G::T, smem, stream>>>(x, y, w, ws, q, reps, SH);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (nb, 8192) int64, nb >= 1; w, ws: the compact forward tables
// (8192,) of q; variant 0 .. 14; reps >= 0.  v12 and v13 take q = q0 only.
extern "C" int aloha_probe_ops(int device, const void* x, void* y, const void* w, const void* ws,
                               u64 q, int variant, int nb, int reps, void* stream) {
  if ((variant == 12 || variant == 13) && q != Q0) return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= MAX_DEVICES || nb < 1 || reps < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const u64* px = (const u64*)x;
  u64* py = (u64*)y;
  const u64* pw = (const u64*)w;
  const u64* pws = (const u64*)ws;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0: return launch<0>(device, px, py, pw, pws, q, nb, reps, s);
    case 1: return launch<1>(device, px, py, pw, pws, q, nb, reps, s);
    case 2: return launch<2>(device, px, py, pw, pws, q, nb, reps, s);
    case 3: return launch<3>(device, px, py, pw, pws, q, nb, reps, s);
    case 4: return launch<4>(device, px, py, pw, pws, q, nb, reps, s);
    case 5: return launch<5>(device, px, py, pw, pws, q, nb, reps, s);
    case 6: return launch<6>(device, px, py, pw, pws, q, nb, reps, s);
    case 7: return launch<7>(device, px, py, pw, pws, q, nb, reps, s);
    case 8: return launch<8>(device, px, py, pw, pws, q, nb, reps, s);
    case 9: return launch<9>(device, px, py, pw, pws, q, nb, reps, s);
    case 10: return launch<10>(device, px, py, pw, pws, q, nb, reps, s);
    case 11: return launch<11>(device, px, py, pw, pws, q, nb, reps, s);
    case 12: return launch<12>(device, px, py, pw, pws, q, nb, reps, s);
    case 13: return launch<13>(device, px, py, pw, pws, q, nb, reps, s);
    case 14: return launch<14>(device, px, py, pw, pws, q, nb, reps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
