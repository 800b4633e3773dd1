// Negacyclic NTT/INTT of one modulus, one polynomial per CTA, exchanging
// through registers, warp shuffles and one shared-memory transpose.
//
// Replaces the TPU grid kernel ntt_pallas._call (aloha_tpu/ops/
// ntt_pallas.py:378; bodies _ntt_kernel_body :248 and _intt_kernel_body
// :316).  There a polynomial is a (rows, 128) tile, and the butterfly
// partner i ^ t of coefficient i sits t/128 sublane rows away (a static
// reshape) or t lanes away (a roll + select).  Here the same split follows
// Hopper's exchange hierarchy: registers first, then warp shuffles, and
// shared memory only where the partner lives in another warp.
//
// Mapping, for n = 2^logn (128 <= n <= 8192), T = n/16 threads of 16
// coefficients each, held in registers:
//   layout A: thread j owns i = j + T k, k = 0..15 (coalesced loads).  A
//             stage of distance t >= T pairs registers k and k ^ (t/T).
//   layout B: thread j owns i = 16 j + r, r = 0..15.  A stage of distance
//             t < 16 pairs registers r and r ^ t; one of 16 <= t < T pairs
//             thread j with thread j ^ (t/16), the same register, through
//             __shfl_xor_sync (t/16 < T/16 <= 32: always inside the warp).
//   A <-> B is one transpose through shared memory (n words, XOR-swizzled
//   so that both sides are free of bank conflicts).
// Forward (Cooley-Tukey, natural order in with entries < 4q, bit-reversed
// order out, Harvey-lazy [0, 4q) between stages, Shoup twiddles):
//   A: t = n/2 .. n/16; transpose; B by shuffle: t = n/32 .. 16; B in
//   registers: t = min(8, n/32) .. 1; condsub 2q, condsub q.
// Inverse (Gentleman-Sande, bit-reversed in with entries < 2q, natural
// out, halving at every stage, canonical between stages): the mirror.
// At n = 8192 that is 4 + 5 + 4 stages and one transpose where csrc/ntt.cu
// makes 13 shared-memory passes with a __syncthreads after each.
//
// In a shuffle stage each thread sends only what its partner needs.
// Forward: the top thread (bit t/16 of j clear) sends u' = condsub(u, 2q),
// the bottom one w v; each Shoup product is made once per pair.  Inverse:
// both send their word; the top makes (u + v)/2, the bottom (u - v) w / 2.
//
// Bound on the H100: 64-bit integer issue (two 64-bit multiplies per
// butterfly), not HBM (16 bytes per coefficient in and out).  The compact
// twiddle tables (ntt_torch.tables) are read through L1/L2: a layout-A
// stage reads one twiddle per register for the whole CTA.
#include "modarith.cuh"

namespace {

// Shared-memory slot of coefficient i: the low 4 bits XOR the next 4, so
// that 16 threads reading 16 j + r (fixed r) and 16 threads writing 16
// consecutive i hit 16 distinct 8-byte bank pairs.
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 15); }

template <int LOGN>
__global__ void __launch_bounds__((1 << LOGN) / 16)
ntt_grid_fwd(const u64* __restrict__ x, u64* __restrict__ y, const u64* __restrict__ w,
             const u64* __restrict__ ws, u64 q) {
  constexpr int N = 1 << LOGN, LOGT = LOGN - 4, T = 1 << LOGT;
  extern __shared__ u64 sh[];
  const int j = threadIdx.x;
  const u64 q2 = 2 * q;
  const u64* src = x + (size_t)blockIdx.x * N;
  u64 a[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) a[k] = src[j + T * k];
  // layout A, s = 0..3: t = T 2^(3-s), registers k and k + (8 >> s); the
  // group i >> (logn - s) = k >> (4 - s) is the same in every thread
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int d = 8 >> s;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k & d) continue;
      const int ti = (1 << s) + (k >> (4 - s));
      ct(a[k], a[k + d], __ldg(w + ti), __ldg(ws + ti), q, q2);
    }
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) sh[swz(j + T * k)] = a[k];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 16; ++r) a[r] = sh[swz(16 * j + r)];
  // layout B by shuffle, s = 4..LOGT-1: t = 2^(LOGN-1-s) in [16, T/2],
  // partner lane j ^ (t/16); group (16 j + r) >> (LOGN - s) = j >> (LOGN-4-s)
#pragma unroll
  for (int s = 4; s < LOGT; ++s) {
    const int m = 1 << (LOGN - 5 - s);
    const bool top = !(j & m);
    const int ti = (1 << s) + (j >> (LOGN - 4 - s));
    const u64 tw = __ldg(w + ti), tws = __ldg(ws + ti);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const u64 send = top ? condsub(a[r], q2) : shoup_mul(a[r], tw, tws, q);
      const u64 got = __shfl_xor_sync(0xffffffffu, send, m);
      a[r] = top ? send + got : got + q2 - send;
    }
  }
  // layout B in registers: t = 2^(LOGN-1-s) < 16 (and s >= 4)
#pragma unroll
  for (int s = (LOGT > 4 ? LOGT : 4); s < LOGN; ++s) {
    const int d = 1 << (LOGN - 1 - s);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (r & d) continue;
      const int ti = (1 << s) + ((16 * j + r) >> (LOGN - s));
      ct(a[r], a[r + d], __ldg(w + ti), __ldg(ws + ti), q, q2);
    }
  }
  ulonglong2* dst = reinterpret_cast<ulonglong2*>(y + (size_t)blockIdx.x * N + 16 * j);
#pragma unroll
  for (int r = 0; r < 16; r += 2)
    dst[r / 2] = make_ulonglong2(condsub(condsub(a[r], q2), q),
                                 condsub(condsub(a[r + 1], q2), q));
}

template <int LOGN>
__global__ void __launch_bounds__((1 << LOGN) / 16)
ntt_grid_inv(const u64* __restrict__ x, u64* __restrict__ y, const u64* __restrict__ w,
             const u64* __restrict__ ws, u64 q) {
  constexpr int N = 1 << LOGN, LOGT = LOGN - 4, T = 1 << LOGT;
  extern __shared__ u64 sh[];
  const int j = threadIdx.x;
  u64 a[16];
  const ulonglong2* src =
      reinterpret_cast<const ulonglong2*>(x + (size_t)blockIdx.x * N + 16 * j);
#pragma unroll
  for (int r = 0; r < 16; r += 2) {
    const ulonglong2 v = src[r / 2];
    a[r] = condsub(v.x, q);
    a[r + 1] = condsub(v.y, q);
  }
  // layout B in registers, s = 0..min(4, LOGT)-1: t = 2^s, group
  // (16 j + r) >> (s + 1), twiddle w[n/2^(s+1) + group]
#pragma unroll
  for (int s = 0; s < (LOGT < 4 ? LOGT : 4); ++s) {
    const int d = 1 << s;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (r & d) continue;
      const int ti = (N >> (s + 1)) + ((16 * j + r) >> (s + 1));
      gs(a[r], a[r + d], __ldg(w + ti), __ldg(ws + ti), q);
    }
  }
  // layout B by shuffle, s = 4..LOGT-1: t = 2^s, partner lane j ^ (t/16),
  // group j >> (s - 3)
#pragma unroll
  for (int s = 4; s < LOGT; ++s) {
    const int m = 1 << (s - 4);
    const bool top = !(j & m);
    const int ti = (N >> (s + 1)) + (j >> (s - 3));
    const u64 tw = __ldg(w + ti), tws = __ldg(ws + ti);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const u64 got = __shfl_xor_sync(0xffffffffu, a[r], m);
      a[r] = top ? halfmod(addmod(a[r], got, q), q)
                 : halfmod(condsub(shoup_mul(got + q - a[r], tw, tws, q), q), q);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) sh[swz(16 * j + r)] = a[r];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 16; ++k) a[k] = sh[swz(j + T * k)];
  // layout A, s = LOGT..LOGN-1: t = 2^s >= T, registers k and k + t/T;
  // group (j + T k) >> (s + 1) = k >> (s + 1 - LOGT)
#pragma unroll
  for (int s = LOGT; s < LOGN; ++s) {
    const int d = 1 << (s - LOGT);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k & d) continue;
      const int ti = (N >> (s + 1)) + (k >> (s + 1 - LOGT));
      gs(a[k], a[k + d], __ldg(w + ti), __ldg(ws + ti), q);
    }
  }
  u64* dst = y + (size_t)blockIdx.x * N;
#pragma unroll
  for (int k = 0; k < 16; ++k) dst[j + T * k] = condsub(a[k], q);
}

template <int LOGN>
cudaError_t launch(const u64* x, u64* y, const u64* w, const u64* ws, u64 q, int nb,
                   int inverse, cudaStream_t stream) {
  auto kernel = inverse ? ntt_grid_inv<LOGN> : ntt_grid_fwd<LOGN>;
  const int smem = (int)(sizeof(u64) << LOGN);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nb, (1 << LOGN) / 16, smem, stream>>>(x, y, w, ws, q);
  return cudaGetLastError();
}

}  // namespace

// x, y: (nb, 2^logn) int64, 7 <= logn <= 13, both 16-byte aligned; w, ws:
// the (2^logn,) compact tables of q (psi forward, psi^-1 inverse).
extern "C" int aloha_ntt_grid(int device, const void* x, void* y, const void* w,
                              const void* ws, unsigned long long q, int nb, int logn,
                              int inverse, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const u64* xx = (const u64*)x;
  u64* yy = (u64*)y;
  const u64 *ww = (const u64*)w, *wws = (const u64*)ws;
  cudaStream_t st = (cudaStream_t)stream;
  switch (logn) {
    case 7: return (int)launch<7>(xx, yy, ww, wws, q, nb, inverse, st);
    case 8: return (int)launch<8>(xx, yy, ww, wws, q, nb, inverse, st);
    case 9: return (int)launch<9>(xx, yy, ww, wws, q, nb, inverse, st);
    case 10: return (int)launch<10>(xx, yy, ww, wws, q, nb, inverse, st);
    case 11: return (int)launch<11>(xx, yy, ww, wws, q, nb, inverse, st);
    case 12: return (int)launch<12>(xx, yy, ww, wws, q, nb, inverse, st);
    case 13: return (int)launch<13>(xx, yy, ww, wws, q, nb, inverse, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
