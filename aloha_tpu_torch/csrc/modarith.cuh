// In-kernel modular arithmetic on native u64.
//
// Replaces the TPU kernels' u32-pair helpers: ntt_pallas._shoup_mul /
// _condsub / _halfq and the CT/GS butterflies (aloha_tpu/ops/
// ntt_pallas.py:95-173), ntt_stream._shoup_mul_limb (ntt_stream.py:188) and
// rns_jax.*64.  Hopper has 64-bit integer lanes and __umul64hi, so a
// 60x64-bit product is two multiplies instead of the TPU's 16-bit limb
// columns.
//
// Moduli are below 2^60, so the Harvey window [0, 4q) of the forward
// transform fits a u64 with room to spare.
#pragma once

#include <cuda_runtime.h>

typedef unsigned long long u64;

// Threads per CTA of every kernel: an 8192-point transform has 4096
// butterflies per stage, 8 per thread.
#define ALOHA_THREADS 512

__device__ __forceinline__ u64 condsub(u64 x, u64 q) { return x >= q ? x - q : x; }

// a, b < q
__device__ __forceinline__ u64 addmod(u64 a, u64 b, u64 q) { return condsub(a + b, q); }

// a, b < q
__device__ __forceinline__ u64 submod(u64 a, u64 b, u64 q) { return a >= b ? a - b : a + q - b; }

// a/2 mod q for a < q (reference: src/vp/vxu/halfred.sv:21-27)
__device__ __forceinline__ u64 halfmod(u64 a, u64 q) {
  return (a >> 1) + ((a & 1ull) ? (q + 1) >> 1 : 0ull);
}

// Shoup multiply: x*w mod q in [0, 2q) for any x, with w < q and
// ws = floor(w 2^64 / q).
__device__ __forceinline__ u64 shoup_mul(u64 x, u64 w, u64 ws, u64 q) {
  u64 t = __umul64hi(x, ws);
  return x * w - t * q;
}

// Harvey CT butterfly: u, v < 4q -> u' + w v, u' + 2q - w v (both < 4q).
__device__ __forceinline__ void ct(u64& u, u64& v, u64 w, u64 ws, u64 q, u64 q2) {
  const u64 x = condsub(u, q2);
  const u64 y = shoup_mul(v, w, ws, q);
  u = x + y;
  v = x + q2 - y;
}

// GS butterfly with halving: u, v < q -> (u + v)/2, (u - v) w / 2 (both < q).
__device__ __forceinline__ void gs(u64& u, u64& v, u64 w, u64 ws, u64 q) {
  const u64 a = u, b = v;
  u = halfmod(addmod(a, b, q), q);
  v = halfmod(condsub(shoup_mul(a + q - b, w, ws, q), q), q);
}

// Low 64 bits of t * (1 + 2^S1 + 2^S2 + 2^S3) as shift-adds: t*q for a sparse
// modulus with those four set bits (q0 = 2^59 + 2^36 + 2^32 + 1: <32, 36, 59>).
template <int S1, int S2, int S3>
__device__ __forceinline__ u64 mul_sparse_lo(u64 t) {
  return t + (t << S1) + (t << S2) + (t << S3);
}

// shoup_mul with t*q formed by mul_sparse_lo: the same word for that q.
template <int S1, int S2, int S3>
__device__ __forceinline__ u64 shoup_mul_sparse(u64 x, u64 w, u64 ws) {
  return x * w - mul_sparse_lo<S1, S2, S3>(__umul64hi(x, ws));
}

// The two 32-bit halves of a word exchanged.
__device__ __forceinline__ u64 swap32(u64 x) { return (x << 32) | (x >> 32); }

// The 32-bit halves of a and b added separately, each wrapping mod 2^32
// (the TPU's u32 lo/hi planes added with no carry between them).
__device__ __forceinline__ u64 add32x2(u64 a, u64 b) {
  const unsigned lo = (unsigned)a + (unsigned)b;
  const unsigned hi = (unsigned)(a >> 32) + (unsigned)(b >> 32);
  return ((u64)hi << 32) | lo;
}

// The RTL Barrett chain (reference: src/vp/vxu/modmul.sv:145-232) for
// inputs a, b < q < 2^w; iq = floor(2^(2w+1) / q).  Equal to exact a*b mod q.
__device__ __forceinline__ u64 barrett(u64 a, u64 b, u64 q, u64 iq, int w) {
  u64 lo = a * b, hi = __umul64hi(a, b);
  u64 ps = (lo >> (w - 2)) | (hi << (64 - (w - 2)));
  u64 mlo = ps * iq, mhi = __umul64hi(ps, iq);
  u64 ms = (mlo >> (w + 3)) | (mhi << (64 - (w + 3)));
  u64 mask = (1ull << (w + 1)) - 1;
  u64 diff = (((lo & mask) | (1ull << (w + 1))) - ((ms * q) & mask)) & mask;
  return condsub(diff, q);
}
