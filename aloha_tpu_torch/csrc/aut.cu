// Coefficient-domain automorphism X -> X^e of nb polynomials under one modulus.
//
// Replaces the TPU kernel of tools/probe_aut_kernel.py:102 (`kernel`, the
// accelerator's `vaut` on one N = 8192 polynomial).  Mosaic has no gather,
// so the TPU kernel decomposes the permutation into one-hot f32 matmuls over
// u16 limb planes and conditional sublane rolls.  Hopper gathers directly:
// with einv = e^-1 mod 2n (e odd, from the host) and t = d * einv mod 2n,
// output coefficient d is
//     src = t mod n,   y[d] = t >= n ? q - x[src] : x[src]
// which is the map of ntt_torch._aut_maps with no tables.  The sign write is
// the RTL's literal q - x with no reduction (0 -> q, q -> 0; reference:
// src/vp/vxu/vxu_lane.sv:594-598).
//
// Shape: output-parallel, straight from global memory.  Each thread owns
// the two consecutive outputs 2p, 2p + 1 of the flat pair index p over all
// rows, gathers their sources with two 8-byte loads from its own row, and
// writes both with one 16-byte store; THREADS threads a CTA and as many CTAs
// as the nb n / 2 pairs need (32 at the ISA's nb = 1, n = 8192).  No shared
// memory, no barrier, no attribute to set.  Input rows lie `stride` words
// apart (>= n), so a caller's strided view of every other row (he_torch's
// (b, a) pairs) needs no copy; the output is contiguous.
//
// Bound on Hopper: bytes, 16 a coefficient in and out; at the ISA's nb = 1
// (64 KiB each way) the launch's latency, not the bytes, sets the time, and
// the gather spreads that latency over many SMs.  One CTA a polynomial,
// staging the row in shared memory behind a barrier, leaves one SM to do
// it all and was slower at every nb measured (PERF.md §6, row 9).
// Consecutive outputs read words einv apart, so a warp's loads touch 32
// sectors for 256 bytes: four times the bytes between L2 and the SMs, none
// more from HBM while a row fits in L2 (the main path's row was just
// written by the previous instruction or transform).
#include "modarith.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
aut_kernel(const u64* __restrict__ x, u64* __restrict__ y, u64 q, unsigned einv, int logn,
           long long stride, long long pairs) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= pairs) return;
  const unsigned n = 1u << logn, wrap = 2 * n - 1;
  const long long row = p >> (logn - 1);
  const unsigned d = 2 * ((unsigned)p & (n / 2 - 1));
  const unsigned t0 = (d * einv) & wrap;  // d < 2^13, einv < 2^14: no overflow
  const unsigned t1 = (t0 + einv) & wrap;
  const u64* src = x + row * stride;
  const u64 v0 = src[t0 & (n - 1)];
  const u64 v1 = src[t1 & (n - 1)];
  ulonglong2 out;
  out.x = t0 >= n ? q - v0 : v0;
  out.y = t1 >= n ? q - v1 : v1;
  reinterpret_cast<ulonglong2*>(y + (row << logn))[d / 2] = out;
}

}  // namespace

// x: nb rows of 2^logn int64 words, row r at x + r * stride (stride >= 2^logn,
// 7 <= logn <= 13); y: (nb, 2^logn) int64, contiguous and 16-byte aligned;
// q: the modulus; einv: e^-1 mod 2^(logn+1).
extern "C" int aloha_aut(int device, const void* x, void* y, u64 q, int einv, int nb, int logn,
                         long long stride, void* stream) {
  if (logn < 7 || logn > 13 || nb < 1 || stride < (1LL << logn) || ((size_t)y & 15))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)nb << (logn - 1);
  const unsigned ctas = (unsigned)((pairs + THREADS - 1) / THREADS);
  aut_kernel<<<ctas, THREADS, 0, (cudaStream_t)stream>>>((const u64*)x, (u64*)y, q,
                                                         (unsigned)einv, logn, stride, pairs);
  return (int)cudaGetLastError();
}
