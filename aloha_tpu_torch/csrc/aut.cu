// Coefficient-domain automorphism X -> X^e of nb polynomials under one modulus.
//
// Replaces the TPU kernel of tools/probe_aut_kernel.py:102 (`kernel`, the
// accelerator's `vaut` on one N = 8192 polynomial).  Mosaic has no gather,
// so the TPU kernel decomposes the permutation into one-hot f32 matmuls over
// u16 limb planes and conditional sublane rolls.  Hopper gathers from shared
// memory directly: with einv = e^-1 mod 2n (e odd, from the host) and
// t = d * einv mod 2n, output coefficient d is
//     src = t mod n,   y[d] = t >= n ? q - x[src] : x[src]
// which is the map of ntt_torch._aut_maps with no tables.  The sign write is
// the RTL's literal q - x with no reduction (0 -> q, q -> 0; reference:
// src/vp/vxu/vxu_lane.sv:594-598).
//
// Shape: one CTA per polynomial; the row is loaded coalesced into dynamic
// shared memory (64 KiB at n = 8192, above the 48 KiB default: the entry
// point raises the limit), then each thread writes its outputs coalesced.
// Consecutive d read addresses einv apart (einv odd), so a warp's gather
// touches every bank pair once: no conflicts beyond the two wavefronts of
// a 64-bit access.
//
// Bound on Hopper: bytes.  Each word is read once and written once, 16
// bytes per coefficient over HBM; at the ISA's nb = 1 the launch is far
// below the per-call floor.
#include "modarith.cuh"

namespace {

__global__ void __launch_bounds__(ALOHA_THREADS)
aut_kernel(const u64* __restrict__ x, u64* __restrict__ y, u64 q, unsigned einv, int logn) {
  extern __shared__ u64 sh[];
  const unsigned n = 1u << logn;
  const size_t off = (size_t)blockIdx.x << logn;
  for (unsigned i = threadIdx.x; i < n; i += blockDim.x) sh[i] = x[off + i];
  __syncthreads();
  const unsigned wrap = 2 * n - 1;
  for (unsigned d = threadIdx.x; d < n; d += blockDim.x) {
    const unsigned t = (d * einv) & wrap;  // d < 2^13, einv < 2^14: no overflow
    const u64 v = sh[t & (n - 1)];
    y[off + d] = t >= n ? q - v : v;
  }
}

}  // namespace

// x, y: (nb, 2^logn) int64; q: the modulus; einv: e^-1 mod 2^(logn+1).
extern "C" int aloha_aut(int device, const void* x, void* y, u64 q, int einv, int nb, int logn,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(u64) << logn;
  err = cudaFuncSetAttribute(aut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (1 << logn) < ALOHA_THREADS ? (1 << logn) : ALOHA_THREADS;
  aut_kernel<<<nb, threads, smem, (cudaStream_t)stream>>>((const u64*)x, (u64*)y, q,
                                                          (unsigned)einv, logn);
  return (int)cudaGetLastError();
}
