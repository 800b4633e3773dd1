// Batched negacyclic NTT/INTT under M moduli in one launch.
//
// Replaces the TPU kernels ntt_stream._stream_body / _stream_body_multi
// (aloha_tpu/ops/ntt_stream.py:630/662, launched at :721 and :814): the
// single-modulus form is M = 1.  With M = 1 and the caller's tables it also
// replaces ntt_stream.ntt_planes_with_tables (:754, launched at :775), the
// per-shard body of the coefficient-sharded NTT: the tables are then a
// shard's compact slice of a larger ring's (ops/ntt_stream.py
// transform_with_tables), read exactly as the whole ring's are.
//
// Shape: one CTA per (polynomial, modulus m); grid (nb, M).  The whole
// polynomial (n u64, 64 KiB at n = 8192) sits in dynamic shared memory for
// all 13 stages; twiddles and their Shoup companions are read from global
// memory, where L2 holds the few tables of a launch.
//
// Bound on Hopper: each stage is 4096 shared-memory butterflies of two
// 64-bit multiplies (a 64-bit multiply is several 32-bit IMAD issues), so
// the kernel is bound by integer issue and shared-memory bandwidth, not by
// HBM (16 bytes per coefficient in and out).  One 64 KiB CTA per polynomial
// keeps three CTAs resident per SM to hide the __syncthreads between stages.
#include "modarith.cuh"

namespace {

__global__ void __launch_bounds__(ALOHA_THREADS)
ntt_kernel(const u64* __restrict__ x, u64* __restrict__ y, const u64* __restrict__ w,
           const u64* __restrict__ ws, const u64* __restrict__ qs, int nb, int logn,
           int inverse) {
  extern __shared__ u64 sh[];
  const int n = 1 << logn;
  const int m = blockIdx.y;
  const u64 q = qs[m];
  const size_t off = ((size_t)m * nb + blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    sh[i] = inverse ? condsub(x[off + i], q) : x[off + i];
  __syncthreads();
  if (inverse)
    intt_smem(sh, logn, w + (size_t)m * n, ws + (size_t)m * n, q);
  else
    ntt_smem(sh, logn, w + (size_t)m * n, ws + (size_t)m * n, q);
  for (int i = threadIdx.x; i < n; i += blockDim.x) y[off + i] = sh[i];
}

}  // namespace

// x, y: (M, nb, 2^logn) int64; w, ws: (M, 2^logn) tables; qs: (M,).
extern "C" int aloha_ntt(int device, const void* x, void* y, const void* w, const void* ws,
                         const void* qs, int M, int nb, int logn, int inverse, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(u64) << logn;
  err = cudaFuncSetAttribute(ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb, M);
  ntt_kernel<<<grid, ALOHA_THREADS, smem, (cudaStream_t)stream>>>(
      (const u64*)x, (u64*)y, (const u64*)w, (const u64*)ws, (const u64*)qs, nb, logn, inverse);
  return (int)cudaGetLastError();
}
