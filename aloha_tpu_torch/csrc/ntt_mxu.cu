// 4-step negacyclic NTT/INTT as exact int8 tensor-core products; k
// data-dependent transforms per launch.  The device code of its steps is in
// csrc/mxu_core.cuh, shared with the cost probes of csrc/probe_mxu.cu.
//
// Replaces the TPU kernels ntt_mxu._mxu_call (aloha_tpu/ops/ntt_mxu.py:653,
// via ntt_planes/intt_planes: k = 1) and ntt_mxu.ntt_chain_planes (:860,
// bodies _chain_body :701 and _chain_ways_body :742: k > 1).  It computes
// what aloha_tpu_torch/ops/ntt_mxu.py's transform_plain computes; the
// tables, their fragment order and the arithmetic are explained there.
//
// With R = n / 128 and the polynomial as an (R x 128) matrix, a forward
// transform is
//   split   8 biased digit planes (byte ^ 0x80 read as int8) of the data
//   rows    8 int32 accumulators e_j = A_j (R x 8R) . S (8R x 128)
//   fold    V = sum_j 2^(8j) (e_j + 2^b) + c_row < 2^82, folded once
//           through 2^59 = -(q - 2^59) (mod q) into a u64 W
//   twiddle Shoup multiply by D[i][l] -> [0, 2q)
//   split, lanes  e_j = S' (R x 1024) . T_j (1024 x 128), fold with c_col
//   final   one more sparse fold and a conditional subtract -> [0, q)
// and the inverse runs lanes -> twiddle -> rows.  Between the transforms of
// a chain the words stay in the fold's lazy window W < 20q + 2^59 (any u64
// is a valid input to the split); only the last transform folds to [0, q).
//
// Shape: one CTA of 8 warps per (polynomial, modulus); grid (nb, M).  The
// polynomial's n u64 words (64 KiB at n = 8192) stay in dynamic shared
// memory for all k transforms, beside one buffer for its 8 digit planes
// (n bytes each, rows padded by 16 bytes so that fragment loads spread over
// the banks: 80 KiB at n = 8192).  The digit products are
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32: every sum is at most K 2^14 <=
// 2^24 in magnitude (K = 8R or 1024), so plain int32 accumulation is exact.
// The data side of each product is read from shared memory, the table side
// (prepared on the host in per-lane fragment order, so a warp reads 512 or
// 256 contiguous bytes) from global memory, where L2 holds it.  The 8
// accumulators of an output tile are combined into a u64 residue in
// registers, in the epilogue of the product: the full (64 x 128) x 8 int32
// accumulator set would be 256 KiB, the whole register file of an SM.
//
// Bound on Hopper (an estimate, to check on the card): per direction and
// modulus the tables hold 1.25 MiB of int8 (A 256 KiB, T 1 MiB).  A warp
// reuses each table fragment over 2 output tiles, so one transform pulls
// 4 MiB of table through L2 for about 1.0e8 int8 MACs (33.6 M in the rows,
// 67.1 M in the lanes; 24,576 mma.sync), and the CTA's 144 KiB of shared
// memory leaves one CTA per SM.  So the kernel is bound by L2 table traffic
// and mma.sync issue latency, not by HBM (16 bytes per coefficient in and
// out).  Sharing each table fragment across several polynomials of a CTA is
// the later fix.
#include "mxu_core.cuh"

namespace {

__global__ void __launch_bounds__(MXU_THREADS, 1)
ntt_mxu_kernel(const u64* __restrict__ x, u64* __restrict__ y, const uint4* __restrict__ af,
               const uint2* __restrict__ tf, const u64* __restrict__ tw,
               const u64* __restrict__ tws, const u64* __restrict__ crow,
               const u64* __restrict__ ccol, const u64* __restrict__ qs, int nb, int logn, int k,
               int inverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 1 << logn, R = n / LANES, m = blockIdx.y;
  u64* sh = (u64*)smem;
  unsigned char* dig = smem + (size_t)n * sizeof(u64);
  const u64 q = qs[m], delta = q - (1ull << 59);
  af += (size_t)m * (NDIG * R * NDIG * R / 16);
  tf += (size_t)m * (NDIG * NDIG * LANES * LANES / 8);
  tw += (size_t)m * n;
  tws += (size_t)m * n;
  crow += (size_t)m * R;
  ccol += (size_t)m * LANES;
  const size_t off = ((size_t)m * nb + blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += MXU_THREADS) sh[i] = x[off + i];
  __syncthreads();
  for (int it = 0; it < k; ++it) {
    const bool fin = it == k - 1;
    if (!inverse) {
      split_rows(sh, dig, R);
      __syncthreads();
      row_step<true>(dig, sh, R, af, crow, tw, tws, fin, q, delta);
      __syncthreads();
      split_lanes(sh, dig, R);
      __syncthreads();
      lane_step<false>(dig, sh, R, tf, ccol, tw, tws, fin, q, delta);
      __syncthreads();
    } else {
      split_lanes(sh, dig, R);
      __syncthreads();
      lane_step<true>(dig, sh, R, tf, ccol, tw, tws, fin, q, delta);
      __syncthreads();
      split_rows(sh, dig, R);
      __syncthreads();
      row_step<false>(dig, sh, R, af, crow, tw, tws, fin, q, delta);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += MXU_THREADS) y[off + i] = sh[i];
}

}  // namespace

// x, y: (M, nb, 2^logn) int64; af: (M, 8 * R * 8R) int8 and tf: (M, 8 * 1024 *
// 128) int8 in fragment order; tw, tws: (M, 2^logn); crow: (M, R); ccol:
// (M, 128); qs: (M,).  R = 2^logn / 128 must be a multiple of 32.
extern "C" int aloha_ntt_mxu(int device, const void* x, void* y, const void* af, const void* tf,
                             const void* tw, const void* tws, const void* crow,
                             const void* ccol, const void* qs, int M, int nb, int logn, int k,
                             int inverse, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = mxu_smem_bytes(logn);
  err = cudaFuncSetAttribute(ntt_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb, M);
  ntt_mxu_kernel<<<grid, MXU_THREADS, smem, (cudaStream_t)stream>>>(
      (const u64*)x, (u64*)y, (const uint4*)af, (const uint2*)tf, (const u64*)tw,
      (const u64*)tws, (const u64*)crow, (const u64*)ccol, (const u64*)qs, nb, logn, k, inverse);
  return (int)cudaGetLastError();
}
