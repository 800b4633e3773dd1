// The fused hybrid key-switch pair: ks_head and ks_tail.
//
// Replaces the TPU kernels ks_kernel._head_body and ks_kernel._tail_body
// (aloha_tpu/ops/ks_kernel.py:153/229, launched at :478 and :568).  What
// they compute is the reference's 122-instruction keyswitch program
// (sim/vp/isram_file_generator/keyswitch.mem) with the a-part handled
// outside, as a gather in the NTT domain.
//
// Bound on Hopper: both kernels are transform kernels (ks_head runs an
// INTT and an NTT per CTA, ks_tail one INTT and L NTTs) and so bound by
// 64-bit integer issue and shared memory like csrc/ntt.cu; the key stream
// of ks_tail (2L(L+1) polys, 1.5 MiB at n = 8192, L = 2) is read once per
// output part from HBM/L2.  The design keeps every intermediate of a
// ciphertext in shared memory: nothing but inputs and outputs touches HBM.
#include "modarith.cuh"

namespace {

// Registers per thread for the automorphism's scatter: n / ALOHA_THREADS.
#define KS_MAX_PER 16

// One CTA per (ciphertext c, output modulus mm, digit j); grid (nb, L+1, L).
// b: (L, nb, n) canonical NTT-domain b-parts.  out: (L+1, nb, L, n).
// INTT of b_j under q_j -> X -> X^e (e = 1 skips it: the hoisted head) ->
// raise the digit to q_mm -> forward NTT under q_mm.
__global__ void __launch_bounds__(ALOHA_THREADS)
ks_head_kernel(const u64* __restrict__ b, u64* __restrict__ out, const u64* __restrict__ fw,
               const u64* __restrict__ fws, const u64* __restrict__ iw,
               const u64* __restrict__ iws, const u64* __restrict__ qs, int L, int nb,
               int logn, int e) {
  extern __shared__ u64 sh[];
  const int n = 1 << logn;
  const int c = blockIdx.x, mm = blockIdx.y, j = blockIdx.z;
  const u64 qj = qs[j], qm = qs[mm];
  const u64* src = b + ((size_t)j * nb + c) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sh[i] = condsub(src[i], qj);
  __syncthreads();
  intt_smem(sh, logn, iw + (size_t)j * n, iws + (size_t)j * n, qj);
  // Automorphism, then the raise.  Coefficient i goes to (i e mod 2n)
  // folded into [0, n), negated as the literal q_j - x (0 becomes q_j,
  // reference: src/vp/vxu/vxu_lane.sv:594-598).  The digit x <= q_j < 2 q_mm,
  // so one conditional subtract is both the JAX raise rules: lazy_reduce
  // when q_mm > q_j and modred (exact x mod q_mm) otherwise.
  u64 v[KS_MAX_PER];
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[cnt++] = sh[i];
  __syncthreads();
  cnt = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned int jj = ((unsigned int)i * (unsigned int)e) & (2u * n - 1);
    const u64 x = jj >= (unsigned int)n ? qj - v[cnt] : v[cnt];
    sh[jj & (n - 1)] = condsub(x, qm);
    ++cnt;
  }
  __syncthreads();
  ntt_smem(sh, logn, fw + (size_t)mm * n, fws + (size_t)mm * n, qm);
  u64* dst = out + (((size_t)mm * nb + c) * L + j) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = sh[i];
}

// Inner product of the raised digits with the key under modulus m at
// coefficient i: sum_j nd[m, d, j, i] * key[2L m + 2j + part, i] mod q.
// Prepared keys (kshoup != nullptr) use Shoup multiplies, others the RTL
// Barrett chain; both are exact, so the words agree.
__device__ __forceinline__ u64 inner(const u64* __restrict__ nd, const u64* __restrict__ key,
                                     const u64* __restrict__ kshoup, int m, int part, int d,
                                     int i, int L, int nb_in, int n, u64 q, u64 iq, int w) {
  u64 acc = 0;
  for (int j = 0; j < L; ++j) {
    const u64 x = nd[(((size_t)m * nb_in + d) * L + j) * n + i];
    const size_t p = (size_t)(2 * L * m + 2 * j + part) * n + i;
    const u64 t = kshoup ? condsub(shoup_mul(x, key[p], kshoup[p], q), q)
                         : barrett(condsub(x, q), condsub(key[p], q), q, iq, w);
    acc = addmod(acc, t, q);
  }
  return acc;
}

// One CTA per (output ciphertext c, part); grid (nb_out, 2).
// nd: (L+1, nb_in, L, n) raised digits; rider: (L, nb_in, n) NTT-domain
// a-parts; key, kshoup: (K, 2L(L+1), n); out: (L, nb_out, 2, n).
// Ciphertext c reads data block d = c % nb_in and key block c / nper
// (single key: nper = nb_in; batched keys: nb_in / K; shared inputs:
// nb_in with nb_out = K nb_in).
// P-residue inner product -> INTT under P -> + (P-1)/2 mod P; then for each
// limb m: - (P-1)/2 mod q_m -> NTT under q_m -> (c_m - corr) P^-1 mod q_m,
// plus the rider on part 0.
__global__ void __launch_bounds__(ALOHA_THREADS)
ks_tail_kernel(const u64* __restrict__ nd, const u64* __restrict__ rider,
               const u64* __restrict__ key, const u64* __restrict__ kshoup,
               u64* __restrict__ out, const u64* __restrict__ fw, const u64* __restrict__ fws,
               const u64* __restrict__ iw, const u64* __restrict__ iws,
               const u64* __restrict__ qs, const u64* __restrict__ iqs,
               const u64* __restrict__ pinv, int L, int nb_in, int nb_out, int nper, int logn,
               int w) {
  extern __shared__ u64 sh[];
  const int n = 1 << logn;
  const int c = blockIdx.x, part = blockIdx.y;
  const int d = c % nb_in;
  const size_t kofs = (size_t)(c / nper) * (2 * L * (L + 1)) * n;
  key += kofs;
  if (kshoup) kshoup += kofs;
  u64* A = sh;      // the centred P-part, kept across limbs
  u64* B = sh + n;  // one limb's correction
  const u64 P = qs[L];
  const u64 half = (P - 1) / 2;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    A[i] = inner(nd, key, kshoup, L, part, d, i, L, nb_in, n, P, iqs[L], w);
  __syncthreads();
  intt_smem(A, logn, iw + (size_t)L * n, iws + (size_t)L * n, P);
  for (int i = threadIdx.x; i < n; i += blockDim.x) A[i] = addmod(A[i], half, P);
  __syncthreads();
  for (int m = 0; m < L; ++m) {
    const u64 q = qs[m];
    const u64 hq = condsub(half, q);
    for (int i = threadIdx.x; i < n; i += blockDim.x) B[i] = submod(condsub(A[i], q), hq, q);
    __syncthreads();
    ntt_smem(B, logn, fw + (size_t)m * n, fws + (size_t)m * n, q);
    u64* dst = out + (((size_t)m * nb_out + c) * 2 + part) * n;
    const u64* r = rider + ((size_t)m * nb_in + d) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const u64 cm = inner(nd, key, kshoup, m, part, d, i, L, nb_in, n, q, iqs[m], w);
      u64 v = barrett(submod(cm, B[i], q), pinv[m], q, iqs[m], w);
      if (part == 0) v = addmod(condsub(r[i], q), v, q);
      dst[i] = v;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int aloha_ks_head(int device, const void* b, void* out, const void* fw,
                             const void* fws, const void* iw, const void* iws, const void* qs,
                             int L, int nb, int logn, int e, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((1 << logn) > KS_MAX_PER * ALOHA_THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(u64) << logn;
  err = cudaFuncSetAttribute(ks_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb, L + 1, L);
  ks_head_kernel<<<grid, ALOHA_THREADS, smem, (cudaStream_t)stream>>>(
      (const u64*)b, (u64*)out, (const u64*)fw, (const u64*)fws, (const u64*)iw,
      (const u64*)iws, (const u64*)qs, L, nb, logn, e);
  return (int)cudaGetLastError();
}

extern "C" int aloha_ks_tail(int device, const void* nd, const void* rider, const void* key,
                             const void* kshoup, void* out, const void* fw, const void* fws,
                             const void* iw, const void* iws, const void* qs, const void* iqs,
                             const void* pinv, int L, int nb_in, int nb_out, int nper, int logn,
                             int w, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 2 * (sizeof(u64) << logn);
  err = cudaFuncSetAttribute(ks_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb_out, 2);
  ks_tail_kernel<<<grid, ALOHA_THREADS, smem, (cudaStream_t)stream>>>(
      (const u64*)nd, (const u64*)rider, (const u64*)key, (const u64*)kshoup, (u64*)out,
      (const u64*)fw, (const u64*)fws, (const u64*)iw, (const u64*)iws, (const u64*)qs,
      (const u64*)iqs, (const u64*)pinv, L, nb_in, nb_out, nper, logn, w);
  return (int)cudaGetLastError();
}
