// Batched negacyclic NTT/INTT under M moduli in one launch.
//
// Replaces the TPU kernels ntt_stream._stream_body / _stream_body_multi
// (aloha_tpu/ops/ntt_stream.py:630/662, launched at :721 and :814): the
// single-modulus form is M = 1.  With M = 1 and the caller's tables it also
// replaces ntt_stream.ntt_planes_with_tables (:754, launched at :775), the
// per-shard body of the coefficient-sharded NTT: the tables are then a
// shard's compact slice of a larger ring's (ops/ntt_stream.py
// transform_with_tables), read exactly as the whole ring's are.  And at
// M = 1 it replaces the grid kernel ntt_pallas._call (aloha_tpu/ops/
// ntt_pallas.py:378; ops/ntt_pallas.py), the same function for n = 128 to
// 8192.
//
// Shape: one CTA per (polynomial, modulus m); grid (nb, M).  The transform
// is csrc/ntt_regs.cuh's: each of n/16 threads holds 16 words in registers
// and runs four stages on them per pass; one n-word shared buffer (64 KiB
// at n = 8192) exchanges the words between passes.
//
// Bound on Hopper: integer issue (two 64-bit multiplies, about 36 INT32
// instructions, per butterfly), not HBM (16 bytes per coefficient in and
// out).  Stage by stage through shared memory (the loop this kernel ran
// until it moved to register passes), a forward transform spent about a
// third of its time on the 13 shared-memory round trips and barriers, a
// fifth on a (w, ws) load per butterfly and a twentieth on runtime
// butterfly distances.  Here a
// transform at n = 8192 makes 4 passes with 3 exchanges and 3 barriers,
// loads each twiddle pair once per thread and pass, and every distance,
// register pairing and table offset is a compile-time constant of the
// kernel's length.  At most 64 registers a thread keep two 512-thread CTAs
// resident on each SM.
//
// Below one wave (nb M CTAs fewer than the card's SMs) a launch of one
// CTA a polynomial leaves SMs idle and its time is one SM's latency for a
// polynomial, not the card's throughput: there each polynomial is split
// over a cluster of C = 2 or 4 CTAs on neighbouring SMs, forward from n =
// 1024 and inverse from n = 4096 (aloha_ntt_cluster), which exchange words
// through distributed shared memory once per transform (csrc/ntt_regs.cuh).  Each SM then issues 1/C
// of the polynomial's instructions; the words are the same.  C = 8 (two
// warps a CTA at n = 8192) was no faster than 4 on the H100 and has no
// instance (PERF.md §6).
#include "device_once.cuh"
#include "ntt_regs.cuh"

namespace {

// The largest cluster of a length-2^logn transform: T/C >= 32 threads a
// CTA, C <= 4; none for an inverse below n = 4096, where a cluster was no
// faster than one CTA on the H100 (PERF.md §6).
__host__ __device__ constexpr int max_cluster(int logn, bool inverse) {
  return logn < (inverse ? 12 : 10) ? 1 : ntt_regs::imin(4, (1 << (logn - 4)) / 32);
}

template <int LOGN, bool INV, int C>
cudaError_t launch(int device, const u64* x, u64* y, const u64* w, const u64* ws,
                   const u64* qs, int M, int nb, cudaStream_t stream) {
  using G = ntt_regs::Geometry<LOGN, C>;
  auto kernel = ntt_regs::ntt_regs_kernel<LOGN, INV, C>;
  const int smem = ntt_regs::smem_bytes<LOGN, C, INV>();
  static bool attribute_set[MAX_DEVICES];  // per device: the kernel's shared-memory size
  cudaError_t err = smem_once(kernel, smem, device, attribute_set);
  if (err != cudaSuccess) return err;
  const int vec = !(((size_t)x | (size_t)y) & 15);
  if constexpr (C == 1) {
    kernel<<<dim3(nb, M), G::THREADS, smem, stream>>>(x, y, w, ws, qs, nb, vec);
  } else {
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = C;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nb * C, M);
    cfg.blockDim = dim3(G::THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    if ((err = cudaLaunchKernelEx(&cfg, kernel, x, y, w, ws, qs, nb, vec)) != cudaSuccess)
      return err;
  }
  return cudaGetLastError();
}

template <int LOGN, bool INV>
cudaError_t launch_cluster(int device, const u64* x, u64* y, const u64* w, const u64* ws,
                           const u64* qs, int M, int nb, int C, cudaStream_t stream) {
  switch (C) {
    case 1: return launch<LOGN, INV, 1>(device, x, y, w, ws, qs, M, nb, stream);
    case 2:
      if constexpr (max_cluster(LOGN, INV) >= 2)
        return launch<LOGN, INV, 2>(device, x, y, w, ws, qs, M, nb, stream);
      break;
    case 4:
      if constexpr (max_cluster(LOGN, INV) >= 4)
        return launch<LOGN, INV, 4>(device, x, y, w, ws, qs, M, nb, stream);
      break;
  }
  return cudaErrorInvalidValue;
}

template <int LOGN>
cudaError_t launch_dir(int device, const u64* x, u64* y, const u64* w, const u64* ws,
                       const u64* qs, int M, int nb, int C, int inverse, cudaStream_t stream) {
  return inverse ? launch_cluster<LOGN, true>(device, x, y, w, ws, qs, M, nb, C, stream)
                 : launch_cluster<LOGN, false>(device, x, y, w, ws, qs, M, nb, C, stream);
}

}  // namespace

// The cluster a launch of M x nb length-2^logn transforms takes: 1 when its
// nb M CTAs fill the SMs; below that 2, or 4 while 2 CTAs a polynomial
// fill less than three quarters of the SMs (at most max_cluster).
// Measured on the H100 at n = 1024 to 16384, M = 1 and 3
// (probes/ntt_cluster.py): more CTAs than SMs, or C = 8 (two warps a CTA),
// cost more than they gain.  0 when the SM count cannot be read.
extern "C" int aloha_ntt_cluster(int device, int M, int nb, int logn, int inverse) {
  if (device < 0 || device >= MAX_DEVICES || logn < 0 || logn > 14) return 0;
  int sms = 0;
  if (sm_count(device, &sms) != cudaSuccess) return 0;
  const long long ctas = (long long)nb * M;
  const int most = max_cluster(logn, inverse);
  if (ctas >= sms || most == 1) return 1;
  return most >= 4 && 4 * ctas * 2 < 3LL * sms ? 4 : 2;
}

// x, y: (M, nb, 2^logn) int64, 0 <= logn <= 14; w, ws: (M, 2^logn) tables;
// qs: (M,).  cluster: 0 takes aloha_ntt_cluster's choice; 1, 2 or 4
// forces that cluster (an error where the length has none that large).
extern "C" int aloha_ntt(int device, const void* x, void* y, const void* w, const void* ws,
                         const void* qs, int M, int nb, int logn, int inverse, int cluster,
                         void* stream) {
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int C = cluster ? cluster : aloha_ntt_cluster(device, M, nb, logn, inverse);
  if (!C) return (int)cudaErrorInvalidValue;
  const u64 *xx = (const u64*)x, *ww = (const u64*)w, *wws = (const u64*)ws,
            *qq = (const u64*)qs;
  u64* yy = (u64*)y;
  cudaStream_t st = (cudaStream_t)stream;
  switch (logn) {
#define ALOHA_NTT_CASE(L) \
  case L: return (int)launch_dir<L>(device, xx, yy, ww, wws, qq, M, nb, C, inverse, st);
    ALOHA_NTT_CASE(0) ALOHA_NTT_CASE(1) ALOHA_NTT_CASE(2) ALOHA_NTT_CASE(3)
    ALOHA_NTT_CASE(4) ALOHA_NTT_CASE(5) ALOHA_NTT_CASE(6) ALOHA_NTT_CASE(7)
    ALOHA_NTT_CASE(8) ALOHA_NTT_CASE(9) ALOHA_NTT_CASE(10) ALOHA_NTT_CASE(11)
    ALOHA_NTT_CASE(12) ALOHA_NTT_CASE(13) ALOHA_NTT_CASE(14)
#undef ALOHA_NTT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
