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
// Shape: one CTA per (polynomial, modulus m); grid (nb, M).  The transform
// is csrc/ntt_regs.cuh's: each of n/16 threads holds 16 words in registers
// and runs four stages on them per pass; one n-word shared buffer (64 KiB
// at n = 8192) exchanges the words between passes.
//
// Bound on Hopper: integer issue (two 64-bit multiplies, about 36 INT32
// instructions, per butterfly), not HBM (16 bytes per coefficient in and
// out).  Stage by stage through shared memory (ntt_smem, which csrc/ks.cu
// still runs), a forward transform spent about a third of its time on the
// 13 shared-memory round trips and barriers, a fifth on a (w, ws) load per
// butterfly and a twentieth on runtime butterfly distances.  Here a
// transform at n = 8192 makes 4 passes with 3 exchanges and 3 barriers,
// loads each twiddle pair once per thread and pass, and every distance,
// register pairing and table offset is a compile-time constant of the
// kernel's length.  At most 64 registers a thread keep two 512-thread CTAs
// resident on each SM.
#include "ntt_regs.cuh"

namespace {

constexpr int MAX_DEVICES = 64;

template <int LOGN, bool INV>
cudaError_t launch(int device, const u64* x, u64* y, const u64* w, const u64* ws,
                   const u64* qs, int M, int nb, cudaStream_t stream) {
  auto kernel = ntt_regs::ntt_regs_kernel<LOGN, INV>;
  const int smem = (int)(sizeof(u64) << LOGN);
  static bool attribute_set[MAX_DEVICES];  // per device: the kernel's shared-memory size
  if (!attribute_set[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attribute_set[device] = true;
  }
  const int vec = !(((size_t)x | (size_t)y) & 15);
  kernel<<<dim3(nb, M), ntt_regs::Geometry<LOGN>::T, smem, stream>>>(x, y, w, ws, qs, nb, vec);
  return cudaGetLastError();
}

template <int LOGN>
cudaError_t launch_dir(int device, const u64* x, u64* y, const u64* w, const u64* ws,
                       const u64* qs, int M, int nb, int inverse, cudaStream_t stream) {
  return inverse ? launch<LOGN, true>(device, x, y, w, ws, qs, M, nb, stream)
                 : launch<LOGN, false>(device, x, y, w, ws, qs, M, nb, stream);
}

}  // namespace

// x, y: (M, nb, 2^logn) int64, 0 <= logn <= 14; w, ws: (M, 2^logn) tables;
// qs: (M,).
extern "C" int aloha_ntt(int device, const void* x, void* y, const void* w, const void* ws,
                         const void* qs, int M, int nb, int logn, int inverse, void* stream) {
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const u64 *xx = (const u64*)x, *ww = (const u64*)w, *wws = (const u64*)ws,
            *qq = (const u64*)qs;
  u64* yy = (u64*)y;
  cudaStream_t st = (cudaStream_t)stream;
  switch (logn) {
#define ALOHA_NTT_CASE(L) \
  case L: return (int)launch_dir<L>(device, xx, yy, ww, wws, qq, M, nb, inverse, st);
    ALOHA_NTT_CASE(0) ALOHA_NTT_CASE(1) ALOHA_NTT_CASE(2) ALOHA_NTT_CASE(3)
    ALOHA_NTT_CASE(4) ALOHA_NTT_CASE(5) ALOHA_NTT_CASE(6) ALOHA_NTT_CASE(7)
    ALOHA_NTT_CASE(8) ALOHA_NTT_CASE(9) ALOHA_NTT_CASE(10) ALOHA_NTT_CASE(11)
    ALOHA_NTT_CASE(12) ALOHA_NTT_CASE(13) ALOHA_NTT_CASE(14)
#undef ALOHA_NTT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
