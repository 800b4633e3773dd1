// Stage loops with a runtime stage index, on a resident (64, 128) block of
// 32-bit words.
//
// Replaces two TPU kernels, each a fori_loop whose traced index sets the
// roll distance, the partner mask and (for the lanes) the table row:
//   tools/probe_dynstage.py:38 (`body` :17-35): lane stages s = 6..12,
//     t = 8192 >> (s + 1) = 64 .. 1 -> aloha_probe_dynstage;
//   tools/probe_dynsub.py:30 (`body` :13-27): row stages s = 0..5,
//     t = 64 >> (s + 1) = 32 .. 1, no table -> aloha_probe_dynsub.
// A stage takes, for bit = (index & t) != 0, the partner p at index + t if
// bit, else at index - t (mod 128 lanes or 64 rows: the TPU's two rolls),
// u = bit ? p : a, v = bit ? a : p, and writes bit ? u - v w : u + v w
// (w = w[s][r][l] for the lanes, 1 for the rows), all mod 2^32.  The
// partner wraps around and its direction mirrors a butterfly's: that is the
// TPU scripts' function (and their NumPy oracles'), ported as it is.
//
// Layout: one CTA of 512 threads per block; the block and a second buffer
// (32 KiB each) in dynamic shared memory for the whole launch; a stage reads
// one buffer, writes the other and ends in a barrier.  The stage loop is not
// unrolled (#pragma unroll 1): t, the mask and the table row come from the
// runtime index, as from the TPU's traced one.  The table row is read from
// global memory (L2) with the runtime s.
//
// Bound on Hopper: integer issue, the instructions of a stage counted in
// probes/probe_dynstage.OPS and probes/probe_dynsub.OPS.
#include <cuda_runtime.h>

namespace {

typedef unsigned int u32;

constexpr int ROWS = 64, LANES = 128, WORDS = ROWS * LANES;
constexpr int DYN_THREADS = 512;
constexpr size_t DYN_SMEM = 2 * sizeof(u32) * WORDS;

__device__ __forceinline__ void load_block(u32* a, const u32* __restrict__ x) {
  const size_t off = (size_t)blockIdx.x * WORDS;
  for (int i = threadIdx.x; i < WORDS; i += DYN_THREADS) a[i] = x[off + i];
  __syncthreads();
}

__device__ __forceinline__ void store_block(u32* __restrict__ y, const u32* a) {
  const size_t off = (size_t)blockIdx.x * WORDS;
  for (int i = threadIdx.x; i < WORDS; i += DYN_THREADS) y[off + i] = a[i];
}

// x, y: (nb, 64, 128) u32; w: (13, 64, 128) u32
__global__ void __launch_bounds__(DYN_THREADS)
dynstage_kernel(const u32* __restrict__ x, u32* __restrict__ y, const u32* __restrict__ w,
                int reps) {
  extern __shared__ u32 buf[];
  u32 *a = buf, *b = buf + WORDS;
  load_block(a, x);
  for (int r = 0; r < reps; ++r) {
#pragma unroll 1
    for (int s = 6; s < 13; ++s) {
      const int t = WORDS >> (s + 1);
      const u32* ws = w + (size_t)s * WORDS;
      for (int i = threadIdx.x; i < WORDS; i += DYN_THREADS) {
        const int l = i & (LANES - 1);
        const bool bit = (l & t) != 0;
        const u32 self = a[i];
        const u32 p = a[(i - l) + ((bit ? l + t : l - t) & (LANES - 1))];
        const u32 u = bit ? p : self, vw = (bit ? self : p) * __ldg(ws + i);
        b[i] = bit ? u - vw : u + vw;
      }
      __syncthreads();
      u32* tmp = a;
      a = b;
      b = tmp;
    }
  }
  store_block(y, a);
}

// x, y: (nb, 64, 128) u32
__global__ void __launch_bounds__(DYN_THREADS)
dynsub_kernel(const u32* __restrict__ x, u32* __restrict__ y, int reps) {
  extern __shared__ u32 buf[];
  u32 *a = buf, *b = buf + WORDS;
  load_block(a, x);
  for (int r = 0; r < reps; ++r) {
#pragma unroll 1
    for (int s = 0; s < 6; ++s) {
      const int t = ROWS >> (s + 1);
      for (int i = threadIdx.x; i < WORDS; i += DYN_THREADS) {
        const int row = i / LANES;
        const bool bit = (row & t) != 0;
        const u32 self = a[i];
        const u32 p = a[((bit ? row + t : row - t) & (ROWS - 1)) * LANES + (i & (LANES - 1))];
        b[i] = bit ? p - self : self + p;
      }
      __syncthreads();
      u32* tmp = a;
      a = b;
      b = tmp;
    }
  }
  store_block(y, a);
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)DYN_SMEM);
}

}  // namespace

// x, y: (nb, 64, 128) int32 (u32 bit patterns); w: (13, 64, 128) int32; reps >= 0.
extern "C" int aloha_probe_dynstage(int device, const void* x, void* y, const void* w, int nb,
                                    int reps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((err = allow_smem(dynstage_kernel)) != cudaSuccess) return (int)err;
  dynstage_kernel<<<nb, DYN_THREADS, DYN_SMEM, (cudaStream_t)stream>>>(
      (const u32*)x, (u32*)y, (const u32*)w, reps);
  return (int)cudaGetLastError();
}

// x, y: (nb, 64, 128) int32 (u32 bit patterns); reps >= 0.
extern "C" int aloha_probe_dynsub(int device, const void* x, void* y, int nb, int reps,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((err = allow_smem(dynsub_kernel)) != cudaSuccess) return (int)err;
  dynsub_kernel<<<nb, DYN_THREADS, DYN_SMEM, (cudaStream_t)stream>>>((const u32*)x, (u32*)y,
                                                                     reps);
  return (int)cudaGetLastError();
}
