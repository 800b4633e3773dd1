// Copy pipelines: chunks of device memory through shared memory by bulk
// asynchronous copies (1-D TMA), with a small step on each chunk.
//
// Replaces the four Mosaic manual-DMA bisections under tools/:
//   tools/dma_bisect.py:34 (`body` :12-31): one slot, synchronous (copy in,
//     wait, compute, copy out, wait); mode "compute" gives x*3 + 1, any
//     other mode copies -> aloha_probe_dma_copy;
//   tools/dma_bisect_doublebuf.py:52 (`body` :11-49): two input and two
//     output slots; each block's lanes rolled by +3, the rows of each pair
//     (2k, 2k+1) swapped, then *3 + 1 -> aloha_probe_dma_doublebuf;
//   tools/dma_bisect_tblread.py:51 (`body` :11-48): the same pipeline, out
//     = x + the sum of the 13 rows of a (13, 64, 128) table ->
//     aloha_probe_dma_tblread;
//   tools/dma_bisect_stages.py:81 (`body` :16-76): the same pipeline over
//     polynomials of 8192 u64 words (the TPU's lo/hi planes as one word),
//     NSTAGES forward Cooley-Tukey lane stages s = 6 .. 5 + NSTAGES of
//     ntt_pallas._ct_butterfly (lazy, in [0, 4q)) -> aloha_probe_dma_stages.
// All words are u32 (the first three) or u64 and wrap as the TPU's do.
//
// Design for Hopper.  The TPU moved chunks of 8 blocks (256 KiB per slot);
// a CTA has 227 KiB of shared memory, so a chunk here is one 32 KiB block
// (half a polynomial for the stages, whose lane stages stay inside a row of
// 128 words).  Persistent CTAs, at most one per SM, walk the chunks c =
// blockIdx.x + k gridDim.x.  One thread issues every copy:
// cp.async.bulk global -> shared completes on an mbarrier that expects the
// chunk's bytes; cp.async.bulk shared -> global goes out in a bulk group.
// Threads write a slot with ordinary stores, so every writer fences the
// generic proxy against the async one (fence.proxy.async) before the
// barrier after which the store is issued.  A slot's mbarrier completes
// once per use: the wait takes the parity of the use count.
//   one slot (dma_copy): load, wait, step in place, store, wait for the
//     store to complete; nothing overlaps, as in the TPU's body;
//   two slots (the rest): chunk k+1's load is in flight while chunk k is
//     worked on; output slot k&1 is rewritten only after the store of chunk
//     k-2 has read it (wait_group.read 1, the TPU's out_copy(cur, c-2)
//     .wait()); the CTA drains its stores at the end.
// tblread folds each thread's 13-row table sum into registers once per CTA
// (the same 16 positions recur in every block; the table is read from L2).
// The stages read q's compact (w, ws) tables (64 KiB each) through L1/L2,
// element i of stage s taking w[2^s + (i >> (13 - s))]; one warp owns a
// row, four words per thread (lanes l, l+32, l+64, l+96), so the distances
// 64 and 32 pair words inside a thread and 16 .. 1 pair threads by
// __shfl_xor_sync; no shared memory round trip between stages.
//
// Bound on Hopper: HBM bytes, each block read once and written once (the
// stages' Shoup products stay under it up to 7 stages).
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

typedef unsigned int u32;
typedef unsigned char u8;

constexpr int ROWS = 64, LANES = 128, WORDS = ROWS * LANES;
constexpr int THREADS = 512;
constexpr u32 CHUNK = WORDS * sizeof(u32);  // bytes of one slot: 32 KiB
constexpr int HALF_ROWS = CHUNK / (LANES * sizeof(u64));  // u64 rows of a chunk: 32
constexpr int VEC = WORDS / 4 / THREADS;  // uint4 per thread per block: 4
constexpr size_t BARRIER_BYTES = 16;  // the mbarriers, after the slots
constexpr int MAX_DEVICES = 64;

// ------------------------------------------------- bulk copies, mbarriers
__device__ __forceinline__ u32 smem_addr(const void* p) {
  return (u32)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(u64* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1u) : "memory");
}

__device__ __forceinline__ void bar_wait(u64* bar, u32 parity) {
  u32 done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// global -> shared, CHUNK bytes, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, u64* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(CHUNK)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(CHUNK), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, CHUNK bytes, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(CHUNK)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// every bulk group but the newest N has finished reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// every bulk group has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// this thread's ordinary shared-memory writes become visible to bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void init_barriers(u64* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) bar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------- steps
// An Op works on one chunk c: setup() once per CTA, then (in, out, c) with
// in and out 16-byte aligned slots of CHUNK bytes (in == out for one slot).

struct CopyStep {  // dma_bisect: copy, or x*3 + 1
  int compute;
  __device__ void setup() {}
  __device__ void operator()(const u8* in, u8* out, int) const {
    if (!compute) return;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int i = threadIdx.x + k * THREADS;
      uint4 v = ((const uint4*)in)[i];
      v.x = v.x * 3u + 1u;
      v.y = v.y * 3u + 1u;
      v.z = v.z * 3u + 1u;
      v.w = v.w * 3u + 1u;
      ((uint4*)out)[i] = v;
    }
  }
};

struct RollSwapStep {  // dma_bisect_doublebuf: out[r][l] = 3 x[r^1][(l-3) mod 128] + 1
  __device__ void setup() {}
  __device__ void operator()(const u8* in_, u8* out_, int) const {
    const u32* in = (const u32*)in_;
    u32* out = (u32*)out_;
#pragma unroll 4
    for (int i = threadIdx.x; i < WORDS; i += THREADS) {
      const int r = i / LANES, l = i % LANES;
      out[i] = in[(r ^ 1) * LANES + ((l - 3) & (LANES - 1))] * 3u + 1u;
    }
  }
};

struct TableStep {  // dma_bisect_tblread: out = x + sum of the 13 table rows
  const u32* t;     // (13, 64, 128)
  uint4 sum[VEC];   // this thread's positions, summed once per CTA
  __device__ void setup() {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int i = threadIdx.x + k * THREADS;
      uint4 s = make_uint4(0u, 0u, 0u, 0u);
      for (int row = 0; row < 13; ++row) {
        const uint4 v = __ldg((const uint4*)(t + (size_t)row * WORDS) + i);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      sum[k] = s;
    }
  }
  __device__ void operator()(const u8* in, u8* out, int) const {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int i = threadIdx.x + k * THREADS;
      uint4 v = ((const uint4*)in)[i];
      v.x += sum[k].x;
      v.y += sum[k].y;
      v.z += sum[k].z;
      v.w += sum[k].w;
      ((uint4*)out)[i] = v;
    }
  }
};

struct StagesStep {  // dma_bisect_stages: lane stages s = 6 .. 5 + nstages
  const u64* w;
  const u64* ws;
  u64 q;
  int nstages;
  __device__ void setup() {}

  // the Harvey butterfly of ntt_pallas._ct_butterfly: u < 4q, v any
  __device__ __forceinline__ void bfly(u64& u, u64& v, int k) const {
    const u64 up = condsub(u, 2 * q);
    const u64 y = shoup_mul(v, __ldg(w + k), __ldg(ws + k), q);
    u = up + y;
    v = up + 2 * q - y;
  }

  __device__ void operator()(const u8* in_, u8* out_, int c) const {
    const u64* in = (const u64*)in_;
    u64* out = (u64*)out_;
    const int lane = threadIdx.x & 31;
    // chunk c is half (c & 1) of polynomial c >> 1: rows (c & 1) * 32 ..
    for (int r = threadIdx.x >> 5; r < HALF_ROWS; r += THREADS / 32) {
      const int base = ((c & 1) * HALF_ROWS + r) * LANES + lane;  // word v[0] in the polynomial
      u64 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = in[r * LANES + lane + 32 * j];
#pragma unroll 1
      for (int s = 6; s < 6 + nstages; ++s) {
        const int sh = 13 - s;  // the pair's twiddle: w[2^s + (i >> sh)]
        const int t = 1 << (12 - s);
        if (t == 64) {  // pairs (j, j + 2) inside the thread
          bfly(v[0], v[2], (1 << s) + (base >> sh));
          bfly(v[1], v[3], (1 << s) + ((base + 32) >> sh));
        } else if (t == 32) {  // pairs (j, j + 1)
          bfly(v[0], v[1], (1 << s) + (base >> sh));
          bfly(v[2], v[3], (1 << s) + ((base + 64) >> sh));
        } else {  // the partner is lane ^ t; the upper thread keeps the bottom
          const bool upper = lane & t;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const u64 p = __shfl_xor_sync(0xffffffffu, v[j], t);
            u64 a = upper ? p : v[j], b = upper ? v[j] : p;
            bfly(a, b, (1 << s) + ((base + 32 * j) >> sh));
            v[j] = upper ? b : a;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) out[r * LANES + lane + 32 * j] = v[j];
    }
  }
};

// ------------------------------------------------------------- pipelines
// x, y: nchunks chunks of CHUNK bytes, 16-byte aligned.

template <class Op>
__global__ void __launch_bounds__(THREADS, 1)
one_slot(const u8* __restrict__ x, u8* __restrict__ y, int nchunks, Op op) {
  extern __shared__ __align__(128) u8 smem[];
  u64* const full = (u64*)(smem + CHUNK);
  init_barriers(full, 1);
  op.setup();
  u32 uses = 0;
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x, ++uses) {
    if (threadIdx.x == 0) bulk_load(smem, x + (size_t)c * CHUNK, full);
    bar_wait(full, uses & 1);
    op(smem, smem, c);
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(y + (size_t)c * CHUNK, smem);
      bulk_wait_all();  // the next load refills the slot
    }
  }
}

template <class Op>
__global__ void __launch_bounds__(THREADS, 1)
two_slots(const u8* __restrict__ x, u8* __restrict__ y, int nchunks, Op op) {
  extern __shared__ __align__(128) u8 smem[];
  // input slots 0 and 1, output slots 2 and 3, the input slots' mbarriers
  u64* const full = (u64*)(smem + 4 * CHUNK);
  init_barriers(full, 2);
  op.setup();
  const int n = (nchunks - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (threadIdx.x == 0) bulk_load(smem, x + (size_t)blockIdx.x * CHUNK, full);
  for (int k = 0; k < n; ++k) {
    const int cur = k & 1, nxt = cur ^ 1, c = blockIdx.x + k * gridDim.x;
    u8* const out = smem + (2 + cur) * CHUNK;
    if (threadIdx.x == 0) {
      // input slot nxt was last read by chunk k-1's step, before the last barrier
      if (k + 1 < n) bulk_load(smem + nxt * CHUNK, x + (size_t)(c + gridDim.x) * CHUNK, full + nxt);
      bulk_wait_read<1>();  // chunk k-2's store has read this output slot
    }
    __syncthreads();
    bar_wait(full + cur, (k >> 1) & 1);
    op(smem + cur * CHUNK, out, c);
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0) bulk_store(y + (size_t)c * CHUNK, out);
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// nslots slots of CHUNK bytes, then one mbarrier per input slot.  The SM
// count is read, and the kernel's shared-memory size set, once per device
// (each Op runs in one kernel), not on every call: the host, not the
// device, held the one-slot pipeline's fixed cost (PERF.md §6, row 16).
template <class Op>
cudaError_t launch(int device, void (*kernel)(const u8*, u8*, int, Op), int nslots, int nchunks,
                   void* stream, const void* x, void* y, const Op& op) {
  static int sms[MAX_DEVICES];  // 0 until the device's first launch
  const size_t smem = nslots * CHUNK + BARRIER_BYTES;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!sms[device]) {
    int n = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return err;
    sms[device] = n;
  }
  const int grid = nchunks < sms[device] ? nchunks : sms[device];
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>((const u8*)x, (u8*)y, nchunks, op);
  return cudaGetLastError();
}

}  // namespace

// x, y: (nb, 64, 128) int32 (u32 bit patterns), 16-byte aligned; nb >= 1.
extern "C" int aloha_probe_dma_copy(int device, const void* x, void* y, int nb, int compute,
                                    void* stream) {
  return (int)launch(device, one_slot<CopyStep>, 1, nb, stream, x, y, CopyStep{compute});
}

// x, y: (nb, 64, 128) int32, 16-byte aligned; nb >= 1.
extern "C" int aloha_probe_dma_doublebuf(int device, const void* x, void* y, int nb,
                                         void* stream) {
  return (int)launch(device, two_slots<RollSwapStep>, 4, nb, stream, x, y,
                     RollSwapStep{});
}

// t: (13, 64, 128) int32; x, y: (nb, 64, 128) int32; all 16-byte aligned; nb >= 1.
extern "C" int aloha_probe_dma_tblread(int device, const void* t, const void* x, void* y, int nb,
                                       void* stream) {
  TableStep op{};
  op.t = (const u32*)t;
  return (int)launch(device, two_slots<TableStep>, 4, nb, stream, x, y, op);
}

// x, y: (nb, 8192) int64 words < 4q, 16-byte aligned; w, ws: q's compact
// forward tables (8192,); 0 <= nstages <= 7; nb >= 1.
extern "C" int aloha_probe_dma_stages(int device, const void* x, void* y, const void* w,
                                      const void* ws, unsigned long long q, int nb, int nstages,
                                      void* stream) {
  const StagesStep op{(const u64*)w, (const u64*)ws, q, nstages};
  return (int)launch(device, two_slots<StagesStep>, 4, 2 * nb, stream, x, y, op);
}
