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
// 128 words).  Persistent CTAs, at most one per SM (the stages: two, below),
// walk the chunks c = blockIdx.x + k gridDim.x.  One thread issues every copy:
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
//
// The stages have their own pipeline (stages_ring): each chunk is stepped
// in place in the slot it was loaded into, by 256 threads of 16 words in
// registers.  A row of 128 words is 8 threads (l0 = 0..7), a warp 4 rows,
// a chunk of 32 rows 8 warps.  Two owner maps, each a radix-16
// sub-transform in registers:
//   pass A, stages s = 6 .. min(9, 5 + NSTAGES) (distances 64 .. 8, lane
//     bits 6 .. 3): register m holds lane l0 + 8m;
//   pass B, stages 10 .. 5 + NSTAGES (distances 4, 2, 1, lane bits 2 .. 0):
//     register m holds lane 16 l0 + m, 16 adjacent words (bit 3 carried).
// Each thread writes its words back to the slots it read, so the exchange
// between the passes is one __syncwarp (a row's 8 threads are one warp's),
// and at NSTAGES <= 4 pass B and the exchange are absent.  Every butterfly
// is computed once, by the thread that holds both words; each distinct
// (w, ws) pair of a pass is loaded once, just before its stage (15 in
// pass A, 14 in pass B, 16-byte loads where a stage takes consecutive
// ones).  NSTAGES is a template parameter: every distance, shift and table
// offset is a constant.
//
// Shared memory: the chunk goes in and out by one 5-D TMA copy with the
// 128-byte swizzle (csrc/tensor_map.cuh), which keeps each 16-byte unit
// whole and moves it to unit u ^ (line mod 8) of its 128-byte line.  The
// box puts line L = (row r, group g = lane >> 4) of the chunk at L = g0 g1
// r0 g2 r1 r2 r3 r4 (bits low to high), so word w of the group lands in
// slot 16 L + (w ^ 2 (L & 7)).  With that slot, pass A's 8-byte accesses
// (a half-warp: rows r0 = 0, 1 of one register, 8 threads each) and pass
// B's 16-byte ones (a quarter-warp: the 8 lines g0 g1 r0) fall on distinct
// banks, with no select or shuffle of a word; tests/test_torch_dma_stages_
// regs.py checks both, and the TMA image, in a NumPy model.
//
// The ring: ST_SLOTS slots; chunk k + 1 of a CTA is loaded into slot
// (k + 1) mod ST_SLOTS while chunk k is stepped, only after
// wait_group.read ST_SLOTS - 2 says the store that last read that slot
// has read it.  Two CTAs share an SM, so one CTA's barrier and mbarrier
// waits hide under the other's arithmetic.  2 slots (64 KiB a CTA) beat
// 3 slots at two CTAs an SM and 2 slots at three (PERF.md §6, row 18),
// most likely because the L1 left beside 128 KiB of slots holds the 64
// KiB of (w, ws) pairs that every chunk of a half takes, and beside 192
// KiB does not: a build with every twiddle at one table row was as fast.  The
// grid is min(2 nb, CTAs an SM x SMs), the CTAs an SM from the occupancy
// calculator, once per device.
//
// Bound on Hopper: HBM bytes, each block read once and written once (the
// stages' Shoup products stay under it up to 7 stages).
#include <cuda_runtime.h>

#include "modarith.cuh"
#include "tensor_map.cuh"  // CUtensorMap, encode_tiled

namespace {

typedef unsigned int u32;
typedef unsigned char u8;

constexpr int ROWS = 64, LANES = 128, WORDS = ROWS * LANES;
constexpr int THREADS = 512;
constexpr u32 CHUNK = WORDS * sizeof(u32);  // bytes of one slot: 32 KiB
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

// ------------------------------------------------------- stages pipeline
constexpr int ST_THREADS = 256;  // 32 rows of 8 threads
constexpr int ST_ROWS = 32;      // u64 rows of a chunk: half a polynomial
constexpr int ST_SLOTS = 2;      // the ring's slots
constexpr int ST_CTAS = 2;       // CTAs an SM (__launch_bounds__: at most 128 registers)
constexpr int ST_A_SHIFT = 3;    // pass A: register m holds lane l0 + (m << ST_A_SHIFT)
constexpr int ST_B_SHIFT = 4;    // pass B: register m holds lane (l0 << ST_B_SHIFT) + m
// The bits of l0 and of the row, low to high, in a thread's index and in a
// line's index (pass B's thread tid holds line tid): l0 at bits 0, 1, 3,
// the row at 2, 4-7.
constexpr unsigned ST_L0_BITS = 0x0b;
constexpr unsigned ST_ROW_BITS = 0xf4;
constexpr unsigned ST_ALIGN = 1024;  // the 128-byte swizzle's atom
constexpr size_t ST_SMEM = ST_SLOTS * (size_t)CHUNK + ST_ALIGN + ST_SLOTS * sizeof(u64);
// The TMA box of a chunk: (16 words, g0 g1, r0, g2, r1-r4), byte strides of
// dimensions 1-4 in the (nb, 64, 128) u64 array (row 1024, group 128 bytes).
constexpr cuuint32_t ST_BOX[5] = {16, 4, 2, 2, 16};
constexpr cuuint64_t ST_STRIDES[4] = {128, 1024, 512, 2048};

// v's bits, low to high, to the set bits of mask, and back
__host__ __device__ constexpr int scatter_bits(int v, unsigned mask) {
  int out = 0, k = 0;
  for (int b = 0; b < 8; ++b)
    if (mask >> b & 1) out |= ((v >> k++) & 1) << b;
  return out;
}
__host__ __device__ constexpr int gather_bits(int v, unsigned mask) {
  int out = 0, k = 0;
  for (int b = 0; b < 8; ++b)
    if (mask >> b & 1) out |= ((v >> b) & 1) << k++;
  return out;
}

// the line of row r's group g, and the u64 slot of its word w (the
// swizzle: 16-byte unit u at u ^ (L mod 8)); slot(L | L', w ^ w') =
// slot(L, w) ^ slot(L', w') for lines of disjoint bits
__host__ __device__ constexpr int st_line(int r, int g) {
  return scatter_bits(g, ST_L0_BITS) | scatter_bits(r, ST_ROW_BITS);
}
__host__ __device__ constexpr int st_slot(int line, int w) {
  return 16 * line + (w ^ ((line & 7) << 1));
}

// chunk c (rows 32c .. 32c + 31 of the array) by the 5-D map, into dst,
// completing on bar; and out of src, as one bulk group
__device__ __forceinline__ void tma_load_chunk(void* dst, const CUtensorMap* map, int c, u64* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(CHUNK)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %2, %2, %2, %3}], [%4];"
      ::"r"(smem_addr(dst)), "l"((unsigned long long)map), "r"(0), "r"(c * (ST_ROWS / 2)),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_chunk(const CUtensorMap* map, const void* src, int c) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %2, %2, %2, %3}], [%1];"
      ::"l"((unsigned long long)map), "r"(smem_addr(src)), "r"(0), "r"(c * (ST_ROWS / 2))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// NJ consecutive (w, ws) pairs from index base (even when NJ > 1: 16-byte loads)
template <int NJ>
__device__ __forceinline__ void load_pairs(u64 (&tw)[NJ], u64 (&tws)[NJ], const u64* w,
                                           const u64* ws, int base) {
  if constexpr (NJ == 1) {
    tw[0] = __ldg(w + base);
    tws[0] = __ldg(ws + base);
  } else {
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      const ulonglong2 a = __ldg((const ulonglong2*)(w + base + j));
      const ulonglong2 b = __ldg((const ulonglong2*)(ws + base + j));
      tw[j] = a.x, tw[j + 1] = a.y, tws[j] = b.x, tws[j + 1] = b.y;
    }
  }
}

// One stage on register bit K: the butterflies (m, m | 2^K), m's bit K
// clear, the pair's twiddle w[base + (m >> (K + 1))]
template <int K>
__device__ __forceinline__ void st_stage(u64 (&a)[16], const u64* w, const u64* ws, int base,
                                         u64 q, u64 q2) {
  constexpr int NJ = 16 >> (K + 1);
  u64 tw[NJ], tws[NJ];
  load_pairs<NJ>(tw, tws, w, ws, base);
#pragma unroll
  for (int m = 0; m < 16; ++m)
    if (!(m >> K & 1)) ct(a[m], a[m | 1 << K], tw[m >> (K + 1)], tws[m >> (K + 1)], q, q2);
}

// Stages S .. LAST of a pass whose register m holds word i0 + (m << SHIFT)
// of the polynomial: stage s pairs index bit 12 - s, register bit K = 12 -
// s - SHIFT; word i takes w[2^s + (i >> (13 - s))], so the pair (m, m |
// 2^K) takes w[2^s + (i0 >> (13 - s)) + (m >> (K + 1))].
template <int S, int LAST, int SHIFT>
__device__ __forceinline__ void st_stages(u64 (&a)[16], const u64* w, const u64* ws, int i0,
                                          u64 q, u64 q2) {
  if constexpr (S <= LAST) {
    st_stage<12 - S - SHIFT>(a, w, ws, (1 << S) + (i0 >> (13 - S)), q, q2);
    st_stages<S + 1, LAST, SHIFT>(a, w, ws, i0, q, q2);
  }
}

// the slot of lane `lane` of row r (its group lane >> 4, its word lane & 15)
__host__ __device__ constexpr int st_lane_slot(int r, int lane) {
  return st_slot(st_line(r, lane >> 4), lane & 15);
}

// NST stages s = 6 .. 5 + NST on chunk c (half c & 1 of polynomial c >> 1)
// in its slot sl, in place.  A register's slot is the thread's part XOR
// the register's (lanes of disjoint bits).
template <int NST>
__device__ __forceinline__ void st_step(u64* sl, int c, const u64* w, const u64* ws, u64 q) {
  if constexpr (NST > 0) {
    const int r = gather_bits(threadIdx.x, ST_ROW_BITS), l0 = gather_bits(threadIdx.x, ST_L0_BITS);
    const int i0 = (((c & 1) * ST_ROWS) | r) * LANES;  // the row's first word in the polynomial
    const u64 q2 = 2 * q;
    u64 a[16];
    // pass A: register m holds lane l0 + (m << ST_A_SHIFT)
    const int ta = st_lane_slot(r, l0);
#pragma unroll
    for (int m = 0; m < 16; ++m) a[m] = sl[ta ^ st_lane_slot(0, m << ST_A_SHIFT)];
    st_stages<6, (NST < 4 ? 5 + NST : 9), ST_A_SHIFT>(a, w, ws, i0 + l0, q, q2);
#pragma unroll
    for (int m = 0; m < 16; ++m) sl[ta ^ st_lane_slot(0, m << ST_A_SHIFT)] = a[m];
    if constexpr (NST > 4) {
      __syncwarp();
      // pass B: register m holds lane (l0 << ST_B_SHIFT) + m; words 2p, 2p + 1
      // are one 16-byte unit
      const int tb = st_lane_slot(r, l0 << ST_B_SHIFT);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const ulonglong2 v = *(const ulonglong2*)(sl + (tb ^ st_lane_slot(0, 2 * p)));
        a[2 * p] = v.x, a[2 * p + 1] = v.y;
      }
      st_stages<10, 5 + NST, 0>(a, w, ws, i0 + (l0 << ST_B_SHIFT), q, q2);
#pragma unroll
      for (int p = 0; p < 8; ++p)
        *(ulonglong2*)(sl + (tb ^ st_lane_slot(0, 2 * p))) =
            make_ulonglong2(a[2 * p], a[2 * p + 1]);
    }
  }
}

// xmap, ymap: x and y as encode_chunks_map lays them out; nchunks = 2 nb.
template <int NST>
__global__ void __launch_bounds__(ST_THREADS, ST_CTAS)
stages_ring(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
            const u64* __restrict__ w, const u64* __restrict__ ws, u64 q, int nchunks) {
  extern __shared__ u8 st_raw[];
  u8* const smem = st_raw + (ST_ALIGN - smem_addr(st_raw) % ST_ALIGN) % ST_ALIGN;
  u64* const full = (u64*)(smem + ST_SLOTS * CHUNK);  // one mbarrier a slot
  init_barriers(full, ST_SLOTS);
  const int n = (nchunks - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (threadIdx.x == 0) tma_load_chunk(smem, &xmap, blockIdx.x, full);
  int s = 0;       // chunk k's slot, k mod ST_SLOTS
  u32 parity = 0;  // of k / ST_SLOTS, the slot's use
  for (int k = 0; k < n; ++k) {
    const int c = blockIdx.x + k * gridDim.x, nxt = s + 1 == ST_SLOTS ? 0 : s + 1;
    if (threadIdx.x == 0 && k + 1 < n) {
      bulk_wait_read<ST_SLOTS - 2>();  // chunk k + 1 - ST_SLOTS's store has read slot nxt
      tma_load_chunk(smem + nxt * CHUNK, &xmap, c + gridDim.x, full + nxt);
    }
    bar_wait(full + s, parity);
    st_step<NST>((u64*)(smem + s * CHUNK), c, w, ws, q);
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0) tma_store_chunk(&ymap, smem + s * CHUNK, c);
    parity ^= nxt == 0;
    s = nxt;
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// The 5-D map of (nb, 64, 128) u64 at p (16-byte aligned): a box is one
// chunk, ST_BOX, 128-byte swizzle.
cudaError_t encode_chunks_map(CUtensorMap* map, const void* p, int nb) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[5] = {16, 4, 2, 2, (cuuint64_t)nb * (ROWS / 2)};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 5, const_cast<void*>(p), dims,
                            ST_STRIDES, ST_BOX, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The SM count, the CTAs an SM (occupancy calculator) and the kernel's
// shared-memory size are read and set once per device and instance.
template <int NST>
cudaError_t launch_stages(int device, const void* x, void* y, const void* w, const void* ws,
                          u64 q, int nb, void* stream) {
  static int sms[MAX_DEVICES], ctas[MAX_DEVICES];  // 0 until the device's first launch
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if ((size_t)w % 16 || (size_t)ws % 16) return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!sms[device]) {
    int n = 0, k = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(stages_ring<NST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)ST_SMEM)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, stages_ring<NST>, ST_THREADS,
                                                             ST_SMEM)) != cudaSuccess)
      return err;
    if (k < 1) return cudaErrorInvalidConfiguration;
    ctas[device] = k;
    sms[device] = n;
  }
  CUtensorMap xmap, ymap;
  if ((err = encode_chunks_map(&xmap, x, nb)) != cudaSuccess ||
      (err = encode_chunks_map(&ymap, y, nb)) != cudaSuccess)
    return err;
  const int nchunks = 2 * nb, most = ctas[device] * sms[device];
  stages_ring<NST><<<nchunks < most ? nchunks : most, ST_THREADS, ST_SMEM, (cudaStream_t)stream>>>(
      xmap, ymap, (const u64*)w, (const u64*)ws, q, nchunks);
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
// forward tables (8192,), 16-byte aligned; 0 <= nstages <= 7; nb >= 1.
extern "C" int aloha_probe_dma_stages(int device, const void* x, void* y, const void* w,
                                      const void* ws, unsigned long long q, int nb, int nstages,
                                      void* stream) {
  switch (nstages) {
    case 0: return (int)launch_stages<0>(device, x, y, w, ws, q, nb, stream);
    case 1: return (int)launch_stages<1>(device, x, y, w, ws, q, nb, stream);
    case 2: return (int)launch_stages<2>(device, x, y, w, ws, q, nb, stream);
    case 3: return (int)launch_stages<3>(device, x, y, w, ws, q, nb, stream);
    case 4: return (int)launch_stages<4>(device, x, y, w, ws, q, nb, stream);
    case 5: return (int)launch_stages<5>(device, x, y, w, ws, q, nb, stream);
    case 6: return (int)launch_stages<6>(device, x, y, w, ws, q, nb, stream);
    case 7: return (int)launch_stages<7>(device, x, y, w, ws, q, nb, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
