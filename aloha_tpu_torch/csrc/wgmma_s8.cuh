// int8 warpgroup products on Hopper (sm_90a) and the copies that feed them:
// shared-memory matrix descriptors, wgmma.mma_async m64nNk32 s32.s8.s8 (N =
// 128, 64, 32), mbarriers, 1-D bulk copies and 3-D tensor (TMA) copies with
// the 128-byte swizzle.  csrc/probe_mxu.cu's rate kernel (N = 128, TMA) and
// csrc/ntt_mxu.cu's transform (N = 64 or 32, bulk copies) run on these.
//
// The layout the descriptors read (K-major, 128-byte swizzle).  Integer
// wgmma takes no transpose: A (M x K) and B (K x N) both lie K-major, one
// row of 128 int8 (K = 128 bytes) per row of A and per column of B.  Row r
// lies at byte 128 r; its 16-byte chunk c (bytes 16c .. 16c+15 of K) at
// chunk c ^ (r mod 8) of the row.  Eight rows make a 1024-byte atom, which
// must start 1024-aligned (the hardware swizzles on address bits: bits 4-6
// XOR bits 7-9).  A TMA copy with CU_TENSOR_MAP_SWIZZLE_128B and a 128-byte
// inner box writes exactly this layout, and a TMA store reads it back.
//
// Matrix descriptor (PTX ISA, "Matrix Descriptor Format"), 64 bits:
//   bits  0-13  start address >> 4: the matrix's first row, plus 32 kc bytes
//               for the k32 step kc = 0..3 of a 128-byte row; with the
//               address-based swizzle that offset selects the logical
//               chunks 2kc and 2kc + 1 of every row;
//   bits 16-29  leading byte offset >> 4: unused by a swizzled K-major
//               matrix whose k32 step lies inside its 128-byte atom; 1, as
//               CUTLASS sets it;
//   bits 32-45  stride byte offset >> 4: 1024 bytes from one 8-row atom to
//               the next (64);
//   bits 49-51  base offset: 0 (every atom starts 1024-aligned);
//   bits 62-63  swizzle mode: 1, the 128-byte swizzle.
// A wrong field gives wrong words, not an error: tests/test_torch_cuda.py
// holds the kernel to its plain version at every shape class.
//
// Accumulator fragment of m64nNk32 (.s32, as for .f32): warp w of the
// warpgroup owns rows 16w .. 16w+15; lane = 4g + t holds, for each 8-column
// block i, d[4i] and d[4i+1] at row 16w+g, columns 8i+2t and 8i+2t+1, and
// d[4i+2], d[4i+3] at row 16w+g+8, the same columns.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>

namespace {

constexpr unsigned SW128_ATOM = 1024;  // bytes of one 8-row swizzle atom

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// the initialised barriers become visible to the async proxy (bulk copies)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// wait until the phase of parity `parity` has completed; the loop stays
// inside the PTX, so the caller's control flow does not diverge
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{ .reg .pred p;\n"
      "WAIT: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT; }"
      ::"r"(smem_u32(bar)), "r"(parity)
      : "memory");
}

// the same, for the threads with `pred` set only (the others pass at once)
__device__ __forceinline__ void mbar_wait_if(unsigned long long* bar, unsigned parity, bool pred) {
  asm volatile(
      "{ .reg .pred p, q; setp.ne.b32 q, %2, 0;\n"
      "@!q bra DONE;\n"
      "WAIT: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "DONE: }"
      ::"r"(smem_u32(bar)), "r"(parity), "r"((int)pred)
      : "memory");
}

// when pred: one arrival on bar
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar, bool pred) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0]; }"
      ::"r"(smem_u32(bar)), "r"((int)pred)
      : "memory");
}

// ----------------------------------------------------------- bulk copies
// The copies below take a predicate: only the threads with `pred` set issue
// them, inside the instruction (@p), so that a warpgroup's wgmma path has
// no divergent branch (ptxas serialises its wgmma around one, warning C7520).

// when pred: arrive, and expect `bytes` of copies to complete on bar
// before its phase ends, then copy `bytes` (a multiple of 16, both ends
// 16-byte aligned) global -> shared, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar, bool pred) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %4, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3]; }"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "r"((int)pred)
      : "memory");
}

// when pred: the same for the box (`bytes` of it) of a 3-D tensor map at
// (c0, c1, c2)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, unsigned bytes, unsigned long long* bar,
                                            bool pred) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %7, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%5], %6;\n"
      "@p cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5]; }"
      ::"r"(smem_u32(dst)), "l"((unsigned long long)map), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar)), "r"(bytes), "r"((int)pred)
      : "memory");
}

// shared -> global, the box of a 3-D tensor map at (c0, c1, c2), as one bulk group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
      ::"l"((unsigned long long)map), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// every bulk group of this thread has finished reading shared memory
__device__ __forceinline__ void bulk_wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// this thread's ordinary shared-memory writes become visible to the async
// proxy (bulk copies and wgmma operand reads)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void named_barrier(unsigned id, unsigned count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ----------------------------------------------------------------- wgmma
// descriptor of a K-major, 128-byte-swizzled matrix at shared address `addr`
__device__ __forceinline__ unsigned long long sw128_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4)            // start address
         | (1ull << 16)                                        // leading byte offset (unused)
         | ((unsigned long long)(SW128_ATOM >> 4) << 32)        // stride byte offset
         | (1ull << 62);                                       // 128-byte swizzle
}

// orders this thread's register and shared-memory accesses before the next
// wgmma.mma_async of the warpgroup
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// every wgmma group of the warpgroup but the newest N has completed
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// pins the accumulators in program order against the asynchronous product:
// reads after a wgmma_wait stay after it
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 int32, fragment layout above) = A (64 x 32) . B (32 x 128)
// (+ d when `accumulate`), A and B int8 in shared memory behind descriptors
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], unsigned long long da,
                                                    unsigned long long db, int accumulate) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p; }"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the same for N = 64 and N = 32 (csrc/ntt_mxu.cu: N is the ring's R rows)
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], unsigned long long da,
                                                   unsigned long long db, int accumulate) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p; }"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n32k32_s8(int (&d)[16], unsigned long long da,
                                                   unsigned long long db, int accumulate) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p; }"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// m64nNk32 for N = 2 x the accumulator count (32 or 64)
template <int NACC>
__device__ __forceinline__ void wgmma_m64k32_s8(int (&d)[NACC], unsigned long long da,
                                                unsigned long long db, int accumulate) {
  static_assert(NACC == 16 || NACC == 32, "m64n32 or m64n64");
  if constexpr (NACC == 32) wgmma_m64n64k32_s8(d, da, db, accumulate);
  else wgmma_m64n32k32_s8(d, da, db, accumulate);
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda);
// looked up once per process
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiledFn)p
                                                                      : nullptr;
  }();
  return fn;
}

// A 3-D map of int8 planes (planes, rows, 128) at p (16-byte aligned), box
// (box_planes, box_rows, 128), 128-byte swizzle: a box lands in shared
// memory as box_planes x box_rows rows of 128 bytes in the layout above.
inline cudaError_t encode_planes_map(CUtensorMap* map, const void* p, int planes, int rows,
                                     int box_planes, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {128, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {128, (cuuint64_t)rows * 128};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {128, (cuuint32_t)box_rows, (cuuint32_t)box_planes};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(p), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
