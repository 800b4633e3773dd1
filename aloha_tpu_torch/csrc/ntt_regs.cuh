// The negacyclic NTT/INTT of one polynomial per CTA as register passes:
// each thread holds R words and runs several stages on them as one radix-R
// sub-transform in registers; shared memory only exchanges words between
// passes.  csrc/ntt.cu launches it; tests/test_torch_ntt_regs.py models
// the same schedule in NumPy.
//
// Geometry, for n = 2^LOGN: T = 2^LOGT threads of R = 2^LOGR words, T = n/16
// (R = 16) from n = 512 up, one full warp (R = n/32) below that, n/2 threads
// under n = 64.  Forward pass p runs the stages whose butterfly bits are
// TOP(p) = LOGN-1-LOGR p down to BOT(p) = max(0, TOP(p)-LOGR+1); the last
// pass may run fewer than LOGR stages.  At n = 8192: 4 + 4 + 4 + 1 stages,
// 4 passes, 3 exchanges, where ntt_smem makes 13 round trips.
//
// Owner map of forward pass p: register bit b holds index bit BOT + b for
// the pass's own bits, then the top index bits LOGN-1, LOGN-2, ... for the
// rest (a short pass's extras); the thread index's bits fill the remaining
// index bits in increasing order.  So pass 0 reads i = j + T r (coalesced)
// and the last forward pass owns adjacent pairs (i, i + 1) whose lanes
// are adjacent (one 16-byte store a pair, coalesced).  The inverse runs the
// same passes in reverse order, each pass's stages from its low bit up:
// pairs in, i = j + T r out.
//
// Exchanges: after pass k, each thread writes its words to slot swz(i) of
// one n-word buffer, then one __syncthreads, then pass k+1 reads its words
// from their slots and, after its stages, writes them back to the same
// slots.  A thread thus writes exactly the slots it read, so no other
// thread's read can race the write: one barrier per exchange.  The slot
// swz(i) = i ^ ((i >> 4) & 15) keeps every warp access of every pass free
// of bank conflicts from n = 512 up (16 lanes, 16 distinct 8-byte bank
// pairs; the model checks it).
//
// Twiddles: a butterfly on bit b of i takes w[2^(LOGN-1-b) + (i >> (b+1))]
// forward and w[n/2^(b+1) + (i >> (b+1))] inverse: the compact tables as
// ntt_torch.tables and shard_tables lay them out.  In a pass the R/2
// butterflies of a stage share 2^(bits above b in the pass) pairs, each
// loaded once, just before its stage.
//
// Windows as in ntt_smem/intt_smem: forward values ride in Harvey's
// [0, 4q) and are reduced once, at the last store; the inverse reduces its
// input (< 2q) once at the load and stays canonical through the halvings.
#pragma once

#include "modarith.cuh"

namespace ntt_regs {

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Shared-memory slot of index i (an XOR-linear map: swz(a ^ b) = swz(a) ^ swz(b)).
__host__ __device__ constexpr int swz(int i) { return i ^ ((i >> 4) & 15); }

template <int LOGN>
struct Geometry {
  static constexpr int LOGT = imax(0, imax(LOGN - 4, imin(5, LOGN - 1)));
  static constexpr int LOGR = LOGN - LOGT;
  static constexpr int T = 1 << LOGT, R = 1 << LOGR;
  static constexpr int PASSES = LOGR ? (LOGN + LOGR - 1) / LOGR : 1;
  // two 512-thread CTAs an SM: at most 64 registers a thread
  static constexpr int MIN_BLOCKS = imin(32, imax(1, 1024 / T));

  // forward pass p's butterfly bits TOP .. BOT
  __host__ __device__ static constexpr int top(int p) { return LOGN - 1 - LOGR * p; }
  __host__ __device__ static constexpr int bot(int p) { return imax(0, top(p) - LOGR + 1); }
  // the index bit of register bit b
  __host__ __device__ static constexpr int regbit(int p, int b) {
    return b <= top(p) - bot(p) ? bot(p) + b : LOGN - 1 - (b - (top(p) - bot(p) + 1));
  }
  // the index bits of register r
  __host__ __device__ static constexpr int off(int p, int r) {
    int o = 0;
    for (int b = 0; b < LOGR; ++b) o |= ((r >> b) & 1) << regbit(p, b);
    return o;
  }
  // the index bits thread j owns: its bits below BOT stay, the rest move
  // above TOP (a short pass's extras are the top bits, above every thread bit)
  __host__ __device__ static constexpr int base(int p, int j) {
    return (j & ((1 << bot(p)) - 1)) | ((j >> bot(p)) << (top(p) + 1));
  }
  // every bit that swz(base(p, j)) may hold
  __host__ __device__ static constexpr int base_slot_bits(int p) {
    const int bits = base(p, T - 1);
    return bits | ((bits >> 4) & 15);
  }
};

// Slot of register r of forward pass P for a thread whose base slot is sb:
// an add (folded into the access's immediate offset) where the two share
// no bit, an XOR where they may.
template <int LOGN, int P, int r>
__device__ __forceinline__ int slot(int sb) {
  using G = Geometry<LOGN>;
  constexpr int c = swz(G::off(P, r));
  if constexpr ((c & G::base_slot_bits(P)) == 0) return sb + c;
  else return sb ^ c;
}

template <int LOGN, int P, int r = 0>
__device__ __forceinline__ void to_shared(u64* sh, int sb, const u64 (&a)[Geometry<LOGN>::R]) {
  if constexpr (r < Geometry<LOGN>::R) {
    sh[slot<LOGN, P, r>(sb)] = a[r];
    to_shared<LOGN, P, r + 1>(sh, sb, a);
  }
}

template <int LOGN, int P, int r = 0>
__device__ __forceinline__ void from_shared(const u64* sh, int sb, u64 (&a)[Geometry<LOGN>::R]) {
  if constexpr (r < Geometry<LOGN>::R) {
    a[r] = sh[slot<LOGN, P, r>(sb)];
    from_shared<LOGN, P, r + 1>(sh, sb, a);
  }
}

// Stage k of forward pass P in the direction's order (forward from the
// pass's top bit down, inverse from its bottom bit up), then the next.
// j is the thread index.
template <int LOGN, bool INV, int P, int k = 0>
__device__ __forceinline__ void stages(u64 (&a)[Geometry<LOGN>::R], int j, const u64* __restrict__ w,
                                       const u64* __restrict__ ws, u64 q) {
  using G = Geometry<LOGN>;
  constexpr int BOT = G::bot(P), TOP = G::top(P), R = G::R;
  if constexpr (k <= TOP - BOT) {
    constexpr int b = INV ? BOT + k : TOP - k;  // the butterfly bit
    constexpr int rb = b - BOT;                 // its register bit
    // i >> (b + 1): the thread's bits above TOP, then the register bits above rb
    const int t0 = (INV ? (1 << LOGN) >> (b + 1) : 1 << (LOGN - 1 - b)) + ((j >> BOT) << (TOP - b));
#pragma unroll
    for (int hi = 0; hi < (R >> (rb + 1)); ++hi) {
      const int t = t0 + (G::off(P, hi << (rb + 1)) >> (b + 1));
      const u64 tw = __ldg(w + t), tws = __ldg(ws + t);
#pragma unroll
      for (int lo = 0; lo < (1 << rb); ++lo) {
        const int r = (hi << (rb + 1)) | lo;
        if constexpr (INV)
          gs(a[r], a[r | (1 << rb)], tw, tws, q);
        else
          ct(a[r], a[r | (1 << rb)], tw, tws, q, 2 * q);
      }
    }
    stages<LOGN, INV, P, k + 1>(a, j, w, ws, q);
  }
}

// Pass K of the direction's order (forward pass P), then the next pass.
// The first pass reads x, the last writes y: in forward pass 0, i = j + T r
// (a coalesced word a lane), in the last forward pass adjacent pairs (one
// coalesced 16-byte access a lane when vec).
template <int LOGN, bool INV, int K>
__device__ __forceinline__ void run(u64 (&a)[Geometry<LOGN>::R], u64* sh, int j,
                                    const u64* __restrict__ x, u64* __restrict__ y,
                                    const u64* __restrict__ w, const u64* __restrict__ ws, u64 q,
                                    bool vec) {
  using G = Geometry<LOGN>;
  constexpr int LAST = G::PASSES - 1, P = INV ? LAST - K : K, R = G::R;
  constexpr bool PAIRS = R > 1 && G::regbit(P, 0) == 0;
  const int base = G::base(P, j);
  if constexpr (K == 0) {
    if constexpr (PAIRS) {
#pragma unroll
      for (int r = 0; r < R; r += 2) {
        const u64* p = x + (base | G::off(P, r));
        if (vec) {
          const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(p);
          a[r] = v.x;
          a[r + 1] = v.y;
        } else {
          a[r] = p[0];
          a[r + 1] = p[1];
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = x[base | G::off(P, r)];
    }
    if constexpr (INV) {
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = condsub(a[r], q);
    }
  } else {
    from_shared<LOGN, P>(sh, swz(base), a);
  }
  stages<LOGN, INV, P>(a, j, w, ws, q);
  if constexpr (K < LAST) {
    to_shared<LOGN, P>(sh, swz(base), a);
    __syncthreads();
    run<LOGN, INV, K + 1>(a, sh, j, x, y, w, ws, q, vec);
  } else {
    if constexpr (!INV) {  // from [0, 4q) to [0, q); the inverse is canonical
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = condsub(condsub(a[r], 2 * q), q);
    }
    if constexpr (PAIRS) {
#pragma unroll
      for (int r = 0; r < R; r += 2) {
        u64* p = y + (base | G::off(P, r));
        if (vec) {
          *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(a[r], a[r + 1]);
        } else {
          p[0] = a[r];
          p[1] = a[r + 1];
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) y[base | G::off(P, r)] = a[r];
    }
  }
}

// One CTA per (polynomial, modulus): grid (nb, M), T threads, n words of
// dynamic shared memory.  x, y: (M, nb, n); w, ws: (M, n); qs: (M,).  vec:
// x and y are 16-byte aligned (pairs move as one access).
template <int LOGN, bool INV>
__global__ void __launch_bounds__(Geometry<LOGN>::T, Geometry<LOGN>::MIN_BLOCKS)
ntt_regs_kernel(const u64* __restrict__ x, u64* __restrict__ y, const u64* __restrict__ w,
                const u64* __restrict__ ws, const u64* __restrict__ qs, int nb, int vec) {
  extern __shared__ u64 sh[];
  const int m = blockIdx.y;
  const size_t off = ((size_t)m * nb + blockIdx.x) << LOGN;
  u64 a[Geometry<LOGN>::R];
  run<LOGN, INV, 0>(a, sh, threadIdx.x, x + off, y + off, w + ((size_t)m << LOGN),
                    ws + ((size_t)m << LOGN), qs[m], vec != 0);
}

}  // namespace ntt_regs
