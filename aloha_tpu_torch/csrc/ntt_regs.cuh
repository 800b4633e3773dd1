// The negacyclic NTT/INTT of one polynomial per CTA, or per cluster of C
// CTAs, as register passes: each thread holds R words and runs several
// stages on them as one radix-R sub-transform in registers; shared memory
// only exchanges words between passes.  csrc/ntt.cu launches it, and
// csrc/ks.cu chains its transforms in registers (run's IN and OUT);
// tests/test_torch_ntt_regs.py models the same schedule in NumPy.
//
// Geometry, for n = 2^LOGN: T = 2^LOGT threads of R = 2^LOGR words, T = n/16
// (R = 16) from n = 512 up, one full warp (R = n/32) below that, n/2 threads
// under n = 64.  Forward pass p runs the stages whose butterfly bits are
// TOP(p) = LOGN-1-LOGR p down to BOT(p) = max(0, TOP(p)-LOGR+1); the last
// pass may run fewer than LOGR stages.  At n = 8192: 4 + 4 + 4 + 1 stages,
// 4 passes, 3 exchanges, where a stage-by-stage loop in shared memory
// makes 13 round trips.
//
// Owner map of forward pass p: register bit b holds index bit BOT + b for
// the pass's own bits, then, for a short pass's extras, the top index bits
// below the cluster rank's (LOGN-1-LOGC, LOGN-2-LOGC, ...); the thread
// index's bits fill the remaining index bits in increasing order.  So pass
// 0 reads i = J + T r (coalesced) and the last forward pass owns adjacent
// pairs (i, i + 1) whose lanes are adjacent (one 16-byte store a pair,
// coalesced).  The inverse runs the same passes in reverse order, each
// pass's stages from its low bit up: pairs in, i = J + T r out.
//
// Exchanges: after pass k, each thread writes its words to their slots in
// shared memory, then one barrier, then pass k+1 reads its words from
// their slots and, after its stages, writes them back to the same slots.
// A thread thus writes exactly the slots it read, so no other thread's read
// can race the write: one barrier per exchange.  The slot swz(i) = i ^ ((i
// >> 4) & 15) keeps every warp access of every pass free of bank conflicts
// from n = 512 up (16 lanes, 16 distinct 8-byte bank pairs; the model
// checks it).
//
// Clusters (C = 2 or 4 CTAs per polynomial, launched below one wave, so
// that a launch of nb polynomials keeps nb C SMs busy): the C CTAs of
// T/C threads each are one polynomial's threads, J = rank T/C + threadIdx.x,
// and each holds n/C words of shared memory.  The rank (J's top LOGC bits)
// sits at index bits LOGT-LOGC and up in pass 0 and at the top LOGC bits
// in every other pass (hence a short pass's extras below them), so only
// the exchange between forward passes 0 and 1 moves words between CTAs:
// each thread writes them straight into the owning CTA's buffer
// (mapa + st.shared::cluster), and one cluster barrier (release, acquire)
// replaces __syncthreads.  A word's slot in its CTA is swz of its index
// with the rank's bits swapped with the top bits, then dropped.  Every
// CTA arrives (relaxed) at a first cluster barrier when it starts and
// waits on it just before its first remote store, so no CTA writes into
// one not yet running.  Forward, that exchange comes first and fills the
// buffer no CTA has read; inverse, it comes last and fills a second n/C
// words, since the other CTAs may still be reading the first.  No remote
// store follows the exchange's barrier, so no CTA exits with writes into
// it pending.
//
// Twiddles: a butterfly on bit b of i takes w[2^(LOGN-1-b) + (i >> (b+1))]
// forward and w[n/2^(b+1) + (i >> (b+1))] inverse: the compact tables as
// ntt_torch.tables and shard_tables lay them out.  In a pass the R/2
// butterflies of a stage share 2^(bits above b in the pass) pairs, each
// loaded once, just before its stage.
//
// Windows: forward values ride in Harvey's [0, 4q) and are reduced once,
// at the last pass; the inverse reduces its input (< 2q) once at the load
// and stays canonical through the halvings.
#pragma once

#include "modarith.cuh"

namespace ntt_regs {

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Shared-memory slot of index i (an XOR-linear map: swz(a ^ b) = swz(a) ^ swz(b)).
__host__ __device__ constexpr int swz(int i) { return i ^ ((i >> 4) & 15); }

template <int LOGN, int C = 1>
struct Geometry {
  static constexpr int LOGT = imax(0, imax(LOGN - 4, imin(5, LOGN - 1)));
  static constexpr int LOGR = LOGN - LOGT;
  static constexpr int T = 1 << LOGT, R = 1 << LOGR;
  static constexpr int PASSES = LOGR ? (LOGN + LOGR - 1) / LOGR : 1;
  static constexpr int LOGC = C == 4 ? 2 : C == 2 ? 1 : 0;
  static constexpr int THREADS = T / C;          // a CTA's threads
  static constexpr int WORDS = (1 << LOGN) / C;  // a CTA's words
  // one CTA a polynomial: two 512-thread CTAs an SM, at most 64 registers
  // a thread; a cluster (below one wave): 512 threads an SM, at most 128
  static constexpr int MIN_BLOCKS =
      C == 1 ? imin(32, imax(1, 1024 / T)) : imin(32, imax(1, 512 / THREADS));
  static_assert((1 << LOGC) == C && (C == 1 || (THREADS >= 32 && LOGC <= LOGR)),
                "a cluster of 2 or 4 CTAs of at least a warp each");

  // forward pass p's butterfly bits TOP .. BOT
  __host__ __device__ static constexpr int top(int p) { return LOGN - 1 - LOGR * p; }
  __host__ __device__ static constexpr int bot(int p) { return imax(0, top(p) - LOGR + 1); }
  // the index bit of register bit b
  __host__ __device__ static constexpr int regbit(int p, int b) {
    return b <= top(p) - bot(p) ? bot(p) + b : LOGN - 1 - LOGC - (b - (top(p) - bot(p) + 1));
  }
  // the index bits of register r
  __host__ __device__ static constexpr int off(int p, int r) {
    int o = 0;
    for (int b = 0; b < LOGR; ++b) o |= ((r >> b) & 1) << regbit(p, b);
    return o;
  }
  // the index bits thread J owns: its bits below BOT stay, the next ones
  // go above TOP (below a short pass's extras), the top LOGC (the rank) on top
  __host__ __device__ static constexpr int base(int p, int j) {
    const int hi = top(p), lo = bot(p);
    if (LOGC == 0) return (j & ((1 << lo) - 1)) | ((j >> lo) << (hi + 1));
    const int mid = imax(0, LOGN - LOGC - (LOGR - (hi - lo + 1)) - hi - 1);
    return (j & ((1 << lo) - 1)) | (((j >> lo) & ((1 << mid) - 1)) << (hi + 1)) |
           ((j >> (lo + mid)) << (LOGN - LOGC));
  }
  // the index bit of the rank's lowest bit in pass p
  __host__ __device__ static constexpr int rankbit(int p) { return (p == 0 ? LOGT : LOGN) - LOGC; }
  // i within its CTA's WORDS in pass p: the rank's bits swapped with the top ones, dropped
  __host__ __device__ static constexpr int local(int p, int i) {
    if (C == 1) return i;
    const int m = C - 1, rb = rankbit(p), hi = LOGN - LOGC;
    const int swapped = (i & ~(m << rb) & ~(m << hi)) | (((i >> rb) & m) << hi) |
                        (((i >> hi) & m) << rb);
    return swapped & (WORDS - 1);
  }
  // the shared-memory slot of index i in the buffer pass p reads
  __host__ __device__ static constexpr int slot_of(int p, int i) { return swz(local(p, i)); }
  // the CTA that owns index i in pass p
  __host__ __device__ static constexpr int rank_of(int p, int i) {
    return (i >> rankbit(p)) & (C - 1);
  }
  // every bit that slot_of(PS, base(P, J)) may hold
  __host__ __device__ static constexpr int base_slot_bits(int P, int PS) {
    const int bits = local(PS, base(P, T - 1));
    return bits | ((bits >> 4) & 15);
  }
};

// Slot of register r of forward pass P in the buffer pass PS reads, for
// a thread whose base slot there is sb: an add (folded into the access's
// immediate offset) where the two share no bit, an XOR where they may.
template <int LOGN, int C, int P, int PS, int r>
__device__ __forceinline__ int slot(int sb) {
  using G = Geometry<LOGN, C>;
  constexpr int c = G::slot_of(PS, G::off(P, r));
  if constexpr ((c & G::base_slot_bits(P, PS)) == 0) return sb + c;
  else return sb ^ c;
}

template <int LOGN, int C, int P, int PS, int r = 0>
__device__ __forceinline__ void to_shared(u64* sh, int sb, const u64 (&a)[Geometry<LOGN, C>::R]) {
  if constexpr (r < Geometry<LOGN, C>::R) {
    sh[slot<LOGN, C, P, PS, r>(sb)] = a[r];
    to_shared<LOGN, C, P, PS, r + 1>(sh, sb, a);
  }
}

template <int LOGN, int C, int P, int r = 0>
__device__ __forceinline__ void from_shared(const u64* sh, int sb,
                                            u64 (&a)[Geometry<LOGN, C>::R]) {
  if constexpr (r < Geometry<LOGN, C>::R) {
    a[r] = sh[slot<LOGN, C, P, P, r>(sb)];
    from_shared<LOGN, C, P, r + 1>(sh, sb, a);
  }
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {  // release
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {  // acquire
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The cross exchange: register r of forward pass P into the buffer (at
// shared address dst in every CTA) of the CTA that owns it in pass PS, at
// its slot there.  The owner is a constant of r: the rank's bits in pass
// PS are register bits of pass P.
template <int LOGN, int C, int P, int PS, int r = 0>
__device__ __forceinline__ void to_cluster(unsigned dst, int sb,
                                           const u64 (&a)[Geometry<LOGN, C>::R]) {
  using G = Geometry<LOGN, C>;
  if constexpr (r < G::R) {
    static_assert(G::rank_of(PS, G::base(P, G::T - 1)) == 0, "the owner is a register's");
    constexpr unsigned rank = G::rank_of(PS, G::off(P, r));
    const unsigned addr = dst + 8u * (unsigned)slot<LOGN, C, P, PS, r>(sb);
    asm volatile(
        "{\n\t.reg .b32 ra;\n\t"
        "mapa.shared::cluster.u32 ra, %0, %1;\n\t"
        "st.shared::cluster.u64 [ra], %2;\n\t}"
        ::"r"(addr), "r"(rank), "l"(a[r]) : "memory");
    to_cluster<LOGN, C, P, PS, r + 1>(dst, sb, a);
  }
}

// Stage k of forward pass P in the direction's order (forward from the
// pass's top bit down, inverse from its bottom bit up), then the next.
// j is the thread index, base its index bits (G::base).
template <int LOGN, int C, bool INV, int P, int k = 0>
__device__ __forceinline__ void stages(u64 (&a)[Geometry<LOGN, C>::R], int j, int base,
                                       const u64* __restrict__ w, const u64* __restrict__ ws,
                                       u64 q) {
  using G = Geometry<LOGN, C>;
  constexpr int BOT = G::bot(P), TOP = G::top(P), R = G::R;
  if constexpr (k <= TOP - BOT) {
    constexpr int b = INV ? BOT + k : TOP - k;  // the butterfly bit
    constexpr int rb = b - BOT;                 // its register bit
    // i >> (b + 1): the thread's bits above TOP, then the register bits above rb
    const int t0 = (INV ? (1 << LOGN) >> (b + 1) : 1 << (LOGN - 1 - b)) +
                   (C == 1 ? (j >> BOT) << (TOP - b) : base >> (b + 1));
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
    stages<LOGN, C, INV, P, k + 1>(a, j, base, w, ws, q);
  }
}

// Where a transform's first pass finds its words and its last pass leaves
// them (run's IN and OUT), so that a kernel can chain transforms:
//   GLOBAL  in: x at the first pass's map (the inverse reduces it from
//           [0, 2q) to [0, q)); out: y at the last pass's map;
//   REGS    in: a[] already holds the first pass's words (in its range:
//           < 4q forward, < q inverse); out: a[] keeps the last pass's
//           words, canonical, for the caller's epilogue;
//   SHARED  in: sh at the first pass's slots, written by the caller before
//           a barrier (C = 1 only).
// An inverse ends in forward pass 0's map, where a forward begins: an
// INTT, an elementwise step on a[] and an NTT chain with no exchange and
// no barrier between the transforms (the NTT's first exchange writes the
// slots the INTT's last pass read, by the same thread).
enum End : int { GLOBAL, REGS, SHARED };

// Pass K of the direction's order (forward pass P), then the next pass.
// The first pass reads x, the last writes y (IN, OUT = GLOBAL): in forward
// pass 0, i = J + T r (a coalesced word a lane), in the last forward pass
// adjacent pairs (one coalesced 16-byte access a lane when vec).
// FIRST_CROSS: the transform's cross exchange is the kernel's first, so it
// waits on the barrier every CTA arrived at when it started; a later one
// follows an earlier cross exchange's barrier, which every CTA passed after
// its last read of the buffer this one writes (the caller alternates sh).
template <int LOGN, int C, bool INV, int K, End IN = GLOBAL, End OUT = GLOBAL,
          bool FIRST_CROSS = true>
__device__ __forceinline__ void run(u64 (&a)[Geometry<LOGN, C>::R], u64* sh, int j,
                                    const u64* __restrict__ x, u64* __restrict__ y,
                                    const u64* __restrict__ w, const u64* __restrict__ ws, u64 q,
                                    bool vec) {
  using G = Geometry<LOGN, C>;
  constexpr int LAST = G::PASSES - 1, P = INV ? LAST - K : K, R = G::R;
  constexpr bool PAIRS = R > 1 && G::regbit(P, 0) == 0;
  static_assert(IN != SHARED || C == 1, "a cluster's first pass reads registers or x");
  const int base = G::base(P, j);
  if constexpr (K == 0 && IN == GLOBAL) {
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
  } else if constexpr (K > 0 || IN == SHARED) {
    // the inverse's last pass reads the cross exchange's own buffer
    const u64* src = (INV && C > 1 && P == 0) ? sh + G::WORDS : sh;
    from_shared<LOGN, C, P>(src, G::slot_of(P, base), a);
  }
  stages<LOGN, C, INV, P>(a, j, base, w, ws, q);
  if constexpr (K < LAST) {
    constexpr int PN = INV ? P - 1 : P + 1;
    if constexpr (C > 1 && P + PN == 1) {  // the cross exchange
      u64* dst = INV ? sh + G::WORDS : sh;
      if constexpr (FIRST_CROSS) cluster_wait();  // every CTA of the cluster runs
      to_cluster<LOGN, C, P, PN>((unsigned)__cvta_generic_to_shared(dst), G::slot_of(PN, base), a);
      cluster_arrive();
      cluster_wait();
    } else {
      to_shared<LOGN, C, P, PN>(sh, G::slot_of(PN, base), a);
      __syncthreads();
    }
    run<LOGN, C, INV, K + 1, IN, OUT, FIRST_CROSS>(a, sh, j, x, y, w, ws, q, vec);
  } else {
    if constexpr (!INV) {  // from [0, 4q) to [0, q); the inverse is canonical
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = condsub(condsub(a[r], 2 * q), q);
    }
    if constexpr (OUT == GLOBAL) {
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
}

// Shared memory of a launch: n words for one CTA a polynomial; n/C a CTA
// in a cluster, twice that inverse (the cross exchange's own buffer).
template <int LOGN, int C, bool INV>
constexpr int smem_bytes() {
  using G = Geometry<LOGN, C>;
  return (int)sizeof(u64) * G::WORDS * (C > 1 && INV ? 2 : 1);
}

// One CTA per (polynomial, modulus), or a cluster of C along x: grid (nb
// C, M), T/C threads, smem_bytes of dynamic shared memory.  x, y: (M, nb,
// n); w, ws: (M, n); qs: (M,).  vec: x and y are 16-byte aligned (pairs
// move as one access).
template <int LOGN, bool INV, int C>
__global__ void __launch_bounds__(Geometry<LOGN, C>::THREADS, Geometry<LOGN, C>::MIN_BLOCKS)
ntt_regs_kernel(const u64* __restrict__ x, u64* __restrict__ y, const u64* __restrict__ w,
                const u64* __restrict__ ws, const u64* __restrict__ qs, int nb, int vec) {
  using G = Geometry<LOGN, C>;
  extern __shared__ u64 sh[];
  int rank = 0;
  if constexpr (C > 1) {
    rank = (int)cluster_rank();
    cluster_arrive_relaxed();  // waited on before the first remote store
  }
  const int m = blockIdx.y;
  const size_t off = ((size_t)m * nb + blockIdx.x / C) << LOGN;
  u64 a[G::R];
  run<LOGN, C, INV, 0>(a, sh, rank * G::THREADS + (int)threadIdx.x, x + off, y + off,
                       w + ((size_t)m << LOGN), ws + ((size_t)m << LOGN), qs[m], vec != 0);
}

}  // namespace ntt_regs
