// Stage-loop probes of csrc/ntt.cu's forward transform on resident data.
//
// Replaces three TPU kernels, each a body that repeats stage loops on a
// block held in VMEM with no DMA:
//   tools/stream_prof.py:81 (`make_body(mode)`): the 13-stage loop, REPS
//     times, in three modes -> aloha_probe_stage_modes:
//       full       the forward transform (real butterflies, canonical
//                  output), one load, REPS transforms, one store: also the
//                  port of tools/stream_prof3.py:29 (`make(reps)`, REPS
//                  forward transforms; probes/stream_prof3.fwd_reps);
//       rollsonly  the partner exchange and an add, no multiply: the TPU's
//                  six sublane stages (distance 4096 .. 128) and seven lane
//                  stages (32 .. 1, then 32), both words of a pair set to
//                  their sum with the 32-bit halves added separately, as
//                  the TPU body adds its u32 planes;
//       noroll     the butterfly with partner = self, x <- condsub(x, 2q) +
//                  x w_s(i), no exchange;
//   tools/stream_prof2.py:64 (`make_body(mode, nstages)`): nstages lane
//     stages (distance 8192 >> (s mod 7 + 7), twiddle row s mod 13), REPS
//     times, in four modes -> aloha_probe_lane_stages:
//       full    the Harvey butterfly, each word with the twiddle of its own
//               position (the TPU applies its table row elementwise);
//       statT   table row 0 (one twiddle in registers: no table load);
//       statS   the distance fixed at 16 (a compile-time constant);
//       nobfly  exchange and add only, as in rollsonly.
// Twiddle row s of element i is w[2^s + (i >> (13 - s))] of the compact
// forward tables: the TPU's per-element table row s (ntt_pallas._tables_np).
//
// Layouts.
//   aloha_probe_stage_modes: csrc/ntt.cu's geometry (ntt_regs::Geometry<13,
//     1>): one CTA of 512 threads a polynomial, 16 words a thread in
//     registers for the whole launch, one 64 KiB buffer at the swizzled
//     slots ntt_regs::swz(i) to exchange them, one barrier an exchange, and
//     ntt.cu's occupancy (__launch_bounds__(512, 2): two CTAs an SM).  An
//     owner map Map<B0, B1, B2, B3> puts index bit B_k in register bit k
//     and the thread's 9 bits in the other index bits, in increasing order
//     (ntt_regs' pass maps are of this kind).  A word's slot is swz(i) in
//     every map, so a thread writes exactly the slots it read at the
//     exchange before: one barrier an exchange and no race.
//       full: ntt_regs::run itself, so it measures ntt.cu's transform: the
//         first transform reads x (GLOBAL) and keeps its last pass's words
//         in registers (REGS); between transforms each thread writes them
//         to their pass-0 slots (to_shared<13, 1, LAST, 0>: the slots its
//         last pass read), one barrier, and the next transform reads them
//         there (SHARED, as csrc/ks.cu's tail does); the last stores y
//         (GLOBAL).  Each transform ends canonical.  A repetition: 4
//         passes and 4 exchanges, ntt.cu's 3 and the one that chains.
//       rollsonly: the stages' bits (ROLL_SHIFTS) 12 11 10 9 | 8 7 5 |
//         4 3 2 1 | 0 5 in the maps A = Map<9, 10, 11, 12> (ntt.cu's
//         forward pass 0), B = Map<5, 6, 7, 8> (pass 1), C = Map<1, 2, 3,
//         4> (pass 2) and D = Map<0, 5, 11, 12>; a stage pairs two
//         registers of a thread.  4 exchanges a repetition (A -> B -> C ->
//         D -> A), the least for 13 stages over 12 distinct bits in maps
//         of 4 bits.  One load and one store in map A.
//       noroll: no exchange, no shared memory, no barrier: the words stay
//         in Map<0, 2, 3, 4> (a thread's 16 words share index bits 5-12,
//         a pair of adjacent lanes covers a 32-byte sector); stage s's
//         twiddle depends on the bits above 13 - s, so a thread loads one
//         (w, ws) pair for each of its distinct ones once a stage: 1 for
//         s <= 8, then 2, 4, 8 and 8 (31 a repetition).
//   aloha_probe_lane_stages: a lane stage's pairs never leave their aligned
//     128-word group, so 16 lanes of a warp hold one group in registers for
//     the whole launch, 8 words a lane (nb * 32 warps, 4 a CTA).  The
//     distances 64 and 32 pair two registers of a lane for good; before a
//     stage at 16 .. 1 whose bit no register holds, lanes lane and lane ^
//     2^p trade half their words by __shfl_xor_sync, which moves the bit
//     into register bit 0.  Every butterfly is a whole pair in one lane; no
//     shared memory, no barrier.  Its cost per stage is that of
//     register-resident stages and of the trades.
//
// Bound on Hopper: integer issue (INT32 instructions per stage: the work
// the function needs, probes/stream_prof*.NEEDED_OPS; OPS keeps the count
// the stage loop was held to); then, for the stage modes, the exchanges
// (a shared-memory round trip and a barrier each), for the lane stages the
// trades' shuffles (a trade moves half the words, two 32-bit shuffles
// each; one warp shuffle a clock an SM).
#include <climits>

#include "device_once.cuh"
#include "ntt_regs.cuh"

namespace {

constexpr int LOGN = 13;
constexpr int N = 1 << LOGN;

enum StageMode { FULL = 0, ROLLSONLY = 1, NOROLL = 2 };
enum LaneMode { LANE_FULL = 0, STAT_T = 1, STAT_S = 2, NOBFLY = 3 };

// x, its value hidden from the compiler.
__device__ __forceinline__ u64 opaque(u64 x) {
  asm("mov.b64 %0, %0;" : "+l"(x));
  return x;
}

// ---------------------------------------------------------- stage modes
using G = ntt_regs::Geometry<LOGN, 1>;
constexpr int T = G::T, R = G::R, LAST = G::PASSES - 1;
constexpr int SMEM = ntt_regs::smem_bytes<LOGN, 1, false>();
static_assert(T == 512 && R == 16 && SMEM == 64 * 1024, "ntt.cu's geometry at n = 8192");

// Register bit k holds index bit B_k; the thread's bits fill the other
// index bits in increasing order.
template <int B0, int B1, int B2, int B3>
struct Map {
  static constexpr int REG = (1 << B0) | (1 << B1) | (1 << B2) | (1 << B3);
  static_assert(B0 < LOGN && B1 < LOGN && B2 < LOGN && B3 < LOGN && B0 != B1 && B0 != B2 &&
                    B0 != B3 && B1 != B2 && B1 != B3 && B2 != B3,
                "four distinct index bits");
  __host__ __device__ static constexpr int bit(int k) {
    return k == 0 ? B0 : k == 1 ? B1 : k == 2 ? B2 : B3;
  }
  // the register bit holding index bit b (-1: a thread bit)
  __host__ __device__ static constexpr int regbit(int b) {
    return b == B0 ? 0 : b == B1 ? 1 : b == B2 ? 2 : b == B3 ? 3 : -1;
  }
  // the index bits of register r
  __host__ __device__ static constexpr int off(int r) {
    int o = 0;
    for (int k = 0; k < 4; ++k) o |= ((r >> k) & 1) << bit(k);
    return o;
  }
  // the index bits thread j owns
  __host__ __device__ static constexpr int base(int j) {
    int i = 0;
    for (int b = 0, t = 0; b < LOGN; ++b)
      if (!((REG >> b) & 1)) i |= ((j >> t++) & 1) << b;
    return i;
  }
  // every bit swz(base(j)) may hold (swz is XOR-linear)
  __host__ __device__ static constexpr int slot_bits() {
    int m = 0;
    for (int t = 0; t < 9; ++t) m |= ntt_regs::swz(base(1 << t));
    return m;
  }
  // word pairs (i, i + 1) sit in registers r, r + 1: one 16-byte access
  static constexpr bool PAIRS = B0 == 0;
};

// rollsonly's maps (A, B and C are ntt.cu's forward passes 0-2) and noroll's
using MapA = Map<9, 10, 11, 12>;
using MapB = Map<5, 6, 7, 8>;
using MapC = Map<1, 2, 3, 4>;
using MapD = Map<0, 5, 11, 12>;
using MapNoroll = Map<0, 2, 3, 4>;
constexpr int ROLL_EXCHANGES = 4;  // a repetition, the one back to map A included

template <class X, int P>
__host__ __device__ constexpr bool is_pass() {
  for (int j = 0; j < T; ++j)
    if (X::base(j) != G::base(P, j)) return false;
  for (int r = 0; r < R; ++r)
    if (X::off(r) != G::off(P, r)) return false;
  return true;
}
static_assert(is_pass<MapA, 0>() && is_pass<MapB, 1>() && is_pass<MapC, 2>(),
              "maps A, B, C are ntt.cu's forward passes 0, 1, 2");

// Slot of register r in map X for a thread whose base slot is sb: an add
// (folded into the access's offset) where the two share no bit, else an XOR.
template <class X, int r>
__device__ __forceinline__ int slot(int sb) {
  constexpr int c = ntt_regs::swz(X::off(r));
  if constexpr ((c & X::slot_bits()) == 0) return sb + c;
  else return sb ^ c;
}

template <class X, int r = 0>
__device__ __forceinline__ void to_slots(u64* sh, int sb, const u64 (&a)[R]) {
  if constexpr (r < R) {
    sh[slot<X, r>(sb)] = a[r];
    to_slots<X, r + 1>(sh, sb, a);
  }
}

template <class X, int r = 0>
__device__ __forceinline__ void from_slots(const u64* sh, int sb, u64 (&a)[R]) {
  if constexpr (r < R) {
    a[r] = sh[slot<X, r>(sb)];
    from_slots<X, r + 1>(sh, sb, a);
  }
}

// The thread's words from map X to map Y: each to its slot swz(i), one
// barrier, each of map Y's from its slot.  sx, sy: the thread's base slots.
template <class X, class Y>
__device__ __forceinline__ void exchange(u64 (&a)[R], u64* sh, int sx, int sy) {
  to_slots<X>(sh, sx, a);
  __syncthreads();
  from_slots<Y>(sh, sy, a);
}

// One load or store of a thread's words in map X: a coalesced word a lane,
// or, where X holds pairs and vec, one 16-byte access a pair.
template <class X>
__device__ __forceinline__ void load(u64 (&a)[R], const u64* __restrict__ x, int base, bool vec) {
#pragma unroll
  for (int r = 0; r < R; r += 2) {
    const u64* p = x + (base | X::off(r));
    if (X::PAIRS && vec) {
      const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(p);
      a[r] = v.x;
      a[r + 1] = v.y;
    } else {
      a[r] = p[0];
      a[r + 1] = x[base | X::off(r + 1)];
    }
  }
}

template <class X>
__device__ __forceinline__ void store(u64* __restrict__ y, const u64 (&a)[R], int base, bool vec) {
#pragma unroll
  for (int r = 0; r < R; r += 2) {
    u64* p = y + (base | X::off(r));
    if (X::PAIRS && vec) {
      *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(a[r], a[r + 1]);
    } else {
      p[0] = a[r];
      y[base | X::off(r + 1)] = a[r + 1];
    }
  }
}

// rollsonly's stage at index bit B, register bit J of map X: the pairs (r,
// r + 2^J) both take add32x2 of the pair.  The copy is hidden from the
// compiler, so that a later stage's pairs, whose words are then equal two by
// two, are each summed and not merged.
template <class X, int B>
__device__ __forceinline__ void roll_stage(u64 (&a)[R]) {
  constexpr int J = X::regbit(B);
  static_assert(J >= 0, "the stage's bit is a register bit of the map");
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r & (1 << J)) continue;
    const u64 v = add32x2(a[r], a[r | (1 << J)]);
    a[r] = v;
    a[r | (1 << J)] = opaque(v);
  }
}

template <class X, int... Bs>
__device__ __forceinline__ void roll_stages(u64 (&a)[R]) {
  (roll_stage<X, Bs>(a), ...);
}

// noroll's stage S on a thread's words (index bits base | off(r)): x <-
// condsub(x, 2q) + x w[2^S + (i >> (13 - S))].  The twiddle reads the
// register bits at or above 13 - S (the mask M of r); one (w, ws) pair is
// loaded for each of their values g, for the registers r with r & M = g.
template <int S = 0>
__device__ __forceinline__ void noroll_stages(u64 (&a)[R], int base, const u64* __restrict__ w,
                                              const u64* __restrict__ ws, u64 q) {
  using X = MapNoroll;
  if constexpr (S < LOGN) {
    constexpr int SH = LOGN - S;
    constexpr int M = (X::bit(0) >= SH) | (X::bit(1) >= SH) << 1 | (X::bit(2) >= SH) << 2 |
                      (X::bit(3) >= SH) << 3;
    const int t0 = (1 << S) + (base >> SH);
#pragma unroll
    for (int g = 0; g < R; ++g) {
      if (g & ~M) continue;
      const int t = t0 + (X::off(g) >> SH);
      const u64 tw = __ldg(w + t), tws = __ldg(ws + t);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((r & M) != g) continue;
        a[r] = condsub(a[r], 2 * q) + shoup_mul(a[r], tw, tws, q);
      }
    }
    noroll_stages<S + 1>(a, base, w, ws, q);
  }
}

// 0, read anew (volatile) at each repetition and added to the thread index
// and the table pointers: the compiler can then neither hoist a
// repetition's index arithmetic and twiddle loads out of the loop as
// invariants nor derive their addresses from induction variables.  Both
// keep dozens of values live across the loop (a transform's 53 (w, ws)
// pairs a thread, noroll's 31) and spill them at 64 registers; with it a
// repetition loads its twiddles inside the loop, as ntt.cu's transform
// does.  What ptxas still spills of full and noroll at 64 registers is in
// PERF.md (rows 11 and 13).
__device__ int fresh_zero;

__device__ __forceinline__ int read_fresh_zero() {
  return *reinterpret_cast<volatile int*>(&fresh_zero);
}

// One CTA a polynomial, 512 threads of 16 words; dynamic shared memory SMEM
// (full, rollsonly) or none (noroll).  vec: x and y are 16-byte aligned.
template <int MODE>
__global__ void __launch_bounds__(G::THREADS, G::MIN_BLOCKS)
stage_modes_kernel(const u64* __restrict__ x, u64* __restrict__ y, const u64* __restrict__ w,
                   const u64* __restrict__ ws, u64 q, int reps, int vec) {
  extern __shared__ u64 sh[];
  const int j = threadIdx.x;
  x += (size_t)blockIdx.x * N;
  y += (size_t)blockIdx.x * N;
  u64 a[R];
  if constexpr (MODE == FULL) {
    using ntt_regs::GLOBAL, ntt_regs::REGS, ntt_regs::SHARED;
    if (reps == 0) {  // the words as they came, in [0, 4q)
      load<MapA>(a, x, MapA::base(j), false);
      store<MapA>(y, a, MapA::base(j), false);
    } else if (reps == 1) {
      ntt_regs::run<LOGN, 1, false, 0, GLOBAL, GLOBAL>(a, sh, j, x, y, w, ws, q, vec);
    } else {
      ntt_regs::run<LOGN, 1, false, 0, GLOBAL, REGS>(a, sh, j, x, y, w, ws, q, vec);
      for (int r = 2; r < reps; ++r) {
        const int z = read_fresh_zero(), jz = j + z;
        ntt_regs::to_shared<LOGN, 1, LAST, 0>(sh, G::slot_of(0, G::base(LAST, jz)), a);
        __syncthreads();
        ntt_regs::run<LOGN, 1, false, 0, SHARED, REGS>(a, sh, jz, x, y, w + z, ws + z, q, vec);
      }
      ntt_regs::to_shared<LOGN, 1, LAST, 0>(sh, G::slot_of(0, G::base(LAST, j)), a);
      __syncthreads();
      ntt_regs::run<LOGN, 1, false, 0, SHARED, GLOBAL>(a, sh, j, x, y, w, ws, q, vec);
    }
  } else if constexpr (MODE == ROLLSONLY) {
    const int ba = MapA::base(j);
    const int sa = ntt_regs::swz(ba), sb = ntt_regs::swz(MapB::base(j)),
              sc = ntt_regs::swz(MapC::base(j)), sd = ntt_regs::swz(MapD::base(j));
    load<MapA>(a, x, ba, false);
    for (int r = 0; r < reps; ++r) {
      roll_stages<MapA, 12, 11, 10, 9>(a);
      exchange<MapA, MapB>(a, sh, sa, sb);
      roll_stages<MapB, 8, 7, 5>(a);
      exchange<MapB, MapC>(a, sh, sb, sc);
      roll_stages<MapC, 4, 3, 2, 1>(a);
      exchange<MapC, MapD>(a, sh, sc, sd);
      roll_stages<MapD, 0, 5>(a);
      exchange<MapD, MapA>(a, sh, sd, sa);
    }
    store<MapA>(y, a, ba, false);
  } else {
    const int base = MapNoroll::base(j);
    load<MapNoroll>(a, x, base, vec);
    for (int r = 0; r < reps; ++r) {
      const int z = read_fresh_zero();
      noroll_stages(a, base + z, w + z, ws + z, q);
    }
    store<MapNoroll>(y, a, base, vec);
  }
}

template <int MODE>
cudaError_t launch_stage_modes(int device, const u64* x, u64* y, const u64* w, const u64* ws,
                               u64 q, int nb, int reps, cudaStream_t stream) {
  constexpr int smem = MODE == NOROLL ? 0 : SMEM;
  if constexpr (smem > 0) {
    static bool attribute_set[MAX_DEVICES];  // per device: the kernel's shared-memory size
    const cudaError_t err = smem_once(stage_modes_kernel<MODE>, smem, device, attribute_set);
    if (err != cudaSuccess) return err;
  }
  const int vec = !(((size_t)x | (size_t)y) & 15);
  stage_modes_kernel<MODE><<<nb, T, smem, stream>>>(x, y, w, ws, q, reps, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------- lane stages
// The lane kernel's layout.  Stage s pairs words i and i + t with t = 64 >>
// (s mod 7), so no pair leaves its aligned 128-word group: a polynomial is
// N / GROUP independent groups over every stage of every repetition.  A
// group lives in 16 lanes of one warp, 8 words a lane.  Register bits 1
// and 2 of a word (bits 1 and 2 of m in a[m]) are its index bits 5 and 6
// for good; register bit 0 is index bit r0, and the lane bits hold the rest.  A stage at a bit no register bit holds first trades that
// bit's lane bit with register bit 0, so every butterfly pairs two
// registers of one lane, and the words' places are tracked at run time.
constexpr int GROUP = 128;
constexpr int GROUP_BITS = 7;
constexpr int LANE_WORDS = 8;                       // words a lane holds
constexpr int LANE_BITS = 4;                        // index bits a lane's place holds
constexpr int GROUP_LANES = 1 << LANE_BITS;         // lanes a group
constexpr int WARP_GROUPS = 32 / GROUP_LANES;       // groups a warp
constexpr int LANE_WARPS = 4;                       // warps a CTA
static_assert(LANE_WORDS << LANE_BITS == GROUP, "a group is 16 lanes of 8 words");

// Where a lane's words sit in their group (the same in every lane but lane_i).
struct Layout {
  int r0;        // the index bit of register bit 0
  unsigned pos;  // 3 bits an index bit b < LANE_BITS + 1: the lane bit holding it
  int lane_i;    // the lane's part of its words' indices in the group
};

__device__ __forceinline__ u64 shfl_xor64(u64 x, int t) {
  const unsigned lo = __shfl_xor_sync(0xffffffffu, (unsigned)x, t);
  const unsigned hi = __shfl_xor_sync(0xffffffffu, (unsigned)(x >> 32), t);
  return ((u64)hi << 32) | lo;
}

// Index in the group of register m's word.
__device__ __forceinline__ int word_index(const Layout& L, int m) {
  return L.lane_i + ((m & 1) << L.r0) + ((m >> 1) << (LANE_BITS + 1));
}

// Brings index bit b into register bit 0: lanes lane and lane ^ 2^pos(b)
// swap half their words (for each register pair m, m + 1: the lane with
// that bit clear sends m + 1, the other m), and bit r0 takes lane bit pos(b).
__device__ __forceinline__ void trade(u64 (&a)[LANE_WORDS], Layout& L, int lane, int b) {
  const int p = (L.pos >> (3 * b)) & 7;
  const bool upper = (lane >> p) & 1;
#pragma unroll
  for (int m = 0; m < LANE_WORDS; m += 2) {
    const u64 got = shfl_xor64(upper ? a[m] : a[m + 1], 1 << p);
    a[m] = upper ? got : a[m];
    a[m + 1] = upper ? a[m + 1] : got;
  }
  L.lane_i += upper ? (1 << L.r0) - (1 << b) : 0;
  L.pos = (L.pos & ~(7u << (3 * L.r0))) | ((unsigned)p << (3 * L.r0));
  L.r0 = b;
}

// The butterflies of a stage whose bit register bit J holds: pairs m, m +
// 2^J of each lane, twiddle row `row` (UNIFORM: row <= LOGN - 7, where one
// twiddle serves the whole group; above it each word loads its own).
template <int J, bool UNIFORM, int MODE>
__device__ __forceinline__ void butterflies(u64 (&a)[LANE_WORDS], const Layout& L, int gbase,
                                            int row, const u64* __restrict__ w,
                                            const u64* __restrict__ ws, u64 w1, u64 ws1, u64 q) {
  constexpr int D = 1 << J;
  const u64 q2 = 2 * q;
  const int sh = LOGN - row;
  u64 wu = w1, wsu = ws1;
  if (MODE == LANE_FULL || MODE == STAT_S) {
    if (UNIFORM) {
      const int k = (1 << row) + (gbase >> sh);
      wu = __ldg(w + k);
      wsu = __ldg(ws + k);
    }
  }
#pragma unroll
  for (int m = 0; m < LANE_WORDS; ++m) {
    if (m & D) continue;
    if constexpr (MODE == NOBFLY) {
      a[m] = a[m + D] = add32x2(a[m], a[m + D]);
    } else if constexpr (MODE == STAT_T) {  // one product: both words take w[1]
      const u64 x2 = condsub(a[m], q2), y = shoup_mul(a[m + D], w1, ws1, q);
      a[m] = x2 + y;
      a[m + D] = x2 + q2 - y;
    } else {
      u64 wi, wsi, wj, wsj;
      if (UNIFORM) {
        // each word its own product, as the TPU applies its row
        // elementwise: the pair's equal twiddles are not merged
        wi = wu;
        wsi = wsu;
        wj = opaque(wu);
        wsj = opaque(wsu);
      } else {
        const int ki = (1 << row) + ((gbase + word_index(L, m)) >> sh);
        const int kj = (1 << row) + ((gbase + word_index(L, m + D)) >> sh);
        wi = __ldg(w + ki);
        wsi = __ldg(ws + ki);
        wj = __ldg(w + kj);
        wsj = __ldg(ws + kj);
      }
      const u64 x2 = condsub(a[m], q2), v = a[m + D];
      a[m] = x2 + shoup_mul(v, wi, wsi, q);
      a[m + D] = x2 + q2 - shoup_mul(v, wj, wsj, q);
    }
  }
}

// The same, UNIFORM read from the row (a branch uniform across the warp).
template <int J, int MODE>
__device__ __forceinline__ void butterflies(u64 (&a)[LANE_WORDS], const Layout& L, int gbase,
                                            int row, const u64* __restrict__ w,
                                            const u64* __restrict__ ws, u64 w1, u64 ws1, u64 q) {
  if (MODE == LANE_FULL || MODE == STAT_S) {
    if (LOGN - row < GROUP_BITS) {
      butterflies<J, false, MODE>(a, L, gbase, row, w, ws, w1, ws1, q);
      return;
    }
  }
  butterflies<J, true, MODE>(a, L, gbase, row, w, ws, w1, ws1, q);
}

// One lane stage at distance 2^b with twiddle row `row`: bits 5 and 6 sit
// in register bits 1 and 2 for good; any other is traded into register bit
// 0 unless it is there already.  Every branch is uniform across the warp.
template <int MODE>
__device__ __forceinline__ void lane_stage(u64 (&a)[LANE_WORDS], Layout& L, int lane, int b,
                                           int gbase, int row, const u64* __restrict__ w,
                                           const u64* __restrict__ ws, u64 w1, u64 ws1, u64 q) {
  switch (b) {
    case 5: butterflies<1, MODE>(a, L, gbase, row, w, ws, w1, ws1, q); break;
    case 6: butterflies<2, MODE>(a, L, gbase, row, w, ws, w1, ws1, q); break;
    default:
      if (L.r0 != b) trade(a, L, lane, b);
      butterflies<0, MODE>(a, L, gbase, row, w, ws, w1, ws1, q);
  }
}

// One group a 16 lanes: one load, reps x nstages stages in
// registers (stage s at distance 64 >> (s mod 7); statS 16 always), one
// store at the layout the stages left.  No shared memory, no barrier.
template <int MODE>
__global__ void __launch_bounds__(32 * LANE_WARPS)
lane_stages_kernel(const u64* __restrict__ x, u64* __restrict__ y, const u64* __restrict__ w,
                   const u64* __restrict__ ws, u64 q, int groups, int reps, int nstages) {
  const int lane = threadIdx.x % 32;
  const int grp = (blockIdx.x * LANE_WARPS + threadIdx.x / 32) * WARP_GROUPS + lane / GROUP_LANES;
  if (grp >= groups) return;  // whole warps: groups is a multiple of WARP_GROUPS
  const int gbase = grp % (N / GROUP) * GROUP;
  const size_t goff = (size_t)grp * GROUP;
  Layout L{LANE_BITS, 0u, lane % GROUP_LANES};
#pragma unroll
  for (int b = 0; b < LANE_BITS; ++b) L.pos |= (unsigned)b << (3 * b);
  u64 a[LANE_WORDS];
#pragma unroll
  for (int m = 0; m < LANE_WORDS; ++m) a[m] = x[goff + word_index(L, m)];
  const u64 w1 = __ldg(w + 1), ws1 = __ldg(ws + 1);
  for (int r = 0; r < reps; ++r) {
    for (int s = 0, b = GROUP_BITS - 1, row = 0; s < nstages; ++s) {
      lane_stage<MODE>(a, L, lane, MODE == STAT_S ? 4 : b, gbase, row, w, ws, w1, ws1, q);
      b = b == 0 ? GROUP_BITS - 1 : b - 1;
      row = row == LOGN - 1 ? 0 : row + 1;
    }
  }
#pragma unroll
  for (int m = 0; m < LANE_WORDS; ++m) y[goff + word_index(L, m)] = a[m];
}

}  // namespace

// Every entry: x, y (nb, 8192) int64; w, ws the compact forward tables
// (8192,) of q; reps >= 0.

// mode: 0 full, 1 rollsonly, 2 noroll; nb >= 1
extern "C" int aloha_probe_stage_modes(int device, const void* x, void* y, const void* w,
                                       const void* ws, u64 q, int mode, int nb, int reps,
                                       void* stream) {
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (nb < 1 || reps < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const u64 *px = (const u64*)x, *pw = (const u64*)w, *pws = (const u64*)ws;
  u64* py = (u64*)y;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case FULL: return (int)launch_stage_modes<FULL>(device, px, py, pw, pws, q, nb, reps, s);
    case ROLLSONLY:
      return (int)launch_stage_modes<ROLLSONLY>(device, px, py, pw, pws, q, nb, reps, s);
    case NOROLL: return (int)launch_stage_modes<NOROLL>(device, px, py, pw, pws, q, nb, reps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// mode: 0 full, 1 statT, 2 statS, 3 nobfly; nstages >= 0 lane stages per repetition
extern "C" int aloha_probe_lane_stages(int device, const void* x, void* y, const void* w,
                                       const void* ws, u64 q, int mode, int nb, int reps,
                                       int nstages, void* stream) {
  if (nb < 1 || nb > INT_MAX / (N / GROUP)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const u64 *px = (const u64*)x, *pw = (const u64*)w, *pws = (const u64*)ws;
  u64* py = (u64*)y;
  cudaStream_t s = (cudaStream_t)stream;
  const int groups = nb * (N / GROUP);
  const int warps = groups / WARP_GROUPS;
  const int ctas = (warps + LANE_WARPS - 1) / LANE_WARPS;
  constexpr int threads = 32 * LANE_WARPS;
  switch (mode) {
    case LANE_FULL:
      lane_stages_kernel<LANE_FULL><<<ctas, threads, 0, s>>>(px, py, pw, pws, q, groups, reps,
                                                             nstages);
      break;
    case STAT_T:
      lane_stages_kernel<STAT_T><<<ctas, threads, 0, s>>>(px, py, pw, pws, q, groups, reps,
                                                          nstages);
      break;
    case STAT_S:
      lane_stages_kernel<STAT_S><<<ctas, threads, 0, s>>>(px, py, pw, pws, q, groups, reps,
                                                          nstages);
      break;
    case NOBFLY:
      lane_stages_kernel<NOBFLY><<<ctas, threads, 0, s>>>(px, py, pw, pws, q, groups, reps,
                                                          nstages);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
