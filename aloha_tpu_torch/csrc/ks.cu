// The fused hybrid key-switch pair: ks_head and ks_tail.
//
// Replaces the TPU kernels ks_kernel._head_body and ks_kernel._tail_body
// (aloha_tpu/ops/ks_kernel.py:153/229, launched at :478 and :568).  What
// they compute is the reference's 122-instruction keyswitch program
// (sim/vp/isram_file_generator/keyswitch.mem) with the a-part handled
// outside, as a gather in the NTT domain.
//
// Design: both kernels run their transforms as csrc/ntt_regs.cuh's
// register passes (16 words a thread at n >= 512, four stages a pass,
// shared memory only between passes) and chain them in registers.  An
// inverse ends in forward pass 0's map, where a forward begins, so an
// INTT, an elementwise step and an NTT follow one another with no exchange
// and no barrier between them.  ks_head: one CTA per (ciphertext, output
// modulus, digit) loads b_j at the inverse's input map (adjacent pairs),
// runs the INTT, raises in registers and runs the NTT, storing pairs; only
// the automorphism (e != 1, `galois`) scatters the words through shared
// memory once.  ks_tail: one CTA per (ciphertext, part) forms the P-residue
// inner products at the inverse's input map straight from 16-byte pairs
// of the digits and keys (CHUNK registers a round, each round's loads
// issued before its products), runs the INTT, keeps the centred P-part A
// in its own region of shared memory (each thread at its own slots: no
// barrier, and 32 registers fewer than keeping it in registers) and, for
// each limb m, runs the correction's NTT from registers and applies the
// epilogue (the limb's inner product, x P^-1, the rider on part 0) at the
// last pass's pairs.  Nothing but inputs, keys, tables and outputs
// touches HBM.
//
// ks_tail launches of few CTAs at n = 8192 (at most 3/8 of the SMs) split
// each polynomial over a cluster of 4 CTAs that exchange words through
// distributed shared memory once per transform (aloha_ks_cluster); each SM
// then issues a quarter of the chain.  ks_head always runs one CTA a
// polynomial: the launches that run it (96 and 288 CTAs) were slower on a
// cluster.
//
// Bound on Hopper: 64-bit integer issue (the transforms' Shoup
// butterflies), like csrc/ntt.cu, for ks_head; ks_tail also streams its
// digits and keys, about 1.2 MB a CTA at n = 8192 and L = 2 (every CTA
// reads all of its ciphertext's digits and its part's key rows and Shoup
// companions), from L2 in three load phases between its transforms.  The
// serving launches (16-96 CTAs at one CTA a polynomial) are below one
// wave of 132 SMs, so their time is one SM's latency for a CTA's chain,
// and the tail's load phases contend for L2 when 96 CTAs run them at once
// (PERF.md §6).
#include <initializer_list>

#include "device_once.cuh"
#include "ntt_regs.cuh"

extern "C" int aloha_ntt_cluster(int device, int M, int nb, int logn, int inverse);  // csrc/ntt.cu

namespace {

using ntt_regs::End;
using ntt_regs::Geometry;

// Resident CTAs an SM a kernel is compiled for: one CTA a polynomial keeps
// one an SM (128 registers a thread; the serving launches are below a
// wave); ks_tail's cluster of 4 is launched for at most 3/8 of the SMs'
// worth of polynomials (aloha_ks_cluster), so two of its 128-thread CTAs
// an SM suffice, with up to 255 registers a thread: no spill.
constexpr int min_blocks(int C) { return C == 1 ? 1 : 2; }

// A word, or an adjacent pair (i, i + 1) as one 16-byte access when vec.
template <int S>
__device__ __forceinline__ void load(const u64* __restrict__ p, u64 (&v)[2], bool vec) {
  if constexpr (S == 2) {
    if (vec) {
      const ulonglong2 t = __ldg(reinterpret_cast<const ulonglong2*>(p));
      v[0] = t.x;
      v[1] = t.y;
      return;
    }
    v[1] = __ldg(p + 1);
  }
  v[0] = __ldg(p);
}

// Registers a thread's inner products form per round: every load of a
// round issues before its products, and a compiler fence between rounds
// keeps the next round's loads out of the registers the transforms hold
// (at most 128 a thread).  Measured on the H100 (PERF.md §6): 4 beat 8 and
// 16 (no rounds), and issuing both digits' loads of a round at once was
// slower.
constexpr int CHUNK = 4;

// A fence the compiler moves no memory access across.
__device__ __forceinline__ void fence() { asm volatile("" ::: "memory"); }

// acc[r] = sum_j x_j[i] k_j[i] mod q for the registers r0 <= r < r0 + CH
// of the last forward pass's map (the inverse's input map: adjacent pairs),
// i = base | off(LAST, r).  x: digit 0's row, digits n apart; k, ks: digit
// 0's key row and its Shoup companions, digits 2n apart.  Shoup products
// for prepared keys, the RTL Barrett chain otherwise: both exact, so the
// words agree.
template <int LOGN, int C, bool SHOUP>
__device__ __forceinline__ void inner(u64 (&acc)[Geometry<LOGN, C>::R], int r0,
                                      const u64* __restrict__ x, const u64* __restrict__ k,
                                      const u64* __restrict__ ks, int base, int L, u64 q, u64 iq,
                                      int w, bool vec) {
  using G = Geometry<LOGN, C>;
  constexpr int R = G::R, S = R > 1 ? 2 : 1, CH = ntt_regs::imin(CHUNK, R);
  constexpr int LAST = G::PASSES - 1;
#pragma unroll
  for (int t = 0; t < CH; ++t) acc[r0 + t] = 0;
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int t = 0; t < CH; t += S) {
      const int r = r0 + t, i = base | G::off(LAST, r);
      u64 xv[2], kv[2], sv[2];
      load<S>(x + i, xv, vec);
      load<S>(k + i, kv, vec);
      if constexpr (SHOUP) load<S>(ks + i, sv, vec);
#pragma unroll
      for (int h = 0; h < S; ++h) {
        const u64 p = SHOUP ? condsub(shoup_mul(xv[h], kv[h], sv[h], q), q)
                            : barrett(condsub(xv[h], q), condsub(kv[h], q), q, iq, w);
        acc[r + h] = addmod(acc[r + h], p, q);
      }
    }
    x += 1 << LOGN;
    k += 2 << LOGN;
    if constexpr (SHOUP) ks += 2 << LOGN;
  }
}

// One CTA per (ciphertext c, output modulus mm, digit j); grid (nb, L+1, L).
// b: (L, nb, n) canonical NTT-domain b-parts.  out: (L+1, nb, L, n).
// INTT of b_j under q_j -> X -> X^e (e = 1 skips it: the hoisted head) ->
// raise the digit to q_mm -> forward NTT under q_mm.
template <int LOGN>
__global__ void __launch_bounds__(Geometry<LOGN, 1>::THREADS, 1)
ks_head_kernel(const u64* __restrict__ b, u64* __restrict__ out, const u64* __restrict__ fw,
               const u64* __restrict__ fws, const u64* __restrict__ iw,
               const u64* __restrict__ iws, const u64* __restrict__ qs, int L, int nb, int e,
               int vec) {
  using G = Geometry<LOGN, 1>;
  constexpr int n = 1 << LOGN;
  extern __shared__ u64 sh[];
  const int c = blockIdx.x, mm = blockIdx.y, j = blockIdx.z;
  const int J = (int)threadIdx.x;
  const u64 qj = qs[j], qm = qs[mm];
  u64 a[G::R];
  ntt_regs::run<LOGN, 1, true, 0, End::GLOBAL, End::REGS>(
      a, sh, J, b + (((size_t)j * nb + c) << LOGN), nullptr, iw + ((size_t)j << LOGN),
      iws + ((size_t)j << LOGN), qj, vec != 0);
  // The raise: the digit x <= q_j < 2 q_mm, so one conditional subtract is
  // both the JAX raise rules: lazy_reduce when q_mm > q_j and modred (exact
  // x mod q_mm) otherwise.
  u64* dst = out + ((((size_t)mm * nb + c) * L + j) << LOGN);
  const u64* w = fw + ((size_t)mm << LOGN);
  const u64* ws = fws + ((size_t)mm << LOGN);
  if (e == 1) {
#pragma unroll
    for (int r = 0; r < G::R; ++r) a[r] = condsub(a[r], qm);
    ntt_regs::run<LOGN, 1, false, 0, End::REGS, End::GLOBAL>(a, sh, J, nullptr, dst, w, ws, qm,
                                                              vec != 0);
  } else {
    // The automorphism: coefficient i goes to (i e mod 2n) folded into
    // [0, n), negated as the literal q_j - x (0 becomes q_j, reference:
    // src/vp/vxu/vxu_lane.sv:594-598), scattered to its image's slot (a
    // permutation of the slots, not free of bank conflicts), after every
    // thread has read the INTT's last slots.
    __syncthreads();
    const int base = G::base(0, J);
#pragma unroll
    for (int r = 0; r < G::R; ++r) {
      const unsigned i = (unsigned)(base | G::off(0, r));
      const unsigned jj = (i * (unsigned)e) & (2u * n - 1);
      const u64 x = jj >= (unsigned)n ? qj - a[r] : a[r];
      sh[ntt_regs::swz((int)(jj & (n - 1)))] = condsub(x, qm);
    }
    __syncthreads();
    ntt_regs::run<LOGN, 1, false, 0, End::SHARED, End::GLOBAL>(a, sh, J, nullptr, dst, w, ws,
                                                                 qm, vec != 0);
  }
}

// One CTA per (output ciphertext c, part), or a cluster of C along x; grid
// (nb_out C, 2).
// nd: (L+1, nb_in, L, n) raised digits; rider: (L, nb_in, n) NTT-domain
// a-parts; key, kshoup: (K, 2L(L+1), n); out: (L, nb_out, 2, n).
// Ciphertext c reads data block d = c % nb_in and key block c / nper
// (single key: nper = nb_in; batched keys: nb_in / K; shared inputs:
// nb_in with nb_out = K nb_in).
// P-residue inner product -> INTT under P -> + (P-1)/2 mod P; then for each
// limb m: - (P-1)/2 mod q_m -> NTT under q_m -> (c_m - corr) P^-1 mod q_m,
// plus the rider on part 0.
template <int LOGN, int C>
__global__ void __launch_bounds__(Geometry<LOGN, C>::THREADS, min_blocks(C))
ks_tail_kernel(const u64* __restrict__ nd, const u64* __restrict__ rider,
               const u64* __restrict__ key, const u64* __restrict__ kshoup,
               u64* __restrict__ out, const u64* __restrict__ fw, const u64* __restrict__ fws,
               const u64* __restrict__ iw, const u64* __restrict__ iws,
               const u64* __restrict__ qs, const u64* __restrict__ iqs,
               const u64* __restrict__ pinv, int L, int nb_in, int nb_out, int nper, int w,
               int vec) {
  using G = Geometry<LOGN, C>;
  constexpr int R = G::R, S = R > 1 ? 2 : 1, CH = ntt_regs::imin(CHUNK, R);
  extern __shared__ u64 sh[];
  int rank = 0;
  if constexpr (C > 1) {
    rank = (int)ntt_regs::cluster_rank();
    ntt_regs::cluster_arrive_relaxed();  // waited on before the INTT's cross exchange
  }
  const int c = blockIdx.x / C, part = blockIdx.y;
  const int d = c % nb_in;
  const int J = rank * G::THREADS + (int)threadIdx.x;
  const int base = G::base(G::PASSES - 1, J);
  const bool v = vec != 0;
  const size_t kofs = ((size_t)(c / nper) * (2 * L * (L + 1)) + part) << LOGN;
  key += kofs;
  if (kshoup) kshoup += kofs;
  // the digits of ciphertext d under modulus m, and the key rows of m
  auto digits = [&](int m) { return nd + (((size_t)m * nb_in + d) * L << LOGN); };
  auto limb_inner = [&](u64 (&acc)[R], int r0, int m) {
    const size_t row = (size_t)(2 * L * m) << LOGN;
    const u64 q = qs[m], iq = iqs[m];
    if (kshoup)
      inner<LOGN, C, true>(acc, r0, digits(m), key + row, kshoup + row, base, L, q, iq, w, v);
    else
      inner<LOGN, C, false>(acc, r0, digits(m), key + row, nullptr, base, L, q, iq, w, v);
  };
  const u64 P = qs[L];
  const u64 half = (P - 1) / 2;
  u64 a[R];
#pragma unroll
  for (int r0 = 0; r0 < R; r0 += CH) {
    limb_inner(a, r0, L);
    fence();
  }
  ntt_regs::run<LOGN, C, true, 0, End::REGS, End::REGS>(
      a, sh, J, nullptr, nullptr, iw + ((size_t)L << LOGN), iws + ((size_t)L << LOGN), P, v);
  // A, the centred P-part, kept across the limbs in its own region of
  // shared memory, each word at its slot of forward pass 0's map: the
  // thread that writes it reads it back, so no barrier.
  u64* A = sh + (C == 1 ? 1 : 2) * G::WORDS;
  const int sa = G::slot_of(0, G::base(0, J));
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = addmod(a[r], half, P);
  ntt_regs::to_shared<LOGN, C, 0, 0>(A, sa, a);
  for (int m = 0; m < L; ++m) {
    const u64 q = qs[m];
    const u64 hq = condsub(half, q);
    ntt_regs::from_shared<LOGN, C, 0>(A, sa, a);
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = submod(condsub(a[r], q), hq, q);
    // Limb m's exchanges must not overwrite slots limb m-1's last pass may
    // still read.  One CTA: a barrier.  A cluster: the limbs alternate
    // between the two buffers, and limb m's cross exchange writes the
    // other CTAs' buffer only after the barrier of limb m-1's, which every
    // CTA passed after its last read of it (limb m-2's, or the INTT's).
    u64* buf = sh;
    if constexpr (C == 1) {
      if (m) __syncthreads();
    } else if (m & 1) {
      buf = sh + G::WORDS;
    }
    ntt_regs::run<LOGN, C, false, 0, End::REGS, End::REGS, false>(
        a, buf, J, nullptr, nullptr, fw + ((size_t)m << LOGN), fws + ((size_t)m << LOGN), q, v);
    // the epilogue, a round of CH registers at a time
    const u64 pm = pinv[m], iq = iqs[m];
    u64* dst = out + ((((size_t)m * nb_out + c) * 2 + part) << LOGN);
    const u64* rr = rider + (((size_t)m * nb_in + d) << LOGN);
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += CH) {
      u64 cm[R];
      limb_inner(cm, r0, m);
#pragma unroll
      for (int t = 0; t < CH; t += S) {
        const int r = r0 + t, i = base | G::off(G::PASSES - 1, r);
        u64 rv[2] = {0, 0};
        if (part == 0) load<S>(rr + i, rv, v);
        u64 o[2];
#pragma unroll
        for (int h = 0; h < S; ++h) {
          o[h] = barrett(submod(cm[r + h], a[r + h], q), pm, q, iq, w);
          if (part == 0) o[h] = addmod(condsub(rv[h], q), o[h], q);
        }
        if (S == 2 && v)
          *reinterpret_cast<ulonglong2*>(dst + i) = make_ulonglong2(o[0], o[1]);
        else
          for (int h = 0; h < S; ++h) dst[i + h] = o[h];
      }
      fence();
    }
  }
}

// One launch of kernel on grid, C CTAs a cluster along x, with smem bytes
// of dynamic shared memory, the shared-memory attribute set once per
// device (attribute_set: the instance's flags).
template <int C, typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), bool (&attribute_set)[MAX_DEVICES], int device,
                   dim3 grid, int threads, int smem, cudaStream_t stream, Args... args) {
  cudaError_t err = smem_once(kernel, smem, device, attribute_set);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = C;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = C > 1 ? 1 : 0;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, args...)) != cudaSuccess) return err;
  return cudaGetLastError();
}

// The ring whose ks_tail has a cluster instance, of 4 CTAs: n = 8192, the
// serving ring.
constexpr int CLUSTER_LOGN = 13;

template <int LOGN, int C>
cudaError_t head(int device, const u64* b, u64* out, const u64* fw, const u64* fws,
                 const u64* iw, const u64* iws, const u64* qs, int L, int nb, int e, int vec,
                 cudaStream_t stream) {
  static_assert(C == 1, "ks_head runs one CTA a polynomial");
  using G = Geometry<LOGN, 1>;
  static bool attribute_set[MAX_DEVICES];
  return launch<1>(ks_head_kernel<LOGN>, attribute_set, device, dim3(nb, L + 1, L),
                   G::THREADS, (int)sizeof(u64) * G::WORDS, stream, b, out, fw, fws, iw, iws,
                   qs, L, nb, e, vec);
}

template <int LOGN, int C>
cudaError_t tail(int device, const u64* nd, const u64* rider, const u64* key,
                 const u64* kshoup, u64* out, const u64* fw, const u64* fws, const u64* iw,
                 const u64* iws, const u64* qs, const u64* iqs, const u64* pinv, int L,
                 int nb_in, int nb_out, int nper, int w, int vec, cudaStream_t stream) {
  using G = Geometry<LOGN, C>;
  static bool attribute_set[MAX_DEVICES];
  // the exchange buffer (a cluster's two) and A's region
  const int smem = (int)sizeof(u64) * G::WORDS * (C == 1 ? 2 : 3);
  return launch<C>(ks_tail_kernel<LOGN, C>, attribute_set, device, dim3(nb_out * C, 2),
                   G::THREADS, smem, stream, nd, rider, key, kshoup, out, fw, fws, iw, iws, qs,
                   iqs, pinv, L, nb_in, nb_out, nper, w, vec);
}

// The instances at one CTA a polynomial, one per length: the cases of a
// switch on logn * 8 + C.
#define ALOHA_KS_ONE_CTA_CASES(FN, ...)                                        \
  case 0 * 8 + 1: return (int)FN<0, 1>(__VA_ARGS__);                          \
  case 1 * 8 + 1: return (int)FN<1, 1>(__VA_ARGS__);                          \
  case 2 * 8 + 1: return (int)FN<2, 1>(__VA_ARGS__);                          \
  case 3 * 8 + 1: return (int)FN<3, 1>(__VA_ARGS__);                          \
  case 4 * 8 + 1: return (int)FN<4, 1>(__VA_ARGS__);                          \
  case 5 * 8 + 1: return (int)FN<5, 1>(__VA_ARGS__);                          \
  case 6 * 8 + 1: return (int)FN<6, 1>(__VA_ARGS__);                          \
  case 7 * 8 + 1: return (int)FN<7, 1>(__VA_ARGS__);                          \
  case 8 * 8 + 1: return (int)FN<8, 1>(__VA_ARGS__);                          \
  case 9 * 8 + 1: return (int)FN<9, 1>(__VA_ARGS__);                          \
  case 10 * 8 + 1: return (int)FN<10, 1>(__VA_ARGS__);                        \
  case 11 * 8 + 1: return (int)FN<11, 1>(__VA_ARGS__);                        \
  case 12 * 8 + 1: return (int)FN<12, 1>(__VA_ARGS__);                        \
  case 13 * 8 + 1: return (int)FN<13, 1>(__VA_ARGS__);

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if ((size_t)p & 15) return false;
  return true;
}

}  // namespace

// The cluster a ks_tail launch of ctas CTAs (one a polynomial) takes at
// n = 8192: 4 where csrc/ntt.cu's rule takes 4 (aloha_ntt_cluster: while 2
// a polynomial would fill less than three quarters of the SMs), else 1.
// Measured on the H100 (PERF.md §6): the single-key tail at 32 CTAs takes
// two thirds of its C = 1 time at C = 4.  At 96 CTAs the two serving tails
// disagree (C = 4 is 5 % faster over shared inputs, 14 % slower over
// batched keys), so the rule, which sees only the CTA count, keeps C = 1
// there.  1 at other lengths; 0 when the SM count cannot be read.
extern "C" int aloha_ks_cluster(int device, int ctas, int logn) {
  if (logn != CLUSTER_LOGN) return 1;
  const int c = aloha_ntt_cluster(device, 1, ctas, logn, 1);
  return c == 4 ? 4 : c ? 1 : 0;
}

// b: (L, nb, 2^logn), out: (L+1, nb, L, 2^logn) int64, 0 <= logn <= 13;
// fw, fws, iw, iws: (L+1, 2^logn) tables; qs: (L+1,); e: the Galois
// exponent mod 2^(logn+1), 1 for none.
extern "C" int aloha_ks_head(int device, const void* b, void* out, const void* fw,
                             const void* fws, const void* iw, const void* iws, const void* qs,
                             int L, int nb, int logn, int e, void* stream) {
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int vec = aligned16({b, out});
  switch (logn * 8 + 1) {
    ALOHA_KS_ONE_CTA_CASES(head, device, (const u64*)b, (u64*)out, (const u64*)fw,
                           (const u64*)fws, (const u64*)iw, (const u64*)iws, (const u64*)qs, L,
                           nb, e, vec, (cudaStream_t)stream)
    default: return (int)cudaErrorInvalidValue;
  }
}

// aloha_ks_tail on a cluster of `cluster` CTAs a polynomial (1, or 4 at
// n = 8192; 0: aloha_ks_cluster chooses): the card tests and
// probes/ks_timing.py compare the sizes through it.
extern "C" int aloha_ks_tail_c(int device, const void* nd, const void* rider, const void* key,
                               const void* kshoup, void* out, const void* fw, const void* fws,
                               const void* iw, const void* iws, const void* qs,
                               const void* iqs, const void* pinv, int L, int nb_in, int nb_out,
                               int nper, int logn, int w, int cluster, void* stream) {
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int C = cluster ? cluster : aloha_ks_cluster(device, nb_out * 2, logn);
  if (C != 1 && C != 4) return (int)cudaErrorInvalidValue;
  const int vec = aligned16({nd, rider, key, kshoup, out});
  switch (logn * 8 + C) {
    ALOHA_KS_ONE_CTA_CASES(tail, device, (const u64*)nd, (const u64*)rider, (const u64*)key,
                           (const u64*)kshoup, (u64*)out, (const u64*)fw, (const u64*)fws,
                           (const u64*)iw, (const u64*)iws, (const u64*)qs, (const u64*)iqs,
                           (const u64*)pinv, L, nb_in, nb_out, nper, w, vec,
                           (cudaStream_t)stream)
    case CLUSTER_LOGN * 8 + 4:
      return (int)tail<CLUSTER_LOGN, 4>(
          device, (const u64*)nd, (const u64*)rider, (const u64*)key, (const u64*)kshoup,
          (u64*)out, (const u64*)fw, (const u64*)fws, (const u64*)iw, (const u64*)iws,
          (const u64*)qs, (const u64*)iqs, (const u64*)pinv, L, nb_in, nb_out, nper, w, vec,
          (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// nd: (L+1, nb_in, L, 2^logn); rider: (L, nb_in, 2^logn); key, kshoup (or
// null): (K, 2L(L+1), 2^logn); out: (L, nb_out, 2, 2^logn); iqs: Barrett
// reciprocals; pinv: P^-1 mod q_m; w: the moduli's bit width.
extern "C" int aloha_ks_tail(int device, const void* nd, const void* rider, const void* key,
                             const void* kshoup, void* out, const void* fw, const void* fws,
                             const void* iw, const void* iws, const void* qs, const void* iqs,
                             const void* pinv, int L, int nb_in, int nb_out, int nper, int logn,
                             int w, void* stream) {
  return aloha_ks_tail_c(device, nd, rider, key, kshoup, out, fw, fws, iw, iws, qs, iqs, pinv,
                         L, nb_in, nb_out, nper, logn, w, 0, stream);
}
