// rns_torch's limb arithmetic on every limb of a tensor in one launch.
//
// Replaces no TPU kernel: the JAX package left these elementwise stages to
// XLA, which fuses each into one pass (aloha_tpu/he_planes.py:169-210).  The
// plain PyTorch path builds every 64-bit word product from 30-bit limbs, so
// on the card one modular product is about a hundred aten launches over
// int64 tensors and an addition about thirteen.  Here a stage is one
// launch on native u64 words, over every limb of a (..., L, N) tensor, each
// limb under its own modulus.
//
// Ops (template argument), each giving rns_torch's plain word for every
// uint64 pattern: lazy_reduce, addmod and submod through `condsub` (the ALU's
// one-subtract input laziness, modalu.sv:44-46) with wrapping adds and
// subtracts; mulmod and modred through modarith.cuh's `barrett`, the RTL
// chain of modmul.sv:145-232 with its 64-bit cuts; halfmod on the int64
// view's arithmetic shift, as the plain path's `>>`; mulmod_shoup with the
// plain path's 62-bit cuts.
//
// Shape: an operand is an (R, L, N) view, word (r, l, j) at
// p[r sr + l sl + j sn] (a stride of 0 broadcasts, as `pt.expand_as(ct)`
// does over the batch), or, with no pointer, one value a limb.  The output
// is contiguous.  Each thread takes UNROLL units of VEC words a round, a
// round's loads issued before its arithmetic, over a grid of at most
// CTAS_PER_SM CTAs an SM that strides over the units.  VEC = 2, 16-byte
// loads and stores, where N is even and every tensor operand has unit
// stride along N, even strides otherwise and a 16-byte aligned base; 1
// otherwise.  A unit's (r, l, j) come from its flat index by two divisions
// as multiplies (`divide`): the index stays below 2^31.
//
// Bound on the H100: bytes, 8 for each word of a tensor operand read and of
// the output written (a broadcast plaintext is read from L2 after its first
// use).  A mulmod is about 60 INT32 instructions a word, a third of the
// issue rate at the 16-24 bytes a word it moves.
#include <algorithm>

#include "device_once.cuh"
#include "modarith.cuh"

namespace {

constexpr int MAX_LIMBS = 4;  // the three-limb ring's L + 1 moduli
constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int CTAS_PER_SM = 8;  // 2048 threads: a full SM
constexpr unsigned MAX_WORDS = 1u << 31;

enum Op { LAZY_REDUCE, ADDMOD, SUBMOD, MULMOD, MODRED, HALFMOD, MULMOD_SHOUP, OPS };

// Word (r, l, j) of an operand at p[r sr + l sl + j sn]; p null: v[l].
struct Operand {
  const u64* p;
  long long sr, sl, sn;
};

// A launch's parameters as ops/rns_kernel.py packs them: 8-byte fields only,
// so the layout has no padding.
struct Params {
  u64* out;
  Operand x[3];
  u64 q[MAX_LIMBS], iq[MAX_LIMBS], v[3][MAX_LIMBS];
  u64 words;                // R L N
  u64 n, n_magic, n_shift;  // N and its divider
  u64 l, l_magic, l_shift;  // L and its divider
  u64 w;                    // the Barrett width
};
static_assert(sizeof(Params) == 8 * (1 + 3 * 4 + 5 * MAX_LIMBS + 8), "ops/rns_kernel._PARAMS");

// floor(x / d) for x < 2^31, with (magic, shift) from ops/rns_kernel.divider(d).
__device__ __forceinline__ unsigned divide(unsigned x, unsigned magic, unsigned shift) {
  return (__umulhi(x, magic) + x) >> shift;
}

template <int OP>
__host__ __device__ constexpr int operands() {
  return OP == MULMOD_SHOUP ? 3 : OP == ADDMOD || OP == SUBMOD || OP == MULMOD ? 2 : 1;
}

template <int OP>
__device__ __forceinline__ u64 apply(u64 a, u64 b, u64 c, u64 q, u64 iq, int w) {
  if constexpr (OP == LAZY_REDUCE) {
    return condsub(a, q);
  } else if constexpr (OP == ADDMOD) {
    return condsub(condsub(a, q) + condsub(b, q), q);
  } else if constexpr (OP == SUBMOD) {
    return submod(condsub(a, q), condsub(b, q), q);
  } else if constexpr (OP == MULMOD) {
    return barrett(condsub(a, q), condsub(b, q), q, iq, w);
  } else if constexpr (OP == MODRED) {
    return barrett(condsub(a, q), 1, q, iq, w);
  } else if constexpr (OP == HALFMOD) {
    return (u64)((long long)a >> 1) + ((a & 1) ? (q + 1) >> 1 : 0);
  } else {  // x a, w b, its Shoup companion c; the plain path's 62-bit cuts
    constexpr u64 M62 = (1ull << 62) - 1;
    return (a * b - (__umul64hi(a, c) & M62) * q) & M62;
  }
}

template <int VEC>
__device__ __forceinline__ void load(const Operand& x, const u64* v, unsigned r, unsigned l,
                                     unsigned j, u64 (&out)[VEC]) {
  if (!x.p) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = v[l];
    return;
  }
  const u64* src = x.p + (long long)r * x.sr + (long long)l * x.sl + (long long)j * x.sn;
  if constexpr (VEC == 2) {
    const ulonglong2 pair = *reinterpret_cast<const ulonglong2*>(src);
    out[0] = pair.x;
    out[1] = pair.y;
  } else {
    out[0] = *src;
  }
}

template <int OP, int VEC>
__global__ void __launch_bounds__(THREADS) rns_kernel(const __grid_constant__ Params p) {
  constexpr int ARGS = operands<OP>();
  const unsigned units = (unsigned)(p.words / VEC), n = (unsigned)p.n, L = (unsigned)p.l;
  const unsigned step = gridDim.x * (THREADS * UNROLL);
  for (unsigned base = blockIdx.x * (THREADS * UNROLL) + threadIdx.x; base < units;
       base += step) {
    u64 in[UNROLL][3][VEC];
    unsigned limb[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const unsigned u = base + i * THREADS;
      if (u < units) {
        const unsigned e = u * VEC;
        const unsigned row = divide(e, (unsigned)p.n_magic, (unsigned)p.n_shift);
        const unsigned r = divide(row, (unsigned)p.l_magic, (unsigned)p.l_shift);
        limb[i] = row - r * L;
#pragma unroll
        for (int k = 0; k < ARGS; ++k) load<VEC>(p.x[k], p.v[k], r, limb[i], e - row * n, in[i][k]);
      }
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const unsigned u = base + i * THREADS;
      if (u < units) {
        const unsigned l = limb[i];
        u64 y[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          y[k] = apply<OP>(in[i][0][k], ARGS > 1 ? in[i][1][k] : 0, ARGS > 2 ? in[i][2][k] : 0,
                           p.q[l], p.iq[l], (int)p.w);
        if constexpr (VEC == 2) {
          reinterpret_cast<ulonglong2*>(p.out)[u] = make_ulonglong2(y[0], y[1]);
        } else {
          p.out[u] = y[0];
        }
      }
    }
  }
}

template <int OP>
void launch(const Params& p, int vec, unsigned ctas, cudaStream_t st) {
  if (vec == 2)
    rns_kernel<OP, 2><<<ctas, THREADS, 0, st>>>(p);
  else
    rns_kernel<OP, 1><<<ctas, THREADS, 0, st>>>(p);
}

bool valid(const Params& p, int op, int vec) {
  if (op < 0 || op >= OPS || (vec != 1 && vec != 2)) return false;
  if (p.words < 1 || p.words >= MAX_WORDS || p.words % vec || !p.out) return false;
  if (p.l < 1 || p.l > MAX_LIMBS || p.n < 1 || p.words % (p.l * p.n)) return false;
  if ((op == MULMOD || op == MODRED) && (p.w < 3 || p.w > 60)) return false;
  if (vec == 2) {
    if (p.n % 2 || ((size_t)p.out & 15)) return false;
    for (const Operand& x : p.x)
      if (x.p && (x.sn != 1 || x.sr % 2 || x.sl % 2 || ((size_t)x.p & 15))) return false;
  }
  return true;
}

}  // namespace

// op: an Op; vec: 1 or 2 words a unit (2 needs the 16-byte layout above);
// params: a Params as ops/rns_kernel.py packs it.  The output and every
// tensor operand are int64 on `device`.
extern "C" int aloha_rns(int device, int op, int vec, const void* params, void* stream) {
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const Params& p = *static_cast<const Params*>(params);
  if (!valid(p, op, vec)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long units = p.words / vec, per_cta = THREADS * UNROLL;
  const unsigned ctas = (unsigned)std::min<unsigned long long>(
      (units + per_cta - 1) / per_cta, (unsigned long long)sms * CTAS_PER_SM);
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case LAZY_REDUCE: launch<LAZY_REDUCE>(p, vec, ctas, st); break;
    case ADDMOD: launch<ADDMOD>(p, vec, ctas, st); break;
    case SUBMOD: launch<SUBMOD>(p, vec, ctas, st); break;
    case MULMOD: launch<MULMOD>(p, vec, ctas, st); break;
    case MODRED: launch<MODRED>(p, vec, ctas, st); break;
    case HALFMOD: launch<HALFMOD>(p, vec, ctas, st); break;
    default: launch<MULMOD_SHOUP>(p, vec, ctas, st); break;
  }
  return (int)cudaGetLastError();
}
