"""Where a tensor-core transform's time goes on the card (the port of tools/probe_mxu_parts.py).

    python -m aloha_tpu_torch.probes.probe_mxu_parts [full mxu vpu]

Replaces the TPU kernel of tools/probe_mxu_parts.py:123 (`build(variant)`
-> `body` :96, variants from `make_stages` :39-88) with
`aloha_probe_mxu_parts` of `csrc/probe_mxu.cu`: REPS forward transforms of
nb polynomials (8192 words under q0) held in shared memory, each one of

- full: csrc/ntt_mxu.cu's own steps (csrc/mxu_core.cuh), canonical after
  every repetition: `ntt_np.ntt` applied REPS times;
- mxu: the digit splits and both products, the 8 accumulators xor-folded
  to e and stored as u32(e) | u32(e + 1) << 32 after the rows and
  u32(e) | u32(e ^ 3) << 32 after the lanes: no twiddle, no constants;
- vpu: no products: e_j = int32(lo32(x) ^ j) folded with the row bias and
  crow[r], the Shoup product by tw[r][l] (y), e_j = int32(lo32(y) ^
  hi32(y) ^ j) folded with the lane bias and ccol[l], then the final fold.

The TPU's transposes to (R, bp, 128) and back leave every constant at the
same (row, lane) as here.  Where the TPU's 16-bit-limb Shoup quotient is q
too large (about 1 word in 10^5), its vpu word differs from the port's,
whose Shoup is exact; everything else is word for word.

The TPU script chained K separate calls; the port repeats in one launch
(probes/common.py says why).  The marginal over REPS 4 and 12 (the
script's KS) at nb = 256 (its NB) is the time of one transform, and
full against mxu + vpu says whether the products and the integer work
overlap (on the v5e they did not: aloha_tpu/ops/ntt_mxu.py:350-354).

Bound on the H100: the larger of MACS int8 MACs (full, mxu) over 1,979
TOP/s and `OPS[variant]` INT32 instructions over the integer issue peak.
TABLE_BYTES is what each variant pulls through L2 per polynomial per
transform, counted from the warp-block loops (no L2 peak is claimed).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.ops import ntt_mxu
from aloha_tpu_torch.probes import common as C

VARIANTS = ("full", "mxu", "vpu")
REPS = (4, 12)
LANES, NDIG = ntt_mxu.LANES, ntt_mxu.NDIG
R = C.N // LANES
B_ROW, B_LANE = ntt_mxu.bias_bits(NDIG * R), ntt_mxu.bias_bits(NDIG * LANES)
MASK59 = (1 << 59) - 1
DELTA = C.Q - (1 << 59)

#: int8 MACs of one transform: the row product (R x 8R x 128 per digit
#: plane) and the lane product (R x 1024 x 128 per plane)
MACS = NDIG * R * NDIG * R * LANES + NDIG * R * NDIG * LANES * LANES

# INT32 instructions per word, counted from csrc/mxu_core.cuh and
# csrc/probe_mxu.cu in common.py's units (a 64-bit add, shift, compare or
# logical op 2, a 32-bit op 1, a 64-bit low product 4)
_SPLIT = C.ADD64 + NDIG  # the bias xor, one placement per byte
_FOLD59 = (NDIG  # e_j + 2^b
           + 6 * 2 * C.ADD64  # six terms shifted into place and added
           + 2 * C.ADD64  # v1 = lo + (hi << 40)
           + C.ADD64  # v2 = v1 + c
           + 5 * C.ADD64  # vhi: a shift, two compares, two adds
           + 3 * C.ADD64  # a = (vhi << 5) | (v2 >> 59)
           + 3 * C.ADD64 + C.MUL64LO)  # (v2 mod 2^59) + 20q - a delta
_FOLD59_WIDE = _FOLD59 + 2 * C.ADD64  # one more compare and add
_FOLD_FINAL = 3 * C.ADD64 + C.MUL64LO + C.CONDSUB + C.ADD64
_XOR = NDIG - 1 + 1 + 2  # the 7 xors, e + 1 or e ^ 3, the pack
_FAKE = NDIG  # e_j = lo ^ j
#: INT32 instructions of one transform on one polynomial
OPS = {
    "full": C.N * (2 * _SPLIT + 2 * _FOLD59 + C.SHOUP + _FOLD_FINAL),
    "mxu": C.N * (2 * _SPLIT + 2 * _XOR),
    # two folds of fake accumulators, the Shoup product, lo32(y) ^ hi32(y)
    "vpu": C.N * (2 * (_FAKE + _FOLD59_WIDE) + C.SHOUP + 2 + _FOLD_FINAL),
}
# Table bytes per transform from the warp-block loops: the row product's
# (R/16) x 8 blocks each read 8R/32 x 8 uint4 fragments per lane, the lane
# product's (R/32) x 16 blocks 32 x 8 uint2; tw, tws, crow and ccol are
# read once per word where the variant uses them.
_FRAGS = (R // 16) * (LANES // 16) * (NDIG * R // 32) * NDIG * 32 * 16 \
    + (R // 32) * (LANES // 8) * (NDIG * LANES // 32) * NDIG * 32 * 8
_CONSTS = C.N * 8 * 4
TABLE_BYTES = {"full": _FRAGS + _CONSTS, "mxu": _FRAGS, "vpu": _CONSTS}


def data(nb: int, device, seed: int = 0) -> torch.Tensor:
    """(nb, 8192) int64 words below q0 drawn as tools/probe_mxu_parts.py draws them."""
    a = np.random.default_rng(seed).integers(0, C.Q, size=(nb, C.N), dtype=np.uint64)
    return torch.from_numpy(a.view(np.int64)).to(device)


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")


def _tables(device):
    return ntt_mxu.plain_tables(C.N, C.Q, C.PSI, False, torch.device(device))


def _xor_word(e, hi_of):
    """(8, ...) accumulators -> u32(e) | u32(hi_of(e)) << 32, e their xor."""
    x = e[0]
    for j in range(1, NDIG):
        x = x ^ e[j]
    return (x & C.M32) | ((hi_of(x) & C.M32) << 32)


def _fold59_wide(v, b: int, c):
    """The WIDE fold59 of the accumulators int32(v ^ j), j = 0..7, for v
    (...) u32 values: W = (V mod 2^59) + 20 q0 - (V >> 59) delta, mod 2^64,
    with V = sum_j 2^(8j) ((v ^ j) + 2^b mod 2^32) + c exact (< 2^89)."""
    low, high = c & MASK59, c >> 59
    for j in range(NDIG):
        u = ((v ^ j) + (1 << b)) & C.M32
        cut = 59 - 8 * j
        low = low + ((u & ((1 << cut) - 1)) << (8 * j))
        high = high + (u >> cut)
    high = high + (low >> 59)
    low = low & MASK59
    twenty_q = (20 * C.Q + (1 << 63)) % (1 << 64) - (1 << 63)  # 20 q0 mod 2^64, signed
    return low + twenty_q - rt.mul_lo64(high, DELTA)


def _fold_final(w):
    """W < 2^64 -> [0, q0): (W mod 2^59) + q0 - (W >> 59) delta, then a
    conditional subtract."""
    return rt.lazy_reduce((w & MASK59) + C.Q - ((w >> 59) & 31) * DELTA, C.Q)


def _shoup(x, w, ws):
    """csrc/modarith.cuh's shoup_mul on any u64 x: x w - hi(x ws) q0, mod 2^64."""
    return rt.mul_lo64(x, w) - rt.mul_lo64(rt.mul_hi64(x, ws), C.Q)


def _mxu_step(x, tb):
    nb = x.shape[0]
    e = ntt_mxu.row_products(x.reshape(nb, R, LANES), tb.row).to(torch.int64)
    y = _xor_word(e, lambda v: v + 1)
    e = ntt_mxu.lane_products(y, tb.lane).to(torch.int64)
    return _xor_word(e, lambda v: v ^ 3).reshape(nb, C.N)


def _vpu_step(x, tb):
    w = _fold59_wide(x & C.M32, B_ROW, tb.crow.repeat_interleave(LANES))
    y = _shoup(w, tb.tw.reshape(-1), tb.tws.reshape(-1))
    w = _fold59_wide((y ^ (y >> 32)) & C.M32, B_LANE, tb.ccol.repeat(R))
    return _fold_final(w)


def parts_plain(x, variant: str, reps: int):
    """Plain PyTorch version: `reps` repetitions of the variant on x (nb,
    8192) int64."""
    _check_variant(variant)
    if variant == "full":
        return ntt_mxu.chain_plain(x, C.Q, C.PSI, reps, False) if reps else x
    tb = _tables(x.device)
    step = _mxu_step if variant == "mxu" else _vpu_step
    for _ in range(reps):
        x = step(x, tb)
    return x


def parts(x, variant: str, reps: int):
    """`reps` repetitions of the variant on x (nb, 8192) int64 under q0.
    CPU tensors take the plain version, CUDA tensors the kernel."""
    _check_variant(variant)
    C.check_reps(reps)
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (nb >= 1, {C.N})")
    C.check_operand(x, torch.int64, (x.shape[0], C.N), "x")
    if not dispatch.use_kernel(x):
        return parts_plain(x, variant, reps)
    af, tf, tw, tws, crow, ccol, _ = ntt_mxu.kernel_tables(C.N, (C.Q,), (C.PSI,), False,
                                                           x.device)
    y = torch.empty_like(x)
    err = _build.lib().aloha_probe_mxu_parts(
        x.device.index, x.data_ptr(), y.data_ptr(), af.data_ptr(), tf.data_ptr(), tw.data_ptr(),
        tws.data_ptr(), crow.data_ptr(), ccol.data_ptr(), C.Q, VARIANTS.index(variant),
        x.shape[0], reps, dispatch.stream_of(x))
    _build.check(err, "aloha_probe_mxu_parts")
    parts.launches += 1
    return y


parts.launches = 0


def measure(variants, device):
    """[(variant, ns per polynomial per transform, t_lo ms, t_hi ms, spread
    ms)] at nb = C.NB_TIME and REPS."""
    x = data(C.NB_TIME, device)
    return [(v, *C.marginal(lambda r: parts(x, v, r), REPS)) for v in variants]


def main(argv=None):
    chosen = C.names(sys.argv[1:] if argv is None else argv, VARIANTS)
    card = C.require_card()
    for v, ns, t_lo, t_hi, spread in measure(chosen, torch.device("cuda", 0)):
        print(f"{v}: marginal {ns / 1e3:.4f} us/poly ({ns:.1f} ns per transform) "
              f"t({REPS[0]})={t_lo:.4f} ms t({REPS[1]})={t_hi:.4f} ms spread={spread:.4f} ms "
              f"nb={C.NB_TIME} macs/poly={MACS if v != 'vpu' else 0} ops/poly={OPS[v]} "
              f"table_bytes/poly={TABLE_BYTES[v]} ({TABLE_BYTES[v] / ns:.1f} GB/s) on {card}",
              flush=True)


if __name__ == "__main__":
    main()
