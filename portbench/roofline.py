"""The least time the card could take for a request's work: its bytes over the
HBM rate or its integer instructions over the issue rate, whichever is
larger.

The instruction counts of a transform, a modular product and an addition,
and the kernels' table layout, are copied from `chip_smoke.py`'s bound
arithmetic (the instructions of `csrc/modarith.cuh`'s arithmetic, counted
from the code: a 64-bit add, subtract, compare or select is 2, a 64x64-bit
low product 4, `__umul64hi` 8; Barrett products counted as Shoup ones, so
the bound stays a lower bound).  The peaks are in `peaks.json`.
"""

from __future__ import annotations

import json
import pathlib

CT_OPS = 36  # forward butterfly: condsub, Shoup product, add, sub, twiddle index
GS_OPS = 56  # inverse butterfly: addmod + halfmod, u + q - v, Shoup product, condsub, halfmod
MULMOD_OPS = 24  # a Shoup product with its condsub
ELEM_OPS = 6  # one add, subtract or condsub mod q
WORD = 8  # bytes of a residue
TABLE_WORD = 16  # bytes of a twiddle with its Shoup companion

PEAKS = pathlib.Path(__file__).resolve().parent / "peaks.json"


def peaks() -> dict:
    return json.loads(PEAKS.read_text())


def transform_ops(n: int, inverse: bool) -> int:
    """INT32 instructions of one length-n transform."""
    logn = n.bit_length() - 1
    return n // 2 * logn * (GS_OPS if inverse else CT_OPS) + n * ELEM_OPS * (1 if inverse else 2)


def head_ops(n: int, L: int) -> int:
    """A key-switch's digits of one ciphertext: L inverse transforms, the
    raise to L + 1 moduli, L (L + 1) forward transforms."""
    return L * transform_ops(n, True) + L * (L + 1) * transform_ops(n, False) + L * (L + 2) * n * ELEM_OPS


def tail_ops(n: int, L: int) -> int:
    """A key-switch's inner products and mod-down for one output ciphertext."""
    return (2 * (L + 1) * L * n * (MULMOD_OPS + ELEM_OPS) + 2 * transform_ops(n, True)
            + 2 * L * transform_ops(n, False) + 2 * L * n * (2 * ELEM_OPS + MULMOD_OPS)
            + (L + 2) * n * ELEM_OPS)


def key_bytes(n: int, L: int) -> int:
    return 2 * L * (L + 1) * n * WORD


def bound_s(work: tuple, pk: dict) -> float:
    """work = (bytes, INT32 instructions) -> seconds."""
    nbytes, ops = work
    return max(nbytes / pk["hbm_bytes_per_s"], ops / pk["int32_ops_per_s"])


class Work:
    """Bytes and instructions by kernel family."""

    def __init__(self):
        self.families = {}

    def add(self, family: str, nbytes: int = 0, ops: int = 0) -> None:
        b, o = self.families.get(family, (0, 0))
        self.families[family] = (b + nbytes, o + ops)


def keyswitch(w: Work, n: int, L: int, batch: int, heads: int, tails: int,
              in_cts: int, out_cts: int) -> None:
    """One stage of key-switches on batches of `batch` ciphertexts: `heads`
    digit decompositions and `tails` outputs; its inputs (b for the digits,
    a as the rider) and outputs read and written once."""
    ct = 2 * batch * L * n * WORD
    w.add("ks", (in_cts + out_cts) * ct, batch * (heads * head_ops(n, L) + tails * tail_ops(n, L)))


def rescale(w: Work, n: int, L: int, batch: int) -> None:
    """Division by the last limb: two inverse transforms a ciphertext, its
    lift into the other limbs, 2 (L - 1) forward transforms, the
    subtraction and the product by q^-1."""
    poly = batch * n * WORD
    w.add("ntt", 2 * (2 + 2 * (L - 1)) * poly + L * n * TABLE_WORD,
          2 * batch * transform_ops(n, True) + 2 * batch * (L - 1) * transform_ops(n, False))
    w.add("elementwise", 2 * poly + 2 * (L - 1) * poly,
          2 * batch * n * ELEM_OPS + 2 * batch * (L - 1) * n * ELEM_OPS)
    w.add("elementwise", 3 * 2 * (L - 1) * poly, 2 * batch * (L - 1) * n * (ELEM_OPS + MULMOD_OPS))


def share(trace, family: str):
    """% of the bound that a family's kernels reach in a trace: the bound of
    the traced requests' work over the device time of the family's kernels;
    None where the request needs no such work or no such kernel ran."""
    work, t_us = trace.work.get(family), trace.family_us(family)
    if not work or not t_us:
        return None
    return 100.0 * bound_s(work, trace.peaks) * trace.requests / (t_us * 1e-6)
