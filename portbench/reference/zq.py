"""Arithmetic modulo word-sized primes on int64 tensors.

Residues are canonical, in [0, q), 2^59 < q < 2^60.  A product a*b mod q splits b
into 30-bit halves, a*b = (a*b1 mod q) * 2^30 + a*b0, so that every product
it forms is of a residue x < 2^60 and a factor y <= 2^30.  Such a product's
quotient by q, Q < 2^31, is estimated in float64: the estimate's relative
error is under 2^-51, so it is off by at most one and x*y - Q'q lies in
[-q, 2q).  That remainder is formed exactly from 30-bit halves of x and q,
each partial product below 2^61, and one correction each way makes it
canonical.  It shares nothing with the program's Barrett and Shoup
products.

`Zq(exact=False)` is the benchmark's control: the same reference with every
modular product taken in float64, whose 53-bit significand is the nearest
precision below the configuration's 60-bit residues.
"""

from __future__ import annotations

import torch

HALF = 30
MASK = (1 << HALF) - 1
#: the moduli whose products' quotients (of a residue and a factor up to
#: 2^30) stay below 2^31
MIN_MODULUS, MAX_MODULUS = (1 << 59) + 1, (1 << 60) - 1


def check_modulus(q: int) -> None:
    if not MIN_MODULUS <= q <= MAX_MODULUS:
        raise ValueError(f"modulus {q} outside (2^59, 2^60)")


def add(a, b, q: int):
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub(a, b, q: int):
    d = a - b
    return torch.where(d < 0, d + q, d)


class Zq:
    """Modular products: exact (the reference) or in float64 (the control)."""

    def __init__(self, exact: bool = True):
        self.exact = exact

    def mul(self, a, b, q: int):
        """a * b mod q for canonical a (a tensor) and b (a tensor that
        broadcasts against a, or a Python int)."""
        if not self.exact:
            return _mul_float64(a, b, q)
        if isinstance(b, int):
            b %= q
        low = _mul_small(a, b & MASK, q)
        if isinstance(b, int) and not b >> HALF:
            return low
        return add(_mul_small(_mul_small(a, b >> HALF, q), 1 << HALF, q), low, q)


def _mul_small(x, y, q: int):
    """x * y mod q for residues x < q and 0 <= y <= 2^30 (a tensor or int)."""
    est = x.double() * (y.double() if isinstance(y, torch.Tensor) else float(y)) / float(q)
    quot = torch.floor(est).long()
    r = (x & MASK) * y - quot * (q & MASK) + ((x >> HALF) * y - quot * (q >> HALF)) * (1 << HALF)
    r = torch.where(r < 0, r + q, r)
    return torch.where(r >= q, r - q, r)


def _mul_float64(a, b, q: int):
    fb = b.double() if isinstance(b, torch.Tensor) else float(b)
    r = torch.remainder(a.double() * fb, float(q))
    return torch.remainder(torch.round(r).long(), q)
