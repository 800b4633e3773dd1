"""Negacyclic number-theoretic transforms and Galois automorphisms.

The forward transform maps coefficients a_j of a polynomial in
Z_q[X]/(X^n + 1) to its values at the odd powers of a primitive 2n-th root
psi, in bit-reversed order:

    A[k] = sum_j a_j psi^((2 rev(k) + 1) j)        rev = bit reversal

It is computed by Cooley-Tukey butterflies on the table psi^rev(i); the
inverse by Gentleman-Sande butterflies on psi^-rev(i) and one final product
by n^-1.  Both outputs are canonical, so they are the only words the
definitions allow.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference import zq


@functools.lru_cache(maxsize=None)
def bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    return np.array([int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(n)],
                    dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _powers_bitrev(n: int, root: int, q: int) -> tuple:
    return tuple(pow(root, int(r), q) for r in bitrev(n))


class Transforms:
    """The transforms of one ring on one device, under the moduli given."""

    def __init__(self, n: int, moduli, psi, device, ring: zq.Zq):
        if n & (n - 1) or n < 2:
            raise ValueError(f"ring degree {n}: a power of two required")
        for q, p in zip(moduli, psi):
            zq.check_modulus(q)
            if pow(p, n, q) != q - 1:
                raise ValueError(f"{p} is not a primitive 2n-th root of unity mod {q}")
        self.n, self.zq, self.device = n, ring, torch.device(device)
        self._fwd, self._inv = {}, {}
        for q, p in zip(moduli, psi):
            self._fwd[q] = torch.tensor(_powers_bitrev(n, p, q), dtype=torch.int64,
                                        device=self.device)
            self._inv[q] = torch.tensor(_powers_bitrev(n, pow(p, -1, q), q),
                                        dtype=torch.int64, device=self.device)

    def ntt(self, a, q: int):
        """Forward transform over the last axis: natural in, bit-reversed out."""
        n, w, mul = self.n, self._fwd[q], self.zq.mul
        batch = a.shape[:-1]
        t, m = n, 1
        while m < n:
            t //= 2
            v = a.reshape(batch + (m, 2, t))
            u = v[..., 0, :]
            x = mul(v[..., 1, :], w[m:2 * m, None], q)
            a = torch.stack([zq.add(u, x, q), zq.sub(u, x, q)], dim=-2).reshape(batch + (n,))
            m *= 2
        return a

    def intt(self, a, q: int):
        """Inverse transform over the last axis: bit-reversed in, natural out."""
        n, w, mul = self.n, self._inv[q], self.zq.mul
        batch = a.shape[:-1]
        t, m = 1, n
        while m > 1:
            h = m // 2
            v = a.reshape(batch + (h, 2, t))
            u, x = v[..., 0, :], v[..., 1, :]
            a = torch.stack([zq.add(u, x, q), mul(zq.sub(u, x, q), w[h:2 * h, None], q)],
                            dim=-2).reshape(batch + (n,))
            t *= 2
            m = h
        return mul(a, pow(n, -1, q), q)


@functools.lru_cache(maxsize=None)
def _eval_perm(n: int, e: int) -> np.ndarray:
    """X -> X^e on values in `Transforms.ntt`'s order: the value at
    psi^(2 rev(k) + 1) of p(X^e) is p's value at psi^((2 rev(k) + 1) e)."""
    rev = bitrev(n)
    point = (2 * rev + 1) * e % (2 * n)
    return rev[(point - 1) // 2]


def eval_automorphism(x, e: int):
    """X -> X^e (e odd) on transformed data (..., n): a gather."""
    n = x.shape[-1]
    perm = torch.from_numpy(_eval_perm(n, e % (2 * n))).to(x.device)
    return x.index_select(-1, perm)


def coeff_automorphism(x, e: int, q: int):
    """X -> X^e (e odd) on coefficients (..., n) under q, a coefficient that
    changes sign written as the integer q - x, so that 0 becomes q: the
    digits of the system's rotation are these integers, in [0, q]."""
    n = x.shape[-1]
    j = np.arange(n) * (e % (2 * n)) % (2 * n)
    dst = torch.from_numpy(j % n).to(x.device)
    negate = torch.from_numpy(j >= n).to(x.device)
    out = torch.empty_like(x)
    out[..., dst] = torch.where(negate, q - x, x)
    return out
