"""Negacyclic NTT / INTT — the port's NumPy golden model.

The port's own copy of the parts of `aloha_tpu/ntt_np.py` it uses, with
the few lines of `aloha_tpu/rns_np.py` under them.  It stays independent
of the port's PyTorch code, which it checks: the bench's `bitexact` word,
the sharded NTT's dry run and `chip_smoke.py` compare against it.

* Forward NTT: iterative Cooley-Tukey over Z_q[X]/(X^N+1), natural order
  in, bit-reversed order out, twiddles psi^bitrev(m+i) (reference:
  sim/vp/tf_rom_generator/tf_rom_generator.sv:104-118).
* Inverse NTT: Gentleman-Sande with the divide-by-two folded into every
  stage (reference: src/vp/vxu/modalu.sv GS_VVS path, halfred.sv).

Arrays are uint64 with the transform over the last axis.  The products go
through the RTL Barrett chain (reference: src/vp/vxu/modmul.sv:145-232),
exact a*b mod q for inputs below q.
"""

from __future__ import annotations

import functools

import numpy as np

from aloha_tpu_torch.config import MOD_WIDTH, barrett_iq

_M32 = np.uint64(0xFFFFFFFF)


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@functools.lru_cache(maxsize=None)
def bitrev_permutation(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    return np.array([bit_reverse(i, logn) for i in range(n)], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def psi_powers_bitrev(n: int, psi: int, q: int) -> np.ndarray:
    """[psi^bitrev(i, logn) for i in range(n)] as uint64: the twiddle set
    of the reference's tf_rom.* (tf_rom_generator.sv:111,148)."""
    logn = n.bit_length() - 1
    return np.array(
        [pow(psi, bit_reverse(i, logn), q) for i in range(n)], dtype=np.uint64
    )


@functools.lru_cache(maxsize=None)
def ntt_aut_perm(n: int, e: int) -> np.ndarray:
    """NTT-domain automorphism X -> X^e as a gather table: out[k] = in[perm[k]].

    Output slot k holds the evaluation at psi^(2 bitrev(k) + 1); X -> X^e
    relabels evaluation point j to j*e mod 2n, so perm[k] =
    bitrev(((2 bitrev(k) + 1) e mod 2n - 1) / 2)."""
    br = bitrev_permutation(n)
    t = ((2 * br + 1) * e % (2 * n) - 1) // 2
    return br[t].astype(np.int32)


# ------------------------------------------------- modular arithmetic (rns_np)
def _mul_wide(a: np.ndarray, b: np.ndarray):
    """Full 64x64 -> 128-bit product as (hi, lo) uint64, from 32-bit limbs."""
    a0, a1 = a & _M32, a >> np.uint64(32)
    b0, b1 = b & _M32, b >> np.uint64(32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> np.uint64(32)) + (p01 & _M32) + (p10 & _M32)
    lo = (p00 & _M32) | (mid << np.uint64(32))
    hi = p11 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) + (mid >> np.uint64(32))
    return hi, lo


def _lazy_reduce(a, q: int) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint64)
    qe = np.uint64(q)
    return np.where(a >= qe, a - qe, a)


def _mulmod(a, b, q: int, w: int = MOD_WIDTH) -> np.ndarray:
    """a*b mod q for inputs < 2q: one lazy subtract, then the Barrett chain."""
    a, b = _lazy_reduce(a, q), _lazy_reduce(b, q)
    qe, iq = np.uint64(q), np.uint64(barrett_iq(q, w))
    hi, lo = _mul_wide(a, b)
    prod_shift = (lo >> np.uint64(w - 2)) | (hi << np.uint64(64 - (w - 2)))
    mhi, mlo = _mul_wide(prod_shift, iq)
    mid_shift = (mlo >> np.uint64(w + 3)) | (mhi << np.uint64(64 - (w + 3)))
    mask = np.uint64((1 << (w + 1)) - 1)
    diff = (((lo & mask) | np.uint64(1 << (w + 1))) - ((mid_shift * qe) & mask)) & mask
    return np.where(diff >= qe, diff - qe, diff)


def _addmod(a, b, q: int) -> np.ndarray:
    s = _lazy_reduce(a, q) + _lazy_reduce(b, q)
    return np.where(s >= np.uint64(q), s - np.uint64(q), s)


def _submod(a, b, q: int) -> np.ndarray:
    a, b = _lazy_reduce(a, q), _lazy_reduce(b, q)
    return np.where(a >= b, a - b, np.uint64(q) + a - b)


def _halfmod(a, q: int) -> np.ndarray:
    """a/2 mod q: (a >> 1) + (a odd ? (q+1)/2 : 0) (halfred.sv:21-27)."""
    return (a >> np.uint64(1)) + np.where(
        (a & np.uint64(1)).astype(bool), np.uint64((q + 1) >> 1), np.uint64(0)
    )


# ----------------------------------------------------------------- transforms
def ntt(a: np.ndarray, q: int, psi: int) -> np.ndarray:
    """Forward negacyclic NTT over the last axis (natural in, bitrev out)."""
    a = np.asarray(a, dtype=np.uint64)
    n = a.shape[-1]
    psis = psi_powers_bitrev(n, psi, q)
    batch = a.shape[:-1]
    t, m = n, 1
    while m < n:
        t //= 2
        v = a.reshape(batch + (m, 2, t))
        u = v[..., 0, :]
        x = _mulmod(v[..., 1, :], psis[m:2 * m].reshape((m, 1)), q)
        a = np.stack([_addmod(u, x, q), _submod(u, x, q)], axis=-2).reshape(batch + (n,))
        m *= 2
    return a


def intt(a: np.ndarray, q: int, ipsi: int) -> np.ndarray:
    """Inverse negacyclic NTT over the last axis (bitrev in, natural out),
    halving at every Gentleman-Sande stage."""
    a = np.asarray(a, dtype=np.uint64)
    n = a.shape[-1]
    ipsis = psi_powers_bitrev(n, ipsi, q)
    batch = a.shape[:-1]
    t, m = 1, n
    while m > 1:
        h = m // 2
        v = a.reshape(batch + (h, 2, t))
        u, x = v[..., 0, :], v[..., 1, :]
        w = ipsis[h:2 * h].reshape((h, 1))
        s0 = _halfmod(_addmod(u, x, q), q)
        s1 = _halfmod(_mulmod(_submod(u, x, q), w, q), q)
        a = np.stack([s0, s1], axis=-2).reshape(batch + (n,))
        t *= 2
        m = h
    return a
