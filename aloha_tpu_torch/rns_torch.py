"""Exact modular arithmetic on int64 tensors (the port of `rns_xla`/`rns_jax`).

Values are int64 tensors with entries below 2^60; moduli, Barrett
reciprocals and constant multipliers are Python ints.  `torch.uint64` has
no add, shift, compare or remainder on the CPU and int64 `*` wraps, so the
exact wide products are formed from 30-bit limbs: any non-negative int64
splits into three limbs below 2^30 (the top one below 2^4 for a u64 bit
pattern), every limb product stays below 2^60, and a column of at most
three of them stays below 2^62, clear of the sign bit.

Every function mirrors `aloha_tpu.rns_np` word for word, including the
RTL Barrett chain (reference: src/vp/vxu/modmul.sv:145-232) and the ALU's
one-subtract input laziness (reference: src/vp/vxu/modalu.sv:44-46).  The
ALU ops (`lazy_reduce`, `addmod`, `submod`, `mulmod`, `modred`) give the
NumPy oracle's word for every uint64 word, as the ISA's DMA can deliver
them: compares are unsigned on the int64 bit view (`uge`), adds and
subtracts wrap mod 2^64 as NumPy's do, and the Barrett chain keeps the
RTL's 64-bit wires.

The ALU entry points (`addmod`, `submod`, `mulmod`, `modred`,
`mulmod_shoup`, `halfmod`) are `aloha.rns.*` spans under a profiler
(`profiling.span`); the helpers they call inside this module open none.
"""

from __future__ import annotations

import torch

from aloha_tpu_torch.config import MOD_WIDTH, barrett_iq
from aloha_tpu_torch.profiling import span

_B = 30
_M = (1 << _B) - 1
_SIGN = -(1 << 63)


def uge(a, b):
    """Unsigned a >= b of uint64 words held as int64 bit views; a Python
    int operand must lie in [0, 2^63).  Biasing both sides by 2^63 (the
    xor with the sign bit) maps unsigned order onto signed order."""
    return (a ^ _SIGN) >= (b ^ _SIGN)


def _limbs(x):
    """Three 30-bit limbs of a Python int or int64 tensor, read as an
    unsigned 64-bit pattern."""
    return [x & _M, (x >> _B) & _M, (x >> 2 * _B) & 0xF]


def _mul(xs, ys):
    """Schoolbook product of limb lists, carries normalised to 30 bits
    (the last limb takes the final carry)."""
    cols = [0] * (len(xs) + len(ys) - 1)
    for i, x in enumerate(xs):
        for j, y in enumerate(ys):
            cols[i + j] = cols[i + j] + x * y
    out, carry = [], 0
    for c in cols:
        c = c + carry
        out.append(c & _M)
        carry = c >> _B
    out.append(carry)
    return out


def _bits(limbs, lo: int, width: int):
    """Bits [lo, lo + width) of a normalised limb list, width <= 64 (a
    64-bit field comes back as its int64 bit view).

    The limbs occupy disjoint bit fields, so their shifted pieces add
    without carries."""
    out = 0
    for k, v in enumerate(limbs):
        pos = _B * k - lo
        if pos >= width:
            break
        if pos < 0:
            out = out + (v >> -pos)
        else:
            out = out + ((v & ((1 << (width - pos)) - 1)) << pos)
    return out if width == 64 else out & ((1 << width) - 1)


def mul_lo64(a, b):
    """Low 64 bits of the product of two uint64 words (int64 bit views or
    Python ints in [0, 2^64)): NumPy's wrapping uint64 multiply."""
    return _bits(_mul(_limbs(a), _limbs(b)), 0, 64)


def mul_hi64(a, b):
    """High 64 bits of the 128-bit product of two uint64 words (`__umul64hi`)."""
    return _bits(_mul(_limbs(a), _limbs(b)), 64, 64)


def lazy_reduce(a, q: int):
    """One conditional subtract x >= q -> x - q (modalu.sv:44-46), unsigned."""
    return torch.where(uge(a, q), a - q, a)


@span("aloha.rns.addmod")
def addmod(a, b, q: int):
    """(a + b) mod q after the ALU's input laziness; inputs < 2q.  Any
    other uint64 words give rns_np.addmod's word (the sum wraps)."""
    s = lazy_reduce(a, q) + lazy_reduce(b, q)
    return torch.where(uge(s, q), s - q, s)


@span("aloha.rns.submod")
def submod(a, b, q: int):
    """(a - b) mod q after the ALU's input laziness; inputs < 2q.  Any
    other uint64 words give rns_np.submod's word (the difference wraps)."""
    a = lazy_reduce(a, q)
    b = lazy_reduce(b, q)
    return torch.where(uge(a, b), a - b, q + a - b)


@span("aloha.rns.halfmod")
def halfmod(a, q: int):
    """a/2 mod q: (a >> 1) + (a odd ? (q+1)/2 : 0) (halfred.sv:21-27)."""
    return (a >> 1) + torch.where((a & 1) == 1, (q + 1) >> 1, 0)


def barrett(a, b, q: int, w: int = MOD_WIDTH):
    """The literal RTL Barrett chain (modmul.sv:145-232) on any uint64 words:

        prod  = a * b                            128-bit
        mid   = (prod >> (w-2))[63:0] * iq,      iq = floor(2^(2w+1) / q)
        estim = (mid >> (w+3))[63:0] * q
        diff  = (prod - estim) mod 2^(w+1)
        res   = diff - q if diff >= q else diff

    Both shifted wires are cut to 64 bits as the RTL (and rns_np._barrett)
    cuts them; for inputs below 2^w the cuts never bite and res = a*b mod q."""
    iq = barrett_iq(q, w)
    prod = _mul(_limbs(a), _limbs(b))
    ps = _bits(prod, w - 2, 64)
    ms = _bits(_mul(_limbs(ps), _limbs(iq)), w + 3, 64)
    est = _bits(_mul(_limbs(ms), _limbs(q)), 0, w + 1)
    mask = (1 << (w + 1)) - 1
    diff = (_bits(prod, 0, w + 1) + (1 << (w + 1)) - est) & mask
    return torch.where(diff >= q, diff - q, diff)


@span("aloha.rns.mulmod")
def mulmod(a, b, q: int, w: int = MOD_WIDTH):
    """Exact a*b mod q for inputs < 2q: lazy reduce, then Barrett (the
    oracle's word for any uint64 inputs)."""
    return barrett(lazy_reduce(a, q), lazy_reduce(b, q), q, w)


@span("aloha.rns.modred")
def modred(a, q: int):
    """`vfqmod`: lazy reduce, then Barrett-multiply by 1; exact for a < 2q."""
    return barrett(lazy_reduce(a, q), torch.ones_like(a), q)


@span("aloha.rns.mulmod_shoup")
def mulmod_shoup(x, w, wshoup, q: int):
    """Shoup multiply x*w mod q, output in [0, 2q) (rns_jax.mulmod_shoup64).

    wshoup = floor(w 2^64 / q): a Python int, or an int64 tensor holding
    the unsigned 64-bit pattern.  x < 2^62:
        t = hi64(x * wshoup);  r = x*w - t*q  (exact, in [0, 2q))"""
    t = _bits(_mul(_limbs(x), _limbs(wshoup)), 64, 62)
    r = _bits(_mul(_limbs(x), _limbs(w)), 0, 62) - _bits(
        _mul(_limbs(t), _limbs(q)), 0, 62
    )
    return r & ((1 << 62) - 1)
