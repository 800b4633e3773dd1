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

The ALU entry points (`lazy_reduce`, `addmod`, `submod`, `mulmod`,
`modred`, `mulmod_shoup`, `halfmod`) route on their tensors' device, as
the `ops/` wrappers do (`dispatch.use_kernel`): CPU tensors take the plain
code here, CUDA tensors one launch of `csrc/rns.cu` (`ops/rns_kernel`),
which gives the same words.  `q` is one modulus, or a tuple of moduli, one
a limb of the axis -2, with each further operand a tensor or a tuple of
values, one a limb: one launch over every limb on the card, a call a limb
stacked back on the CPU (`aloha.pack.per_limb`, or `scalar_per_limb` where
values are given).  Each entry point is an `aloha.rns.*` span under a
profiler (`profiling.span`); the helpers they call inside this module open
none.

`plain` holds the same seven entry points with the plain code on any
device, under the same spans: the port's plain references (`ntt_torch`'s
transforms, the `*_plain` functions of `ops/`, the probes' plain versions)
call those, so that on the card they stay aten code and never reach
`csrc/rns.cu`.
"""

from __future__ import annotations

import types

import torch

from aloha_tpu_torch.config import MOD_WIDTH, barrett_iq
from aloha_tpu_torch.ops import rns_kernel
from aloha_tpu_torch.ops.dispatch import use_kernel
from aloha_tpu_torch.profiling import span

_B = 30
_M = (1 << _B) - 1
_SIGN = -(1 << 63)

#: the layout copies of the CPU's limb-by-limb form: limbs stacked back
_stack_limbs = span("aloha.pack.per_limb")(torch.stack)
_stack_scalar_limbs = span("aloha.pack.scalar_per_limb")(torch.stack)


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


def _on_card(*operands) -> bool:
    """True when the tensor operands lie on one CUDA device, False when on
    the CPU; raises for mixed or other devices (`dispatch.use_kernel`)."""
    return use_kernel(*(x for x in operands if isinstance(x, torch.Tensor)))


def _route(op: str, plain, q, *operands, **kw):
    """One launch of the kernel's op on the card, the plain function on the CPU."""
    if _on_card(*operands):
        return rns_kernel.elementwise(op, q, *operands, **kw)
    return _plain(plain, q, *operands, **kw)


def _plain(fn, q, *operands, **kw):
    """fn(*operands, q) on CPU tensors; for a tuple of moduli, fn on each
    limb m of the axis -2 under q[m] (a tuple operand gives limb m its
    value m, a uint64 word, as a tensor), stacked back."""
    if not isinstance(q, (tuple, list)):
        return fn(*operands, q, **kw)
    tensors = [x for x in operands if isinstance(x, torch.Tensor)]
    shape = rns_kernel.broadcast_shape(tensors)
    first = tensors[0].expand(shape)

    def limb(x, m):
        if isinstance(x, torch.Tensor):
            return x.expand(shape)[..., m, :]
        return torch.full_like(first[..., m, :], (x[m] - _SIGN) % (1 << 64) + _SIGN)

    stack = _stack_limbs if len(tensors) == len(operands) else _stack_scalar_limbs
    return stack([fn(*(limb(x, m) for x in operands), qm, **kw) for m, qm in enumerate(q)],
                 dim=-2)


def _lazy_reduce(a, q: int):
    return torch.where(uge(a, q), a - q, a)


@span("aloha.rns.lazy_reduce")
def lazy_reduce(a, q):
    """One conditional subtract x >= q -> x - q (modalu.sv:44-46), unsigned."""
    return _route("lazy_reduce", _lazy_reduce, q, a)


def _addmod(a, b, q: int):
    s = _lazy_reduce(a, q) + _lazy_reduce(b, q)
    return torch.where(uge(s, q), s - q, s)


@span("aloha.rns.addmod")
def addmod(a, b, q):
    """(a + b) mod q after the ALU's input laziness; inputs < 2q.  Any
    other uint64 words give rns_np.addmod's word (the sum wraps)."""
    return _route("addmod", _addmod, q, a, b)


def _submod(a, b, q: int):
    a = _lazy_reduce(a, q)
    b = _lazy_reduce(b, q)
    return torch.where(uge(a, b), a - b, q + a - b)


@span("aloha.rns.submod")
def submod(a, b, q):
    """(a - b) mod q after the ALU's input laziness; inputs < 2q.  Any
    other uint64 words give rns_np.submod's word (the difference wraps)."""
    return _route("submod", _submod, q, a, b)


def _halfmod(a, q: int):
    return (a >> 1) + torch.where((a & 1) == 1, (q + 1) >> 1, 0)


@span("aloha.rns.halfmod")
def halfmod(a, q):
    """a/2 mod q: (a >> 1) + (a odd ? (q+1)/2 : 0) (halfred.sv:21-27)."""
    return _route("halfmod", _halfmod, q, a)


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


def _mulmod(a, b, q: int, w: int = MOD_WIDTH):
    return barrett(_lazy_reduce(a, q), _lazy_reduce(b, q), q, w)


@span("aloha.rns.mulmod")
def mulmod(a, b, q, w: int = MOD_WIDTH):
    """Exact a*b mod q for inputs < 2q: lazy reduce, then Barrett (the
    oracle's word for any uint64 inputs)."""
    return _route("mulmod", _mulmod, q, a, b, w=w)


def _modred(a, q: int):
    return barrett(_lazy_reduce(a, q), torch.ones_like(a), q)


@span("aloha.rns.modred")
def modred(a, q):
    """`vfqmod`: lazy reduce, then Barrett-multiply by 1; exact for a < 2q."""
    return _route("modred", _modred, q, a)


def _mulmod_shoup(x, w, wshoup, q: int):
    t = _bits(_mul(_limbs(x), _limbs(wshoup)), 64, 62)
    r = _bits(_mul(_limbs(x), _limbs(w)), 0, 62) - _bits(
        _mul(_limbs(t), _limbs(q)), 0, 62
    )
    return r & ((1 << 62) - 1)


@span("aloha.rns.mulmod_shoup")
def mulmod_shoup(x, w, wshoup, q):
    """Shoup multiply x*w mod q, output in [0, 2q) (rns_jax.mulmod_shoup64).

    wshoup = floor(w 2^64 / q): a Python int, or an int64 tensor holding
    the unsigned 64-bit pattern.  x < 2^62:
        t = hi64(x * wshoup);  r = x*w - t*q  (exact, in [0, 2q))"""
    return _route("mulmod_shoup", _mulmod_shoup, q, x, w, wshoup)


def _plain_entry(name: str, body):
    """The entry point `name` on the plain code wherever its tensors lie."""

    def entry(*args, **kw):
        *operands, q = args
        return _plain(body, q, *operands, **kw)

    entry.__name__ = entry.__qualname__ = name
    entry.__doc__ = f"`rns_torch.{name}` on the plain code, on any device."
    return span(f"aloha.rns.{name}")(entry)


#: the entry points on the plain code, on any device (the references' ALU)
plain = types.SimpleNamespace(**{
    name: _plain_entry(name, body) for name, body in (
        ("lazy_reduce", _lazy_reduce), ("addmod", _addmod), ("submod", _submod),
        ("mulmod", _mulmod), ("modred", _modred), ("halfmod", _halfmod),
        ("mulmod_shoup", _mulmod_shoup))
})
