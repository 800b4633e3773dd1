"""rns_torch's limb arithmetic on the card: one launch of `csrc/rns.cu` a stage.

Replaces no TPU kernel: the JAX package's elementwise stages were XLA,
which fuses each into one pass (aloha_tpu/he_planes.py:169-210), while
`rns_torch`'s plain path forms each 64-bit product from 30-bit limbs in
aten ops (~100 launches a modular product on the card).  Here an op of
`rns_torch` over a whole tensor is one launch on native u64 words, every
limb of the axis -2 under its own modulus, with the plain path's word for
every uint64 pattern.

`elementwise` takes what `rns_torch`'s entry points take on the card: one
modulus over tensors of any broadcastable shapes, or a tuple of moduli,
one a limb of the axis -2, with tensor operands or a tuple of values a limb
(no `torch.full_like` is made).  Each tensor operand goes in as an
(R, L, N) view with its own strides, so a plaintext expanded over the batch
(stride 0) is read without a copy; only leading axes that do not collapse
to one stride are copied.  The output is contiguous.

Bound on the H100: bytes (each word of a tensor operand read, each output
word written once).
"""

from __future__ import annotations

import functools
import struct

import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch.config import MOD_WIDTH, barrett_iq
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.profiling import span

#: op -> (the kernel's `Op`, its operand count)
OPS = {"lazy_reduce": (0, 1), "addmod": (1, 2), "submod": (2, 2), "mulmod": (3, 2),
       "modred": (4, 1), "halfmod": (5, 1), "mulmod_shoup": (6, 3)}
MAX_LIMBS = 4  # the three-limb ring's L + 1 moduli
MAX_WORDS = 1 << 31  # the kernel's 32-bit word index
_U64 = (1 << 64) - 1
#: csrc/rns.cu's `Params`: out; (p, sr, sl, sn) of three operands; q, iq and
#: three operands' values a limb; words; N, L with their dividers; w
_PARAMS = struct.Struct("<Q" + "Qqqq" * 3 + "Q" * (5 * MAX_LIMBS) + "Q" * 8)
_NONE = (0, 0, 0, 0)
_ZEROS = (0,) * MAX_LIMBS


def divider(d: int) -> tuple:
    """(magic, shift) for csrc/rns.cu's `divide`: floor(x / d) equals
    (hi32(x * magic) + x) >> shift for every 0 <= x < 2^31, 1 <= d < 2^31
    (the round-up method: 2^shift >= d, magic < 2^32)."""
    shift = (d - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def view(t: torch.Tensor, shape) -> tuple:
    """(tensor, (sr, sl, sn)): t broadcast to shape (..., L, N) and read as
    an (R, L, N) view, its strides in words (0 along an axis of size 1).
    A view of t when its leading axes collapse to one stride, else a
    contiguous copy."""
    if t.shape == shape and t.is_contiguous():
        return t, (shape[-2] * shape[-1], shape[-1], 1)
    t = t.expand(shape)
    lead = [(size, st) for size, st in zip(shape[:-2], t.stride()[:-2]) if size != 1]
    if any(st != size_in * st_in for (_, st), (size_in, st_in) in zip(lead, lead[1:])):
        t = t.contiguous()
        lead = [(size, st) for size, st in zip(shape[:-2], t.stride()[:-2]) if size != 1]
    return t, (lead[-1][1] if lead else 0, t.stride(-2) if shape[-2] != 1 else 0,
               t.stride(-1) if shape[-1] != 1 else 0)


def broadcast_shape(tensors) -> torch.Size:
    """The shape the tensors broadcast to, by NumPy's rules.  Written out:
    `torch.broadcast_shapes` imports sympy at its first call (6 s of a
    process's set-up on the H100 machine's host)."""
    shape = tensors[0].shape
    if all(t.shape == shape for t in tensors[1:]):
        return shape
    ndim = max(t.dim() for t in tensors)
    out = [1] * ndim
    for t in tensors:
        for i, size in enumerate(t.shape, ndim - t.dim()):
            if size != 1:
                if out[i] not in (1, size):
                    raise ValueError(f"shapes {[tuple(t.shape) for t in tensors]} do not broadcast")
                out[i] = size
    return torch.Size(out)


def _limb_axis(t: torch.Tensor) -> torch.Tensor:
    """t (..., N) as (..., 1, N); a 0-d t as (1, 1)."""
    return t.view(1, 1) if t.dim() == 0 else t.unsqueeze(-2)


def elementwise(op: str, q, *operands, w: int = MOD_WIDTH):
    """`rns_torch.<op>` of CUDA int64 tensors in one launch.

    q an int: one modulus for every word; operands are tensors of
    broadcastable shapes or Python ints (one word everywhere).  q a tuple of
    L <= 4 moduli: limb m of the axis -2 under q[m]; operands are tensors
    broadcastable to one shape (..., L, N) or tuples of L values, value m
    for every word of limb m.  `w` is mulmod's Barrett width.  Returns a
    contiguous tensor of the operands' broadcast shape."""
    code, arity = OPS[op]
    if len(operands) != arity:
        raise TypeError(f"{op} takes {arity} operands, got {len(operands)}")
    if isinstance(q, (tuple, list)):
        return _launch_limbs(code, tuple(q), operands, op, w)
    shape = broadcast_shape([x for x in operands if isinstance(x, torch.Tensor)])
    lifted = [_limb_axis(x) if isinstance(x, torch.Tensor) else (x,) for x in operands]
    return _launch_limbs(code, (q,), lifted, op, w).view(shape)


elementwise.launches = 0


def _launch_limbs(code: int, moduli: tuple, operands, op: str, w: int):
    L = len(moduli)
    tensors = [x for x in operands if isinstance(x, torch.Tensor)]
    if not tensors:
        raise TypeError(f"{op}: no tensor operand")
    if not dispatch.use_kernel(*tensors):
        raise ValueError(f"{op}: the kernel takes CUDA tensors")
    for t in tensors:
        if t.dtype != torch.int64:
            raise TypeError(f"{op}: dtype {t.dtype}, expected torch.int64")
    shape = broadcast_shape(tensors)
    if len(shape) < 2 or shape[-2] != L:
        raise ValueError(f"{op}: shape {tuple(shape)} has no limb axis -2 of {L} limbs")
    consts = _limb_consts(moduli, op, w)
    first = tensors[0]
    out = (torch.empty_like(first, memory_format=torch.contiguous_format)
           if first.shape == shape else torch.empty(shape, dtype=torch.int64, device=first.device))
    words = out.numel()
    if not words:
        return out
    if words >= MAX_WORDS:
        raise ValueError(f"{op}: {words} words, at most {MAX_WORDS - 1} a launch")
    n = shape[-1]
    vec = 2 if n % 2 == 0 else 1
    fields, values, keep = [], [], []
    for x in operands:
        if isinstance(x, torch.Tensor):
            t, (sr, sl, sn) = view(x, shape)
            keep.append(t)
            ptr = t.data_ptr()
            if sn != 1 or sr % 2 or sl % 2 or ptr % 16:
                vec = 1
            fields += (ptr, sr, sl, sn)
            values += _ZEROS
        else:
            if len(x) != L:
                raise ValueError(f"{op}: {len(x)} values for {L} limbs")
            fields += _NONE
            values += _padded([v & _U64 for v in x])
    for _ in range(3 - len(operands)):
        fields += _NONE
        values += _ZEROS
    params = _PARAMS.pack(out.data_ptr(), *fields, *consts, *values, words, *_dims(n, L), w)
    _launch(out.device.index, code, vec, params, dispatch.stream_of(out))
    return out


def _padded(xs) -> tuple:
    return tuple(xs) + (0,) * (MAX_LIMBS - len(xs))


@functools.lru_cache(maxsize=64)
def _limb_consts(moduli: tuple, op: str, w: int) -> tuple:
    """The kernel's q and iq tables, each padded to MAX_LIMBS."""
    if not 1 <= len(moduli) <= MAX_LIMBS:
        raise ValueError(f"{len(moduli)} moduli: one launch takes 1 to {MAX_LIMBS} limbs")
    iq = [0] * len(moduli)
    if op in ("mulmod", "modred"):
        if not 3 <= w <= 60:  # the 64-bit cuts of modarith.cuh's `barrett`
            raise ValueError(f"{op}: Barrett width {w}, the kernel takes 3 to 60")
        iq = [barrett_iq(q, w) for q in moduli]
    return _padded(moduli) + _padded(iq)


@functools.lru_cache(maxsize=64)
def _dims(n: int, L: int) -> tuple:
    """N and L with their dividers, as `Params` holds them."""
    return (n, *divider(n), L, *divider(L))


@span("aloha.kernel.rns")
def _launch(*args):
    _build.check(_build.lib().aloha_rns(*args), "rns")
    elementwise.launches += 1
