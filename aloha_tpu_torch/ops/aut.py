"""Coefficient-domain automorphism X -> X^e: the CUDA kernel and its plain form.

Replaces the TPU kernel of tools/probe_aut_kernel.py:102 (`kernel`): the
accelerator's `vaut` instruction on one N = 8192 polynomial, with the
RTL's literal `q - x` sign rule (0 becomes q, reference:
src/vp/vxu/vxu_lane.sv:594-598).  The TPU kernel decomposes the
permutation into one-hot f32 matmuls and sublane rolls because Mosaic has
no gather; `csrc/aut.cu` gathers straight from global memory instead,
output-parallel over as many CTAs as the outputs need, two outputs a
thread, with the index map computed in the kernel from e^-1 mod 2n.  It
takes input rows at any stride >= n, so a strided view such as
he_torch's `pair[..., 0, :]` goes in without a copy.

Bound on the H100: bytes (each word read and written once).  The ISA
replay (`torch_backend`) launches it at nb = 1, where the launch's
latency and the wrapper's host time, not the bytes, set its time.
"""

from __future__ import annotations

import torch

from aloha_tpu_torch import _build, ntt_torch
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.profiling import span

MIN_N, MAX_N = 128, 8192


def automorphism_plain(x, step: int, q: int):
    """Plain PyTorch version: `ntt_torch.automorphism` (index_select + where)."""
    return ntt_torch.automorphism(x, step, q)


def rows(x: torch.Tensor) -> tuple:
    """(rows, stride): x (..., n) as nb rows of n words with unit inner
    stride, row r at rows[0] + r * stride, stride >= n.  A view of x when its
    leading axes collapse to one such stride (a contiguous x, or every other
    row as in he_torch's `pair[..., 0, :]`), else a contiguous copy."""
    n = x.shape[-1]
    if x.is_contiguous():  # the ISA's rows: no stride walk on the host
        return x.view(-1, n), n
    lead = [(size, st) for size, st in zip(x.shape[:-1], x.stride()[:-1]) if size != 1]
    if x.stride(-1) == 1 and all(st == st_in * size_in
                                 for (_, st), (size_in, st_in) in zip(lead, lead[1:])):
        stride = lead[-1][1] if lead else n
        if stride >= n:
            return x.view(-1, n), stride
    return x.reshape(-1, n).contiguous(), n


def automorphism(x, step: int, q: int):
    """X -> X^step over the last axis (length n = 128 ... 8192, a power of
    two) of an int64 tensor, under modulus q, with the literal q - x sign
    rule.  `step` is taken mod 2n and must be odd: for an even exponent the
    map is no bijection.  CPU tensors take the plain version, CUDA tensors
    the kernel; the output is contiguous."""
    n = x.shape[-1]
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise ValueError(f"length {n}: a power of two in [{MIN_N}, {MAX_N}] required")
    step %= 2 * n
    if step % 2 == 0:
        raise ValueError(
            f"automorphism exponent {step} (mod 2n = {2 * n}) is even: "
            "X -> X^e is a bijection only for odd e"
        )
    if not dispatch.use_kernel(x):
        return automorphism_plain(x, step, q)
    if x.dtype != torch.int64:
        raise TypeError(f"x: dtype {x.dtype}, expected torch.int64")
    src, stride = rows(x)
    nb = src.shape[0]
    y = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    if nb:
        _launch(
            x.device.index, src.data_ptr(), y.data_ptr(), q, pow(step, -1, 2 * n), nb,
            n.bit_length() - 1, stride, dispatch.stream_of(x),
        )
    return y


automorphism.launches = 0


@span("aloha.kernel.aut")
def _launch(*args):
    _build.check(_build.lib().aloha_aut(*args), "aut")
    automorphism.launches += 1
