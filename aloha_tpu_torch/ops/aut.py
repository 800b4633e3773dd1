"""Coefficient-domain automorphism X -> X^e: the CUDA kernel and its plain form.

Replaces the TPU kernel of tools/probe_aut_kernel.py:102 (`kernel`): the
accelerator's `vaut` instruction on one N = 8192 polynomial, with the
RTL's literal `q - x` sign rule (0 becomes q, reference:
src/vp/vxu/vxu_lane.sv:594-598).  The TPU kernel decomposes the
permutation into one-hot f32 matmuls and sublane rolls because Mosaic has
no gather; `csrc/aut.cu` gathers from shared memory instead, one CTA per
polynomial, with the index map computed in the kernel from e^-1 mod 2n.

Bound on the H100: bytes (each word read and written once).  The ISA
replay (`torch_backend`) launches it at nb = 1, where the per-call floor
of a launch, not the bytes, sets its time.
"""

from __future__ import annotations

import torch

from aloha_tpu_torch import _build, ntt_torch
from aloha_tpu_torch.ops import dispatch

MIN_N, MAX_N = 128, 8192


def automorphism_plain(x, step: int, q: int):
    """Plain PyTorch version: `ntt_torch.automorphism` (index_select + where)."""
    return ntt_torch.automorphism(x, step, q)


def automorphism(x, step: int, q: int):
    """X -> X^step over the last axis (length n = 128 ... 8192, a power of
    two) of an int64 tensor, under modulus q, with the literal q - x sign
    rule.  `step` is taken mod 2n and must be odd: for an even exponent the
    map is no bijection.  CPU tensors take the plain version, CUDA tensors
    the kernel."""
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
    flat = x.reshape(-1, n).contiguous()
    nb = flat.shape[0]
    dispatch.check(flat, (nb, n), "x")
    y = torch.empty_like(flat)
    if nb:
        err = _build.lib().aloha_aut(
            x.device.index, flat.data_ptr(), y.data_ptr(), q, pow(step, -1, 2 * n), nb,
            n.bit_length() - 1, dispatch.stream_of(x),
        )
        _build.check(err, "aut")
        automorphism.launches += 1
    return y.reshape(x.shape)


automorphism.launches = 0
