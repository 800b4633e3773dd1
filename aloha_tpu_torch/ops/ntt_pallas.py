"""Negacyclic NTT/INTT of one modulus over the last axis: the CUDA kernel and its plain form.

Replaces the TPU grid kernel `ntt_pallas._call` (aloha_tpu/ops/
ntt_pallas.py:378; bodies `_ntt_kernel_body` :248 and `_intt_kernel_body`
:316; wrappers `ntt` :397 and `intt` :402).  The JAX package reaches it
through its per-transform surface (`he_jax.encode_post`, `he_jax.rotate`;
aloha_tpu/ops/dispatch.py:95-123): under impl `pallas`, and for the one-row
ring n = 128 that the stream kernel cannot take.  Here `he_torch.encode`
and `he_torch.rotate_per_transform` call it, one launch per transform.

The kernel is `csrc/ntt.cu` at one modulus (M = 1), launched through
`ntt_stream._launch`: the register passes of `csrc/ntt_regs.cuh`, which
compute the same function (natural order in, bit-reversed out, and back)
at every length this wrapper takes.  It reads the compact tables of
`ntt_torch.tables`; the TPU's per-element (logn, rows, 128) table planes
existed for its tile layout and are not carried over.

Bound on the H100: 64-bit integer issue, not HBM.
"""

from __future__ import annotations

from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch.ops import dispatch, ntt_stream

MIN_N, MAX_N = 128, 8192


def _check(n: int, q: int) -> None:
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise ValueError(f"length {n}: a power of two in [{MIN_N}, {MAX_N}] required")
    if not 1 < q < 1 << 62:  # the forward window [0, 4q) must fit 64 bits
        raise ValueError(f"modulus {q}: 1 < q < 2^62 required")


def ntt_plain(a, q: int, psi: int):
    """Plain PyTorch version of the forward transform: `ntt_torch`'s stage loop."""
    return ntt_torch.ntt(a, q, psi)


def intt_plain(a, q: int, ipsi: int):
    """Plain PyTorch version of the inverse transform."""
    return ntt_torch.intt(a, q, ipsi)


def transform(a, q: int, root: int, inverse: bool):
    """Forward (natural -> bit-reversed, root psi) or inverse (bit-reversed
    -> natural, root psi^-1) negacyclic NTT over the last axis of a
    (..., n) int64 tensor, n a power of two in [128, 8192].  Forward input
    entries < 4q, inverse < 2q; canonical output.  CPU tensors take the
    plain version; CUDA tensors the kernel, one launch (none for an empty
    batch)."""
    n = a.shape[-1]
    _check(n, q)
    if not dispatch.use_kernel(a):
        return (intt_plain if inverse else ntt_plain)(a, q, root)
    x = a.reshape(1, -1, n).contiguous()
    dispatch.check(x, x.shape, "a")
    w, ws, qs = ntt_torch.tables(n, (q,), (root,), x.device)
    y, launched = ntt_stream._launch(x, w, ws, qs, inverse, "ntt_grid")
    transform.launches += launched
    return y.reshape(a.shape)


transform.launches = 0


def ntt(a, q: int, psi: int):
    """Forward negacyclic NTT over the last axis (`ntt_pallas.ntt`)."""
    return transform(a, q, psi, False)


def intt(a, q: int, ipsi: int):
    """Inverse negacyclic NTT over the last axis (`ntt_pallas.intt`)."""
    return transform(a, q, ipsi, True)
