"""Batched negacyclic NTT/INTT under M moduli: the CUDA kernel and its plain form.

Replaces the TPU kernels `ntt_stream._stream_body` (single modulus, via
`ntt_planes`/`intt_planes`) and `_stream_body_multi` (via
`ntt_planes_multi`/`intt_planes_multi`), aloha_tpu/ops/ntt_stream.py:630/662.
Both become one kernel, `csrc/ntt.cu`, with the modulus on the grid: M = 1
is the single-modulus form.  Output is canonical [0, q).

Bound on the H100: integer issue and shared memory (13 stages of 64-bit
Shoup butterflies on a polynomial held in shared memory), not HBM; one CTA
per (polynomial, modulus) keeps every stage on chip.
"""

from __future__ import annotations

import torch

from aloha_tpu_torch import _build, ntt_torch
from aloha_tpu_torch.ops import dispatch


def transform_plain(x, qs, roots, inverse: bool):
    """Plain PyTorch version: x (M, nb, n) int64, group m under qs[m] with
    root roots[m] (psi forward, psi^-1 inverse)."""
    fn = ntt_torch.intt if inverse else ntt_torch.ntt
    return torch.stack([fn(x[m], q, r) for m, (q, r) in enumerate(zip(qs, roots))])


def transform(x, qs, roots, inverse: bool):
    """Forward (natural -> bit-reversed) or inverse NTT of x (M, nb, n)
    int64, group m under modulus qs[m].  Forward input entries < 4q,
    inverse < 2q.  CPU tensors take the plain version, CUDA tensors the
    kernel."""
    qs, roots = tuple(qs), tuple(roots)
    M, nb, n = x.shape
    if len(qs) != M or len(roots) != M:
        raise ValueError(f"{M} groups but {len(qs)} moduli, {len(roots)} roots")
    if not dispatch.use_kernel(x):
        return transform_plain(x, qs, roots, inverse)
    dispatch.check(x, (M, nb, n), "x")
    if n & (n - 1) or n > 16384:
        raise ValueError(f"ring degree {n}: a power of two up to 16384 required")
    w, ws, q = ntt_torch.tables(n, qs, roots, x.device)
    y = torch.empty_like(x)
    if nb:
        err = _build.lib().aloha_ntt(
            x.device.index, x.data_ptr(), y.data_ptr(), w.data_ptr(),
            ws.data_ptr(), q.data_ptr(), M, nb, n.bit_length() - 1,
            int(inverse), dispatch.stream_of(x),
        )
        _build.check(err, "ntt")
        transform.launches += 1
    return y


transform.launches = 0
