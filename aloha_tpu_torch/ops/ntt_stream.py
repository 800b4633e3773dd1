"""Batched negacyclic NTT/INTT under M moduli: the CUDA kernel and its plain form.

Replaces the TPU kernels `ntt_stream._stream_body` (single modulus, via
`ntt_planes`/`intt_planes`) and `_stream_body_multi` (via
`ntt_planes_multi`/`intt_planes_multi`), aloha_tpu/ops/ntt_stream.py:630/662.
Both become one kernel, `csrc/ntt.cu`, with the modulus on the grid: M = 1
is the single-modulus form.  Output is canonical [0, q).

The same kernel replaces `ntt_stream.ntt_planes_with_tables`
(aloha_tpu/ops/ntt_stream.py:754, `pallas_call` at :775), the per-shard body
of the coefficient-sharded NTT: `transform_with_tables` feeds it the
caller's compact tables of a shard's slice of a larger ring
(`ntt_torch.shard_tables`).  The TPU's per-element (logn, rows, 128) table
planes are not carried over.

Bound on the H100: 64-bit integer issue (Shoup butterflies), not HBM; one
CTA per (polynomial, modulus) keeps every stage on chip.  The kernel runs
`csrc/ntt_regs.cuh`'s register passes: 16 words a thread, four stages a
pass, shared memory only between passes (three exchanges at N = 8192).
Every power-of-two length up to 16384 has its own compiled instance.
Below one wave (nb M CTAs fewer than the card's SMs) the kernel splits each
polynomial over a cluster of 2 or 4 CTAs, from n = 1024 up forward and n =
4096 up inverse, one exchange through distributed shared memory per
transform (`cluster_size`).
"""

from __future__ import annotations

import functools

import torch

from aloha_tpu_torch import _build, ntt_torch
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.profiling import span


def _call(name: str, *args) -> None:
    _build.check(_build.lib().aloha_ntt(*args), name)


#: one launch of csrc/ntt.cu under each wrapper's name, in its `aloha.kernel.*` span
_CALLS = {name: span(f"aloha.kernel.{name}")(_call)
          for name in ("ntt", "ntt_with_tables", "ntt_grid")}


def _launch(x, w, ws, q, inverse: bool, name: str, cluster: int = 0):
    """One launch of csrc/ntt.cu on x (M, nb, n), group m with tables
    w[m], ws[m] (n,) under modulus q[m]: (output, whether it launched).
    The launch is an `aloha.kernel.<name>` span under a profiler.
    cluster 0 lets the kernel choose how many CTAs share a polynomial
    (`cluster_size`); 1, 2 or 4 forces it (the card tests and
    chip_smoke.py's timing; no caller on the main path)."""
    M, nb, n = x.shape
    if n & (n - 1) or n > 16384:
        raise ValueError(f"length {n}: a power of two up to 16384 required")
    y = torch.empty_like(x)
    if nb:
        _CALLS[name](
            name, x.device.index, x.data_ptr(), y.data_ptr(), w.data_ptr(),
            ws.data_ptr(), q.data_ptr(), M, nb, n.bit_length() - 1,
            int(inverse), cluster, dispatch.stream_of(x),
        )
    return y, bool(nb)


def max_cluster(n: int, inverse: bool) -> int:
    """The largest cluster csrc/ntt.cu has an instance for at length n
    (its max_cluster): 2 or 4 CTAs of at least a warp each, forward from n
    = 1024 and inverse from n = 4096; 1 elsewhere."""
    if n < (4096 if inverse else 1024):
        return 1
    return min(4, n // 16 // 32)


def cluster_size(device: torch.device, M: int, nb: int, n: int, inverse: bool) -> int:
    """CTAs per polynomial of a csrc/ntt.cu launch of M x nb length-n
    transforms on a CUDA device: 1 when the nb M CTAs fill the SMs or the
    length has no cluster (`max_cluster`); otherwise 2, or 4 while 2 a
    polynomial would fill less than three quarters of the SMs."""
    c = _build.lib().aloha_ntt_cluster(device.index, M, nb, n.bit_length() - 1, int(inverse))
    if not c:
        raise RuntimeError(f"no cluster size for device {device}")
    return c


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
    w, ws, q = ntt_torch.tables(n, qs, roots, x.device)
    y, launched = _launch(x, w, ws, q, inverse, "ntt")
    transform.launches += launched
    return y


transform.launches = 0


def transform_limbs(x, moduli, roots, inverse: bool):
    """NTT/INTT of x (..., M, N), limb m under moduli[m]: one launch."""
    M, n = x.shape[-2], x.shape[-1]
    batch = x.shape[:-2]
    y = transform(
        x.reshape(-1, M, n).transpose(0, 1).contiguous(), moduli, roots, inverse
    )
    return y.transpose(0, 1).reshape(batch + (M, n))


@functools.lru_cache(maxsize=64)
@span("aloha.build.modulus")
def _modulus(q: int, device: torch.device):
    return torch.tensor([q], dtype=torch.int64, device=device)


def transform_with_tables_plain(x, w, ws, q: int, inverse: bool):
    """Plain PyTorch version: `ntt_torch`'s stage loop fed the same tables."""
    fn = ntt_torch.intt_with_tables if inverse else ntt_torch.ntt_with_tables
    return fn(x, w, ws, q)


def transform_with_tables(x, w, ws, q: int, inverse: bool):
    """Forward or inverse NTT of x (nb, C) int64 under q with caller-supplied
    compact tables w, ws (C,) int64 (`ntt_torch.shard_tables`): a shard's
    local stages of a larger ring, or the whole ring's transform.  Forward
    input entries < 4q, inverse < 2q; canonical output.  CPU tensors take
    the plain version, CUDA tensors the kernel."""
    if not dispatch.use_kernel(x, w, ws):
        return transform_with_tables_plain(x, w, ws, q, inverse)
    nb, n = x.shape
    dispatch.check(x, (nb, n), "x")
    dispatch.check(w, (n,), "w")
    dispatch.check(ws, (n,), "ws")
    y, launched = _launch(x[None], w[None], ws[None], _modulus(q, x.device), inverse,
                          "ntt_with_tables")
    transform_with_tables.launches += launched
    return y[0]


transform_with_tables.launches = 0
