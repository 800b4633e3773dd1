"""Negacyclic NTT/INTT, automorphisms and twiddle tables (the port of `ntt_jax`).

Transform semantics are `aloha_tpu.ntt_np`'s: the forward NTT is
Cooley-Tukey, natural order in, bit-reversed order out, with twiddles
psi^bitrev(m + k); the inverse is Gentleman-Sande, bit-reversed in,
natural out, halving at every stage (the folded n^-1).  Outputs are
canonical [0, q), so any exact butterfly arithmetic gives the same words.

Tables are compact: per modulus and direction the n twiddles
root^bitrev(i) and their Shoup companions floor(w 2^64 / q) (stored as the
u64 bit pattern in int64).  Stage s of the forward transform reads entries
[2^s, 2^(s+1)), stage s of the inverse reads [n/2^(s+1), n/2^s).  The TPU's
per-element (logn, rows, 128) tables existed only for its (8, 128) layout.

The functions here are the plain PyTorch forms; `ops.ntt_stream` puts the
CUDA kernel beside them.  Their butterflies take `rns_torch.plain`, aten
code on either device, so a transform here on the card never reaches
`csrc/rns.cu`.  Under a profiler (`profiling.span`) a table or
gather map built anew is an `aloha.build.*` span, and an NTT-domain
automorphism an `aloha.gather.ntt_domain_aut` span.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aloha_tpu_torch import ntt_np
from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.profiling import span


@functools.lru_cache(maxsize=None)
@span("aloha.build.twiddles_np")
def twiddles_np(n: int, root: int, q: int):
    """(w, wshoup) uint64 arrays of length n: root^bitrev(i) mod q and
    floor(w 2^64 / q)."""
    w = ntt_np.psi_powers_bitrev(n, root, q)
    ws = np.array([(int(v) << 64) // q for v in w], dtype=np.uint64)
    return w, ws


@functools.lru_cache(maxsize=64)
@span("aloha.build.tables")
def tables(n: int, qs: tuple, roots: tuple, device: torch.device):
    """Stacked per-modulus tables on `device`: (w, wshoup) int64 (M, n)
    and the moduli q (M,) int64."""
    per = [twiddles_np(n, r, q) for r, q in zip(roots, qs)]
    w = np.stack([p[0] for p in per]).view(np.int64)
    ws = np.stack([p[1] for p in per]).view(np.int64)
    return (
        torch.from_numpy(w).to(device),
        torch.from_numpy(ws).to(device),
        torch.tensor(qs, dtype=torch.int64, device=device),
    )


@functools.lru_cache(maxsize=64)
def shard_tables(n: int, q: int, root: int, D: int, d: int, inverse: bool,
                 device: torch.device):
    """Shard d's tables when a ring of n coefficients is block-sharded over
    D devices (C = n/D coefficients each): (w, wshoup) int64 (C,) and the
    logD cross-stage twiddles (Python ints).

    The local stages of the global transform are a size-C transform whose
    compact tables are one contiguous run of the global tables per stage:
    forward local stage s reads w_d[2^s + k] = w[2^(logD+s) + d 2^s + k],
    inverse local stage s reads w_d[C/2^(s+1) + k] = w[n/2^(s+1) + d C/2^(s+1) + k].
    In a cross stage every element of a shard takes one twiddle: forward
    stage s (s < logD) w[2^s + (d >> (logD - s))], inverse cross stage s2
    (after the local ones) w[n/2^(logC+s2+1) + (d >> (s2+1))].  D = 1 gives
    the whole ring's tables and no cross stage."""
    if D < 1 or D & (D - 1) or n % D or not 0 <= d < D:
        raise ValueError(f"shard {d} of {D}: D a power of two dividing n={n} required")
    C = n // D
    logD, logC = D.bit_length() - 1, C.bit_length() - 1
    w, ws = twiddles_np(n, root, q)
    idx = np.zeros(C, dtype=np.int64)
    for s in range(logC):
        if inverse:
            span = C >> (s + 1)
            idx[span:2 * span] = (n >> (s + 1)) + d * span + np.arange(span)
        else:
            idx[1 << s:2 << s] = (1 << (logD + s)) + (d << s) + np.arange(1 << s)
    if inverse:
        cross = tuple(int(w[(n >> (logC + s + 1)) + (d >> (s + 1))]) for s in range(logD))
    else:
        cross = tuple(int(w[(1 << s) + (d >> (logD - s))]) for s in range(logD))
    return (
        torch.from_numpy(w[idx].view(np.int64)).to(device),
        torch.from_numpy(ws[idx].view(np.int64)).to(device),
        cross,
    )


def ntt_with_tables(a, w, ws, q: int):
    """Forward negacyclic NTT over the last axis (length C) with caller-
    supplied compact tables w, ws (C,): stage s reads [2^s, 2^(s+1)).
    Canonical output; input entries < 4q (the CUDA kernel's Harvey window)."""
    n = a.shape[-1]
    batch = a.shape[:-1]
    a = a % q
    t, m = n, 1
    while m < n:
        t //= 2
        v = a.reshape(batch + (m, 2, t))
        u = v[..., 0, :]
        x = rt.plain.lazy_reduce(
            rt.plain.mulmod_shoup(
                v[..., 1, :], w[m:2 * m, None], ws[m:2 * m, None], q
            ),
            q,
        )
        a = torch.stack(
            [rt.plain.addmod(u, x, q), rt.plain.submod(u, x, q)], dim=-2
        ).reshape(batch + (n,))
        m *= 2
    return a


def intt_with_tables(a, w, ws, q: int):
    """Inverse negacyclic NTT over the last axis with caller-supplied compact
    tables (stage s reads [C/2^(s+1), C/2^s)), halving per GS stage.
    Input entries < 2q."""
    n = a.shape[-1]
    batch = a.shape[:-1]
    a = rt.plain.lazy_reduce(a, q)
    t, m = 1, n
    while m > 1:
        h = m // 2
        v = a.reshape(batch + (h, 2, t))
        u, x = v[..., 0, :], v[..., 1, :]
        s0 = rt.plain.halfmod(rt.plain.addmod(u, x, q), q)
        d = rt.plain.submod(u, x, q)
        s1 = rt.plain.halfmod(
            rt.plain.lazy_reduce(
                rt.plain.mulmod_shoup(d, w[h:2 * h, None], ws[h:2 * h, None], q), q
            ),
            q,
        )
        a = torch.stack([s0, s1], dim=-2).reshape(batch + (n,))
        t *= 2
        m = h
    return a


def ntt(a, q: int, psi: int):
    """Forward negacyclic NTT over the last axis, canonical output.
    Input entries < 4q."""
    w, ws, _ = tables(a.shape[-1], (q,), (psi,), a.device)
    return ntt_with_tables(a, w[0], ws[0], q)


def intt(a, q: int, ipsi: int):
    """Inverse negacyclic NTT over the last axis.  Input entries < 2q."""
    w, ws, _ = tables(a.shape[-1], (q,), (ipsi,), a.device)
    return intt_with_tables(a, w[0], ws[0], q)


@functools.lru_cache(maxsize=64)
@span("aloha.build.aut_maps")
def _aut_maps(n: int, step: int, device: torch.device):
    """Gather index and sign mask of X -> X^step (coefficient domain):
    out[d] = sign[d] ? q - a[src[d]] : a[src[d]]."""
    i = np.arange(n, dtype=np.int64)
    j = (i * step) % (2 * n)
    src = np.empty(n, dtype=np.int64)
    src[j % n] = i
    neg = np.zeros(n, dtype=bool)
    neg[j % n] = j >= n
    return torch.from_numpy(src).to(device), torch.from_numpy(neg).to(device)


def automorphism(a, step: int, q: int):
    """X -> X^step over the last axis with the RTL sign rule: a negated
    coefficient is written as the literal q - x, so 0 becomes q
    (reference: src/vp/vxu/vxu_lane.sv:594-598)."""
    src, neg = _aut_maps(a.shape[-1], step % (2 * a.shape[-1]), a.device)
    g = a.index_select(-1, src)
    return torch.where(neg, q - g, g)


@functools.lru_cache(maxsize=256)
@span("aloha.build.aut_perm")
def aut_perm(n: int, e: int, device: torch.device):
    """NTT-domain automorphism X -> X^e as a gather index (ntt_np.ntt_aut_perm)."""
    return torch.from_numpy(ntt_np.ntt_aut_perm(n, e).astype(np.int64)).to(
        device
    )


@span("aloha.gather.ntt_domain_aut")
def ntt_domain_aut(x, e: int):
    """Apply X -> X^e to NTT-domain data (..., n): one gather.  Equal word
    for word to NTT(automorphism(INTT(x)))."""
    return x.index_select(-1, aut_perm(x.shape[-1], e, x.device))
