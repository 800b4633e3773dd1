"""Coefficient-sharded NTT/INTT over a `torch.distributed` process group.

The port of `aloha_tpu/parallel/ntt_sharded.py`.  A ring of n = D C
coefficients is block-sharded over the D ranks of a group: rank d holds
coefficients [d C, (d+1) C) of every polynomial of the batch, an (nb, C)
int64 block.  The butterfly partner of element i in a stage of distance t
is i XOR t, so

  * stages with t >= C pair whole blocks: rank d exchanges its block with
    rank d XOR (t/C) (`torch.distributed.batch_isend_irecv`, the JAX form's
    `ppermute`) and keeps the add half (lower rank) or the sub half (upper);
    every element of a shard takes the same twiddle in such a stage;
  * stages with t < C stay on the rank: one launch of the NTT kernel fed
    the shard's slice of the global tables
    (`ops.ntt_stream.transform_with_tables`, the port of TPU kernel
    `ntt_planes_with_tables`).

The JAX package has two forms, a u64 XLA one and the composed plane form
(ppermute stages around the Pallas kernel, ntt_sharded.py:164-258); the
port has no plane split, so only the composed form remains.  The cross
stages are plain PyTorch on the rank's device, as they were XLA outside the
Pallas kernel.  Traffic per transform: log2(D) block exchanges of nb C
words each way.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.ops import ntt_stream
from aloha_tpu_torch.parallel import multihost


def _layout(x, group):
    """(D, d, n) of this rank's (nb, C) block."""
    D, d = dist.get_world_size(group), dist.get_rank(group)
    if x.dim() != 2:
        raise ValueError(f"block of shape {tuple(x.shape)}, expected (nb, C)")
    return D, d, D * x.shape[-1]


def _exchange(x, peer: int, group):
    """Send this rank's block to group rank `peer` and receive its block
    (through host memory where `multihost.staged_on_host` says gloo cannot
    send the device's tensors)."""
    glob = peer if group is None else dist.get_global_rank(group, peer)
    multihost.record("exchange", x)
    device = x.device
    if multihost.staged_on_host(x, group):
        x = x.cpu()
    x = x.contiguous()
    got = torch.empty_like(x)
    for req in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, glob, group),
        dist.P2POp(dist.irecv, got, glob, group),
    ]):
        req.wait()
    return got.to(device)


def ntt_sharded(x, q: int, psi: int, group=None):
    """Forward negacyclic NTT of the ring sharded over `group` (None: the
    default group): x is this rank's (nb, C) block, entries < 2q, natural
    order; returns its block of the bit-reversed canonical output."""
    D, d, n = _layout(x, group)
    w, ws, cross = ntt_torch.shard_tables(n, q, psi, D, d, False, x.device)
    for s, tw in enumerate(cross):
        k = D >> (s + 1)
        other = _exchange(x, d ^ k, group)
        if d & k:  # upper half: u - v w, v the own block
            x = rt.submod(other, rt.mulmod(x, torch.full_like(x, tw), q), q)
        else:
            x = rt.addmod(x, rt.mulmod(other, torch.full_like(x, tw), q), q)
    return ntt_stream.transform_with_tables(x, w, ws, q, False)


def intt_sharded(x, q: int, ipsi: int, group=None):
    """Inverse of `ntt_sharded`: x is this rank's (nb, C) block of the
    bit-reversed transform, entries < 2q; the local Gentleman-Sande stages
    run first (one kernel launch), then the log2(D) cross stages, each
    halving.  Returns the rank's block of the natural-order coefficients."""
    D, d, n = _layout(x, group)
    w, ws, cross = ntt_torch.shard_tables(n, q, ipsi, D, d, True, x.device)
    x = ntt_stream.transform_with_tables(x, w, ws, q, True)
    for s, tw in enumerate(cross):
        k = 1 << s
        other = _exchange(x, d ^ k, group)
        if d & k:  # upper half: (u - v) w / 2, u the partner's block
            x = rt.mulmod(rt.submod(other, x, q), torch.full_like(x, tw), q)
        else:
            x = rt.addmod(x, other, q)
        x = rt.halfmod(x, q)
    return x
