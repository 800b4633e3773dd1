"""Digit-sharded rotation: one `all_reduce` sums the key-switch inner products.

The port of `aloha_tpu/parallel/keyswitch_sharded.py`.  The hybrid
key-switch sums per-digit contributions under every modulus,

    c_m = sum_j NTT_m(raise(digit_j)) * ksk[m, j],

the reference's per-limb accumulation loop (keyswitch.mem lines 43-78).
With the ciphertext limbs spread over the L ranks of a digit group (rank j
holds limb j of a and b and its digit's key columns), each rank forms its
digit's share under all L+1 moduli, and ONE `all_reduce(SUM)` over the
group (the JAX form's `psum`, keyswitch_sharded.py:130) gives every rank
the whole inner products.  Each rank then repeats the mod-down by P and
finishes its own limb, so the outputs are sharded as the inputs are.

On the card the transforms go through `ops.ntt_stream` (csrc/ntt.cu: the
INTT of b_j and a_j, one launch across the L+1 moduli for the raised
digit, the INTT under P and the NTTs under q_j) and the coefficient
automorphism through `ops.aut` (csrc/aut.cu); CPU tensors take their plain
versions.  The collective moves 2(L+1) nb N int64 words a rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.config import DEFAULT_CONFIG, HEConfig
from aloha_tpu_torch.ops import aut, ntt_stream
from aloha_tpu_torch.parallel import multihost


def _ntt(x, q: int, root: int, inverse: bool):
    """One launch of the transform of x (k, nb, n) under a single modulus."""
    k, nb, n = x.shape
    return ntt_stream.transform(x.reshape(1, k * nb, n), (q,), (root,), inverse).reshape(x.shape)


def _local_rotate(a_j, b_j, key_j, e: int, j: int, cfg: HEConfig, group):
    """One rank's part of the rotation (keyswitch_sharded.py:67-169).

    a_j, b_j: (nb, N) this rank's limb j; key_j: (L+1, 2, N), digit j's key
    columns under every modulus, parts (a, b).  Returns (a_rot_j, b_rot_j)."""
    L, moduli = cfg.n_limbs, cfg.moduli
    sp = cfg.special_prime
    half = (sp - 1) // 2
    q = moduli[j]

    # d = aut(INTT_qj(b_j)), and aut(INTT_qj(a_j)) beside it: one INTT
    # launch and one automorphism launch for both
    d, a_aut = aut.automorphism(_ntt(torch.stack([b_j, a_j]), q, cfg.ipsi[j], True), e, q)

    # raise d to every modulus by the reference's rule (:100-110), d itself
    # under q_j: the automorphism's literal q - x makes 0 into q_j, and a
    # canonical reduce first would change the raised words
    raised = torch.stack([
        d if m == j else rt.lazy_reduce(d, moduli[m]) if moduli[m] > q else rt.modred(d, moduli[m])
        for m in range(L + 1)
    ])
    nd = ntt_stream.transform(raised, moduli[:L + 1], cfg.psi[:L + 1], False)

    # this digit's share of every inner product, then one all_reduce: L
    # canonical terms stay below L 2^60 < 2^63, so the int64 sum cannot wrap
    shares = torch.stack([
        rt.mulmod(nd[m], key_j[m, p].expand_as(nd[m]), moduli[m])
        for m in range(L + 1) for p in (0, 1)
    ])
    multihost.record("all_reduce", shares)
    dist.all_reduce(shares, op=dist.ReduceOp.SUM, group=group)
    c = []
    for k in range(2 * (L + 1)):
        # each conditional subtract removes at most one q from a sum < L q:
        # L - 1 of them restore the consumers' [0, 2q) window
        v = shares[k]
        for _ in range(max(1, L - 1)):
            v = rt.lazy_reduce(v, moduli[k // 2])
        c.append(v)

    # mod-down by P (the same work on every rank), then this rank's limb
    p_coeff = _ntt(torch.stack(c[2 * L:]), sp, cfg.ipsi[-1], True)
    m_coeff = rt.addmod(p_coeff, torch.full_like(p_coeff, half), sp)
    corr_in = rt.submod(m_coeff, torch.full_like(m_coeff, half), q)
    # the two correction NTTs and the NTT of aut(a_j) in one launch
    corr0, corr1, a_rot = _ntt(torch.cat([corr_in, a_aut[None]]), q, cfg.psi[j], False)
    pinv = cfg.pinv_mod(j)
    ks = [rt.mulmod(t, torch.full_like(t, pinv), q)
          for t in (rt.submod(c[2 * j], corr0, q), rt.submod(c[2 * j + 1], corr1, q))]
    return rt.addmod(a_rot, ks[0], q), ks[1]


def rotate_sharded(ct, step: int, ksk, cfg: HEConfig = DEFAULT_CONFIG, digit_group=None,
                   dp_group=None):
    """Slot rotation by `step` with the limbs sharded over `digit_group`
    (None: the default group), whose size must be cfg.n_limbs; rank j of
    the group holds limb j.

    ct: (a, b), each (..., 1, N) int64, this rank's limb of a batch of
    ciphertexts; ksk: the whole key (2L(L+1), N) in the reference layout,
    of which the rank reads its digit's columns.  With a `dp_group` of
    size dp the leading axis of a and b is the whole batch, and the rank of
    dp index i rotates its block i of nb/dp rows (the JAX form's batch
    sharding over `dp_axis`).  Returns this rank's (a_rot, b_rot), each
    (..., 1, N) over its block."""
    a, b = ct
    L, n = cfg.n_limbs, a.shape[-1]
    size = dist.get_world_size(digit_group)
    if size != L:
        raise ValueError(f"digit axis size {size} != n_limbs {L}")
    if a.shape[-2] != 1 or b.shape != a.shape:
        raise ValueError(f"limb shards of shapes {tuple(a.shape)}, {tuple(b.shape)}: "
                         "expected two equal (..., 1, N)")
    if dp_group is not None:
        dp, i = dist.get_world_size(dp_group), dist.get_rank(dp_group)
        if a.dim() < 3 or a.shape[0] % dp:
            raise ValueError(f"batch of shape {tuple(a.shape[:-2])} does not split over dp={dp}")
        rows = slice(i * a.shape[0] // dp, (i + 1) * a.shape[0] // dp)
        a, b = a[rows], b[rows]
    j = dist.get_rank(digit_group)
    # (2L(L+1), N) -> (L+1 moduli, 2 parts, L digits, N); this rank's digit
    key_j = ksk.reshape(L + 1, L, 2, n).transpose(1, 2)[:, :, j]
    batch = a.shape[:-2]
    out = _local_rotate(a.reshape(-1, n), b.reshape(-1, n), key_j, pow(3, step, 2 * n), j,
                        cfg, digit_group)
    return tuple(x.reshape(batch + (1, n)) for x in out)
