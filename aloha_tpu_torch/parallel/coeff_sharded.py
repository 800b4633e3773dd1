"""The slot rotation with the ring split over a coefficient group.

The port of the rotation the JAX package gets from its partitioner on a
(dp, coeff) mesh: `he_jax.rotate` jitted with ciphertexts sharded
P("dp", None, "coeff") and the key P(None, "coeff") (__graft_entry__.py:
49-145, tools/bench_scaling.py:49-97).  PyTorch has no partitioner, so the
rotation is written out here over the D ranks of a coefficient group: rank
d holds coefficients [d C, (d+1) C) of every polynomial, C = n/D, of its
block of the batch, and the key's columns [d C, (d+1) C).

It follows `he_torch.rotate_per_transform` (the port of he_jax._rotate_exp)
step for step.  Each transform is `ntt_sharded.ntt_sharded` /
`intt_sharded` on the group (log2(D) block exchanges and one launch of the
NTT kernel fed the shard's tables, `ops.ntt_stream.transform_with_tables`
on csrc/ntt.cu); the coefficient automorphism, which moves words between
shards, is `automorphism_sharded` (one all-to-all); the rest is the same
`rns_torch` arithmetic on the rank's block.  At L limbs a rotation is
3L + 2 sharded transforms and one all-to-all.  The same structure runs at
every group size, D = 1 included, so one program is compared across
meshes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.config import DEFAULT_CONFIG, HEConfig
from aloha_tpu_torch.parallel import multihost
from aloha_tpu_torch.parallel.ntt_sharded import intt_sharded, ntt_sharded


@functools.lru_cache(maxsize=64)
def _aut_maps(n: int, e: int, D: int, d: int, device: torch.device):
    """Rank d's maps of X -> X^e over a ring of n coefficients in D blocks.

    Source i goes to j = i e mod 2n, position j mod n of rank (j mod n) // C.
    Returns (send, send_counts, recv_counts, place, neg): this rank's local
    sources grouped by destination rank (ascending within each), the words
    it sends to and receives from each rank, the gather that puts the
    received words (from rank 0 first, each rank's in its send order) at
    their local positions, and the sign mask over those positions (j >= n:
    the word arrives negated)."""
    C = n // D
    i = np.arange(n, dtype=np.int64)
    j = (i * e) % (2 * n)
    dest = j % n
    owner = dest // C
    mine = owner[d * C:(d + 1) * C]
    send = np.argsort(mine, kind="stable")
    srcs = i[owner == d]  # ascending: by source rank, then as each sends
    place = np.argsort(dest[srcs] - d * C)
    return (torch.from_numpy(send).to(device),
            np.bincount(mine, minlength=D).tolist(),
            np.bincount(srcs // C, minlength=D).tolist(),
            torch.from_numpy(place).to(device),
            torch.from_numpy((j[srcs] >= n)[place]).to(device))


def automorphism_sharded(x, e: int, q, group=None):
    """X -> X^e of the ring sharded over `group` (None: the default group):
    x (..., C) is this rank's block of coefficients [d C, (d+1) C) of each
    polynomial, natural order.  The cross-shard form of
    `ntt_torch.automorphism`, word for word: a negated coefficient is the
    literal q - x, so 0 becomes q.  q is an int or an int64 tensor that
    broadcasts against x (one modulus per polynomial).

    One `all_to_all_single` moves every word to its rank; the split sizes
    come from the index map and are uneven, some zero."""
    D, d = dist.get_world_size(group), dist.get_rank(group)
    C = x.shape[-1]
    n = D * C
    send, send_counts, recv_counts, place, neg = _aut_maps(n, e % (2 * n), D, d, x.device)
    rows = x.reshape(-1, C)
    buf = rows.index_select(-1, send).T.contiguous()  # (C, rows), by destination
    multihost.record("all_to_all", buf)
    device = x.device
    if multihost.staged_on_host(buf, group):
        buf = buf.cpu()
    got = torch.empty_like(buf)
    dist.all_to_all_single(got, buf, recv_counts, send_counts, group=group)
    g = got.to(device).index_select(0, place).T.reshape(x.shape)
    return torch.where(neg, q - g, g)


def _check(a, b, ksk, cfg: HEConfig, D: int):
    L, n = cfg.n_limbs, cfg.n
    if D < 1 or D & (D - 1) or n % D:
        raise ValueError(f"coefficient group of {D} ranks: a power of two dividing n={n} required")
    C = n // D
    if a.dim() != 3 or tuple(a.shape[1:]) != (L, C) or b.shape != a.shape:
        raise ValueError(f"blocks of shapes {tuple(a.shape)}, {tuple(b.shape)}: expected two "
                         f"equal (nb, {L}, {C}) for n={n} over {D} ranks")
    if tuple(ksk.shape) != (2 * L * (L + 1), C):
        raise ValueError(f"key block of shape {tuple(ksk.shape)}: expected "
                         f"({2 * L * (L + 1)}, {C})")


def rotate(ct_block, step: int, ksk_block, cfg: HEConfig = DEFAULT_CONFIG, coeff_group=None):
    """Slot rotation by `step` with the ring sharded over `coeff_group`
    (None: the default group), of D ranks, D a power of two dividing n.

    ct_block: (a, b), each (nb, L, C) int64, this rank's coefficients
    [d C, (d+1) C) of a batch of ciphertexts in the NTT domain, bit-reversed
    order (the columns `ntt_sharded` gives the rank); ksk_block: the same
    columns of the key, (2L(L+1), C), stride 2L rows per modulus.  Returns
    this rank's (a_rot, b_rot) blocks, words equal to the same columns of
    `he_torch.rotate` of the whole ring."""
    a, b = ct_block
    D = dist.get_world_size(coeff_group)
    _check(a, b, ksk_block, cfg, D)
    moduli, L, n = cfg.moduli, cfg.n_limbs, cfg.n
    nb = a.shape[0]
    e = pow(3, step, 2 * n)
    sp = cfg.special_prime
    half = (sp - 1) // 2

    def ntt(polys, m):
        return ntt_sharded(torch.cat(polys), moduli[m], cfg.psi[m], coeff_group)

    def intt(polys, m):
        return intt_sharded(torch.cat(polys), moduli[m], cfg.ipsi[m], coeff_group)

    # 1. digits d_j = aut(INTT(b_qj)) and aut(a) beside them: L transforms,
    # then every limb's automorphism in one all-to-all
    pairs = torch.stack([intt([b[:, m], a[:, m]], m) for m in range(L)])
    qs = torch.tensor(moduli[:L], dtype=torch.int64, device=a.device).view(L, 1, 1)
    pairs = automorphism_sharded(pairs, e, qs, coeff_group)
    digits, a_aut = list(pairs[:, :nb]), list(pairs[:, nb:])

    # 2. raise the digits to every modulus, one transform per modulus
    nd = [[None] * (L + 1) for _ in range(L)]
    for m in range(L + 1):
        polys = [
            d if m == j
            else rt.lazy_reduce(d, moduli[m]) if moduli[m] > moduli[j]
            else rt.modred(d, moduli[m])
            for j, d in enumerate(digits)
        ]
        if m < L:
            polys.append(a_aut[m])
        stacked = ntt(polys, m).view(len(polys), nb, -1)
        for j in range(L):
            nd[j][m] = stacked[j]
        if m < L:
            a_aut[m] = stacked[L]

    # 3. KSK inner products on the rank's columns, stride 2L rows a modulus
    stride = 2 * L

    def inner(m, part):
        q = moduli[m]
        acc = rt.mulmod(nd[0][m], ksk_block[stride * m + part].expand_as(nd[0][m]), q)
        for j in range(1, L):
            acc = rt.addmod(
                acc, rt.mulmod(nd[j][m], ksk_block[stride * m + 2 * j + part].expand_as(nd[j][m]),
                               q), q)
        return acc

    c = [[inner(m, part) for part in (0, 1)] for m in range(L + 1)]

    # 4. mod-down by P with (P-1)/2 rounding, scale by P^-1 mod q
    p_pair = intt_sharded(torch.cat(c[L]), sp, cfg.ipsi[-1], coeff_group).view(2, nb, -1)
    m_coeff = [rt.addmod(p, torch.full_like(p, half), sp) for p in p_pair]
    ks = []
    for m in range(L):
        q = moduli[m]
        corr = ntt([rt.submod(x, torch.full_like(x, half), q) for x in m_coeff], m).view(2, nb, -1)
        ks.append([
            rt.mulmod(t, torch.full_like(t, cfg.pinv_mod(m)), q)
            for t in (rt.submod(c[m][p], corr[p], q) for p in (0, 1))
        ])

    # 5. the rotated message part aut(a) plus the key-switch a-part
    return (torch.stack([rt.addmod(a_aut[m], ks[m][0], moduli[m]) for m in range(L)], dim=1),
            torch.stack([ks[m][1] for m in range(L)], dim=1))
