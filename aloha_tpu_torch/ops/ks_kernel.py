"""The fused hybrid key-switch: `ks_head` and `ks_tail` kernels and the steps around them.

Replaces the TPU kernels `ks_kernel._head_body` and `ks_kernel._tail_body`
(aloha_tpu/ops/ks_kernel.py:153/229): a rotation is two launches,

  ks_head:  INTT of each b limb -> automorphism (skipped when hoisted) ->
            digit raise to all L+1 moduli -> forward NTT under each
  ks_tail:  KSK inner products under the L+1 residues -> INTT under P ->
            (P-1)/2-rounded mod-down with correction NTTs -> x P^-1, plus
            the NTT-domain a-part ("rider") on part 0

with the kernels in `csrc/ks.cu`.  Both run their transforms as
`csrc/ntt_regs.cuh`'s register passes (16 words a thread, shared memory
only between passes) and chain them in registers: an INTT ends in the map
where an NTT begins, so the head's INTT, raise and NTT, and the tail's INTT
and its L correction NTTs, follow one another with no exchange between the
transforms; only the automorphism scatters the words once through shared
memory.  The tail forms its inner products from 16-byte pairs of the
digits and keys, at the maps its transforms read and write; a tail launch
of few CTAs (at N = 8192) splits every polynomial over a cluster of 4
CTAs (`cluster_size`).  The head emits
canonical words (the TPU's lazy fold59 output belonged to its MXU
transform only).

Everything else here is plain PyTorch, as it was XLA around the Pallas
kernels: key preparation, the NTT-domain automorphism gathers and the
packing of hoisted and batched rotations (ks_kernel.py:615-909).

Under a profiler (`profiling.span`) each launch is an `aloha.kernel.*`
span, each packing copy an `aloha.pack.*` span, and each key prepared or
constants formed anew an `aloha.build.*` span.
"""

from __future__ import annotations

import collections
import functools
import math

import numpy as np
import torch

from aloha_tpu_torch import _build, ntt_np, ntt_torch
from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.config import HEConfig
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.profiling import span


@functools.lru_cache(maxsize=16)
@span("aloha.build.ks_consts")
def _consts(cfg: HEConfig, device: torch.device):
    """Per-(cfg, device) kernel constants: forward and inverse tables of
    every modulus, Barrett reciprocals (u64 bit patterns) and P^-1 mod q_m."""
    n = cfg.n
    iq = np.array(cfg.iq, dtype=np.uint64).view(np.int64)
    return (
        ntt_torch.tables(n, cfg.moduli, cfg.psi, device),
        ntt_torch.tables(n, cfg.moduli, cfg.ipsi, device),
        torch.from_numpy(iq).to(device),
        torch.tensor(
            [cfg.pinv_mod(m) for m in range(cfg.n_limbs)],
            dtype=torch.int64, device=device,
        ),
    )


def _check_ring(n: int) -> None:
    """The kernels have one compiled instance per power of two up to 8192:
    a polynomial's n words in the registers of n/16 threads (one warp below
    n = 512) and up to 2n words of shared memory a CTA (ks_tail's exchange
    buffer and its P-part)."""
    if n & (n - 1) or n > 8192:
        raise ValueError(f"ring degree {n}: a power of two up to 8192 required")


def tail_clusters(n: int) -> tuple:
    """The CTAs a polynomial csrc/ks.cu's ks_tail has instances for at
    length n: 1, and a cluster of 4 at n = 8192 (ks_head: 1 alone)."""
    return (1, 4) if n == 8192 else (1,)


def cluster_size(device: torch.device, ctas: int, n: int) -> int:
    """CTAs per polynomial of a ks_tail launch of `ctas` CTAs at one a
    polynomial (2 nb_out) on a CUDA device: 4 at n = 8192 while 2 a
    polynomial would fill less than three quarters of the card's SMs
    (csrc/ntt.cu's rule for 4), else 1."""
    c = _build.lib().aloha_ks_cluster(device.index, ctas, n.bit_length() - 1)
    if not c:
        raise RuntimeError(f"no cluster size for device {device}")
    return c


# ------------------------------------------------------------------ ks_head
def ks_head_plain(b, step_exp, cfg: HEConfig):
    """Plain PyTorch version of `ks_head`."""
    L, moduli = cfg.n_limbs, cfg.moduli
    digits = []
    for j in range(L):
        d = ntt_torch.intt(b[j], moduli[j], cfg.ipsi[j])
        if step_exp is not None:
            d = ntt_torch.automorphism(d, step_exp, moduli[j])
        digits.append(d)
    out = []
    for mm in range(L + 1):
        q = moduli[mm]
        raised = [
            d if mm == j
            else rt.plain.lazy_reduce(d, q) if q > moduli[j]
            else rt.plain.modred(d, q)
            for j, d in enumerate(digits)
        ]
        out.append(ntt_torch.ntt(torch.stack(raised, dim=1), q, cfg.psi[mm]))
    return torch.stack(out)


def ks_head(b, step_exp, cfg: HEConfig):
    """(L, nb, N) canonical NTT-domain b-parts -> (L+1, nb, L, N) raised
    digits: out[mm, c, j] = NTT_{q_mm}(raise(aut_e(INTT_{q_j}(b[j, c])))).

    step_exp=None is the hoisted head: no automorphism, the digits of b
    itself (each step's automorphism then rides the key and the output)."""
    L, n = cfg.n_limbs, cfg.n
    nb = b.shape[1]
    if not dispatch.use_kernel(b):
        return ks_head_plain(b, step_exp, cfg)
    dispatch.check(b, (L, nb, n), "b")
    _check_ring(n)
    (fw, fws, q), (iw, iws, _), _, _ = _consts(cfg, b.device)
    out = torch.empty((L + 1, nb, L, n), dtype=torch.int64, device=b.device)
    if nb:
        e = 1 if step_exp is None else step_exp % (2 * n)
        _launch_head(
            b.device.index, b.data_ptr(), out.data_ptr(), fw.data_ptr(),
            fws.data_ptr(), iw.data_ptr(), iws.data_ptr(), q.data_ptr(),
            L, nb, n.bit_length() - 1, e, dispatch.stream_of(b),
        )
    return out


ks_head.launches = 0


@span("aloha.kernel.ks_head")
def _launch_head(*args):
    _build.check(_build.lib().aloha_ks_head(*args), "ks_head")
    ks_head.launches += 1


# ------------------------------------------------------------------ ks_tail
def _blocks(nb_in: int, K: int, shared_inputs: bool):
    """(nb_out, nper): output ciphertexts and ciphertexts per key block.
    Output c reads data block c % nb_in and key block c // nper."""
    if shared_inputs:
        return K * nb_in, nb_in
    if nb_in % K:
        raise ValueError(f"{nb_in} ciphertexts do not split into {K} key blocks")
    return nb_in, nb_in // K


def ks_tail_plain(nd, rider, key, cfg: HEConfig, shared_inputs: bool = False):
    """Plain PyTorch version of `ks_tail`.  The result does not depend on
    the key's Shoup companions (exact arithmetic), so the plain form takes
    none and multiplies by Barrett."""
    L, moduli = cfg.n_limbs, cfg.moduli
    key = key if key.dim() == 3 else key[None]
    nb_in = nd.shape[1]
    nb_out, nper = _blocks(nb_in, key.shape[0], shared_inputs)
    c = torch.arange(nb_out, device=nd.device)
    g, r, k = nd[:, c % nb_in], rider[:, c % nb_in], key[c // nper]
    stride = 2 * L

    def inner(m, part):
        q = moduli[m]
        acc = rt.plain.mulmod(g[m, :, 0], k[:, stride * m + part], q)
        for j in range(1, L):
            acc = rt.plain.addmod(
                acc, rt.plain.mulmod(g[m, :, j], k[:, stride * m + 2 * j + part], q), q
            )
        return acc

    ip = [[inner(m, part) for part in (0, 1)] for m in range(L + 1)]
    sp = cfg.special_prime
    half = (sp - 1) // 2
    pc = ntt_torch.intt(torch.stack(ip[L], dim=1), sp, cfg.ipsi[-1])
    m_coeff = rt.plain.addmod(pc, torch.full_like(pc, half), sp)
    outs = []
    for m in range(L):
        q = moduli[m]
        corr = ntt_torch.ntt(
            rt.plain.submod(m_coeff, torch.full_like(m_coeff, half), q), q, cfg.psi[m]
        )
        parts = []
        for part in (0, 1):
            t = rt.plain.submod(ip[m][part], corr[:, part], q)
            v = rt.plain.mulmod(t, torch.full_like(t, cfg.pinv_mod(m)), q)
            if part == 0:
                v = rt.plain.addmod(r[m], v, q)
            parts.append(v)
        outs.append(torch.stack(parts, dim=1))
    return torch.stack(outs)


def ks_tail(nd, rider, key, cfg: HEConfig, kshoup=None,
            shared_inputs: bool = False, cluster: int = 0):
    """Raised digits (L+1, nb, L, N) + NTT-domain riders (L, nb, N) + key
    -> (L, nb_out, 2, N): [:, :, 0] = a_rot, [:, :, 1] = b_rot.

    key: (2L(L+1), N), or (K, 2L(L+1), N) for K keys; kshoup: the keys'
    Shoup companions from `prepare_ksk` (None: Barrett products).
    Batched keys: nb = K blocks of nb/K ciphertexts, block c // (nb/K)
    under key c // (nb/K).  shared_inputs: all K keys read the same nb
    ciphertexts, and the output is key-major (nb_out = K nb).
    cluster 0 lets the kernel choose how many CTAs share a polynomial
    (`cluster_size`); one of `tail_clusters(N)` forces it (the card tests
    and the timing probes; no caller on the main path)."""
    L, n = cfg.n_limbs, cfg.n
    nb_in = nd.shape[1]
    K = 1 if key.dim() == 2 else key.shape[0]
    nb_out, nper = _blocks(nb_in, K, shared_inputs)
    operands = (nd, rider, key) + ((kshoup,) if kshoup is not None else ())
    if not dispatch.use_kernel(*operands):
        return ks_tail_plain(nd, rider, key, cfg, shared_inputs)
    nk = 2 * L * (L + 1)
    dispatch.check(nd, (L + 1, nb_in, L, n), "nd")
    dispatch.check(rider, (L, nb_in, n), "rider")
    dispatch.check(key, key.shape[:-2] + (nk, n), "key")
    if kshoup is not None:
        dispatch.check(kshoup, key.shape, "kshoup")
    _check_ring(n)
    (fw, fws, q), (iw, iws, _), iq, pinv = _consts(cfg, nd.device)
    out = torch.empty((L, nb_out, 2, n), dtype=torch.int64, device=nd.device)
    if nb_out:
        args = (
            nd.device.index, nd.data_ptr(), rider.data_ptr(), key.data_ptr(),
            kshoup.data_ptr() if kshoup is not None else None,
            out.data_ptr(), fw.data_ptr(), fws.data_ptr(), iw.data_ptr(),
            iws.data_ptr(), q.data_ptr(), iq.data_ptr(), pinv.data_ptr(),
            L, nb_in, nb_out, nper, n.bit_length() - 1, cfg.mod_width,
        )
        _launch_tail(args, cluster, dispatch.stream_of(nd))
    return out


ks_tail.launches = 0


@span("aloha.kernel.ks_tail")
def _launch_tail(args, cluster: int, stream: int):
    lib = _build.lib()
    err = (lib.aloha_ks_tail_c(*args, cluster, stream) if cluster
           else lib.aloha_ks_tail(*args, stream))
    _build.check(err, "ks_tail")
    ks_tail.launches += 1


# --------------------------------------------------------- key preparation
_KSK_CACHE: "collections.OrderedDict" = collections.OrderedDict()
# a full BSGS key set (g-1 baby + b-1 giant keys) plus headroom
_KSK_CACHE_CAP = 64


def prepare_ksk(ksk, cfg: HEConfig, aut_exp: int | None = None):
    """Prepare a key for `ks_tail` once, on the host: (k, kshoup) int64
    tensors (2L(L+1), N) on the key's device, kshoup = floor(k 2^64 / q_m)
    as u64 bit patterns (the analogue of the reference's one-time key DMA,
    sim/top/top_noaxilite_tb.sv:372).

    aut_exp: Galois exponent of the rotation this key serves.  The key is
    then inverse-gathered (NTT-domain permutation for e^-1 mod 2n), so
    hoisted and batched tails read ungathered digits and the automorphism
    moves to the small output (the lazy-gather form).

    Cached (LRU) by the key tensor's identity and version, with a
    reference held so the identity stays valid."""
    ck = (id(ksk), ksk._version, aut_exp)
    hit = _KSK_CACHE.get(ck)
    if hit is not None and hit[0] is ksk:
        _KSK_CACHE.move_to_end(ck)
        return hit[1]
    out = _prepared(ksk, cfg, aut_exp)
    while len(_KSK_CACHE) >= _KSK_CACHE_CAP:
        _KSK_CACHE.popitem(last=False)
    _KSK_CACHE[ck] = (ksk, out)
    return out


@span("aloha.build.prepare_ksk")
def _prepared(ksk, cfg: HEConfig, aut_exp):
    """`prepare_ksk`'s (k, kshoup), formed anew."""
    L, n = cfg.n_limbs, cfg.n
    k64 = ksk.detach().cpu().numpy().view(np.uint64).reshape(2 * L * (L + 1), n)
    if aut_exp is not None:
        k64 = k64[:, ntt_np.ntt_aut_perm(n, pow(aut_exp, -1, 2 * n))]
    k64 = np.ascontiguousarray(k64)
    s = np.empty_like(k64)
    for p in range(k64.shape[0]):
        q = cfg.moduli[p // (2 * L)]
        s[p] = ((k64[p].astype(object) << 64) // q).astype(np.uint64)
    return (
        torch.from_numpy(k64.view(np.int64)).to(ksk.device),
        torch.from_numpy(s.view(np.int64)).to(ksk.device),
    )


@span("aloha.pack.stacked_keys")
def _stacked_keys(ksks, cfg: HEConfig, aut_exps):
    """Stack K prepared keys into the batched-tail layout (K, 2L(L+1), N)."""
    preps = [prepare_ksk(k, cfg, aut_exp=e) for k, e in zip(ksks, aut_exps)]
    return (
        torch.stack([p[0] for p in preps]),
        torch.stack([p[1] for p in preps]),
    )


# ---------------------------------------------------------------- rotations
#: the K ciphertexts of a batched rotation stacked key-major
_stack_cts = span("aloha.pack.batch_stack")(torch.stack)


@span("aloha.pack.ks_pack")
def _pack(x, L: int, n: int):
    """(..., L, N) -> (L, nb, N) contiguous."""
    return x.reshape(-1, L, n).transpose(0, 1).contiguous()


def rotate_planes(a, b, step_exp: int, ksk, cfg: HEConfig):
    """One rotation X -> X^step_exp in two launches.  a, b: (..., L, N);
    ksk: (2L(L+1), N).  Returns (a_rot, b_rot) like he_np.galois.

    The a-part never enters a kernel: its automorphism is a permutation
    of NTT evaluation points (one gather), word-equal to the reference's
    coefficient-domain INTT/vaut/NTT round trip."""
    L, n = cfg.n_limbs, cfg.n
    batch = a.shape[:-2]
    nd = ks_head(_pack(b, L, n), step_exp, cfg)
    rider = _pack(ntt_torch.ntt_domain_aut(a, step_exp), L, n)
    k, ks = prepare_ksk(ksk, cfg)
    out = ks_tail(nd, rider, k, cfg, kshoup=ks)
    return tuple(
        out[:, :, part].transpose(0, 1).reshape(batch + (L, n)) for part in (0, 1)
    )


def _unpack_gathered(out, step_exps, batch, nb: int, cfg: HEConfig):
    """Slice each step's block out of the key-major tail output
    (L, K nb, 2, N) and apply its NTT-domain automorphism: the per-step
    list of (a_rot, b_rot)."""
    L, n = cfg.n_limbs, cfg.n
    return [
        tuple(
            ntt_torch.ntt_domain_aut(
                out[:, k * nb:(k + 1) * nb, part]
                .transpose(0, 1).reshape(batch + (L, n)),
                e,
            )
            for part in (0, 1)
        )
        for k, e in enumerate(step_exps)
    ]


def rotate_planes_hoisted(a, b, step_exps, ksks, cfg: HEConfig):
    """K rotations of one ciphertext (batch) in two launches: one
    aut-free head, one tail over all K keys with shared inputs.

    The lazy-gather form: g_e(sum_j nd_j g_e^-1(K_j)) = sum_j g_e(nd_j) K_j
    and the mod-down is automorphism-equivariant, so the keys carry the
    inverse gather and only the output is gathered.  Word-exact against
    he_np.rotate_hoisted; decrypts like rotate_planes (another digit lift)."""
    if len(step_exps) != len(ksks):
        raise ValueError(f"{len(step_exps)} steps but {len(ksks)} keys")
    if not step_exps:
        return []
    L, n = cfg.n_limbs, cfg.n
    batch = a.shape[:-2]
    nb = math.prod(batch)
    k, ks = _stacked_keys(ksks, cfg, list(step_exps))
    nd = ks_head(_pack(b, L, n), None, cfg)
    out = ks_tail(nd, _pack(a, L, n), k, cfg, kshoup=ks, shared_inputs=True)
    return _unpack_gathered(out, step_exps, batch, nb, cfg)


def rotate_planes_batch(cts, step_exps, ksks, cfg: HEConfig):
    """Rotate K different ciphertexts (same batch shape), each by its own
    exponent and key, in two launches: the b-parts stack key-major through
    one aut-free head, and one tail takes per-block keys (the BSGS giant
    steps).  Word-exact against he_np.rotate_hoisted(ct_k, [s_k], [ksk_k])."""
    if not len(cts) == len(step_exps) == len(ksks):
        raise ValueError(f"{len(cts)} cts, {len(step_exps)} steps, {len(ksks)} keys")
    if not cts:
        return []
    L, n = cfg.n_limbs, cfg.n
    batch = cts[0][0].shape[:-2]
    nb = math.prod(batch)

    def pack_k(parts):
        return _pack(_stack_cts([p.reshape(nb, L, n) for p in parts]), L, n)

    k, ks = _stacked_keys(ksks, cfg, list(step_exps))
    nd = ks_head(pack_k([ct[1] for ct in cts]), None, cfg)
    out = ks_tail(nd, pack_k([ct[0] for ct in cts]), k, cfg, kshoup=ks)
    return _unpack_gathered(out, step_exps, batch, nb, cfg)
