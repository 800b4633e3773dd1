"""Ciphertext-level HE ops on int64 tensors (the port of `he_planes` and `he_jax`).

A ciphertext is ``(a, b)``, each an int64 tensor ``(..., L, N)`` of
canonical residues in the NTT domain, bit-reversed order (he_np's data
model; decrypt = a + b*s).  A plaintext is ``(..., L, N)`` in the same
domain, a key-switch key ``(2L(L+1), N)`` in the reference's KSK layout.
Every op runs where its inputs lie: the transforms and the key-switch go
through `ops/` (CUDA kernels on the card, plain PyTorch on the CPU), the
elementwise stages through `rns_torch` (on the card one launch of
`csrc/rns.cu` a stage over every limb, on the CPU a call a limb), and the
gathers are plain PyTorch, as they were XLA outside the Pallas kernels.

Which JAX function each op ports:
- `he_planes` (fused launches): hom_add, hom_sub, add_plain, mul_plain,
  encode_post (one multi-modulus launch of csrc/ntt.cu), galois, rotate,
  conjugate (the fused ks_head/ks_tail pair), the hoisted and batched
  rotations, matvec_bsgs, ct_mul, relinearize (the key-switch pair with
  e = 1 and a zero rider, he_planes.py:558-565) and rescale;
- `he_jax` (one grid-kernel launch per transform, ops/ntt_pallas):
  encode (he_jax.encode, he_jax.py:94-103, on the fixed-point device
  encoder `encoder_torch`) and rotate_per_transform (he_jax.rotate /
  _rotate_exp, he_jax.py:106-208).

Words equal `aloha_tpu.he_np`'s: rotate/galois/conjugate and
rotate_per_transform match he_np.rotate; the hoisted and batched forms and
matvec_bsgs match he_np.rotate_hoisted / he_np.matvec_bsgs; ct_mul,
relinearize and rescale match he_np's.

Each op of the serving slice is an `aloha.he.<op>` span under a profiler
(`profiling.span`), its layout copies `aloha.pack.*` spans.
"""

from __future__ import annotations

import math

import torch

from aloha_tpu_torch import encoder_torch, ntt_torch
from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.config import DEFAULT_CONFIG, HEConfig
from aloha_tpu_torch.ops import aut, ks_kernel, ntt_pallas, ntt_stream
from aloha_tpu_torch.profiling import span

#: the layout copy of the rescale: both parts' last limbs stacked
_stack_rescale = span("aloha.pack.rescale")(torch.stack)


def _moduli(cfg: HEConfig, x) -> tuple:
    """The moduli of the limbs of x (..., L, N)."""
    return cfg.moduli[: x.shape[-2]]


@span("aloha.he.hom_add")
def hom_add(ct1, ct2, cfg: HEConfig = DEFAULT_CONFIG):
    """(a1 + a2, b1 + b2) limb-wise."""
    return (rt.addmod(ct1[0], ct2[0], _moduli(cfg, ct1[0])),
            rt.addmod(ct1[1], ct2[1], _moduli(cfg, ct1[1])))


@span("aloha.he.hom_sub")
def hom_sub(ct1, ct2, cfg: HEConfig = DEFAULT_CONFIG):
    """(a1 - a2, b1 - b2) limb-wise."""
    return (rt.submod(ct1[0], ct2[0], _moduli(cfg, ct1[0])),
            rt.submod(ct1[1], ct2[1], _moduli(cfg, ct1[1])))


@span("aloha.he.add_plain")
def add_plain(ct, pt, cfg: HEConfig = DEFAULT_CONFIG):
    """ct + pt into the message part."""
    return (rt.addmod(ct[0], pt.expand_as(ct[0]), _moduli(cfg, ct[0])), ct[1])


@span("aloha.he.mul_plain")
def mul_plain(ct, pt, cfg: HEConfig = DEFAULT_CONFIG):
    """(a pt, b pt) limb-wise pointwise (NTT domain)."""
    return (rt.mulmod(ct[0], pt.expand_as(ct[0]), _moduli(cfg, ct[0])),
            rt.mulmod(ct[1], pt.expand_as(ct[1]), _moduli(cfg, ct[1])))


@span("aloha.he.encode_post")
def encode_post(pt_coeff, cfg: HEConfig = DEFAULT_CONFIG):
    """Per-limb forward NTT of a coefficient-domain plaintext (..., L, N)."""
    L = cfg.n_limbs
    return ntt_stream.transform_limbs(pt_coeff, cfg.moduli[:L], cfg.psi[:L], False)


def encode(cleartext, cfg: HEConfig = DEFAULT_CONFIG):
    """(..., N) float64 interleaved re/im cleartexts -> (..., L, N) NTT-domain
    plaintexts on the cleartext's device: the fixed-point encoder, then one
    grid-kernel transform per limb (he_jax.encode_post).  Words equal
    `encode_post` of the same coefficients."""
    pt = encoder_torch.encode(cleartext, cfg)
    return torch.stack([ntt_pallas.ntt(pt[..., m, :], cfg.moduli[m], cfg.psi[m])
                        for m in range(cfg.n_limbs)], dim=-2)


def automorphism(x, step: int, q: int):
    """X -> X^step (step odd) in the coefficient domain, RTL sign rule
    (q - x): the automorphism kernel `ops/aut` on the card."""
    return aut.automorphism(x, step, q)


@span("aloha.he.galois")
def galois(ct, step_exp: int, ksk, cfg: HEConfig = DEFAULT_CONFIG):
    """Galois automorphism X -> X^step_exp + hybrid key-switch (two launches)."""
    return ks_kernel.rotate_planes(ct[0], ct[1], step_exp, ksk, cfg)


@span("aloha.he.rotate")
def rotate(ct, step: int, ksk, cfg: HEConfig = DEFAULT_CONFIG):
    """Slot rotation by `step`: X -> X^(3^step) + key-switch."""
    return galois(ct, pow(3, step, 2 * cfg.n), ksk, cfg)


@span("aloha.he.conjugate")
def conjugate(ct, cjk, cfg: HEConfig = DEFAULT_CONFIG):
    """Slot conjugation: X -> X^(2N-1) + key-switch."""
    return galois(ct, 2 * cfg.n - 1, cjk, cfg)


def rotate_per_transform(ct, step: int, ksk, cfg: HEConfig = DEFAULT_CONFIG):
    """Slot rotation by `step` with one grid-kernel launch per transform:
    the port of he_jax.rotate / he_jax._rotate_exp (he_jax.py:106-208),
    step for step.  At L = 2 it is 8 grid launches: L INTTs of the stacked
    (b, a) pairs, L+1 NTTs of the raised digits, one INTT under P, L
    correction NTTs; and 2L automorphism launches (`ops/aut`).  Words equal
    `rotate` (the fused pair) and he_np.rotate."""
    a, b = ct
    moduli, L, n = cfg.moduli, cfg.n_limbs, cfg.n
    e = pow(3, step, 2 * n)
    sp = cfg.special_prime
    half = (sp - 1) // 2

    # 1. digits d_j = aut(INTT(b_qj)), and aut(a) beside them
    digits, a_aut = [], []
    for m in range(L):
        pair = ntt_pallas.intt(torch.stack([b[..., m, :], a[..., m, :]], dim=-2),
                               moduli[m], cfg.ipsi[m])
        digits.append(automorphism(pair[..., 0, :], e, moduli[m]))
        a_aut.append(automorphism(pair[..., 1, :], e, moduli[m]))

    # 2. raise the digits to every modulus, one NTT per modulus
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
        stacked = ntt_pallas.ntt(torch.stack(polys, dim=-2), moduli[m], cfg.psi[m])
        for j in range(L):
            nd[j][m] = stacked[..., j, :]
        if m < L:
            a_aut[m] = stacked[..., L, :]

    # 3. KSK inner products, stride 2L rows per modulus
    stride = 2 * L

    def inner(m, part):
        q = moduli[m]
        acc = rt.mulmod(nd[0][m], ksk[stride * m + part].expand_as(nd[0][m]), q)
        for j in range(1, L):
            acc = rt.addmod(
                acc, rt.mulmod(nd[j][m], ksk[stride * m + 2 * j + part].expand_as(nd[j][m]), q),
                q)
        return acc

    c = [[inner(m, part) for part in (0, 1)] for m in range(L + 1)]

    # 4. mod-down by P with (P-1)/2 rounding, scale by P^-1 mod q
    p_pair = ntt_pallas.intt(torch.stack(c[L], dim=-2), sp, cfg.ipsi[-1])
    m_coeff = [rt.addmod(p_pair[..., p, :], torch.full_like(p_pair[..., p, :], half), sp)
               for p in (0, 1)]
    ks = []
    for m in range(L):
        q = moduli[m]
        corr = ntt_pallas.ntt(
            torch.stack([rt.submod(x, torch.full_like(x, half), q) for x in m_coeff], dim=-2),
            q, cfg.psi[m])
        ks.append([
            rt.mulmod(t, torch.full_like(t, cfg.pinv_mod(m)), q)
            for t in (rt.submod(c[m][p], corr[..., p, :], q) for p in (0, 1))
        ])

    # 5. the rotated message part aut(a) plus the key-switch a-part
    return (torch.stack([rt.addmod(a_aut[m], ks[m][0], moduli[m]) for m in range(L)], dim=-2),
            torch.stack([ks[m][1] for m in range(L)], dim=-2))


def galois_hoisted(ct, step_exps, ksks, cfg: HEConfig = DEFAULT_CONFIG):
    """Hoisted Galois automorphisms of one ciphertext: one head, one tail."""
    return ks_kernel.rotate_planes_hoisted(ct[0], ct[1], list(step_exps), ksks, cfg)


@span("aloha.he.rotate_hoisted")
def rotate_hoisted(ct, steps, ksks, cfg: HEConfig = DEFAULT_CONFIG):
    """Rotate one ciphertext by several steps sharing one key-switch head.
    Returns a list of ciphertexts aligned with steps."""
    return galois_hoisted(ct, [pow(3, s, 2 * cfg.n) for s in steps], ksks, cfg)


@span("aloha.he.rotate_batch")
def rotate_batch(cts, steps, ksks, cfg: HEConfig = DEFAULT_CONFIG):
    """Rotate K different ciphertexts, each by its own step, in two launches."""
    return ks_kernel.rotate_planes_batch(
        cts, [pow(3, s, 2 * cfg.n) for s in steps], ksks, cfg
    )


@span("aloha.he.pt_rotate")
def pt_rotate(pt, r: int, cfg: HEConfig = DEFAULT_CONFIG):
    """Rotate an encoded (NTT-domain) plaintext by r slots: one gather."""
    n = pt.shape[-1]
    return ntt_torch.ntt_domain_aut(pt, pow(3, r % n, 2 * n))


@span("aloha.he.matvec_bsgs")
def matvec_bsgs(ct, diags, ksks_baby, ksks_giant,
                cfg: HEConfig = DEFAULT_CONFIG, g: int | None = None):
    """Encrypted matrix-vector product by the diagonal method with
    baby-step/giant-step: g-1 hoisted baby rotations, then the b-1 giant
    rotations of the inner sums as one batched rotation.

    diags: D encoded NTT-domain plaintexts (L, N), diags[k] the k-th
    wrapped diagonal; ksks_baby[j-1] is the key of step j (j < g),
    ksks_giant[i-1] the key of step g i (i < b = ceil(D / g))."""
    D = len(diags)
    if g is None:
        g = math.isqrt(D - 1) + 1 if D else 1  # ceil(sqrt(D))
    b = (D + g - 1) // g
    if len(ksks_baby) < g - 1 or len(ksks_giant) < b - 1:
        raise ValueError(
            f"need {g - 1} baby and {b - 1} giant keys, got "
            f"{len(ksks_baby)} and {len(ksks_giant)}"
        )
    babies = [ct] + rotate_hoisted(ct, list(range(1, g)), ksks_baby[: g - 1], cfg)
    inners = []
    for i in range(b):
        inner = None
        for j in range(min(g, D - g * i)):
            t = mul_plain(babies[j], pt_rotate(diags[g * i + j], -g * i, cfg), cfg)
            inner = t if inner is None else hom_add(inner, t, cfg)
        inners.append(inner)
    acc = inners[0]
    for r in rotate_batch(
        inners[1:], [g * i for i in range(1, b)], ksks_giant[: b - 1], cfg
    ):
        acc = hom_add(acc, r, cfg)
    return acc


@span("aloha.he.ct_mul")
def ct_mul(ct1, ct2, cfg: HEConfig = DEFAULT_CONFIG):
    """Ciphertext x ciphertext tensor product, limb by limb in the NTT
    domain: (d0, d1, d2) = (a1 a2, a1 b2 + b1 a2, b1 b2), decrypting as
    d0 + d1 s + d2 s^2 (he_planes.ct_mul)."""
    (a1, b1), (a2, b2) = ct1, ct2
    moduli = _moduli(cfg, a1)
    d1 = rt.addmod(rt.mulmod(a1, b2, moduli), rt.mulmod(b1, a2, moduli), moduli)
    return rt.mulmod(a1, a2, moduli), d1, rt.mulmod(b1, b2, moduli)


@span("aloha.he.relinearize")
def relinearize(d0, d1, d2, rlk, cfg: HEConfig = DEFAULT_CONFIG):
    """Fold d2 s^2 back to degree 1 with the relinearization key: the
    key-switch pair on d2 as the b input with e = 1 (no automorphism) and a
    zero rider, added into (d0, d1) (he_planes.relinearize, :558-565)."""
    ka, kb = ks_kernel.rotate_planes(torch.zeros_like(d2), d2, 1, rlk, cfg)
    return rt.addmod(d0, ka, _moduli(cfg, d0)), rt.addmod(d1, kb, _moduli(cfg, d1))


@span("aloha.he.rescale")
def rescale(ct, cfg: HEConfig = DEFAULT_CONFIG):
    """Drop the last limb: c' = round(c / q_last) over the remaining
    limbs.  Returns a ciphertext of (..., L-1, N) tensors."""
    L = cfg.n_limbs
    if L < 2:
        raise ValueError("rescale needs at least 2 limbs")
    q_last = cfg.moduli[L - 1]
    half = (q_last - 1) // 2
    moduli = cfg.moduli[: L - 1]
    a, b = ct
    # centred lift of the last limb of both parts: one INTT launch
    last = ntt_stream.transform_limbs(
        _stack_rescale([a[..., L - 1:, :], b[..., L - 1:, :]], dim=-3),
        (q_last,), (cfg.ipsi[L - 1],), True,
    )[..., 0, :]
    last = rt.addmod(last[..., None, :], (half,), (q_last,))[..., 0, :]
    # correction NTTs of both parts across the remaining limbs: one launch
    # over the stacked (..., 2, L-1, N) group
    corr = ntt_stream.transform_limbs(
        rt.submod(last[..., :, None, :].expand(last.shape[:-1] + (L - 1, last.shape[-1])),
                  (half,) * (L - 1), moduli),
        moduli, cfg.psi[: L - 1], False,
    )
    inv = tuple(pow(q_last, -1, q) for q in moduli)
    return tuple(
        rt.mulmod(rt.submod(src[..., : L - 1, :], corr[..., p, :, :], moduli), inv, moduli)
        for p, src in enumerate((a, b))
    )
