"""Ciphertext-level HE ops on int64 tensors (the port of `he_planes` and `he_jax`).

A ciphertext is ``(a, b)``, each an int64 tensor ``(..., L, N)`` of
canonical residues in the NTT domain, bit-reversed order (he_np's data
model; decrypt = a + b*s).  A plaintext is ``(..., L, N)`` in the same
domain, a key-switch key ``(2L(L+1), N)`` in the reference's KSK layout.
Every op runs where its inputs lie: the transforms and the key-switch go
through `ops/` (CUDA kernels on the card, plain PyTorch on the CPU), and
the elementwise ops and gathers are plain PyTorch, as they were XLA
outside the Pallas kernels.

Words equal `aloha_tpu.he_np`'s: rotate/galois/conjugate match
he_np.rotate; the hoisted and batched forms and matvec_bsgs match
he_np.rotate_hoisted / he_np.matvec_bsgs.
"""

from __future__ import annotations

import math

import torch

from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.config import DEFAULT_CONFIG, HEConfig
from aloha_tpu_torch.ops import ks_kernel, ntt_stream


def _per_limb(op, x, y, cfg: HEConfig):
    return torch.stack(
        [op(x[..., m, :], y[..., m, :], cfg.moduli[m]) for m in range(x.shape[-2])],
        dim=-2,
    )


def _scalar_per_limb(op, x, values, moduli):
    """op(x[..., m, :], values[m]) under moduli[m], for each limb m."""
    return torch.stack(
        [
            op(x[..., m, :], torch.full_like(x[..., m, :], v), q)
            for m, (v, q) in enumerate(zip(values, moduli))
        ],
        dim=-2,
    )


def hom_add(ct1, ct2, cfg: HEConfig = DEFAULT_CONFIG):
    """(a1 + a2, b1 + b2) limb-wise."""
    return (_per_limb(rt.addmod, ct1[0], ct2[0], cfg),
            _per_limb(rt.addmod, ct1[1], ct2[1], cfg))


def hom_sub(ct1, ct2, cfg: HEConfig = DEFAULT_CONFIG):
    """(a1 - a2, b1 - b2) limb-wise."""
    return (_per_limb(rt.submod, ct1[0], ct2[0], cfg),
            _per_limb(rt.submod, ct1[1], ct2[1], cfg))


def add_plain(ct, pt, cfg: HEConfig = DEFAULT_CONFIG):
    """ct + pt into the message part."""
    return (_per_limb(rt.addmod, ct[0], pt.expand_as(ct[0]), cfg), ct[1])


def mul_plain(ct, pt, cfg: HEConfig = DEFAULT_CONFIG):
    """(a pt, b pt) limb-wise pointwise (NTT domain)."""
    return (_per_limb(rt.mulmod, ct[0], pt.expand_as(ct[0]), cfg),
            _per_limb(rt.mulmod, ct[1], pt.expand_as(ct[1]), cfg))


def encode_post(pt_coeff, cfg: HEConfig = DEFAULT_CONFIG):
    """Per-limb forward NTT of a coefficient-domain plaintext (..., L, N)."""
    L = cfg.n_limbs
    return ntt_stream.transform_limbs(pt_coeff, cfg.moduli[:L], cfg.psi[:L], False)


def automorphism(x, step: int, q: int):
    """X -> X^step in the coefficient domain, RTL sign rule (q - x)."""
    return ntt_torch.automorphism(x, step, q)


def galois(ct, step_exp: int, ksk, cfg: HEConfig = DEFAULT_CONFIG):
    """Galois automorphism X -> X^step_exp + hybrid key-switch (two launches)."""
    return ks_kernel.rotate_planes(ct[0], ct[1], step_exp, ksk, cfg)


def rotate(ct, step: int, ksk, cfg: HEConfig = DEFAULT_CONFIG):
    """Slot rotation by `step`: X -> X^(3^step) + key-switch."""
    return galois(ct, pow(3, step, 2 * cfg.n), ksk, cfg)


def conjugate(ct, cjk, cfg: HEConfig = DEFAULT_CONFIG):
    """Slot conjugation: X -> X^(2N-1) + key-switch."""
    return galois(ct, 2 * cfg.n - 1, cjk, cfg)


def galois_hoisted(ct, step_exps, ksks, cfg: HEConfig = DEFAULT_CONFIG):
    """Hoisted Galois automorphisms of one ciphertext: one head, one tail."""
    return ks_kernel.rotate_planes_hoisted(ct[0], ct[1], list(step_exps), ksks, cfg)


def rotate_hoisted(ct, steps, ksks, cfg: HEConfig = DEFAULT_CONFIG):
    """Rotate one ciphertext by several steps sharing one key-switch head.
    Returns a list of ciphertexts aligned with steps."""
    return galois_hoisted(ct, [pow(3, s, 2 * cfg.n) for s in steps], ksks, cfg)


def rotate_batch(cts, steps, ksks, cfg: HEConfig = DEFAULT_CONFIG):
    """Rotate K different ciphertexts, each by its own step, in two launches."""
    return ks_kernel.rotate_planes_batch(
        cts, [pow(3, s, 2 * cfg.n) for s in steps], ksks, cfg
    )


def pt_rotate(pt, r: int, cfg: HEConfig = DEFAULT_CONFIG):
    """Rotate an encoded (NTT-domain) plaintext by r slots: one gather."""
    n = pt.shape[-1]
    return ntt_torch.ntt_domain_aut(pt, pow(3, r % n, 2 * n))


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
        torch.stack([a[..., L - 1:, :], b[..., L - 1:, :]], dim=-3),
        (q_last,), (cfg.ipsi[L - 1],), True,
    )[..., 0, :]
    last = rt.addmod(last, torch.full_like(last, half), q_last)
    # correction NTTs of both parts across the remaining limbs: one launch
    # over the stacked (..., 2, L-1, N) group
    corr = ntt_stream.transform_limbs(
        _scalar_per_limb(
            rt.submod,
            last[..., :, None, :].expand(last.shape[:-1] + (L - 1, last.shape[-1])),
            [half] * (L - 1), moduli,
        ),
        moduli, cfg.psi[: L - 1], False,
    )
    inv = [pow(q_last, -1, q) for q in moduli]
    return tuple(
        _scalar_per_limb(
            rt.mulmod,
            _per_limb(rt.submod, src[..., : L - 1, :], corr[..., p, :, :], cfg),
            inv, moduli,
        )
        for p, src in enumerate((a, b))
    )
