"""Encrypted matrix-vector product: the request's inputs, its reference and
its cleartext result.

A banded plaintext matrix of D wrapped diagonals over the n/2 slots is
applied to each encrypted vector by the baby-step/giant-step diagonal
method (Halevi and Shoup):

    M z = sum_i rot_{g i}( sum_j rot_{-g i}(diag_{g i + j}) * rot_j(z) )

with g - 1 hoisted baby rotations and ceil(D / g) - 1 giant rotations, then
one rescale.  rot_k(z)[i] = z[i + k].
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import encoder
from portbench.reference.ckks import rotation_exponent
from portbench.reference.ntt import eval_automorphism

CIPHERTEXTS = 1  # ciphertexts a batch element brings


def draw_extra(gen, config: dict, ring) -> dict:
    """The matrix: D real diagonals, uniform in [-1, 1)."""
    d = torch.rand((config["matrix"]["diagonals"], ring.n // 2), generator=gen,
                   dtype=torch.float64, device=gen.device)
    return {"diagonals": (2 * d - 1).cpu().numpy()}


def scale(ring) -> float:
    """The result's scale: a product at the encode scale squared, rescaled."""
    return encoder.SCALE ** 2 / ring.moduli[ring.L - 1]


def expected(config: dict, extra: dict, slots: np.ndarray) -> np.ndarray:
    """slots (1, B, n/2) -> the cleartext products (B, n/2)."""
    z = slots[0]
    return sum(d * np.roll(z, -k, axis=-1) for k, d in enumerate(extra["diagonals"]))


def prepare(scheme, config: dict, extra: dict) -> torch.Tensor:
    """The diagonals' encodings (D, L, n) on the scheme's device."""
    ring = scheme.ring
    m = torch.from_numpy(encoder.encode_batch(extra["diagonals"] + 0j, ring.n))
    return scheme.transform(m.to(scheme.t.device), ring.moduli[:ring.L])


def reference(scheme, config: dict, diags, keys: dict, cts):
    (ct,) = cts
    n = scheme.ring.n
    D, g = config["matrix"]["diagonals"], config["matrix"]["baby_steps"]
    babies = [ct] + [scheme.rotate_lazy(ct, rotation_exponent(j, n), keys[f"rot{j}"])
                     for j in range(1, g)]
    acc = None
    for i in range(-(-D // g)):
        inner = None
        for j in range(min(g, D - g * i)):
            pt = eval_automorphism(diags[g * i + j], rotation_exponent(-g * i, n))
            t = scheme.mul_plain(babies[j], pt)
            inner = t if inner is None else scheme.add(inner, t)
        if i:
            inner = scheme.rotate_lazy(inner, rotation_exponent(g * i, n), keys[f"rot{g * i}"])
        acc = inner if acc is None else scheme.add(acc, inner)
    return scheme.rescale(acc)
