"""Rotate-and-sum: every slot of each encrypted vector replaced by the sum of
all its slots (HElib's totalSums), by rotations by 1, 2, 4, ..., n/4 and an
addition after each: x <- x + rot_s(x).  No rescale."""

from __future__ import annotations

import numpy as np

from portbench.reference import encoder
from portbench.reference.ckks import rotation_exponent

CIPHERTEXTS = 1


def draw_extra(gen, config: dict, ring) -> dict:
    return {}


def scale(ring) -> float:
    return encoder.SCALE


def steps(config: dict) -> list:
    return list(config["keys"]["rotations"])


def total(z: np.ndarray) -> np.ndarray:
    """(B, n/2) -> each vector's slot sum in every slot."""
    return np.broadcast_to(z.sum(axis=-1, keepdims=True), z.shape)


def expected(config: dict, extra: dict, slots: np.ndarray) -> np.ndarray:
    return total(slots[0])


def prepare(scheme, config: dict, extra: dict):
    return None


def rotate_and_sum(scheme, config: dict, keys: dict, ct):
    n = scheme.ring.n
    for s in steps(config):
        ct = scheme.add(ct, scheme.rotate(ct, rotation_exponent(s, n), keys[f"rot{s}"]))
    return ct


def reference(scheme, config: dict, prepared, keys: dict, cts):
    (ct,) = cts
    return rotate_and_sum(scheme, config, keys, ct)
