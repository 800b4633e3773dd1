"""Encrypted dot product of two vectors (HEBench's "Dot Product" shape): the
slot-wise product (ct_mul, relinearize), the rotate-and-sum of `rotsum`,
then one rescale.  Every slot holds sum_i x_i y_i."""

from __future__ import annotations

import numpy as np

from portbench.reference import encoder, rotsum

CIPHERTEXTS = 2


def draw_extra(gen, config: dict, ring) -> dict:
    return {}


def scale(ring) -> float:
    return encoder.SCALE ** 2 / ring.moduli[ring.L - 1]


def expected(config: dict, extra: dict, slots: np.ndarray) -> np.ndarray:
    return rotsum.total(slots[0] * slots[1])


def prepare(scheme, config: dict, extra: dict):
    return None


def reference(scheme, config: dict, prepared, keys: dict, cts):
    x, y = cts
    ct = scheme.relinearize(*scheme.ct_mul(x, y), keys["relin"])
    return scheme.rescale(rotsum.rotate_and_sum(scheme, config, keys, ct))
