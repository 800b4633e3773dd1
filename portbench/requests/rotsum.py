"""Rotate-and-sum at full level: a rotation and an addition a key."""

from __future__ import annotations


def prepare(cfg, config: dict, keys: dict, extra: dict, device) -> dict:
    return {"steps": [(s, keys[f"rot{s}"]) for s in config["keys"]["rotations"]]}


def rotate_and_sum(cfg, prepared: dict, ct):
    from aloha_tpu_torch import he_torch as ht

    for step, key in prepared["steps"]:
        ct = ht.hom_add(ct, ht.rotate(ct, step, key, cfg), cfg)
    return ct


def serve(cfg, prepared: dict, cts):
    (ct,) = cts
    return rotate_and_sum(cfg, prepared, ct)
