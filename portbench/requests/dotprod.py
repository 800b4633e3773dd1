"""ct_mul, relinearize, rotate-and-sum, rescale: the system's dot product."""

from __future__ import annotations

from portbench.requests import rotsum


def prepare(cfg, config: dict, keys: dict, extra: dict, device) -> dict:
    return dict(rotsum.prepare(cfg, config, keys, extra, device), relin=keys["relin"])


def serve(cfg, prepared: dict, cts):
    from aloha_tpu_torch import he_torch as ht

    x, y = cts
    ct = ht.relinearize(*ht.ct_mul(x, y, cfg), prepared["relin"], cfg)
    return ht.rescale(rotsum.rotate_and_sum(cfg, prepared, ct), cfg)
