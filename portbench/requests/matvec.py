"""matvec_bsgs then rescale: the system's encrypted matrix-vector product."""

from __future__ import annotations

import numpy as np
import torch


def prepare(cfg, config: dict, keys: dict, extra: dict, device) -> dict:
    """Encode the diagonals with the system's encoder and pick the keys of
    the baby and giant steps."""
    from aloha_tpu_torch import encoder, he_torch

    D, g = config["matrix"]["diagonals"], config["matrix"]["baby_steps"]
    coeffs = np.stack([encoder.encode(encoder.cleartext_from_slots(d + 0j), cfg)
                       for d in extra["diagonals"]])
    diags = he_torch.encode_post(torch.from_numpy(coeffs.view(np.int64)).to(device), cfg)
    return {"diags": list(diags), "g": g,
            "baby": [keys[f"rot{j}"] for j in range(1, g)],
            "giant": [keys[f"rot{g * i}"] for i in range(1, -(-D // g))]}


def serve(cfg, prepared: dict, cts):
    from aloha_tpu_torch import he_torch as ht

    (ct,) = cts
    p = prepared
    return ht.rescale(ht.matvec_bsgs(ct, p["diags"], p["baby"], p["giant"], cfg, g=p["g"]), cfg)
