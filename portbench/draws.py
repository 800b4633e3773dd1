"""Every input of a run, drawn from its seed.

One `torch.Generator` on the run's device, seeded with --seed, draws in a
fixed order and at sizes fixed by the cell: the ternary secret; for each
evaluation key of the configuration the uniform words and the error of each
digit; what the request kind needs beside (a matrix); then the pool of
request batches: their cleartext slots, encryption errors and uniform
b-parts.  Every seed draws the same sizes.  Both sides get these tensors;
each derives its own keys, encodings and encryptions from them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SIGMA = 3.2  # standard deviation of the error polynomials
SLACK_BITS = 128  # random bits beyond the modulus product in a uniform draw


@dataclasses.dataclass
class Draws:
    secret: torch.Tensor  # (n,) int64 in {-1, 0, 1}
    keys: dict  # key name -> (chunks (L, c, n) 63-bit words, noise (L, n))
    extra: dict  # what the request kind draws (`requests.<kind>.draw_extra`)
    slots: np.ndarray  # (pool, k, B, n/2) complex128 cleartexts, k a request's vectors
    noise: torch.Tensor  # (pool, k, B, n) int64 encryption errors
    b: torch.Tensor  # (pool, k, B, L, n) int64 uniform residues


def key_names(config: dict) -> list:
    """The configuration's evaluation keys: "rot<step>" for each rotation
    step, then "relin" where it relinearizes."""
    keys = config["keys"]
    return [f"rot{s}" for s in keys["rotations"]] + (["relin"] if keys["relinearization"] else [])


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def noise(gen, shape) -> torch.Tensor:
    x = torch.normal(0.0, SIGMA, tuple(shape), generator=gen, dtype=torch.float64,
                     device=gen.device)
    return torch.round(x).to(torch.int64)


def uniform_slots(gen, shape) -> np.ndarray:
    re, im = (torch.rand(tuple(shape), generator=gen, dtype=torch.float64, device=gen.device)
              for _ in range(2))
    return ((2 * re - 1) + 1j * (2 * im - 1)).cpu().numpy()


def draw(ring, config: dict, traffic: dict, request, seed: int, device) -> Draws:
    """ring: `reference.ckks.Ring`; request: the request kind's module."""
    gen = generator(seed, device)
    n, L = ring.n, ring.L
    chunks = -(-(math.prod(ring.moduli).bit_length() + SLACK_BITS) // 63)
    secret = torch.randint(0, 3, (n,), generator=gen, device=gen.device) - 1
    keys = {}
    for name in key_names(config):
        words = torch.empty((L, chunks, n), dtype=torch.int64, device=gen.device)
        keys[name] = (words.random_(generator=gen), noise(gen, (L, n)))
    extra = request.draw_extra(gen, config, ring)
    lead = (traffic["pool"], request.CIPHERTEXTS, traffic["batch"])
    slots = uniform_slots(gen, lead + (n // 2,))
    err = noise(gen, lead + (n,))
    b = torch.stack([torch.randint(0, q, lead + (n,), generator=gen, device=gen.device)
                     for q in ring.moduli[:L]], dim=-2)
    return Draws(secret=secret, keys=keys, extra=extra, slots=slots, noise=err, b=b)
