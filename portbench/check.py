"""Whether the answers the window produced are right.

The answers kept from the window (result batches in host memory, as they
came back from the card) are held against the plain reference, which
derives everything again from the run's draws:

  * mismatched_words: the words of the kept answers that differ from the
    reference's, which computes every answer of each pool batch kept.  RNS
    arithmetic is exact, so a right answer matches word for word: limit 0.
  * max_slot_error: every kept answer decrypted (with the reference's secret
    key) and decoded, against the cleartext result: the largest |error| of
    any slot.  Its limit lies between the readings of sound runs and of the
    control (`readings`).

The reference runs after the window, when the card's memory peak has been
read and the system's state freed, on blocks of ciphertexts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import draws as dr
from portbench.reference import ckks, encoder

BLOCK = 256  # ciphertexts the reference takes at once


@dataclasses.dataclass
class Kept:
    """One answer batch kept from the window: out (2, B, L', n) on the host."""

    out: torch.Tensor
    request: int
    pool: int


def reference_keys(scheme: ckks.Scheme, config: dict, draws: dr.Draws, s) -> dict:
    n = scheme.ring.n
    secret = draws.secret.to(scheme.t.device)
    keys = {}
    for name in dr.key_names(config):
        chunks, noise = (x.to(scheme.t.device) for x in draws.keys[name])
        if name == "relin":
            src = scheme.relin_secret(s)
        else:
            src = scheme.galois_secret(secret, ckks.rotation_exponent(int(name[3:]), n))
        keys[name] = scheme.ksk(src, s, chunks, noise)
    return keys


def encrypt_pool(scheme: ckks.Scheme, draws: dr.Draws, s, p: int) -> list:
    """The reference's encryptions of pool batch p: one (a, b) a vector of
    a batch element."""
    dev = scheme.t.device
    out = []
    for c in range(draws.slots.shape[1]):
        m = torch.from_numpy(encoder.encode_batch(draws.slots[p, c], scheme.ring.n)).to(dev)
        out.append(scheme.encrypt(m, s, draws.noise[p, c].to(dev), draws.b[p, c].to(dev)))
    return out


def serve_blocks(fn, cts: list) -> tuple:
    """fn applied to blocks of BLOCK batch elements, the results joined."""
    B = cts[0][0].shape[0]
    parts = [fn([(a[i:i + BLOCK], b[i:i + BLOCK]) for a, b in cts]) for i in range(0, B, BLOCK)]
    return tuple(torch.cat([p[k] for p in parts]) for k in (0, 1))


class Judge:
    """The reference of one run, built from its draws on `device`."""

    def __init__(self, ring, config: dict, kind, draws: dr.Draws, device, exact: bool = True):
        self.scheme = ckks.Scheme(ring, device, exact)
        self.config, self.kind, self.draws = config, kind, draws
        self.s = self.scheme.secret(draws.secret.to(self.scheme.t.device))
        self.keys = reference_keys(self.scheme, config, draws, self.s)
        self.prepared = kind.prepare(self.scheme, config, draws.extra)

    def serve(self, cts: list) -> tuple:
        """The reference in the system's place (the control, when inexact)."""
        return serve_blocks(
            lambda c: self.kind.reference(self.scheme, self.config, self.prepared, self.keys, c),
            cts)

    def answers(self, p: int) -> tuple:
        return self.serve(encrypt_pool(self.scheme, self.draws, self.s, p))

    def numbers(self, kept: list) -> tuple:
        """({number: value} over the kept answers, [(mismatched words, max
        slot error)] of each kept answer batch)."""
        dev = self.scheme.t.device
        want = {p: self.answers(p) for p in sorted({k.pool for k in kept})}
        scale = self.kind.scale(self.scheme.ring)
        mismatched, worst, per = 0, 0.0, []
        for k in kept:
            got = tuple(k.out[i].to(dev) for i in (0, 1))
            bad = sum(int((g != w).sum()) for g, w in zip(got, want[k.pool]))
            dec = self.scheme.decrypt(got, self.s).cpu().numpy()
            slots = encoder.decode(dec, scale)
            err = float(np.abs(slots - self.kind.expected(
                self.config, self.draws.extra, self.draws.slots[k.pool])).max())
            mismatched += bad
            worst = max(worst, err)
            per.append((bad, err))
        return {"mismatched_words": mismatched, "max_slot_error": worst}, per
