"""Rotate-and-sum: a rotation and an addition for each rotation key, on B
ciphertexts."""

from __future__ import annotations

from portbench import roofline as rf


def steps(w, ring, config: dict, B: int) -> None:
    n, L = ring.n, ring.L
    k = len(config["keys"]["rotations"])
    ct = 2 * B * L * n * rf.WORD
    for _ in range(k):
        rf.keyswitch(w, n, L, B, heads=1, tails=1, in_cts=1, out_cts=1)
        w.add("elementwise", 3 * ct, 2 * B * L * n * rf.ELEM_OPS)
    w.add("ks", k * rf.key_bytes(n, L))


def work(ring, config: dict, traffic: dict) -> dict:
    w = rf.Work()
    steps(w, ring, config, traffic["batch"])
    w.add("ks", 2 * (ring.L + 1) * ring.n * rf.TABLE_WORD)
    return w.families
