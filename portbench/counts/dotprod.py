"""ct_mul, relinearize, rotate-and-sum and rescale on B ciphertext pairs."""

from __future__ import annotations

from portbench import roofline as rf
from portbench.counts import rotsum


def work(ring, config: dict, traffic: dict) -> dict:
    n, L, B = ring.n, ring.L, traffic["batch"]
    ct = 2 * B * L * n * rf.WORD
    coeffs = B * L * n
    w = rf.Work()
    # (a1 a2, a1 b2 + b1 a2, b1 b2): two ciphertexts in, three polynomials out
    w.add("elementwise", 2 * ct + 3 * ct // 2, coeffs * (4 * rf.MULMOD_OPS + rf.ELEM_OPS))
    rf.keyswitch(w, n, L, B, heads=1, tails=1, in_cts=0, out_cts=1)
    w.add("ks", ct // 2 + rf.key_bytes(n, L))  # d2 in, the relinearization key
    w.add("elementwise", 2 * ct + ct, 2 * coeffs * rf.ELEM_OPS)  # (d0, d1) + the switched d2
    rotsum.steps(w, ring, config, B)
    w.add("ks", 2 * (L + 1) * n * rf.TABLE_WORD)
    rf.rescale(w, n, L, B)
    return w.families
