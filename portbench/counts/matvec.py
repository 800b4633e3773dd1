"""matvec_bsgs (D diagonals, g baby steps) and rescale on B ciphertexts."""

from __future__ import annotations

from portbench import roofline as rf


def work(ring, config: dict, traffic: dict) -> dict:
    n, L, B = ring.n, ring.L, traffic["batch"]
    D, g = config["matrix"]["diagonals"], config["matrix"]["baby_steps"]
    b = -(-D // g)
    ct = 2 * B * L * n * rf.WORD
    w = rf.Work()
    rf.keyswitch(w, n, L, B, heads=1, tails=g - 1, in_cts=1, out_cts=g - 1)  # hoisted babies
    rf.keyswitch(w, n, L, B, heads=b - 1, tails=b - 1, in_cts=b - 1, out_cts=b - 1)  # giants
    w.add("ks", (g - 1 + b - 1) * rf.key_bytes(n, L) + 2 * (L + 1) * n * rf.TABLE_WORD)
    coeffs = 2 * B * L * n  # residues of one ciphertext
    # the inner sums: babies and diagonals in, one sum a giant step out
    w.add("elementwise", g * ct + D * L * n * rf.WORD + b * ct,
          D * coeffs * rf.MULMOD_OPS + (D - b) * coeffs * rf.ELEM_OPS)
    # the giant steps' sum
    w.add("elementwise", b * ct + ct, (b - 1) * coeffs * rf.ELEM_OPS)
    rf.rescale(w, n, L, B)
    return w.families
