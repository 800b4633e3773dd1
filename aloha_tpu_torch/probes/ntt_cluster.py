"""Where a cluster of CTAs per polynomial pays: csrc/ntt.cu forced onto each size.

    python -m aloha_tpu_torch.probes.ntt_cluster [n ...]

Below one wave (fewer CTAs than SMs) csrc/ntt.cu splits each polynomial
over a cluster of C CTAs, and `ntt_stream.cluster_size` says which C a
launch takes.  This probe times the kernel forced onto C = 1, 2 and 4
(`ntt_stream._launch`'s internal argument) in a CUDA-graph burst
(`common.graph_ms`: device time, no host between the calls) at lengths n =
1024 to 16384 (or those named), M = 1 and 3 moduli, both directions, and
batches from one polynomial to two waves of CTAs, beside the size the
kernel chooses (an inverse below n = 4096 has no cluster instance:
C = 1 alone there).  Every forced size's words are held against C = 1's
(torch.equal).  One line per shape, then the crossover of each (n, M,
direction): the largest CTA count at which a cluster is still faster.
Run it when the rule in `aloha_ntt_cluster` (csrc/ntt.cu) is re-tuned; it
exits 1 without CUDA.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch.ops import ntt_stream
from aloha_tpu_torch.probes import common as C

LENGTHS = (1024, 2048, 4096, 8192, 16384)
#: CTA counts (nb M) of the scan: one polynomial up to two waves of 132 SMs
CTAS = (1, 8, 16, 32, 48, 64, 96, 128, 132, 264)
SIZES = (1, 2, 4)
MS = (1, 3)


def _ring(n: int, M: int, inverse: bool):
    """M moduli of length-n transforms and their roots: q0, q1, P up to N,
    q0, q1, q0 at 2N (2N does not divide P - 1), as chip_smoke.py's ntt_ring."""
    qs = (CFG.moduli if n <= CFG.n else (CFG.moduli[0], CFG.moduli[1], CFG.moduli[0]))[:M]
    roots = []
    for m, q in enumerate(qs):
        if n <= CFG.n:
            psi = pow(CFG.psi[m], CFG.n // n, q)
        else:
            psi = next(r for r in (pow(g, (q - 1) // (2 * n), q) for g in range(2, 100))
                       if pow(r, n, q) == q - 1)
        roots.append(pow(psi, -1, q) if inverse else psi)
    return tuple(qs), tuple(roots)


def scan(n: int, M: int, inverse: bool, device) -> list:
    """[(nb, {C: graph µs}, chosen C)] at each CTA count of CTAS."""
    qs, roots = _ring(n, M, inverse)
    w, ws, q = ntt_torch.tables(n, qs, roots, device)
    top = 2 if inverse else 4
    nbs = sorted({max(1, ctas // M) for ctas in CTAS})
    rng = np.random.default_rng(n + M)
    a = np.stack([rng.integers(0, qq, size=(max(nbs), n), dtype=np.uint64)
                  + np.uint64(qq) * rng.integers(0, top, size=(max(nbs), n), dtype=np.uint64)
                  for qq in qs])
    x = cv.from_u64(a, device)
    rows = []
    for nb in nbs:
        xb = x[:, :nb].contiguous()
        sizes = [c for c in SIZES if c <= ntt_stream.max_cluster(n, inverse)]
        want = ntt_stream._launch(xb, w, ws, q, inverse, "ntt", cluster=1)[0]
        for c in sizes[1:]:
            got = ntt_stream._launch(xb, w, ws, q, inverse, "ntt", cluster=c)[0]
            if not torch.equal(got, want):
                raise SystemExit(f"n={n} M={M} nb={nb}: C={c} differs from C=1")
        us = {c: C.graph_ms(lambda c=c: ntt_stream._launch(xb, w, ws, q, inverse, "ntt",
                                                          cluster=c)) * 1e3
              for c in sizes}
        rows.append((nb, us, ntt_stream.cluster_size(device, M, nb, n, inverse)))
    return rows


def crossover(rows, M: int):
    """The largest CTA count at which some cluster beats C = 1, and where
    each size is fastest: {C: [CTA counts]}."""
    best = {}
    last = 0
    for nb, us, _ in rows:
        c = min(us, key=us.get)
        best.setdefault(c, []).append(nb * M)
        if c > 1:
            last = nb * M
    return last, best


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    lengths = [int(a) for a in args] or list(LENGTHS)
    bad = [n for n in lengths if n not in LENGTHS]
    if bad:
        raise SystemExit(f"unknown lengths {bad}; choose from {list(LENGTHS)}")
    card = C.require_card()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in lengths:
        for M in MS:
            for inverse in (False, True):
                rows = scan(n, M, inverse, dev)
                name = f"{'inv' if inverse else 'fwd'} n={n} M={M}"
                for nb, us, chosen in rows:
                    fastest = min(us, key=us.get)
                    print(f"ntt cluster {name} nb={nb} ctas={nb * M}: graph_us "
                          + ", ".join(f"C={c} {t:.2f}" for c, t in us.items())
                          + f"; chosen C={chosen} ({us[chosen] / us[fastest]:.3f}x the "
                          f"fastest, C={fastest}) on {card}", flush=True)
                last, best = crossover(rows, M)
                print(f"ntt cluster crossover {name}: a cluster is faster up to {last} CTAs "
                      f"of {sms} SMs; fastest C by CTA count {best}", flush=True)


if __name__ == "__main__":
    main()
