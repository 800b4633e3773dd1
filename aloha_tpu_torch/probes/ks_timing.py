"""The fused key-switch pair at the serving shapes, eager and in a CUDA graph.

    python -m aloha_tpu_torch.probes.ks_timing [--unchecked]

Times `ops.ks_kernel.ks_head` and `ks_tail` (csrc/ks.cu) at N = 8192, L = 2
on the shapes the serving request and the multiply path launch: the
hoisted head (the baby steps) and the head with an automorphism at nb = 16,
the hoisted head at nb = 48 (the giant steps' batch), and the tail with
three keys over shared inputs at nb = 16, with three batched keys at nb =
48, and with one key (Shoup and Barrett products) at nb = 16.  Each case
is held against its plain version (torch.equal), then timed eager
(`common.time_ms`: calls enqueued back to back) and in a CUDA-graph burst
(`common.graph_ms`: device time, no host between the calls).  Beside each
tail, where the tree's ks_tail has cluster instances
(`ks_kernel.tail_clusters`), the same case forced onto each of them in a
graph, its words compared, and the C the launch chooses
(`ks_kernel.cluster_size`).  One line per case, with the card; it exits 1
without CUDA.  It uses only the wrappers' public calls, so it also times
an older tree of the package put first on PYTHONPATH.  --unchecked skips the
comparisons: for a build cut apart to time its parts (PERF.md §5), whose
words differ by design.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from aloha_tpu_torch import convert as cv
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch.ops import ks_kernel as K
from aloha_tpu_torch.probes import common as C

B = 16  # ciphertexts of a serving request
SEED = 14


def cases(dev) -> list:
    """[(kernel, label, run, plain, ctas)]: a tail's run takes the cluster
    as keywords (none: the kernel's choice) and ctas is its launch's CTA
    count at one CTA a polynomial; a head's ctas is 0."""
    rng = np.random.default_rng(SEED)
    L, n, mod = CFG.n_limbs, CFG.n, CFG.moduli

    def rand(nb, moduli):
        return cv.from_u64(
            np.stack([rng.integers(0, q, size=(nb, n), dtype=np.uint64) for q in moduli]), dev)

    def key():
        rows = [rng.integers(0, mod[p // (2 * L)], size=n, dtype=np.uint64)
                for p in range(2 * L * (L + 1))]
        return cv.from_u64(np.stack(rows), dev)

    b16, b48 = rand(B, mod[:L]), rand(3 * B, mod[:L])
    e = pow(3, 5, 2 * n)
    out = [("ks_head", f"hoisted nb={B}", lambda: K.ks_head(b16, None, CFG),
            lambda: K.ks_head_plain(b16, None, CFG), 0),
           ("ks_head", f"aut nb={B}", lambda: K.ks_head(b16, e, CFG),
            lambda: K.ks_head_plain(b16, e, CFG), 0),
           ("ks_head", f"hoisted nb={3 * B}", lambda: K.ks_head(b48, None, CFG),
            lambda: K.ks_head_plain(b48, None, CFG), 0)]
    nd16, nd48 = K.ks_head(b16, None, CFG), K.ks_head(b48, None, CFG)
    r16, r48 = rand(B, mod[:L]), rand(3 * B, mod[:L])
    raw = [key() for _ in range(3)]
    prep = [K.prepare_ksk(k, CFG, aut_exp=pow(3, s, 2 * n)) for k, s in zip(raw, (1, 2, 3))]
    k3, s3 = torch.stack([p[0] for p in prep]), torch.stack([p[1] for p in prep])
    out += [("ks_tail", f"shared K=3 nb={B}",
             lambda **c: K.ks_tail(nd16, r16, k3, CFG, kshoup=s3, shared_inputs=True, **c),
             lambda: K.ks_tail_plain(nd16, r16, k3, CFG, shared_inputs=True), 3 * B * 2),
            ("ks_tail", f"batched K=3 nb={3 * B}",
             lambda **c: K.ks_tail(nd48, r48, k3, CFG, kshoup=s3, **c),
             lambda: K.ks_tail_plain(nd48, r48, k3, CFG), 3 * B * 2),
            ("ks_tail", f"single nb={B} shoup",
             lambda **c: K.ks_tail(nd16, r16, prep[0][0], CFG, kshoup=prep[0][1], **c),
             lambda: K.ks_tail_plain(nd16, r16, prep[0][0], CFG), B * 2),
            ("ks_tail", f"single nb={B} barrett",
             lambda **c: K.ks_tail(nd16, r16, raw[0], CFG, **c),
             lambda: K.ks_tail_plain(nd16, r16, raw[0], CFG), B * 2)]
    return out


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    if args not in ([], ["--unchecked"]):
        raise SystemExit(f"unknown arguments {args}; only --unchecked")
    checked = not args
    card = C.require_card()
    dev = torch.device("cuda", 0)
    clusters = getattr(K, "tail_clusters", None)
    for kernel, label, run, plain, ctas in cases(dev):
        want = plain() if checked else None
        if checked and not torch.equal(run(), want):
            raise SystemExit(f"{kernel} {label}: kernel differs from plain")
        line = (f"ks timing {kernel} {label}: eager_us={C.time_ms(run) * 1e3:.2f} "
                f"graph_us={C.graph_ms(run) * 1e3:.2f}")
        if clusters is not None and ctas:
            line += f" C={K.cluster_size(dev, ctas, CFG.n)}; forced graph_us"
            for c in clusters(CFG.n):
                if checked and not torch.equal(run(cluster=c), want):
                    raise SystemExit(f"{kernel} {label}: C={c} differs from plain")
                line += f" C={c} {C.graph_ms(lambda: run(cluster=c)) * 1e3:.2f}"
        print(f"{line} on {card}", flush=True)


if __name__ == "__main__":
    main()
