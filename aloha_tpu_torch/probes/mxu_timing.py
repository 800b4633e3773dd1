"""Time the tensor-core NTT (csrc/ntt_mxu.cu) at n = 4096 and 8192.

    python -m aloha_tpu_torch.probes.mxu_timing
    PYTHONPATH=<another checkout> python aloha_tpu_torch/probes/mxu_timing.py

For `ops.ntt_mxu`: the forward transform of the bench's case (1, 256,
8192) under q0 and of (1, 256, 4096), the CUDA-event mean of 15 launches
after 3 warm-ups as chip_smoke.py times every case, each first held
word for word against its plain version; the chain's marginal ns per
polynomial per transform (k = 1 -> 9 at nb = 256, `common.marginal`, as
chip_smoke.py's) at both rings; and ptxas' registers and spill of every
`ntt_mxu_kernel` instance.

It calls only what every checkout since the kernel went onto `wgmma` has
(`ntt_mxu.transform`, `.chain`, `.transform_plain`, `probes.common`), so
that, run as a file with another checkout first on PYTHONPATH, it builds
and times that checkout's kernels: two checkouts compare in one call, in
turns (A, B, B, A).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch.ops import ntt_mxu
from aloha_tpu_torch.probes import common as C

MARGINAL_K = (1, 9)  # chip_smoke.py's MXU_MARGINAL_K


def time_us(fn, warmup: int = 3, iters: int = 15) -> float:
    """chip_smoke.py's `time_us`: one call's mean over `iters` calls between two events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def main():
    card = C.require_card()
    dev = torch.device("cuda", 0)
    out = {"tree": str(_build.CSRC.parent.parent), "card": card,
           "registers": {k: list(v) for k, v in _build.ptxas_usage("ntt_mxu_kernel").items()}}
    q = CFG.moduli[0]
    for n in (8192, 4096):
        psi = pow(CFG.psi[0], CFG.n // n, q)
        x = torch.from_numpy(np.random.default_rng(0).integers(
            0, q, size=(1, C.NB_TIME, n), dtype=np.uint64).view(np.int64)).to(dev)
        run = lambda: ntt_mxu.transform(x, (q,), (psi,), False)  # noqa: E731
        if not torch.equal(run(), ntt_mxu.transform_plain(x, (q,), (psi,), False)):
            raise SystemExit(f"n={n}: the kernel differs from its plain version")
        ns, t_lo, t_hi, spread = C.marginal(
            lambda k: ntt_mxu.chain(x[0], q, psi, k, False), MARGINAL_K)
        out[f"n={n}"] = {"fwd_us": time_us(run), "chain_marginal_ns": ns,
                         "chain_t_ms": [t_lo, t_hi], "spread_ms": spread,
                         "shape": [1, C.NB_TIME, n]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
