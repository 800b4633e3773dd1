"""Time the stage-modes probe's kernel beside csrc/ntt.cu's forward transform.

    python -m aloha_tpu_torch.probes.stage_modes_timing
    PYTHONPATH=<another checkout> python aloha_tpu_torch/probes/stage_modes_timing.py

For `aloha_probe_stage_modes` (csrc/probe_stages.cu, `stream_prof` and
`stream_prof3`): each mode's marginal ns per polynomial per repetition at
nb = 256 (`stream_prof.REPS`; full also at `stream_prof3.REPS`) with the
spread of its tries, and the full mode at nb = 8, reps = 3 eager and in a
CUDA-graph burst (`common.time_ms`, `common.graph_ms`); in the same
process csrc/ntt.cu's forward marginal ns per polynomial over the batch
(nb = 256 -> 1024, `common.batch_marginal`); and ptxas' registers and
spill of the stage-modes kernels and of ntt_regs_kernel<13, false, 1>.

It calls only what every checkout since the probes were ported has
(`stream_prof.stage_modes`, `stream_prof3.fwd_reps`, `probes.common`,
`ops.ntt_stream`), so that, run as a file with another checkout first on
PYTHONPATH, it builds and times that checkout's kernels: two checkouts
compare in one call, in turns (A, B, B, A).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch.ops import ntt_stream
from aloha_tpu_torch.probes import common as C
from aloha_tpu_torch.probes import stream_prof, stream_prof3

NTT_NB = (256, 1024)  # the batches of ntt.cu's marginal (chip_smoke.py's)


def main():
    card = C.require_card()
    dev = torch.device("cuda", 0)
    print(f"tree: {_build.CSRC.parent.parent} on {card}", flush=True)
    regs = {}
    for name, use in _build.ptxas_usage("stage_modes_kernel").items():
        regs[stream_prof.MODES[int(re.search(r"stage_modes_kernelILi(\d)E", name).group(1))]] = use
    ntt = _build.ptxas_usage("ntt_regs_kernelILi13ELb0ELi1E")
    print("registers/spill stores/spill loads: " + ", ".join(
        f"{m} {'/'.join(map(str, regs[m]))}" for m in stream_prof.MODES)
        + "; ntt_regs_kernel<13, false, 1> " + ", ".join('/'.join(map(str, u)) for u in ntt.values()),
        flush=True)

    x = C.resident_data(C.NB_TIME, dev)
    for mode in stream_prof.MODES:
        y = stream_prof.stage_modes(x[:8], mode, 3)
        if not torch.equal(y, stream_prof.stage_modes_plain(x[:8], mode, 3)):
            raise SystemExit(f"{mode}: the kernel differs from its plain version")
    for mode, run, reps in [(m, lambda r, m=m: stream_prof.stage_modes(x, m, r), stream_prof.REPS)
                            for m in stream_prof.MODES] + [
                               ("full (fwd_reps)", lambda r: stream_prof3.fwd_reps(x, r),
                                stream_prof3.REPS)]:
        ns, t_lo, t_hi, spread = C.marginal(run, reps)
        print(f"{mode}: marginal {ns:.3f} ns per polynomial per repetition, REPS {reps[0]} -> "
              f"{reps[1]}, t_lo={t_lo:.4f} ms t_hi={t_hi:.4f} ms spread={spread:.4f} ms "
              f"nb={C.NB_TIME} on {card}", flush=True)
    small = x[:C.SMALL[0]]
    call = lambda: stream_prof3.fwd_reps(small, C.SMALL[1])  # noqa: E731
    print(f"full nb={C.SMALL[0]} reps={C.SMALL[1]}: eager {C.time_ms(call) * 1e3:.2f} us, graph "
          f"{C.graph_ms(call) * 1e3:.2f} us per call on {card}", flush=True)

    q, psi = CFG.moduli[0], CFG.psi[0]
    big = torch.from_numpy(np.random.default_rng(1).integers(
        0, q, size=(1, NTT_NB[1], CFG.n), dtype=np.uint64).view(np.int64)).to(dev)
    ns, t_lo, t_hi, spread = C.batch_marginal(
        lambda nb: ntt_stream.transform(big[:, :nb], (q,), (psi,), False), NTT_NB)
    print(f"ntt fwd q0: marginal {ns:.3f} ns per polynomial, nb {NTT_NB[0]} -> {NTT_NB[1]}, "
          f"t_lo={t_lo:.4f} ms t_hi={t_hi:.4f} ms spread={spread:.4f} ms on {card}", flush=True)


if __name__ == "__main__":
    main()
