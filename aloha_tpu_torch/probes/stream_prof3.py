"""Pure-compute cost of the forward transform on the card (the port of tools/stream_prof3.py).

    python -m aloha_tpu_torch.probes.stream_prof3

Replaces the TPU kernel of tools/stream_prof3.py:29 (`make(reps)` ->
`body`: REPS forward transforms of resident planes by the streaming stage
loops, no DMA) with the `full` mode of `aloha_probe_stage_modes` in
`csrc/probe_stages.cu` (the kernel of `stream_prof.stage_modes`):
`csrc/ntt.cu`'s transform itself (`ntt_regs::run`: 4 register passes of
16 words a thread), REPS times on nb polynomials held in registers,
chained through one shared buffer (4 exchanges a transform), one load
and one store.  The marginal over REPS 20 and 120 (the TPU script's) at
nb = 256 is the time of one such transform without the launch, loads and
stores.

Bound on the H100: integer issue, `NEEDED_OPS` INT32 instructions per
transform (`OPS`, frozen, is the stage loop's count with an index per
butterfly).
"""

from __future__ import annotations

import sys

import torch

from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.probes import common as C

REPS = (20, 120)
#: INT32 instructions of one transform on one polynomial: 13 stages of
#: butterflies, then two conditional subtracts per word (frozen: each
#: butterfly with the stage loop's index arithmetic)
OPS = C.N // 2 * C.LOGN * C.CT_BUTTERFLY + C.N * 2 * C.CONDSUB
#: the same without the per-butterfly index, which the register passes do
#: not compute: 30 INT32 a butterfly
NEEDED_OPS = C.N // 2 * C.LOGN * (C.CT_BUTTERFLY - C.INDEX) + C.N * 2 * C.CONDSUB
_FULL = 0  # the stage-modes entry's mode of the forward transform (stream_prof.MODES)


def fwd_reps_plain(x, reps: int):
    """Plain PyTorch version: `ntt_torch.ntt` under q0, `reps` times."""
    for _ in range(reps):
        x = ntt_torch.ntt(x, C.Q, C.PSI)
    return x


def fwd_reps(x, reps: int):
    """`reps` forward transforms of x (nb, N) int64 (entries < 4q0) under
    q0, each canonical.  CPU tensors take the plain version, CUDA tensors
    the kernel."""
    C.check_reps(reps)
    if not dispatch.use_kernel(x):
        return fwd_reps_plain(x, reps)
    y = C.launch("aloha_probe_stage_modes", x, _FULL, x.shape[0], reps)
    fwd_reps.launches += 1
    return y


fwd_reps.launches = 0


def measure(device):
    """(ns per polynomial per transform, t_lo ms, t_hi ms) of the kernel
    at nb = C.NB_TIME and REPS."""
    x = C.resident_data(C.NB_TIME, device)
    return C.marginal_ns(lambda r: fwd_reps(x, r), REPS)


def main(argv=None):
    C.names(sys.argv[1:] if argv is None else argv, ())
    card = C.require_card()
    ns, t_lo, t_hi = measure(torch.device("cuda", 0))
    print(f"nb={C.NB_TIME} compute-only: {ns / 1e3:.4f} us/poly ({ns:.1f} ns) "
          f"t({REPS[0]})={t_lo:.4f} ms t({REPS[1]})={t_hi:.4f} ms ops/poly={NEEDED_OPS} "
          f"(frozen count {OPS}) on {card}",
          flush=True)


if __name__ == "__main__":
    main()
