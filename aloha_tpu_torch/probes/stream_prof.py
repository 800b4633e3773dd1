"""The 13-stage loop's cost split on the card (the port of tools/stream_prof.py).

    python -m aloha_tpu_torch.probes.stream_prof [full rollsonly noroll]

Replaces the TPU kernel of tools/stream_prof.py:81 (`make_body(mode)` ->
`body`: REPS steps of 13 stages on resident (512, 128) planes) with
`aloha_probe_stage_modes` of `csrc/probe_stages.cu`, on `csrc/ntt.cu`'s
geometry: nb polynomials of 512 threads x 16 words in registers, one
load and one store, words exchanged through one swizzled shared buffer:

- full: `csrc/ntt.cu`'s forward transform (`ntt_regs::run`, real
  butterflies, canonical output), chained through shared memory: 4
  passes and 4 exchanges a repetition;
- rollsonly: the partner exchange and an add, no multiply: both words of a
  pair become their sum, the 32-bit halves added separately as the TPU
  body adds its u32 planes; the TPU's distances (six sublane stages 4096
  .. 128, seven lane stages 32 .. 1 and 32), in four register maps, 4
  exchanges a repetition;
- noroll: the butterfly with partner = self, x <- condsub(x, 2q) + x w_s(i)
  with stage s's twiddle of element i, no exchange.

rollsonly prices the exchanges (with a trivial add), full - rollsonly the
butterflies' arithmetic, and noroll the elementwise product alone (one on
every word: twice a butterfly stage's).  The TPU script timed one REPS =
50; the marginal takes REPS 10 and 50 at nb = 256.

Bound on the H100: integer issue.  `NEEDED_OPS[mode]` counts the INT32
instructions the function needs per polynomial per repetition (no index
arithmetic: the register passes compute none per butterfly); `OPS[mode]`
keeps the count the shared-memory stage loop was held to, so that the
times of both designs compare on the same work.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.probes import common as C
from aloha_tpu_torch.probes import stream_prof3

MODES = ("full", "rollsonly", "noroll")
REPS = (10, 50)
#: log2 of each rollsonly stage's distance: the TPU's row stages 32 .. 1
#: (x 128 words), then its lane stages 32 .. 1 and 32
ROLL_SHIFTS = tuple(12 - s for s in range(6)) + tuple(5 - s % 6 for s in range(7))

#: INT32 instructions of one repetition (13 stages) on one polynomial, as
#: the stage loop was counted, each pair or word with its index (frozen)
OPS = {
    "full": stream_prof3.OPS,
    "rollsonly": C.LOGN * C.N // 2 * (C.INDEX + 2),  # two 32-bit adds per pair
    "noroll": C.LOGN * C.N * (C.CONDSUB + C.SHOUP + C.ADD64 + C.INDEX),
}
#: the same without the index arithmetic: the work the function needs
NEEDED_OPS = {
    "full": stream_prof3.NEEDED_OPS,
    "rollsonly": C.LOGN * C.N // 2 * 2,
    "noroll": C.LOGN * C.N * (C.CONDSUB + C.SHOUP + C.ADD64),
}


def edge_data(nb: int, device, seed: int = 0) -> torch.Tensor:
    """(nb, N) int64 words in [0, 4q0), every mode's input window: random
    ones, with polynomial 0 cycling through 0, q - 1, 2q and 4q - 1 and
    every polynomial's first and last words at 4q - 1 and 0."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4 * C.Q, size=(nb, C.N), dtype=np.int64)
    x[0] = np.resize(np.array([0, C.Q - 1, 2 * C.Q, 4 * C.Q - 1], dtype=np.int64), C.N)
    x[:, 0], x[:, -1] = 4 * C.Q - 1, 0
    return torch.from_numpy(x).to(device)


def stage_modes_plain(x, mode: str, reps: int):
    """Plain PyTorch version: `reps` repetitions of the mode's 13 stages on
    x (nb, N) int64 under q0."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    if mode == "full":
        return stream_prof3.fwd_reps_plain(x, reps)
    for _ in range(reps):
        if mode == "rollsonly":
            for sh in ROLL_SHIFTS:
                z = C.add32x2(*C.pairs(x, sh))
                x = C.join(z, z)
        else:
            for s in range(C.LOGN):
                w, ws = C.twiddle_row(s, x.device)
                x = rt.plain.lazy_reduce(x, 2 * C.Q) + rt.plain.mulmod_shoup(x, w, ws, C.Q)
    return x


def stage_modes(x, mode: str, reps: int):
    """`reps` repetitions of the mode's 13 stages on x (nb, N) int64
    (entries < 4q0 for full and noroll) under q0.  CPU tensors take the
    plain version, CUDA tensors the kernel."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    C.check_reps(reps)
    if not dispatch.use_kernel(x):
        return stage_modes_plain(x, mode, reps)
    y = C.launch("aloha_probe_stage_modes", x, MODES.index(mode), x.shape[0], reps)
    stage_modes.launches += 1
    return y


stage_modes.launches = 0


def measure(modes, device):
    """[(mode, ns per polynomial per repetition, t_lo ms, t_hi ms)] at nb =
    C.NB_TIME and REPS."""
    x = C.resident_data(C.NB_TIME, device)
    return [(m, *C.marginal_ns(lambda r: stage_modes(x, m, r), REPS)) for m in modes]


def main(argv=None):
    chosen = C.names(sys.argv[1:] if argv is None else argv, MODES)
    card = C.require_card()
    for m, ns, t_lo, t_hi in measure(chosen, torch.device("cuda", 0)):
        print(f"{m}: {ns / 1e3:.4f} us/poly-transform ({ns / C.LOGN:.2f} ns/stage) "
              f"t({REPS[0]})={t_lo:.4f} ms t({REPS[1]})={t_hi:.4f} ms nb={C.NB_TIME} "
              f"ops/poly/rep={NEEDED_OPS[m]} (frozen count {OPS[m]}) on {card}", flush=True)


if __name__ == "__main__":
    main()
