"""Cost split of the lane stages on the card (the port of tools/stream_prof2.py).

    python -m aloha_tpu_torch.probes.stream_prof2 [full-2 full-13 statT-2 ...]

Replaces the TPU kernel of tools/stream_prof2.py:64 (`make_body(mode,
nstages)` -> `body`: REPS steps of `nstages` lane stages on resident
planes) with `aloha_probe_lane_stages` of `csrc/probe_stages.cu`.  Stage
s pairs the words i and i + t, t = 8192 >> (s mod 7 + 7) (64 .. 1), with
table row s mod 13; each word of a pair takes the twiddle of its own
position, as the TPU applies its table row elementwise.  Modes:

- full: the Harvey butterfly (top = u' + v w_i, bottom = u' + 2q - v w_j);
- statT: table row 0 (one twiddle in registers, no table load);
- statS: the distance fixed at 16, a compile-time constant;
- nobfly: exchange and add only (both words become their sum, the 32-bit
  halves added separately).

Each mode runs at nstages 2 and 13, REPS 20 (the TPU script's) and 100
at nb = 256.

Bound on the H100: integer issue, `ops(mode, nstages)` INT32 instructions
per polynomial per repetition.
"""

from __future__ import annotations

import sys

import torch

from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.probes import common as C

MODES = ("full", "statT", "statS", "nobfly")
NSTAGES = (2, 13)
CASES = tuple(f"{m}-{n}" for m in MODES for n in NSTAGES)
REPS = (20, 100)
#: INT32 instructions of one lane stage on one pair: two twiddle indices and
#: two Shoup products (one each for the top and bottom word); statT's two
#: products are one (the same twiddle and operand)
PAIR_OPS = {
    "full": 2 * C.INDEX + C.CONDSUB + 2 * C.SHOUP + C.ADD64 + 2 * C.ADD64,
    "statT": C.INDEX + C.CONDSUB + C.SHOUP + C.ADD64 + 2 * C.ADD64,
    "statS": 2 * C.INDEX + C.CONDSUB + 2 * C.SHOUP + C.ADD64 + 2 * C.ADD64,
    "nobfly": C.INDEX + 2,
}


def parse(case: str):
    """(mode, nstages) of a case name "mode-nstages" of CASES."""
    mode, nstages = case.split("-")
    return mode, int(nstages)


def ops(mode: str, nstages: int) -> int:
    """INT32 instructions of one repetition on one polynomial."""
    return nstages * C.N // 2 * PAIR_OPS[mode]


def _check(mode: str, nstages: int) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    C.check_reps(nstages, "nstages")


def lane_stages_plain(x, mode: str, nstages: int, reps: int):
    """Plain PyTorch version: `reps` repetitions of `nstages` lane stages
    of the mode on x (nb, N) int64 under q0."""
    _check(mode, nstages)
    for _ in range(reps):
        for s in range(nstages):
            sh = 4 if mode == "statS" else 6 - s % 7
            u, v = C.pairs(x, sh)
            if mode == "nobfly":
                z = C.add32x2(u, v)
                x = C.join(z, z)
                continue
            w, ws = C.twiddle_row(0 if mode == "statT" else s % C.LOGN, x.device)
            (wi, wj), (wsi, wsj) = C.pairs(w[None], sh), C.pairs(ws[None], sh)
            up = rt.lazy_reduce(u, 2 * C.Q)
            x = C.join(up + rt.mulmod_shoup(v, wi, wsi, C.Q),
                       up + 2 * C.Q - rt.mulmod_shoup(v, wj, wsj, C.Q))
    return x


def lane_stages(x, mode: str, nstages: int, reps: int):
    """`reps` repetitions of `nstages` lane stages of the mode on x (nb, N)
    int64 (entries < 4q0 but for nobfly) under q0.  CPU tensors take the
    plain version, CUDA tensors the kernel."""
    _check(mode, nstages)
    C.check_reps(reps)
    if not dispatch.use_kernel(x):
        return lane_stages_plain(x, mode, nstages, reps)
    y = C.launch("aloha_probe_lane_stages", x, MODES.index(mode), x.shape[0], reps, nstages)
    lane_stages.launches += 1
    return y


lane_stages.launches = 0


def measure(cases, device):
    """[(case "mode-nstages", ns per polynomial per repetition, t_lo ms,
    t_hi ms)] at nb = C.NB_TIME and REPS."""
    x = C.resident_data(C.NB_TIME, device)
    rows = []
    for case in cases:
        mode, nstages = parse(case)
        run = lambda r, m=mode, k=nstages: lane_stages(x, m, k, r)  # noqa: E731
        rows.append((case, *C.marginal_ns(run, REPS)))
    return rows


def main(argv=None):
    chosen = C.names(sys.argv[1:] if argv is None else argv, CASES)
    card = C.require_card()
    for case, ns, t_lo, t_hi in measure(chosen, torch.device("cuda", 0)):
        mode, nstages = parse(case)
        print(f"{mode} n={nstages}: {ns / nstages:.2f} ns/poly/stage ({ns:.1f} ns/poly/rep) "
              f"t({REPS[0]})={t_lo:.4f} ms t({REPS[1]})={t_hi:.4f} ms nb={C.NB_TIME} "
              f"ops/poly/rep={ops(mode, nstages)} on {card}", flush=True)


if __name__ == "__main__":
    main()
