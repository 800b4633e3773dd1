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

The kernel: no pair leaves its aligned 128-word group, the TPU script's
128-lane row, so 16 lanes of a warp hold a group in registers for the
whole launch, 8 words a lane (nb * 32 warps, 4 a CTA).  Register bits 1
and 2 of a word hold its index bits 5 and 6 for good, register bit 0 one
more, the lane bits the rest.  A stage at a bit that no register holds
first trades its lane bit with register bit 0: lanes lane and lane ^ 2^p
swap half their words by `__shfl_xor_sync`.  So every butterfly is a whole
pair in one lane (statT's two products of one twiddle and operand are
one; full's and statS's are two, one a word, even where the pair's
twiddles are equal), and where the words sit is tracked at run time (a
layout of 3 integers, the same in every lane but one).  The
distance is a runtime value, as in the TPU body: only the register bit of
the pairs and whether a twiddle serves the whole group (table rows up to 6)
select a body, by branches uniform across the warp; statS's distance 16 is
a compile-time constant and never trades.  Above row 6 each word loads its
twiddle through the read-only path.  No shared memory, no barrier.

Each mode runs at nstages 2 and 13, REPS 20 (the TPU script's) and 100
at nb = 256 (the marginal), and one call at nb = 8, 3 repetitions
(chip_smoke.py's timed case) eager (`common.time_ms`) and in a CUDA-graph
burst (`common.graph_ms`).  Beyond the wrapper, `main` reads only
`common`, the plain helpers and the C entry from the package, so run as a
file (`python aloha_tpu_torch/probes/stream_prof2.py`) with an older tree
first on PYTHONPATH it times that tree's kernel.

Bound on the H100: integer issue, `ops(mode, nstages)` INT32 instructions
per polynomial per repetition: the yardstick every tree is timed against,
which charges each pair its index arithmetic.  `needed_ops(mode, nstages)`
counts only what the function needs once a pair is two registers of one
lane, as in this kernel (no pair index; a twiddle index a word only above
table row 6, one a group below; none for statT and nobfly): the least work,
beside which the kernel's share of its bound is read.
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
SMALL = (8, 3)  # nb, reps of one timed call (chip_smoke.py times every probe at it)
#: INT32 instructions of one lane stage on one pair: two twiddle indices and
#: two Shoup products (one each for the top and bottom word); statT's two
#: products are one (the same twiddle and operand)
PAIR_OPS = {
    "full": 2 * C.INDEX + C.CONDSUB + 2 * C.SHOUP + C.ADD64 + 2 * C.ADD64,
    "statT": C.INDEX + C.CONDSUB + C.SHOUP + C.ADD64 + 2 * C.ADD64,
    "statS": 2 * C.INDEX + C.CONDSUB + 2 * C.SHOUP + C.ADD64 + 2 * C.ADD64,
    "nobfly": C.INDEX + 2,
}

#: INT32 instructions of one lane stage on one pair that the function needs
#: when the pair is two registers of one lane: PAIR_OPS without the
#: indices (`needed_ops` adds the twiddle indices); nobfly's two 32-bit adds
NEEDED_PAIR_OPS = {
    "full": C.CONDSUB + 2 * C.SHOUP + C.ADD64 + 2 * C.ADD64,
    "statT": C.CONDSUB + C.SHOUP + C.ADD64 + 2 * C.ADD64,
    "statS": C.CONDSUB + 2 * C.SHOUP + C.ADD64 + 2 * C.ADD64,
    "nobfly": 2,
}
UNIFORM_ROWS = C.LOGN - 7  # table rows up to this one: one twiddle a 128-word group


def parse(case: str):
    """(mode, nstages) of a case name "mode-nstages" of CASES."""
    mode, nstages = case.split("-")
    return mode, int(nstages)


def ops(mode: str, nstages: int) -> int:
    """INT32 instructions of one repetition on one polynomial."""
    return nstages * C.N // 2 * PAIR_OPS[mode]


def needed_ops(mode: str, nstages: int) -> int:
    """INT32 instructions of one repetition on one polynomial that the
    function needs: NEEDED_PAIR_OPS a pair, and for full and statS one
    twiddle index (C.INDEX) a 128-word group at table rows up to
    UNIFORM_ROWS and one a word above."""
    total = nstages * C.N // 2 * NEEDED_PAIR_OPS[mode]
    if mode in ("full", "statS"):
        total += sum(C.INDEX * (C.N // 128 if s % C.LOGN <= UNIFORM_ROWS else C.N)
                     for s in range(nstages))
    return total


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


def measure_small(cases, device):
    """[(case, eager ms, graph ms)] of one call at nb, reps = SMALL."""
    x = C.resident_data(SMALL[0], device)
    rows = []
    for case in cases:
        mode, nstages = parse(case)
        run = lambda m=mode, k=nstages: lane_stages(x, m, k, SMALL[1])  # noqa: E731
        rows.append((case, C.time_ms(run), C.graph_ms(run)))
    return rows


def main(argv=None):
    chosen = C.names(sys.argv[1:] if argv is None else argv, CASES)
    card = C.require_card()
    dev = torch.device("cuda", 0)
    for case, ns, t_lo, t_hi in measure(chosen, dev):
        mode, nstages = parse(case)
        print(f"{mode} n={nstages}: {ns / nstages:.2f} ns/poly/stage ({ns:.1f} ns/poly/rep) "
              f"t({REPS[0]})={t_lo:.4f} ms t({REPS[1]})={t_hi:.4f} ms nb={C.NB_TIME} "
              f"ops/poly/rep={ops(mode, nstages)} needed_ops/poly/rep="
              f"{needed_ops(mode, nstages)} on {card}", flush=True)
    for case, eager_ms, graph_ms in measure_small(chosen, dev):
        mode, nstages = parse(case)
        print(f"{mode} n={nstages} nb={SMALL[0]} reps={SMALL[1]}: eager {eager_ms * 1e3:.2f} us, "
              f"graph {graph_ms * 1e3:.2f} us per call on {card}", flush=True)


if __name__ == "__main__":
    main()
