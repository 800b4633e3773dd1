"""Row stages under a runtime stage index on the card (the port of tools/probe_dynsub.py).

    python -m aloha_tpu_torch.probes.probe_dynsub

Replaces the TPU kernel of tools/probe_dynsub.py:30 (`body` :13-27) with
`aloha_probe_dynsub` of `csrc/probe_dyn.cu`: probe_dynstage's scheme along
the 64 rows of a (64, 128) u32 block, with no table.  One repetition runs
the stages s = 0..5 under a runtime index (the TPU's traced roll shift):
t = 64 >> (s + 1) = 32 .. 1, bit = (r & t) != 0, p = a[(r + t) mod 64][l]
if bit else a[(r - t) mod 64][l], out = bit ? p - a : a + p, mod 2^32.

The TPU script compiled and ran one call; the port repeats in one launch
(probes/common.py says why), nb independent blocks, one CTA each.  The
marginal over REPS at nb = 256 is the time of one repetition.

Bound on the H100: integer issue, `OPS` INT32 instructions per block per
repetition.
"""

from __future__ import annotations

import sys

import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.probes import common as C
from aloha_tpu_torch.probes.probe_dynstage import LANES, ROWS, data, from_u32, to_u32

STAGES = range(6)
REPS = (20, 220)
#: INT32 instructions per word and stage: the row and the bit test, the
#: partner row (r +- t, select, mask), the sum and the difference, the select
OPS_PER_WORD = 2 + 3 + 2 + 1
OPS = len(STAGES) * ROWS * LANES * OPS_PER_WORD


def _check(x, reps: int) -> None:
    C.check_reps(reps)
    if x.dim() != 3 or x.shape[0] < 1:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (nb >= 1, {ROWS}, {LANES})")
    C.check_operand(x, torch.int32, (x.shape[0], ROWS, LANES), "x")


def dynsub_plain(x, reps: int):
    """Plain PyTorch version: int64 arithmetic masked to 32 bits."""
    a = to_u32(x)
    row = torch.arange(ROWS, device=x.device)[:, None]
    for _ in range(reps):
        for s in STAGES:
            t = ROWS >> (s + 1)
            bit = (row & t) != 0
            p = torch.where(bit, torch.roll(a, -t, -2), torch.roll(a, t, -2))
            a = torch.where(bit, p - a, a + p) & C.M32
    return from_u32(a)


def dynsub(x, reps: int):
    """`reps` repetitions of the 6 row stages on x (nb, 64, 128) int32.
    CPU tensors take the plain version, CUDA tensors the kernel."""
    _check(x, reps)
    if not dispatch.use_kernel(x):
        return dynsub_plain(x, reps)
    y = torch.empty_like(x)
    err = _build.lib().aloha_probe_dynsub(x.device.index, x.data_ptr(), y.data_ptr(), x.shape[0],
                                          reps, dispatch.stream_of(x))
    _build.check(err, "aloha_probe_dynsub")
    dynsub.launches += 1
    return y


dynsub.launches = 0


def measure(device):
    """(ns per block per repetition, t_lo ms, t_hi ms, spread ms) at nb =
    C.NB_TIME and REPS."""
    x = data(C.NB_TIME, device)
    return C.marginal(lambda r: dynsub(x, r), REPS)


def main(argv=None):
    C.names(sys.argv[1:] if argv is None else argv, ())
    card = C.require_card()
    ns, t_lo, t_hi, spread = measure(torch.device("cuda", 0))
    print(f"nb={C.NB_TIME}: {ns:.3f} ns per block per repetition ({len(STAGES)} stages) "
          f"t({REPS[0]})={t_lo:.4f} ms t({REPS[1]})={t_hi:.4f} ms spread={spread:.4f} ms "
          f"ops/block/rep={OPS} on {card}", flush=True)


if __name__ == "__main__":
    main()
