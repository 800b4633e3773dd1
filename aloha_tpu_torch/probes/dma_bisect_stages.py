"""NTT lane stages in a double-buffered copy pipeline on the card.

The port of tools/dma_bisect_stages.py; alone:

    python -m aloha_tpu_torch.probes.dma_bisect_stages [4 7 ...]

Replaces the TPU kernel of tools/dma_bisect_stages.py:81 (`body` :16-76:
`dma_bisect_doublebuf`'s pipeline over two u32 planes, NSTAGES forward
Cooley-Tukey lane stages on each chunk) with `aloha_probe_dma_stages` of
`csrc/probe_dma.cu`.  A polynomial is (8192,) int64 words hi << 32 | lo,
the port's one word for the TPU's two planes (`common.resident_data` draws
the script's lo < 2^31, hi < 2^27).  Stage s = 6 .. 5 + nstages pairs the
words i and i + t, t = 8192 >> (s + 1) = 64 .. 1 (inside a row of 128),
with the twiddle of the lower one, w[2^s + (i >> (13 - s))] of q0's compact
forward tables (`common.twiddle_row`, the TPU's `_tables_np` row s), in
ntt_pallas._ct_butterfly's lazy Harvey form: u' = u - 2q if u >= 2q, y =
Shoup(v w), top u' + y, bottom u' + 2q - y; the words stay lazy, below 4q,
and are compared as they are.

The kernel moves half a polynomial (32 KiB) per chunk.  Timed as
`dma_bisect`, per polynomial at nb = NBS (64 and 256 MiB each way); the
bound is the larger of the bytes over the HBM rate and `ops(nstages)`
INT32 instructions over the integer issue peak.
"""

from __future__ import annotations

import sys

import torch

from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.probes import common as C
from aloha_tpu_torch.probes.dma_bisect import check_aligned, report

#: the lane stages, the most a call runs
FIRST, MAX_STAGES = 6, 7
#: stage counts measured: the script's default and every lane stage
NSTAGES = (4, 7)
#: polynomials of the timed launches: 64 and 256 MiB each way
NBS = (1024, 4096)
#: bytes one polynomial moves: read once, written once
POLY_BYTES = 2 * C.N * 8


def ops(nstages: int) -> int:
    """INT32 instructions of `nstages` stages on one polynomial."""
    return nstages * C.N // 2 * C.CT_BUTTERFLY


def _check(x, nstages: int) -> None:
    if not 0 <= nstages <= MAX_STAGES:
        raise ValueError(f"nstages = {nstages}: 0 .. {MAX_STAGES} lane stages")
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (nb >= 1, {C.N})")
    C.check_operand(x, torch.int64, (x.shape[0], C.N), "x")


def stages_plain(x, nstages: int):
    """Plain PyTorch version: the exact u64 products of `rns_torch`, adds
    and subtracts as the kernel's (no word leaves [0, 2^63))."""
    _check(x, nstages)
    q = C.Q
    for s in range(FIRST, FIRST + nstages):
        sh = C.LOGN - 1 - s  # log2 of the distance t
        u, v = C.pairs(x, sh)
        w, ws = (C.pairs(tb[None], sh)[0] for tb in C.twiddle_row(s, x.device))
        up = rt.lazy_reduce(u, 2 * q)
        y = rt.mul_lo64(v, w) - rt.mul_lo64(rt.mul_hi64(v, ws), q)
        x = C.join(up + y, up + 2 * q - y)
    return x


def stages(x, nstages: int):
    """`nstages` lane stages on x (nb, 8192) int64 words below 4q0.  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    _check(x, nstages)
    if not dispatch.use_kernel(x):
        return stages_plain(x, nstages)
    check_aligned(x)
    y = C.launch("aloha_probe_dma_stages", x, x.shape[0], nstages)
    stages.launches += 1
    return y


stages.launches = 0


def measure(counts, device, x=None):
    """[(nstages, ns per polynomial, t_lo ms, t_hi ms, spread ms)] at nb =
    NBS, on the first NBS[1] polynomials of x (drawn when None)."""
    x = C.resident_data(NBS[1], device) if x is None else x
    return [(k, *C.batch_marginal(lambda nb, k=k: stages(x[:nb], k), NBS)) for k in counts]


def bound(nstages: int, int32_peak: float):
    """(ns, "bytes" or "operations") per polynomial: the larger of the bytes
    over the HBM rate and the instructions over the INT32 peak (per s)."""
    t_bytes, t_ops = POLY_BYTES / C.HBM_BYTES_PER_S, ops(nstages) / int32_peak
    return max(t_bytes, t_ops) * 1e9, "bytes" if t_bytes >= t_ops else "operations"


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    counts = [int(k) for k in C.names(args, [str(k) for k in range(MAX_STAGES + 1)])]
    card = C.require_card()
    peak = C.int32_peak()
    for k, *m in measure(counts if args else NSTAGES, torch.device("cuda", 0)):
        print(report(f"dma_stages nstages={k}", m, POLY_BYTES, card, NBS, "polynomial",
                     bound(k, peak)), flush=True)


if __name__ == "__main__":
    main()
