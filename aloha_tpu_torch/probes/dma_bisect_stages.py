"""NTT lane stages in a double-buffered copy pipeline on the card.

The port of tools/dma_bisect_stages.py; alone:

    python -m aloha_tpu_torch.probes.dma_bisect_stages [0 4 7 ...]

or as a file, `PYTHONPATH=<checkout> python aloha_tpu_torch/probes/
dma_bisect_stages.py 0 4 7`, which times that checkout's kernel (it reads
only `common`'s helpers, `dma_bisect`'s report and `copy_` timing, and the
C entry from the package).

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

The kernel moves half a polynomial (32 KiB) per chunk through a ring of
slots in shared memory (5-D TMA copies with the 128-byte swizzle) and steps
it in place: 256 threads of 16 words in registers, pass A (stages 6-9,
register m holding lane l0 + 8m of the thread's row) and pass B (stages
10-12, lane 16 l0 + m), each thread writing its words back to the slots it
read, one `__syncwarp` between the passes, every butterfly computed once,
nstages a template parameter (csrc/probe_dma.cu, `stages_ring`).  Timed as
`dma_bisect`, per polynomial at nb = NBS (64 and 256 MiB each way); the
bound is the larger of the bytes over the HBM rate and `ops(nstages)`
INT32 instructions over the integer issue peak.  `main` prints beside
them `torch.Tensor.copy_`'s marginal per polynomial (two 32 KiB blocks,
`dma_bisect.measure_library`), the floor of any pipeline that moves the
words: no one PyTorch call computes the stages.
"""

from __future__ import annotations

import sys

import torch

from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.probes import common as C
from aloha_tpu_torch.probes.dma_bisect import check_aligned, measure_library, report

#: the lane stages, the most a call runs
FIRST, MAX_STAGES = 6, 7
#: stage counts measured: the copy ring alone, pass A alone, both passes
NSTAGES = (0, 4, 7)
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
    dev = torch.device("cuda", 0)
    copy_ns = 2 * measure_library(dev)[0]  # two 32 KiB blocks a polynomial
    for k, *m in measure(counts if args else NSTAGES, dev):
        print(report(f"dma_stages nstages={k}", m, POLY_BYTES, card, NBS, "polynomial",
                     bound(k, peak)) + f"; torch copy_ marginal_ns={copy_ns:.3f} per polynomial",
              flush=True)


if __name__ == "__main__":
    main()
