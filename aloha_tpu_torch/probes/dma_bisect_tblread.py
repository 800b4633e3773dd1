"""A double-buffered pipeline that reads a table, on the card.

The port of tools/dma_bisect_tblread.py; alone:

    python -m aloha_tpu_torch.probes.dma_bisect_tblread

Replaces the TPU kernel of tools/dma_bisect_tblread.py:51 (`body` :11-48:
`dma_bisect_doublebuf`'s pipeline with a plain copy, each chunk plus the 13
rows of a (13, 64, 128) VMEM table) with `aloha_probe_dma_tblread` of
`csrc/probe_dma.cu`: out = x + t[0] + ... + t[12] mod 2^32 on every (64,
128) u32 block.  The 416 KiB table does not fit a CTA's shared memory; the
kernel folds each thread's 13-row sum into registers once per CTA, since
the same positions recur in every block.  The script's table is all ones;
`table` draws one, so that a wrong row shows.

Timed as `dma_bisect` (the marginal over the batch at nb = NBS beside the
HBM bound; the table is read once per launch and drops out).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.probes import common as C
from aloha_tpu_torch.probes.dma_bisect import (BLOCK_BYTES, NBS, blocks, check_aligned,
                                               check_blocks, report)
from aloha_tpu_torch.probes.probe_dynstage import LANES, ROWS, from_u32, to_u32

TABLE_ROWS = 13
TABLE_BYTES = TABLE_ROWS * ROWS * LANES * 4
#: INT32 instructions per block: one add a word (the table's sum is folded
#: once per CTA)
OPS = ROWS * LANES


def table(device, seed: int = 2) -> torch.Tensor:
    """(13, 64, 128) int32: u32 words drawn over their whole range."""
    t = np.random.default_rng(seed).integers(0, 1 << 32, size=(TABLE_ROWS, ROWS, LANES),
                                             dtype=np.uint32)
    return torch.from_numpy(t.view(np.int32)).to(device)


def _check(t, x) -> None:
    C.check_operand(t, torch.int32, (TABLE_ROWS, ROWS, LANES), "t")
    check_blocks(x)


def tblread_plain(t, x):
    """Plain PyTorch version: int64 arithmetic masked to 32 bits."""
    _check(t, x)
    return from_u32((to_u32(x) + to_u32(t).sum(0)) & C.M32)


def tblread(t, x):
    """The pipeline on x (nb, 64, 128) int32 with the table t (13, 64, 128)
    int32.  CPU tensors take the plain version, CUDA tensors the kernel."""
    _check(t, x)
    if not dispatch.use_kernel(t, x):
        return tblread_plain(t, x)
    y = torch.empty_like(x)
    check_aligned(t, x, y)
    err = _build.lib().aloha_probe_dma_tblread(x.device.index, t.data_ptr(), x.data_ptr(),
                                               y.data_ptr(), x.shape[0], dispatch.stream_of(x))
    _build.check(err, "aloha_probe_dma_tblread")
    tblread.launches += 1
    return y


tblread.launches = 0


def measure(device, x=None):
    """(ns per block, t_lo ms, t_hi ms, spread ms) at nb = NBS, on the
    first NBS[1] blocks of x (drawn when None)."""
    x = blocks(NBS[1], device) if x is None else x
    t = table(device)
    return C.batch_marginal(lambda nb: tblread(t, x[:nb]), NBS)


def main(argv=None):
    C.names(sys.argv[1:] if argv is None else argv, ())
    card = C.require_card()
    print(report("dma_tblread", measure(torch.device("cuda", 0)), BLOCK_BYTES, card), flush=True)


if __name__ == "__main__":
    main()
