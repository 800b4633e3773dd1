"""A double-buffered copy pipeline on the card (the port of tools/dma_bisect_doublebuf.py).

    python -m aloha_tpu_torch.probes.dma_bisect_doublebuf

Replaces the TPU kernel of tools/dma_bisect_doublebuf.py:52 (`body`
:11-49: two input and two output VMEM slots, the next chunk's copy in
flight while this one is worked on, an output slot rewritten only after
its copy of two steps before has finished) with `aloha_probe_dma_doublebuf`
of `csrc/probe_dma.cu`, the same pipeline on 32 KiB blocks through shared
memory by bulk asynchronous copies.  The step on each (64, 128) u32 block:
the lanes rolled by +3 (np.roll), the rows of each pair (2k, 2k+1)
swapped, then x*3 + 1 mod 2^32.

Timed as `dma_bisect` (the marginal over the batch at nb = NBS beside the
HBM bound): the pair shows what the second slot buys.
"""

from __future__ import annotations

import sys

import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.probes import common as C
from aloha_tpu_torch.probes.dma_bisect import (BLOCK_BYTES, NBS, blocks, check_aligned,
                                               check_blocks, report)
from aloha_tpu_torch.probes.probe_dynstage import LANES, ROWS, from_u32, to_u32

#: INT32 instructions per word: the source row and lane (xor, l - 3, mask,
#: address) and the IMAD
OPS = ROWS * LANES * 5


def doublebuf_plain(x):
    """Plain PyTorch version: int64 arithmetic masked to 32 bits."""
    a = torch.roll(to_u32(x), 3, -1)
    a = a.reshape(-1, ROWS // 2, 2, LANES).flip(2).reshape(x.shape)
    return from_u32((a * 3 + 1) & C.M32)


def doublebuf(x):
    """The double-buffered pipeline on x (nb, 64, 128) int32.  CPU tensors
    take the plain version, CUDA tensors the kernel."""
    check_blocks(x)
    if not dispatch.use_kernel(x):
        return doublebuf_plain(x)
    y = torch.empty_like(x)
    check_aligned(x, y)
    err = _build.lib().aloha_probe_dma_doublebuf(x.device.index, x.data_ptr(), y.data_ptr(),
                                                 x.shape[0], dispatch.stream_of(x))
    _build.check(err, "aloha_probe_dma_doublebuf")
    doublebuf.launches += 1
    return y


doublebuf.launches = 0


def measure(device, x=None):
    """(ns per block, t_lo ms, t_hi ms, spread ms) at nb = NBS, on the
    first NBS[1] blocks of x (drawn when None)."""
    x = blocks(NBS[1], device) if x is None else x
    return C.batch_marginal(lambda nb: doublebuf(x[:nb]), NBS)


def main(argv=None):
    C.names(sys.argv[1:] if argv is None else argv, ())
    card = C.require_card()
    print(report("dma_doublebuf", measure(torch.device("cuda", 0)), BLOCK_BYTES, card), flush=True)


if __name__ == "__main__":
    main()
