"""Lane stages under a runtime stage index on the card (the port of tools/probe_dynstage.py).

    python -m aloha_tpu_torch.probes.probe_dynstage

Replaces the TPU kernel of tools/probe_dynstage.py:38 (`body` :17-35) with
`aloha_probe_dynstage` of `csrc/probe_dyn.cu`.  A block is (64, 128) u32
words, held here as int32 tensors of their bit patterns; the table w is
(13, 64, 128).  One repetition runs the stages s = 6..12 under a runtime
index (the TPU's traced fori_loop index; the kernel's loop is not
unrolled): t = 8192 >> (s + 1) = 64 .. 1, bit = (l & t) != 0, the partner
p = a[r][(l + t) mod 128] if bit else a[r][(l - t) mod 128], u = bit ? p :
a, v = bit ? a : p, out = bit ? u - v w[s] : u + v w[s], mod 2^32.  The
partner wraps around the 128 lanes and is not l ^ t: that is the script's
function (its NumPy oracle agrees).

The TPU script compiled and ran one call; the port repeats in one launch
(probes/common.py says why).  The kernel keeps each block in registers, 16
words a thread at 8 threads a row (lane 8 j + i in register j of thread
i): stages t = 64 .. 8 stay in the thread, t = 4, 2, 1 take one shuffle a
word.  A switch on the runtime s picks a body compiled for its t.  w's
rows 6-12 are staged once per CTA into shared memory in the owner map's
order; min(nb, SMs) persistent CTAs walk the blocks.  The marginal over
REPS at nb = 256 is the time of one repetition.

Bound on the H100, per block per repetition: `NEEDED_OPS` INT32
instructions (a product and a sum or difference a word a stage) over the
integer issue peak.  `TABLE_BYTES` of table (the 7 rows) over shared
memory's 128 bytes a clock an SM is printed beside it as the floor of
this design, where a thread holds one block and reads its table words
from shared memory every repetition (registers cannot hold 224 KiB beside
the block).  It is not the function's floor: w is the same for every
block, and a thread holding the same lanes of two blocks would read each
table word once for both, half those bytes, which take as long as the
operations.  `OPS`, frozen, also charged each word the bit test, the
partner lane and the selects, which the owner map settles at compile
time.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.probes import common as C

ROWS, LANES, LOGN = 64, 128, 13
STAGES = range(6, LOGN)
REPS = (20, 220)
#: INT32 instructions per word and stage, frozen (the first port's count):
#: the bit test, the partner lane (l +- t, select, mask), the u and v
#: selects, the product, the sum and the difference, the select of the result
OPS_PER_WORD = 1 + 3 + 2 + 1 + 2 + 1
OPS = len(STAGES) * ROWS * LANES * OPS_PER_WORD
#: the work the function needs: a product and a sum or difference a word a stage
NEEDED_OPS = len(STAGES) * ROWS * LANES * 2
#: the table rows the stages read (w[6..12]), bytes: read once a launch from
#: device memory, and from shared memory every repetition
TABLE_BYTES = len(STAGES) * ROWS * LANES * 4
INT32_LANES_PER_SM = 128  # the integer issue peak's lanes (chip_smoke.py's INT32_LANES / 132)
SMEM_BYTES_PER_CLOCK = 128  # an SM's shared memory


#: csrc/probe_dyn.cu's kernels, and the SASS opcodes counted in them:
#: local-memory loads and stores, shuffles, shared-memory loads and stores,
#: barriers
KERNELS = ("dynstage_kernel", "dynsub_kernel")
SASS_OPS = ("LDL", "STL", "SHFL", "LDS", "STS", "BAR")


def bounds_ns(int32_peak: float) -> dict:
    """ns per block per repetition: {"operations": NEEDED_OPS over the
    integer issue peak (132 SMs x 128 lanes x clocks.max.sm, INT32 a
    second), the bound; "one block a thread": TABLE_BYTES over 128 bytes a
    clock on each of those SMs, the floor of this design's table reads;
    "frozen OPS": OPS over the peak}."""
    sm_clocks = int32_peak / INT32_LANES_PER_SM
    return {"operations": NEEDED_OPS / int32_peak * 1e9,
            "one block a thread": TABLE_BYTES / (SMEM_BYTES_PER_CLOCK * sm_clocks) * 1e9,
            "frozen OPS": OPS / int32_peak * 1e9}


def data(nb: int, device, seed: int = 1) -> torch.Tensor:
    """(nb, 64, 128) int32 words below 2^20, the script's x for nb = 1."""
    x = np.random.default_rng(seed).integers(0, 1 << 20, size=(nb, ROWS, LANES), dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


def table(device, seed: int = 0) -> torch.Tensor:
    """The script's table w (13, 64, 128), entries in [1, 97), as int32."""
    w = np.random.default_rng(seed).integers(1, 97, size=(LOGN, ROWS, LANES), dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


#: batches of the card's edge sweep: one block, around one CTA an SM, two
#: blocks a CTA of the persistent kernel
EDGE_NBS = (1, 131, 132, 133, 264)
#: the words at the ends of u32 and around its sign bit
EDGE_WORDS = (0, 1, 1 << 31, (1 << 32) - 1)


def edge_data(nb: int, device, seed: int = 2) -> torch.Tensor:
    """(nb, 64, 128) int32 bit patterns of EDGE_WORDS, seeded."""
    x = np.random.default_rng(seed).choice(np.array(EDGE_WORDS, dtype=np.uint32),
                                           size=(nb, ROWS, LANES))
    return torch.from_numpy(x.view(np.int32)).to(device)


def edge_table(device, seed: int = 3) -> torch.Tensor:
    """A table w (13, 64, 128) of EDGE_WORDS, seeded."""
    return edge_data(LOGN, device, seed)


def _check(x, w, reps: int) -> None:
    C.check_reps(reps)
    if x.dim() != 3 or x.shape[0] < 1:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (nb >= 1, {ROWS}, {LANES})")
    C.check_operand(x, torch.int32, (x.shape[0], ROWS, LANES), "x")
    C.check_operand(w, torch.int32, (LOGN, ROWS, LANES), "w")


def to_u32(x) -> torch.Tensor:
    """int32 bit patterns -> their u32 values as int64."""
    return x.to(torch.int64) & C.M32


def from_u32(a) -> torch.Tensor:
    """u32 values in int64 -> int32 bit patterns."""
    return (((a + (1 << 31)) & C.M32) - (1 << 31)).to(torch.int32)


def dynstage_plain(x, w, reps: int):
    """Plain PyTorch version: int64 arithmetic masked to 32 bits."""
    a, wt = to_u32(x), to_u32(w)
    lane = torch.arange(LANES, device=x.device)
    for _ in range(reps):
        for s in STAGES:
            t = (ROWS * LANES) >> (s + 1)
            bit = (lane & t) != 0
            p = torch.where(bit, torch.roll(a, -t, -1), torch.roll(a, t, -1))
            u, v = torch.where(bit, p, a), torch.where(bit, a, p)
            vw = v * wt[s]
            a = torch.where(bit, u - vw, u + vw) & C.M32
    return from_u32(a)


def dynstage(x, w, reps: int):
    """`reps` repetitions of the 7 lane stages on x (nb, 64, 128) int32 with
    the table w (13, 64, 128) int32.  CPU tensors take the plain version,
    CUDA tensors the kernel."""
    _check(x, w, reps)
    if not dispatch.use_kernel(x, w):
        return dynstage_plain(x, w, reps)
    y = torch.empty_like(x)
    err = _build.lib().aloha_probe_dynstage(x.device.index, x.data_ptr(), y.data_ptr(),
                                            w.data_ptr(), x.shape[0], reps, dispatch.stream_of(x))
    _build.check(err, "aloha_probe_dynstage")
    dynstage.launches += 1
    return y


dynstage.launches = 0


def measure(device):
    """(ns per block per repetition, t_lo ms, t_hi ms, spread ms) at nb =
    C.NB_TIME and REPS."""
    x, w = data(C.NB_TIME, device), table(device)
    return C.marginal(lambda r: dynstage(x, w, r), REPS)


def main(argv=None):
    """One call at nb, reps = C.SMALL checked and timed (`C.small_call`),
    then the marginal at nb = NB_TIME beside its bounds."""
    C.names(sys.argv[1:] if argv is None else argv, ())
    card = C.require_card()
    dev = torch.device("cuda", 0)
    C.small_call("probe_dynstage", dynstage, dynstage_plain,
                 (data(C.SMALL[0], dev), table(dev)), card)
    C.print_marginal(measure(dev), REPS, f"{len(STAGES)} stages", bounds_ns(C.int32_peak()), card)


if __name__ == "__main__":
    main()
