"""A one-slot copy pipeline on the card (the port of tools/dma_bisect.py).

    python -m aloha_tpu_torch.probes.dma_bisect [copy compute]

Replaces the TPU kernel of tools/dma_bisect.py:34 (`body` :12-31: chunks
of (64, 128) u32 blocks copied into one VMEM slot, waited for, stepped,
copied out, waited for) with `aloha_probe_dma_copy` of `csrc/probe_dma.cu`:
persistent CTAs move one 32 KiB block at a time through one shared-memory
slot by bulk asynchronous copies, synchronously, as the TPU's body does.
Mode "compute" gives x*3 + 1 mod 2^32, mode "copy" the words as they are.

Blocks are int32 tensors of u32 bit patterns (`probe_dynstage.to_u32` and
`from_u32` convert).  The marginal over the batch (`common.batch_marginal`
at nb = NBS, 64 and 256 MiB each way, beyond the 50 MB L2) is the time per
block; its bound is the block's bytes in and out over the HBM rate.  The
yardstick is `torch.Tensor.copy_` of the same blocks, timed the same way
(the library call that computes the copy mode; the port never calls it).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.probes import common as C
from aloha_tpu_torch.probes.probe_dynstage import LANES, ROWS, from_u32, to_u32

MODES = ("copy", "compute")
#: blocks of the timed launches: 64 and 256 MiB each way
NBS = (2048, 8192)
#: bytes one block moves: read once, written once
BLOCK_BYTES = 2 * ROWS * LANES * 4
#: calls per part of `host_us` (fewer than the launches a stream queues)
HOST_CALLS = 500
#: INT32 instructions per block of a mode (x*3 + 1 is one IMAD a word)
OPS = {"copy": 0, "compute": ROWS * LANES}


def blocks(nb: int, device, seed: int = 0) -> torch.Tensor:
    """(nb, 64, 128) int32: u32 words drawn over their whole range."""
    x = np.random.default_rng(seed).integers(0, 1 << 32, size=(nb, ROWS, LANES), dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


def check_blocks(x, name: str = "x") -> None:
    """Raise ValueError unless x is (nb >= 1, 64, 128) int32, contiguous."""
    if x.dim() != 3 or x.shape[0] < 1:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected (nb >= 1, {ROWS}, {LANES})")
    C.check_operand(x, torch.int32, (x.shape[0], ROWS, LANES), name)


def check_aligned(*tensors) -> None:
    """Bulk copies take 16-byte aligned addresses: raise ValueError else."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"address {t.data_ptr():#x} not 16-byte aligned")


def bound_ns(nbytes: int) -> float:
    """Bytes over the HBM rate, in ns."""
    return nbytes / C.HBM_BYTES_PER_S * 1e9


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")


def dma_copy_plain(x, mode: str):
    """Plain PyTorch version: int64 arithmetic masked to 32 bits."""
    _check_mode(mode)
    if mode == "copy":
        return x.clone()
    return from_u32((to_u32(x) * 3 + 1) & C.M32)


def dma_copy(x, mode: str):
    """The one-slot pipeline on x (nb, 64, 128) int32 in the mode.  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    _check_mode(mode)
    check_blocks(x)
    if not dispatch.use_kernel(x):
        return dma_copy_plain(x, mode)
    check_aligned(x)  # y comes aligned from the allocator
    y = torch.empty_like(x)
    err = _build.lib().aloha_probe_dma_copy(x.device.index, x.data_ptr(), y.data_ptr(), x.shape[0],
                                            mode == "compute", dispatch.stream_of(x))
    _build.check(err, "aloha_probe_dma_copy")
    dma_copy.launches += 1
    return y


dma_copy.launches = 0


def measure(modes, device, x=None):
    """[(mode, ns per block, t_lo ms, t_hi ms, spread ms)] at nb = NBS, on
    the first NBS[1] blocks of x (drawn when None)."""
    x = blocks(NBS[1], device) if x is None else x
    return [(m, *C.batch_marginal(lambda nb, m=m: dma_copy(x[:nb], m), NBS)) for m in modes]


def measure_library(device, x=None):
    """`torch.Tensor.copy_` of the same blocks: (ns per block, t_lo ms,
    t_hi ms, spread ms) at nb = NBS."""
    x = blocks(NBS[1], device) if x is None else x
    y = torch.empty_like(x)
    return C.batch_marginal(lambda nb: y[:nb].copy_(x[:nb]), NBS)


def measure_split(device, x=None):
    """{name: {nb: (eager ms, graph ms)}} of one call of the kernel (copy
    mode) and of `copy_` at nb = NBS, on the first NBS[1] blocks of x:
    eager is `common.time_ms` (calls enqueued by the host back to back),
    graph the same calls replayed from one CUDA graph (`common.graph_ms`).
    Their difference is the host's share of a call; graph time less nb
    blocks at the graph marginal is the device's fixed cost."""
    x = blocks(NBS[1], device) if x is None else x
    y = torch.empty_like(x)
    fns = {"dma_copy": lambda nb: dma_copy(x[:nb], "copy"),
           "torch copy_": lambda nb: y[:nb].copy_(x[:nb])}
    return {name: {nb: (C.time_ms(lambda: fn(nb)), C.graph_ms(lambda: fn(nb))) for nb in NBS}
            for name, fn in fns.items()}


def host_us(device) -> dict:
    """Host µs per call, on the host clock, of the wrapper and its parts at
    nb = 1 (about 3 µs of device work, so the host's enqueue sets the pace):
    the whole wrapper, its checks, `torch.empty_like`, `dispatch.stream_of`
    and the C entry alone (ctypes, cudaSetDevice, the launch)."""
    x = blocks(1, device)
    y = torch.empty_like(x)
    lib, stream = _build.lib(), dispatch.stream_of(x)
    parts = {
        "wrapper": lambda: dma_copy(x, "copy"),
        "checks": lambda: (_check_mode("copy"), check_blocks(x), dispatch.use_kernel(x),
                           check_aligned(x)),
        "empty_like": lambda: torch.empty_like(x),
        "stream_of": lambda: dispatch.stream_of(x),
        "C entry": lambda: lib.aloha_probe_dma_copy(x.device.index, x.data_ptr(), y.data_ptr(),
                                                    1, 0, stream),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        out[name] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
    return out


def split_report(split: dict, card: str) -> list:
    """Lines of `measure_split`: per call, eager and graph µs at both nb,
    the graph marginal per block and the fixed costs (device: graph
    intercept; host: eager - graph)."""
    lo, hi = NBS
    lines = []
    for name, t in split.items():
        (e_lo, g_lo), (e_hi, g_hi) = t[lo], t[hi]
        ns = (g_hi - g_lo) * 1e6 / (hi - lo)
        lines.append(f"split {name}: eager {e_lo * 1e3:.2f} / {e_hi * 1e3:.2f} us, graph "
                     f"{g_lo * 1e3:.2f} / {g_hi * 1e3:.2f} us at nb={lo}/{hi}; graph marginal "
                     f"{ns:.3f} ns per block, device fixed {g_lo * 1e3 - lo * ns / 1e3:.2f} us, "
                     f"host over device {(e_lo - g_lo) * 1e3:.2f} / {(e_hi - g_hi) * 1e3:.2f} us "
                     f"on {card}")
    return lines


def report(label: str, m: tuple, nbytes: int, card: str, nbs=NBS, unit: str = "block",
           bound=None) -> str:
    """One line of a measurement m = (ns, t_lo ms, t_hi ms, spread ms): the
    marginal, its bound (ns, "bytes" or "operations"; the bytes over the
    HBM rate when None) and the rate of the bytes in and out."""
    ns, t_lo, t_hi, spread = m
    b_ns, b_by = bound or (bound_ns(nbytes), "bytes")
    rate = nbytes / ns if ns > 0 else float("nan")
    return (f"{label}: marginal_ns={ns:.3f} per {unit} bound_ns={b_ns:.3f} ({b_by}) "
            f"{rate:.1f} GB/s t({nbs[0]})={t_lo:.4f} ms t({nbs[1]})={t_hi:.4f} ms "
            f"spread={spread:.4f} ms on {card}")


def main(argv=None):
    chosen = C.names(sys.argv[1:] if argv is None else argv, MODES)
    card = C.require_card()
    dev = torch.device("cuda", 0)
    x = blocks(NBS[1], dev)
    for mode, *m in measure(chosen, dev, x):
        print(report(f"dma_copy {mode}", m, BLOCK_BYTES, card), flush=True)
    print(report("torch copy_", measure_library(dev, x), BLOCK_BYTES, card), flush=True)
    for line in split_report(measure_split(dev, x), card):
        print(line, flush=True)
    parts = ", ".join(f"{k} {v:.2f}" for k, v in host_us(dev).items())
    print(f"host us per call at nb=1: {parts} on {card}", flush=True)


if __name__ == "__main__":
    main()
