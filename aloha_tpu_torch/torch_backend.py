"""PyTorch execution backend of the ISA replayer (the port of `aloha_tpu/jax_backend.py`).

`TorchBackend` implements the backend protocol of
`aloha_tpu_torch.isa.interp.VectorProcessor` over int64 tensors that hold
the bits of the accelerator's uint64 words.  Every instruction runs where
its operands lie: `vntt`/`vintt` through `ops/ntt_stream.transform` at
M = 1, nb = 1 (`csrc/ntt.cu` on the card), `vaut` through `ops/aut`
(`csrc/aut.cu`), the ALU through `rns_torch` (one launch of
`csrc/rns.cu` an instruction on the card, plain PyTorch on the CPU).

The TPU path jits a whole program into one XLA executable
(`jax_backend.make_executable`).  Here `make_executable` returns a cached
callable that replays the decoded program eagerly: one launch per
transform and per ALU instruction.

Words outside the moduli's range reach a launch through DMA.  The ALU
gives the NumPy oracle's word for every uint64 operand (`rns_torch`); an
immediate must fit the 60-bit datapath.  The transforms take the words on
which the oracle computes the exact transform of the reduced word: below
4q forward (the Harvey window of csrc/ntt.cu) and below 2q inverse.  On
any other word the oracle's output is not that transform (forward: not
even canonical from some words below 2^63 on), and no cheap pass gives
it, so the launch raises `ValueError`.  The check makes no host sync per
instruction: each transform ORs an out-of-window flag into a tensor on
the device, and `end_launch` reads it once per launch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aloha_tpu_torch import convert
from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.config import HEConfig, NUM_LANES
from aloha_tpu_torch.isa.encoding import Instr
from aloha_tpu_torch.isa.interp import LaunchArgs, VectorProcessor
from aloha_tpu_torch.ops import aut, ntt_stream

_DATAPATH = 1 << 60


class TorchBackend:
    """int64 tensors on one device (default `cuda`); `wrap`/`unwrap` are bit
    views of uint64, so any word round-trips."""

    name = "torch"

    def __init__(self, device=None):
        self.device = torch.device("cuda" if device is None else device)
        self._out_of_window = None  # a bool tensor once a transform ran this launch

    def wrap(self, arr):
        """uint64 array (or int64 tensor of the same bits) -> int64 tensor."""
        if isinstance(arr, torch.Tensor):
            if arr.dtype != torch.int64:
                raise TypeError(f"dtype {arr.dtype}, expected torch.int64")
            return arr.to(self.device)
        return convert.from_u64(arr, self.device)

    def unwrap(self, arr) -> np.ndarray:
        """int64 tensor -> a uint64 host array of its own (same bits)."""
        return np.array(convert.to_u64(arr))

    def zeros(self, shape):
        return torch.zeros(shape, dtype=torch.int64, device=self.device)

    @staticmethod
    def _scalar(a, s: int):
        """The immediate as a tensor like `a`: s mod 2^64, as the NumPy
        oracle takes it; it must fit the 60-bit datapath."""
        s %= 1 << 64
        if s >= _DATAPATH:
            raise ValueError(f"immediate 0x{s:x} exceeds the 60-bit datapath")
        return torch.full_like(a, s)

    # element-wise ops (scalars are python ints)
    def mulmod(self, a, b, q):
        return rt.mulmod(a, b, q)

    def mulmod_scalar(self, a, s, q):
        return rt.mulmod(a, self._scalar(a, s), q)

    def addmod(self, a, b, q):
        return rt.addmod(a, b, q)

    def addmod_scalar(self, a, s, q):
        return rt.addmod(a, self._scalar(a, s), q)

    def submod(self, a, b, q):
        return rt.submod(a, b, q)

    def submod_scalar(self, a, s, q, reverse=False):
        s = self._scalar(a, s)
        return rt.submod(s, a, q) if reverse else rt.submod(a, s, q)

    def modred(self, a, q):
        return rt.modred(a, q)

    def lazy_reduce(self, a, q):
        return rt.lazy_reduce(a, q)

    # transforms
    def _flag_window(self, a, bound: int):
        """OR (any word of a >= bound, unsigned) into the launch's flag,
        on a's device: no host sync."""
        bad = rt.uge(a, bound).any()
        self._out_of_window = bad if self._out_of_window is None else self._out_of_window | bad

    def ntt(self, a, q, psi):
        self._flag_window(a, 4 * q)
        return ntt_stream.transform(a.reshape(1, 1, -1), (q,), (psi,), False).reshape(a.shape)

    def intt(self, a, q, ipsi):
        self._flag_window(a, 2 * q)
        return ntt_stream.transform(a.reshape(1, 1, -1), (q,), (ipsi,), True).reshape(a.shape)

    def automorphism(self, a, step, q):
        return aut.automorphism(a, step, q)

    def rotate_lanes(self, a, step):
        return torch.roll(a, -int(step), dims=-1)

    # memory: SPM/KSK tensors are (rows, 128) int64
    def begin_launch(self, mem):
        """Copy device memory once per launch; write_rows then updates the
        copy in place, so the caller's tensor stays as it was."""
        self._out_of_window = None
        return mem.clone()

    def end_launch(self):
        """Raise if a transform of this launch got a word outside its window
        (>= 4q forward, >= 2q inverse): the one host sync of the check."""
        flag, self._out_of_window = self._out_of_window, None
        if flag is not None and bool(flag):
            raise ValueError(
                "vntt/vintt operand outside the transform's window (a word >= 4q "
                "forward or >= 2q inverse): the reference's output there is not the "
                "transform of the reduced word"
            )

    def read_rows(self, mem, row, nrows):
        return mem[row : row + nrows].reshape(-1)

    def write_rows(self, mem, row, value):
        mem[row : row + value.numel() // NUM_LANES] = value.reshape(-1, NUM_LANES)
        return mem


@functools.lru_cache(maxsize=256)
def _cached_executable(cfg: HEConfig, program_digest, pc, src0, src1, rslt, step, ksk_ptr):
    program = [Instr.decode(v) for v in program_digest]
    args = LaunchArgs(pc=pc, src0=src0, src1=src1, rslt=rslt, step=step, ksk_ptr=ksk_ptr)

    def run(spm, ksk_mem):
        return VectorProcessor(cfg, TorchBackend(spm.device)).run(program, spm, ksk_mem, args)

    return run


def make_executable(cfg: HEConfig, program, args: LaunchArgs, program_key=None):
    """One (program, launch CSRs) pair as a callable `run(spm, ksk_mem)`
    that returns the updated SPM (the caller's stays as it was).

    Cached by the program's *contents* (instruction encodings) and the
    CSRs, as `jax_backend.make_executable` is, so two different programs
    can never share an executable; `program_key` is accepted and ignored,
    as there.  The callable replays eagerly on the device of the SPM it is
    given; no graph is captured."""
    digest = tuple(i.encode() for i in program)
    return _cached_executable(cfg, digest, args.pc, args.src0, args.src1, args.rslt,
                              args.step, args.ksk_ptr)
