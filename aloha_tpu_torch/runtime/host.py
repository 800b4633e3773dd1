"""Host-side program runner: op-lists against a DRAM model.

The port of `aloha_tpu/runtime/host.py`: the DRAM model stays a uint64
NumPy array on the host, and the device is the port's `AlohaDevice`
(its memories on the card unless the caller passes another).  It
replicates the reference host program (the end-to-end testbench's parse/run
loop, reference: sim/top/top_noaxilite_tb.sv:249-298 op encoding,
:596-638 dispatch), so op-list programs in the reference's case3.txt format
run unchanged:

    each line: AAAAAAAA,BBBBBBBB,CCCCCCCC   (three 32-bit hex words)
    op   = A[31:28]: 1 load_cipher   (spm <- dram B:C)
                     2 store_cipher  (dram B:C <- spm)
                     3 encode        (encoder dram B:C -> spm, + encode_post)
                     4 encode_post   (spm A <- ntt(spm B))
                     5 mul_plain     (spm A <- spm B x spm C)
                     6 hom_add       (spm A <- spm B + spm C)
                     7 rotate        (spm A <- rot(spm C) by step B)
    spm_addr = A[13:0] (SPM row)

DRAM is a flat uint64 word array; address constants follow the testbench
(DRAM_VP_BASE = 10 MiB for ciphertext traffic, encoder data at 0).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from aloha_tpu_torch.config import DEFAULT_CONFIG, HEConfig
from aloha_tpu_torch.runtime.device import AlohaDevice

#: reference: sim/top/top_noaxilite_tb.sv:43-45,77
DRAM_ENCODER_BASE = 0
DRAM_VP_BASE = 10485760  # bytes
DMA_LOAD_POLY_NUM = 4


@dataclasses.dataclass
class Op:
    kind: str
    dest: int = 0
    src1: int = 0
    src2: int = 0
    dram_addr: int = 0
    step: int = 0

    _KINDS = {
        1: "load_cipher",
        2: "store_cipher",
        3: "encode",
        4: "encode_post",
        5: "mul_plain",
        6: "hom_add",
        7: "rotate",
    }

    @classmethod
    def parse(cls, line: str) -> "Op":
        a, b, c = (int(x, 16) for x in line.strip().split(","))
        op = (a >> 28) & 0xF
        spm = a & 0x3FFF
        kind = cls._KINDS.get(op)
        if kind is None:
            raise ValueError(f"unknown op {op} in line {line!r}")
        if kind in ("load_cipher", "store_cipher", "encode"):
            return cls(kind=kind, dest=spm, dram_addr=(b << 32) | c)
        if kind == "rotate":
            return cls(kind=kind, dest=spm, step=b & 0x3FFF, src1=c & 0x3FFF)
        return cls(kind=kind, dest=spm, src1=b & 0x3FFF, src2=c & 0x3FFF)


def parse_op_list(text: str) -> List[Op]:
    return [Op.parse(l) for l in text.splitlines() if l.strip()]


class HostRunner:
    """Drives one AlohaDevice through an op-list program."""

    def __init__(
        self,
        device: Optional[AlohaDevice] = None,
        cfg: HEConfig = DEFAULT_CONFIG,
        dram_words: int = 1 << 23,
        encoder: Optional[Callable] = None,
    ):
        self.cfg = cfg
        self.dev = device or AlohaDevice(cfg)
        self.dram = np.zeros(dram_words, dtype=np.uint64)
        self.encoder = encoder
        self.poly_words = cfg.n
        self.trace: List[tuple] = []

    # ------------------------------------------------------------- DRAM io
    def load_dram(self, byte_addr: int, data: np.ndarray) -> None:
        data = np.asarray(data, dtype=np.uint64).ravel()
        w = byte_addr // 8
        self.dram[w : w + data.size] = data

    def read_dram(self, byte_addr: int, n_words: int) -> np.ndarray:
        w = byte_addr // 8
        return self.dram[w : w + n_words].copy()

    def load_ksk_from_dram(self, byte_addr: int, n_steps: int = 3) -> None:
        """DMA command 0, sized as the reference testbench loads it
        (n_steps x 12 polys, reference: top_noaxilite_tb.sv:381)."""
        words = n_steps * 12 * self.poly_words
        self.dev.dma_load_ksk(self.read_dram(byte_addr, words))

    # ------------------------------------------------------------ dispatch
    def run(self, ops) -> None:
        if isinstance(ops, str):
            ops = parse_op_list(ops)
        for op in ops:
            self.run_op(op)

    def run_op(self, op: Op) -> None:
        dev = self.dev
        n_ct_words = DMA_LOAD_POLY_NUM * self.poly_words
        if op.kind == "load_cipher":
            dev.load_cipher(
                op.dest, self.read_dram(DRAM_VP_BASE + op.dram_addr, n_ct_words)
            )
        elif op.kind == "store_cipher":
            data = dev.store_cipher(op.dest)
            self.load_dram(DRAM_VP_BASE + op.dram_addr, data)
        elif op.kind == "encode":
            if self.encoder is None:
                raise NotImplementedError(
                    "encode op requires an encoder callable "
                    "(for example aloha_tpu_torch.encoder.encode)"
                )
            raw = self.read_dram(DRAM_ENCODER_BASE + op.dram_addr, self.poly_words)
            cleartext = raw.view(np.float64)
            pt_coeff = self.encoder(cleartext)
            dev.dma_write_spm(op.dest, pt_coeff)
            dev.run_encode_post(dest=op.dest, src=op.dest)
        elif op.kind == "encode_post":
            dev.run_encode_post(dest=op.dest, src=op.src1)
        elif op.kind == "mul_plain":
            dev.run_mul_plain(dest=op.dest, src_ct=op.src1, src_pt=op.src2)
        elif op.kind == "hom_add":
            dev.run_hom_add(dest=op.dest, src1=op.src1, src2=op.src2)
        elif op.kind == "rotate":
            dev.run_rotate(dest=op.dest, src=op.src1, step=op.step)
        else:  # pragma: no cover
            raise AssertionError(op.kind)
        self.trace.append((op, None))
