"""Trace database: record and replay-verify per-instruction engine results.

The port of `aloha_tpu/trace_db.py:35-141`, in the same `.tdb` file
format, so a trace written by either package reads in the other.  This is
the co-simulation tier, the role the reference fills with its golden
C-model traces (`.tdb` files) replayed against the RTL
(reference: sim/vp/top/vp_top_tb.sv, tdb_reader.cpp): one engine produces
a trace, another replays the same program and every instruction's result
is diffed, instruction by instruction.  Here one backend (the CPU's plain
path, or the JAX package's NumPy oracle) records and another (the card)
verifies.  `read` runs the port's own C++ reader (`native.read_tdb`, the
port's copy of the JAX package's `native/aloha_native.cpp`, built with
g++ at first use; a build failure raises); the Python reader stays
reachable by name (`_read_python`), and the tests hold the two against
each other and against the JAX package's.

Row = one traced instruction: [pc, instr_hi, instr_lo, result[0..n-1]].
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List

import numpy as np

from aloha_tpu_torch import native
from aloha_tpu_torch.isa.encoding import Instr

_MAGIC = 0x42445441  # "ATDB"
_VERSION = 1


@dataclasses.dataclass
class TraceRow:
    pc: int
    instr: Instr
    result: np.ndarray  # (n,) uint64 destination value (vreg or store data)


def write(path, rows: List[TraceRow], n: int) -> None:
    """Write a trace database."""
    fields = [("pc", 0, 1), ("instr", 1, 2), ("result", 3, n)]
    names = b"".join(f[0].encode() for f in fields)
    row_words = 3 + n
    with open(path, "wb") as f:
        f.write(struct.pack("<IIII", _MAGIC, _VERSION, len(fields), len(names)))
        f.write(struct.pack("<QQ", len(rows), row_words))
        off = 0
        for name, woff, wlen in fields:
            f.write(struct.pack("<IIII", off, len(name), woff, wlen))
            off += len(name)
        f.write(names)
        buf = np.empty((len(rows), row_words), dtype="<u8")
        for i, r in enumerate(rows):
            enc = r.instr.encode()
            buf[i, 0] = r.pc
            buf[i, 1] = enc >> 64
            buf[i, 2] = enc & ((1 << 64) - 1)
            buf[i, 3:] = r.result
        f.write(buf.tobytes())


def read(path) -> List[TraceRow]:
    """Read a trace database with the native reader."""
    return _rows_from(native.read_tdb(path))


def _read_python(path) -> List[TraceRow]:
    """Read a trace database with the Python reader."""
    with open(path, "rb") as f:
        magic, _ver, n_fields, name_bytes = struct.unpack("<IIII", f.read(16))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a trace database")
        n_rows, row_words = struct.unpack("<QQ", f.read(16))
        f.read(16 * n_fields + name_bytes)
        data = np.frombuffer(f.read(n_rows * row_words * 8), dtype="<u8")
    return _rows_from(data.reshape(n_rows, row_words))


def _rows_from(mat: np.ndarray) -> List[TraceRow]:
    rows = []
    for r in mat:
        enc = (int(r[1]) << 64) | int(r[2])
        rows.append(TraceRow(pc=int(r[0]), instr=Instr.decode(enc),
                             result=np.array(r[3:], dtype=np.uint64)))
    return rows


# ----------------------------------------------------------- co-simulation
def record(vp, program, spm, ksk_mem=None, args=None) -> List[TraceRow]:
    """Replay `program` on `vp` recording every result."""
    sink: list = []
    vp.run(program, spm, ksk_mem, args, trace=sink)
    return [
        TraceRow(pc=pc, instr=i, result=np.array(v, dtype=np.uint64))
        for pc, i, v in sink
    ]


def verify(vp, program, spm, ksk_mem, args, rows: List[TraceRow]):
    """Replay on another backend and diff every instruction against `rows`.

    Returns a list of (pc, mnemonic, n_mismatches); empty == bit-exact.
    """
    sink: list = []
    vp.run(program, spm, ksk_mem, args, trace=sink)
    if len(sink) != len(rows):
        raise ValueError(
            f"trace length mismatch: {len(sink)} vs {len(rows)} rows"
        )
    bad = []
    for (pc, instr, val), ref in zip(sink, rows):
        if instr.encode() != ref.instr.encode():
            bad.append((pc, instr.disasm(), -1))
            continue
        n_mis = int((np.asarray(val) != ref.result).sum())
        if n_mis:
            bad.append((pc, instr.disasm(), n_mis))
    return bad
