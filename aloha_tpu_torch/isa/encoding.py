"""The HE vector ISA: 96-bit instruction encoding.

The port's own copy of `aloha_tpu/isa/encoding.py` (pure Python).

Instruction format (reference: src/vp/sequncer/expander.v:123-130):

    [95:90] funct6   [89] mask   [88:84] vs2   [83:79] vs1
    [78:76] funct3   [75:71] vd  [70:64] opcode (always 0x0b, R-type custom)
    [63:0]  imm      (64-bit immediate: scalar operand / config value /
                      load-store segment+offset)

Load/store immediates pack a 16-bit segment selector in bits [63:48] and a
byte offset in bits [47:0] (reference: src/vp/top/vp_top_full.sv:105-118):
segment 0 -> src0_ptr, 1 -> src1_ptr, 2 -> rslt_ptr, 15 -> KSK memory.
The funct6 opcode map follows src/vp/sequncer/expander.v:64-81.
"""

from __future__ import annotations

import dataclasses
import enum


class Funct6(enum.IntEnum):
    NOP = 0b000000
    VSETVL = 0b000100
    VSETQ = 0b001000
    VSETIQ = 0b001100
    VBREAK = 0b010000
    VFQMUL = 0b000001
    VFQADD = 0b000101
    VFQSUB = 0b001001
    VFQMOD = 0b001101
    VCPY = 0b010001
    VAUT = 0b010101
    VROLI = 0b011001
    VNTT = 0b000010
    VINTT = 0b000110
    VLE = 0b000011
    VSE = 0b000111


class Funct3(enum.IntEnum):
    VV = 0b000  # vector-vector
    VS = 0b001  # vector-scalar (imm)
    SV = 0b010  # scalar-vector (imm first operand)
    SS = 0b011


OPCODE_RTYPE = 0x0B

#: Segment selectors of the load-store unit
SEG_SRC0 = 0
SEG_SRC1 = 1
SEG_RSLT = 2
SEG_KSK = 15

IMM_MASK = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class Instr:
    funct6: Funct6
    vd: int = 0
    vs1: int = 0
    vs2: int = 0
    funct3: Funct3 = Funct3.VV
    mask: int = 0
    imm: int = 0
    opcode: int = OPCODE_RTYPE

    def encode(self) -> int:
        word = (
            (int(self.funct6) << 26)
            | ((self.mask & 1) << 25)
            | ((self.vs2 & 0x1F) << 20)
            | ((self.vs1 & 0x1F) << 15)
            | ((int(self.funct3) & 0x7) << 12)
            | ((self.vd & 0x1F) << 7)
            | (self.opcode & 0x7F)
        )
        return (word << 64) | (self.imm & IMM_MASK)

    def hex(self) -> str:
        """One line of an instruction-memory image (24 hex digits)."""
        return f"{self.encode():024x}"

    @classmethod
    def decode(cls, value) -> "Instr":
        if isinstance(value, str):
            value = int(value, 16)
        imm = value & IMM_MASK
        word = value >> 64
        return cls(
            funct6=Funct6((word >> 26) & 0x3F),
            mask=(word >> 25) & 1,
            vs2=(word >> 20) & 0x1F,
            vs1=(word >> 15) & 0x1F,
            funct3=Funct3((word >> 12) & 0x7),
            vd=(word >> 7) & 0x1F,
            imm=imm,
            opcode=word & 0x7F,
        )

    # -- load/store immediate helpers ------------------------------------
    @property
    def segment(self) -> int:
        return (self.imm >> 48) & 0xFFFF

    @property
    def offset(self) -> int:
        return self.imm & ((1 << 48) - 1)

    def disasm(self) -> str:
        f6 = self.funct6
        if f6 in (Funct6.VSETVL, Funct6.VSETQ, Funct6.VSETIQ):
            return f"{f6.name.lower()} 0x{self.imm:x}"
        if f6 == Funct6.VBREAK:
            return "vbreak"
        if f6 == Funct6.VLE:
            return f"vle v{self.vd}, seg{self.segment}+0x{self.offset:x}"
        if f6 == Funct6.VSE:
            return f"vse v{self.vs1}, seg{self.segment}+0x{self.offset:x}"
        if f6 in (Funct6.VNTT, Funct6.VINTT, Funct6.VCPY, Funct6.VFQMOD):
            return f"{f6.name.lower()} v{self.vd}, v{self.vs1}"
        if f6 in (Funct6.VAUT, Funct6.VROLI):
            return f"{f6.name.lower()} v{self.vd}, v{self.vs1}, 0x{self.imm:x}"
        sfx = {Funct3.VV: "vv", Funct3.VS: "vs", Funct3.SV: "sv"}.get(
            self.funct3, "?"
        )
        if self.funct3 == Funct3.VV:
            return f"{f6.name.lower()}.vv v{self.vd}, v{self.vs1}, v{self.vs2}"
        return f"{f6.name.lower()}.{sfx} v{self.vd}, v{self.vs1}, 0x{self.imm:x}"


def ls_imm(segment: int, offset: int) -> int:
    return ((segment & 0xFFFF) << 48) | (offset & ((1 << 48) - 1))


def load_program(lines) -> list:
    """Parse an instruction-memory image (.mem style, one hex instr/line)."""
    out = []
    for line in lines:
        line = line.strip()
        if line and not line.startswith("//"):
            out.append(Instr.decode(line))
    return out


def dump_program(prog) -> str:
    return "\n".join(i.hex() for i in prog) + "\n"
