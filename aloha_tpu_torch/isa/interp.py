"""The HE vector-processor replayer.

The port of `aloha_tpu/isa/interp.py:108-246`: the same decode loop,
segment resolution, `trace` hook and error messages.  It plays the role of
the reference's sequencer + lane array (reference: src/vp/sequncer/
seq_top.v fetch/dispatch FSMs, src/vp/vxu/ lanes): it fetches 96-bit
instructions from an instruction image, decodes them on the host, and
dispatches each instruction's numerical semantics through a backend.  The
port's backend is `aloha_tpu_torch.torch_backend.TorchBackend` (int64
tensors on one device: the CUDA kernels on the card, their plain versions
on the CPU).  The NumPy oracle stays in the JAX package; only the tests
hold the two against each other.

Memory model: SPM as a (rows, 128) array (row = 1 KiB = 128 lanes x 64 b,
reference: src/mem_buf/spm.sv:12-21) and a separate KSK memory
(reference: src/mem_buf/ksk_mem.sv).  Load/store segments resolve through
the CSR base pointers exactly like vp_top_full
(reference: src/vp/top/vp_top_full.sv:105-118).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from aloha_tpu_torch.config import DEFAULT_CONFIG, HEConfig, NUM_LANES, barrett_iq
from aloha_tpu_torch.isa.encoding import Funct3, Funct6, Instr


@dataclasses.dataclass
class LaunchArgs:
    """The runtime CSR surface of one kernel launch.

    Mirrors the reference's AXI-Lite registers: pc, src0/src1/rslt SPM
    pointers, rot_step, ksk_ptr (reference: src/mem_buf/axil_parse.sv:50-72,
    host usage sim/top/top_noaxilite_tb.sv:396-417).
    Pointers are SPM row addresses; ksk_ptr is a KSK-memory row address.
    """

    pc: int = 0
    src0: int = 0
    src1: int = 0
    rslt: int = 0
    step: int = 0
    ksk_ptr: int = 0


class VectorProcessor:
    """In-order instruction replayer with 32 vector registers.

    `backend` defaults to a `TorchBackend` on the card (`cuda`)."""

    def __init__(self, cfg: HEConfig = DEFAULT_CONFIG, backend=None):
        if backend is None:
            from aloha_tpu_torch.torch_backend import TorchBackend

            backend = TorchBackend()
        self.cfg = cfg
        self.be = backend
        # modulus value -> limb index, the analogue of the hard-coded
        # modq -> twiddle-set map (reference: src/vp/vxu/vxu_top.sv:112-118).
        self._limb_of = {q: i for i, q in enumerate(cfg.moduli)}

    def run(
        self,
        program,
        spm,
        ksk_mem=None,
        args: Optional[LaunchArgs] = None,
        trace: Optional[list] = None,
    ):
        """Execute until vbreak; returns the updated SPM array.  The
        caller's `spm` is left as it was (the backend snapshots it).  A
        transform fed words outside its window raises ValueError here,
        after the last instruction (`TorchBackend.end_launch`).

        `program` is a list of Instr; when launched from a full instruction
        RAM image, slice it at args.pc first (the fetch FSM's PC counter,
        reference: src/vp/sequncer/seq_top.v:179-221).

        `trace`, when given, collects (pc, instr, result) for every
        result-producing instruction, the result as a uint64 host array
        (see aloha_tpu_torch.trace_db; reference analogue: the tdb trace
        replay of sim/vp/top/vp_top_tb.sv).
        """
        cfg, be = self.cfg, self.be
        args = args or LaunchArgs()
        spm = be.begin_launch(spm)
        vregs: Dict[int, object] = {}
        vl_bits = cfg.n * 64
        q = cfg.moduli[0]
        seg_base = {0: args.src0, 1: args.src1, 2: args.rslt}

        for pc_off, instr in enumerate(program[args.pc :]):
            f6 = instr.funct6
            if f6 == Funct6.VBREAK:
                break
            elif f6 == Funct6.NOP:
                continue
            elif f6 == Funct6.VSETVL:
                vl_bits = instr.imm
            elif f6 == Funct6.VSETQ:
                q = instr.imm
                if q not in self._limb_of:
                    raise ValueError(f"vsetq 0x{q:x}: modulus not in config")
            elif f6 == Funct6.VSETIQ:
                expected = barrett_iq(q, cfg.mod_width)
                if not (expected <= instr.imm <= expected + 1):
                    raise ValueError(
                        f"vsetiq 0x{instr.imm:x} inconsistent with q=0x{q:x}"
                    )
            elif f6 == Funct6.VLE:
                n_el = vl_bits // 64
                row = instr.offset // (NUM_LANES * 8)
                if instr.segment == 15:
                    src = be.read_rows(
                        ksk_mem, args.ksk_ptr + row, n_el // NUM_LANES
                    )
                else:
                    base = seg_base[instr.segment]
                    src = be.read_rows(spm, base + row, n_el // NUM_LANES)
                vregs[instr.vd] = src
            elif f6 == Funct6.VSE:
                row = instr.offset // (NUM_LANES * 8)
                base = seg_base[instr.segment]
                spm = be.write_rows(spm, base + row, vregs[instr.vs1])
                if trace is not None:
                    trace.append(
                        (args.pc + pc_off, instr, be.unwrap(vregs[instr.vs1]))
                    )
            elif f6 == Funct6.VNTT:
                limb = self._limb_of[q]
                vregs[instr.vd] = be.ntt(vregs[instr.vs1], q, cfg.psi[limb])
            elif f6 == Funct6.VINTT:
                limb = self._limb_of[q]
                vregs[instr.vd] = be.intt(vregs[instr.vs1], q, cfg.ipsi[limb])
            elif f6 == Funct6.VAUT:
                step = (args.step + instr.imm) % (2 * cfg.n)
                vregs[instr.vd] = be.automorphism(vregs[instr.vs1], step, q)
            elif f6 == Funct6.VROLI:
                vregs[instr.vd] = be.rotate_lanes(vregs[instr.vs1], instr.imm)
            elif f6 == Funct6.VCPY:
                # ADDVS with scalar 0: one lazy reduce + cond-subtract
                vregs[instr.vd] = be.addmod_scalar(vregs[instr.vs1], 0, q)
            elif f6 == Funct6.VFQMOD:
                vregs[instr.vd] = be.modred(vregs[instr.vs1], q)
            elif f6 in (Funct6.VFQMUL, Funct6.VFQADD, Funct6.VFQSUB):
                vregs[instr.vd] = self._alu(instr, vregs, q)
            else:
                raise NotImplementedError(f"funct6 {f6!r}")
            if trace is not None and f6 not in (
                Funct6.VSE, Funct6.VSETVL, Funct6.VSETQ, Funct6.VSETIQ,
            ):
                trace.append(
                    (args.pc + pc_off, instr, be.unwrap(vregs[instr.vd]))
                )
        be.end_launch()
        return spm

    def _alu(self, instr: Instr, vregs, q):
        be = self.be
        a = vregs[instr.vs1]
        if instr.funct3 == Funct3.VV:
            b = vregs[instr.vs2]
            op = {
                Funct6.VFQMUL: be.mulmod,
                Funct6.VFQADD: be.addmod,
                Funct6.VFQSUB: be.submod,
            }[instr.funct6]
            return op(a, b, q)
        if instr.funct6 == Funct6.VFQMUL:
            return be.mulmod_scalar(a, instr.imm, q)
        if instr.funct6 == Funct6.VFQADD:
            return be.addmod_scalar(a, instr.imm, q)
        # vfqsub.vs = a - imm ; vfqsub.sv = imm - a
        return be.submod_scalar(
            a, instr.imm, q, reverse=(instr.funct3 == Funct3.SV)
        )
