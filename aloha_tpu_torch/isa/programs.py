"""The four canned VP kernels, authored against our assembler.

The port's own copy of `aloha_tpu/isa/programs.py`: the images are
byte-identical to the JAX package's for the same config
(tests/test_torch_isa.py).

The reference ships these as pre-assembled instruction-memory images
(reference: sim/vp/isram_file_generator/{encode_post,mul_plain,hom_add,
keyswitch}.mem, concatenated into the 4096-deep instruction RAM at offsets
0/64/160/256 by isram_file_generator.sv:22-32).  Here each kernel is a
*generator* parameterized by HEConfig: the first three reproduce the
reference images byte for byte for the default config (certified by
tests/test_isa.py against the JAX package's copy), and `keyswitch`
generalizes the reference's fixed 2-limb sequence to any limb count while
replaying bit-identically.

SPM data layout (one polynomial = N x 8 bytes = 64 rows):
  segment 0 (src0): input ciphertext  a_q0 | a_q1 | b_q0 | b_q1
  segment 1 (src1): second operand (ct or pt)
  segment 2 (rslt): output
  segment 15      : key-switch keys, 12 polys per step
"""

from __future__ import annotations

from typing import List

from aloha_tpu_torch.config import HEConfig, barrett_iq
from aloha_tpu_torch.isa.encoding import (
    Funct3,
    Funct6,
    Instr,
    SEG_KSK,
    SEG_RSLT,
    SEG_SRC0,
    SEG_SRC1,
    ls_imm,
)

#: Instruction RAM offsets of each kernel
#: (reference: sim/vp/isram_file_generator/isram_file_generator.sv:27-31).
ISRAM_ENCODE_POST = 0
ISRAM_MUL_PLAIN = 64
ISRAM_HOM_ADD = 160
ISRAM_KEYSWITCH = 256


def program_iq(cfg: HEConfig, limb: int) -> int:
    """The Barrett constant a reference program feeds to `vsetiq`.

    floor(2^121/q) for the ciphertext limbs; the reference's keyswitch image
    uses floor+1 for the special prime (keyswitch.mem line 11) — both are
    within the Barrett error budget, but we reproduce the shipped constant
    exactly for byte-identical program images.
    """
    iq = barrett_iq(cfg.moduli[limb], cfg.mod_width)
    if limb == len(cfg.moduli) - 1:
        return iq + 1
    return iq


class Asm:
    """Tiny chaining assembler for the HE vector ISA.

    Field conventions match the reference's pre-assembled images exactly
    (mask always set; config ops use funct3=2; loads/stores and scalar ALU
    forms use funct3=1; vector-vector ALU and NTT ops use funct3=0).
    """

    def __init__(self):
        self.prog: List[Instr] = []

    def _emit(self, **kw) -> "Asm":
        self.prog.append(Instr(mask=1, **kw))
        return self

    # -- config ----------------------------------------------------------
    def vsetvl(self, bits):
        return self._emit(funct6=Funct6.VSETVL, funct3=Funct3.SV, imm=bits)

    def vsetq(self, q):
        return self._emit(funct6=Funct6.VSETQ, funct3=Funct3.SV, imm=q)

    def vsetiq(self, iq):
        return self._emit(funct6=Funct6.VSETIQ, funct3=Funct3.SV, imm=iq)

    def set_modulus(self, cfg: HEConfig, limb: int):
        self.vsetq(cfg.moduli[limb])
        return self.vsetiq(program_iq(cfg, limb))

    def vbreak(self):
        return self._emit(funct6=Funct6.VBREAK, funct3=Funct3.SV)

    # -- memory ------------------------------------------------------------
    def vle(self, vd, seg, off):
        return self._emit(
            funct6=Funct6.VLE, vd=vd, funct3=Funct3.VS, imm=ls_imm(seg, off)
        )

    def vse(self, vs1, seg, off):
        return self._emit(
            funct6=Funct6.VSE, vs1=vs1, funct3=Funct3.VS, imm=ls_imm(seg, off)
        )

    # -- ALU ---------------------------------------------------------------
    def _vv(self, f6, vd, vs1, vs2):
        if (vs1 ^ vs2) & 1 == 0:
            raise ValueError(
                f"{f6.name}.vv operands v{vs1}, v{vs2} share a register-file "
                "bank (even/odd constraint, reference expander.v:183-199)"
            )
        return self._emit(funct6=f6, vd=vd, vs1=vs1, vs2=vs2, funct3=Funct3.VV)

    def _imm(self, f6, f3, vd, vs1, imm):
        return self._emit(funct6=f6, vd=vd, vs1=vs1, funct3=f3, imm=imm)

    def vfqmul(self, vd, vs1, vs2):
        return self._vv(Funct6.VFQMUL, vd, vs1, vs2)

    def vfqmul_vs(self, vd, vs1, imm):
        return self._imm(Funct6.VFQMUL, Funct3.VS, vd, vs1, imm)

    def vfqadd(self, vd, vs1, vs2):
        return self._vv(Funct6.VFQADD, vd, vs1, vs2)

    def vfqadd_vs(self, vd, vs1, imm):
        return self._imm(Funct6.VFQADD, Funct3.VS, vd, vs1, imm)

    def vfqsub(self, vd, vs1, vs2):
        return self._vv(Funct6.VFQSUB, vd, vs1, vs2)

    def vfqsub_vs(self, vd, vs1, imm):
        return self._imm(Funct6.VFQSUB, Funct3.VS, vd, vs1, imm)

    def vfqsub_sv(self, vd, vs1, imm):
        return self._imm(Funct6.VFQSUB, Funct3.SV, vd, vs1, imm)

    def vfqmod(self, vd, vs1):
        return self._imm(Funct6.VFQMOD, Funct3.VV, vd, vs1, 0)

    def vcpy(self, vd, vs1):
        return self._imm(Funct6.VCPY, Funct3.VV, vd, vs1, 0)

    def vntt(self, vd, vs1):
        return self._imm(Funct6.VNTT, Funct3.VV, vd, vs1, 0)

    def vintt(self, vd, vs1):
        return self._imm(Funct6.VINTT, Funct3.VV, vd, vs1, 0)

    def vaut(self, vd, vs1, imm=0):
        return self._imm(Funct6.VAUT, Funct3.VS, vd, vs1, imm)

    def vroli(self, vd, vs1, imm):
        return self._imm(Funct6.VROLI, Funct3.VS, vd, vs1, imm)


def _poly_bytes(cfg: HEConfig) -> int:
    return cfg.n * 8


def encode_post(cfg: HEConfig) -> List[Instr]:
    """Per-limb NTT of a freshly encoded plaintext (2 polys in, 2 out)."""
    a = Asm()
    P = _poly_bytes(cfg)
    a.vsetvl(cfg.n * 64)
    for limb in range(cfg.n_limbs):
        a.set_modulus(cfg, limb)
        a.vle(0, SEG_SRC0, limb * P)
        a.vntt(2, 0)
        a.vse(2, SEG_RSLT, limb * P)
    a.vbreak()
    return a.prog


def mul_plain(cfg: HEConfig) -> List[Instr]:
    """ct x pt: 2*n_limbs pointwise multiplies; pt limb loaded once."""
    a = Asm()
    P = _poly_bytes(cfg)
    L = cfg.n_limbs
    a.vsetvl(cfg.n * 64)
    for limb in range(L):
        a.set_modulus(cfg, limb)
        a.vle(0, SEG_SRC0, limb * P)          # ct_a residue
        a.vle(1, SEG_SRC1, limb * P)          # pt residue (reused)
        a.vfqmul(2, 0, 1)
        a.vse(2, SEG_RSLT, limb * P)
        a.vle(0, SEG_SRC0, (L + limb) * P)    # ct_b residue
        a.vfqmul(2, 0, 1)
        a.vse(2, SEG_RSLT, (L + limb) * P)
    a.vbreak()
    return a.prog


def hom_add(cfg: HEConfig) -> List[Instr]:
    """ct + ct: 2*n_limbs pointwise adds."""
    a = Asm()
    P = _poly_bytes(cfg)
    L = cfg.n_limbs
    a.vsetvl(cfg.n * 64)
    for limb in range(L):
        a.set_modulus(cfg, limb)
        for part in (0, 1):
            off = (part * L + limb) * P
            a.vle(0, SEG_SRC0, off)
            a.vle(1, SEG_SRC1, off)
            a.vfqadd(2, 0, 1)
            a.vse(2, SEG_RSLT, off)
    a.vbreak()
    return a.prog


def keyswitch(cfg: HEConfig) -> List[Instr]:
    """Rotation: automorphism (step CSR) + hybrid key-switch.

    Re-derivation of the reference's 122-instruction kernel
    (reference: sim/vp/isram_file_generator/keyswitch.mem, disassembled),
    generated for any limb count.  Replays bit-identically to the reference
    image on the same inputs (tests/test_isa.py::test_keyswitch_replay_*).

    Register plan (2-limb default; generalizes by allocation below):
      nd[j][m]  NTT of digit j under modulus m   (even regs)
      arot[j]   NTT_qj(aut(a_qj))                (even regs)
      acc[m][p] inner-product accumulators       (even regs)
      odd regs  KSK operands / short-lived temps
    """
    a = Asm()
    P = _poly_bytes(cfg)
    L = cfg.n_limbs
    nmod = L + 1
    if L > 2:
        # the register-resident schedule below needs L(L+2)+2L+3 long-lived
        # even vregs; beyond 2 limbs switch to the SPM-spilling schedule
        return _keyswitch_spill(cfg)
    a.vsetvl(cfg.n * 64)

    # --- register allocation (evens for long-lived values, odds for temps)
    even = iter(range(0, 32, 2))
    nd = [[next(even) for _ in range(nmod)] for _ in range(L)]
    arot = [next(even) for _ in range(L)]
    acc = [[next(even) for _ in range(2)] for _ in range(nmod)]
    tmp_e = next(even)  # even scratch
    t_odd, k_odd, d_odd = 1, 3, 5  # odd scratch: intt tmp, ksk ops, digits

    # --- phase 1: digits d_j = aut(INTT(b_qj)); raise to every modulus; NTT.
    #     Also aut(a_qj) -> NTT while q_j is configured.
    for j in range(L):
        a.set_modulus(cfg, j)
        a.vle(d_odd, SEG_SRC0, (L + j) * P)     # b_qj (NTT domain)
        a.vintt(t_odd, d_odd)
        a.vaut(d_odd, t_odd)                    # digit, coeff domain
        for m in range(nmod):
            if m == j:
                continue
            a.set_modulus(cfg, m)
            if cfg.moduli[m] > cfg.moduli[j]:
                a.vcpy(tmp_e, d_odd)            # raise: residue already < q_m
            else:
                a.vfqmod(tmp_e, d_odd)          # reduce into smaller modulus
            # vntt reads its source; use an odd temp to keep banks legal
            a.vntt(nd[j][m], tmp_e)
        a.set_modulus(cfg, j)
        a.vntt(nd[j][j], d_odd)
        # aut(a_qj)
        a.vle(t_odd, SEG_SRC0, j * P)
        a.vintt(tmp_e, t_odd)
        a.vaut(t_odd, tmp_e)
        a.vntt(arot[j], t_odd)

    # --- phase 2: KSK inner products under every modulus.
    #     Multiplies land in the odd KSK register so the accumulate's
    #     even/odd bank pairing stays legal, as in the reference image
    #     (e.g. keyswitch.mem line 48: vfqmul.vv v11, v10, v11).
    for m in range(nmod):
        a.set_modulus(cfg, m)
        for part in (0, 1):
            for j in range(L):
                # KSK image stride: 2L polys per modulus (gen_ksk layout
                # [m0d0a, m0d0b, m0d1a, m0d1b, m1...]; = 4 for L = 2, the
                # reference's 12-poly ksk_step*.txt format)
                a.vle(k_odd, SEG_KSK, ((2 * L) * m + 2 * j + part) * P)
                if j == 0:
                    a.vfqmul(acc[m][part], nd[j][m], k_odd)
                else:
                    a.vfqmul(k_odd, nd[j][m], k_odd)
                    a.vfqadd(acc[m][part], acc[m][part], k_odd)

    # --- phase 3: mod-down by the special prime with (P-1)/2 rounding,
    #     then scale by P^-1 mod q_m.  The a-part result goes to an odd
    #     register so phase 4 can add it to arot (even) directly.
    sp = cfg.special_prime
    half = (sp - 1) // 2
    odd = iter(range(7, 32, 2))
    ksa = [next(odd) for _ in range(L)]
    a.set_modulus(cfg, nmod - 1)
    m_reg = [None, None]
    for part in (0, 1):
        a.vintt(tmp_e, acc[nmod - 1][part])
        a.vfqadd_vs(acc[nmod - 1][part], tmp_e, half)
        m_reg[part] = acc[nmod - 1][part]
    for m in range(L):
        a.set_modulus(cfg, m)
        pinv = cfg.pinv_mod(m)
        a.vfqsub_vs(tmp_e, m_reg[0], half)
        a.vntt(t_odd, tmp_e)
        a.vfqsub(acc[m][0], acc[m][0], t_odd)
        a.vfqmul_vs(ksa[m], acc[m][0], pinv)
        a.vfqsub_vs(tmp_e, m_reg[1], half)
        a.vntt(t_odd, tmp_e)
        a.vfqsub(acc[m][1], acc[m][1], t_odd)
        a.vfqmul_vs(acc[m][1], acc[m][1], pinv)

    # --- phase 4: message part = aut(a) + key-switch a-part; store.
    for m in range(L):
        a.set_modulus(cfg, m)
        a.vfqadd(acc[m][0], arot[m], ksa[m])
    for m in range(L):
        a.vse(acc[m][0], SEG_RSLT, m * P)
    for m in range(L):
        a.vse(acc[m][1], SEG_RSLT, (L + m) * P)
    a.vbreak()
    return a.prog


def _keyswitch_spill(cfg: HEConfig) -> List[Instr]:
    """Keyswitch for 3+ ciphertext limbs: SPM-spilling register schedule.

    The 16-even-vreg budget cannot hold the L(L+1) digit-NTT values, so
    they spill to a scratch area of the result segment just past the
    2L output polys (the device reserves it — AlohaDevice.run_rotate
    documents the requirement).  Layout from scratch base S0 = 2L polys:

        nd[j][m]  at S0 + (j*(L+1) + m)   (L*(L+1) polys)
        arot[m]   at S0 + L*(L+1) + m     (L polys)

    Same arithmetic as the register-resident 2-limb kernel; the only
    difference is vse/vle traffic, exactly how the silicon would spill.
    Accumulators stay register-resident (2(L+1) evens, enough to L = 6).
    """
    a = Asm()
    P = _poly_bytes(cfg)
    L = cfg.n_limbs
    nmod = L + 1
    if 2 * nmod + 2 > 16:
        raise NotImplementedError(
            f"{L} limbs need {2 * nmod} accumulator vregs (> 14 even)"
        )
    S0 = 2 * L  # scratch base, in polys
    nd_off = lambda j, m: (S0 + j * nmod + m) * P
    arot_off = lambda m: (S0 + L * nmod + m) * P

    a.vsetvl(cfg.n * 64)
    tmp_e = 0
    nd_e = 2
    # accumulators: consecutive even regs starting at 4
    evens = iter(range(4, 32, 2))
    acc = [[next(evens) for _ in (0, 1)] for _ in range(nmod)]
    t_odd, k_odd, d_odd = 1, 3, 5

    # --- phase 1: digits + aut(a), spilled to scratch
    for j in range(L):
        a.set_modulus(cfg, j)
        a.vle(d_odd, SEG_SRC0, (L + j) * P)     # b_qj (NTT domain)
        a.vintt(t_odd, d_odd)
        a.vaut(d_odd, t_odd)                    # digit, coeff domain
        for m in range(nmod):
            if m == j:
                continue
            a.set_modulus(cfg, m)
            if cfg.moduli[m] > cfg.moduli[j]:
                a.vcpy(tmp_e, d_odd)
            else:
                a.vfqmod(tmp_e, d_odd)
            a.vntt(nd_e, tmp_e)
            a.vse(nd_e, SEG_RSLT, nd_off(j, m))
        a.set_modulus(cfg, j)
        a.vntt(nd_e, d_odd)
        a.vse(nd_e, SEG_RSLT, nd_off(j, j))
        # aut(a_qj)
        a.vle(t_odd, SEG_SRC0, j * P)
        a.vintt(tmp_e, t_odd)
        a.vaut(t_odd, tmp_e)
        a.vntt(nd_e, t_odd)
        a.vse(nd_e, SEG_RSLT, arot_off(j))

    # --- phase 2: inner products from spilled digit NTTs
    stride = 2 * L
    for m in range(nmod):
        a.set_modulus(cfg, m)
        for part in (0, 1):
            for j in range(L):
                a.vle(nd_e, SEG_RSLT, nd_off(j, m))
                a.vle(k_odd, SEG_KSK, (stride * m + 2 * j + part) * P)
                if j == 0:
                    a.vfqmul(acc[m][part], nd_e, k_odd)
                else:
                    a.vfqmul(k_odd, nd_e, k_odd)
                    a.vfqadd(acc[m][part], acc[m][part], k_odd)

    # --- phase 3: mod-down by P with (P-1)/2 rounding, P^-1 scale
    sp = cfg.special_prime
    half = (sp - 1) // 2
    a.set_modulus(cfg, nmod - 1)
    m_reg = [None, None]
    for part in (0, 1):
        a.vintt(tmp_e, acc[nmod - 1][part])
        a.vfqadd_vs(acc[nmod - 1][part], tmp_e, half)
        m_reg[part] = acc[nmod - 1][part]
    for m in range(L):
        a.set_modulus(cfg, m)
        pinv = cfg.pinv_mod(m)
        # a-part: acc - NTT(m0 - half) then * P^-1, + arot, store
        a.vfqsub_vs(tmp_e, m_reg[0], half)
        a.vntt(t_odd, tmp_e)
        a.vfqsub(acc[m][0], acc[m][0], t_odd)
        a.vfqmul_vs(acc[m][0], acc[m][0], pinv)
        a.vle(k_odd, SEG_RSLT, arot_off(m))
        a.vfqadd(acc[m][0], acc[m][0], k_odd)
        a.vse(acc[m][0], SEG_RSLT, m * P)
        # b-part
        a.vfqsub_vs(tmp_e, m_reg[1], half)
        a.vntt(t_odd, tmp_e)
        a.vfqsub(acc[m][1], acc[m][1], t_odd)
        a.vfqmul_vs(acc[m][1], acc[m][1], pinv)
        a.vse(acc[m][1], SEG_RSLT, (L + m) * P)
    a.vbreak()
    return a.prog


def isram_image(cfg: HEConfig) -> List[Instr]:
    """Full instruction RAM image with the reference's kernel offsets."""
    image: List[Instr] = [Instr(funct6=Funct6.NOP)] * 4096
    for base, prog in (
        (ISRAM_ENCODE_POST, encode_post(cfg)),
        (ISRAM_MUL_PLAIN, mul_plain(cfg)),
        (ISRAM_HOM_ADD, hom_add(cfg)),
        (ISRAM_KEYSWITCH, keyswitch(cfg)),
    ):
        image[base : base + len(prog)] = prog
    return image
