"""Parameter surface of the port: the ring, the RNS moduli and their roots.

The port's own copy of `aloha_tpu/config.py` (the reference pins N = 8192,
two 60-bit limbs q0, q1 and the key-switch special prime P; reference:
src/top/h2_top.sv:31-32, sim/vp/tf_rom_generator/tf_rom_generator.sv:75-77).
The defaults must stay equal to the JAX package's: the port is held word
for word against it (tests/test_torch_host.py compares every field).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

#: Ring degree N (reference VLMAX = 8192 x 64b, src/vp/include/vp_defines.vh:24).
N_DEFAULT = 8192

#: 60-bit RNS moduli: q0, q1 and the key-switching special prime P
#: (reference: src/vp/vxu/vxu_top.sv:115-116, tf_rom_generator.sv:77).
Q0 = 576460825317867521  # 2^59 + 2^36 + 2^32 + 1
Q1 = 576460924102115329  # 2^59 + 2^37 + 2^35 + 1
SP = 576462951330889729  # 2^59 + 2^41 + 2^22 + 2^14 + 1
MODULI_DEFAULT: Tuple[int, ...] = (Q0, Q1, SP)

#: 2N-th primitive roots psi (and inverses) per modulus, the bases of the
#: reference's twiddle ROMs (tf_rom_generator.sv:75-76).
PSI_DEFAULT: Tuple[int, ...] = (3825716582911, 79932510954937, 101017252977188)
IPSI_DEFAULT: Tuple[int, ...] = (
    264250557364078134,
    101614808487310449,
    106746493840490977,
)

#: Modulus bit width w of the Barrett pipeline (reference:
#: src/vp/vxu/vxu_lane.sv:539 hard-codes mod_width = 60).
MOD_WIDTH = 60

#: SPM geometry: 4 banks x 4096 rows x 1 KiB = 16 MiB, "64 ciphertexts"
#: (reference: src/vp/include/vp_defines.vh:27, src/mem_buf/spm.sv:12-21).
SPM_ROWS = 16384

#: KSK memory: 9216 rows x 1 KiB (reference: src/top/h2_top.sv:8).
KSK_ROWS = 9216

#: Lane count of the reference SIMD engine: one memory row is 128 words
#: (reference: src/vp/include/vp_defines.vh:25).
NUM_LANES = 128


def barrett_iq(q: int, w: int = MOD_WIDTH) -> int:
    """Barrett reciprocal floor(2^(2w+1) / q) of the RTL modmul chain
    (reference: src/vp/vxu/modmul.sv:145-187).  It must fit 64 bits, so
    q > 2^(2w+1-64) (q > 2^57 for w = 60)."""
    iq = (1 << (2 * w + 1)) // q
    if iq >= 1 << 64:
        raise ValueError(
            f"modulus {q:#x} too small for the {w}-bit Barrett datapath "
            f"(reciprocal needs {iq.bit_length()} bits; require q > 2^{2*w+1-64})"
        )
    return iq


def shoup(w: int, q: int) -> int:
    """Shoup precomputed quotient floor(w * 2^64 / q) for lazy mulmod."""
    return (w << 64) // q


@functools.lru_cache(maxsize=None)
def _validate(n: int, moduli: Tuple[int, ...], psi: Tuple[int, ...]) -> None:
    for q, p in zip(moduli, psi):
        if pow(p, n, q) != q - 1:
            raise ValueError(f"psi={p} is not a primitive 2N-th root mod {q}")


@dataclasses.dataclass(frozen=True)
class HEConfig:
    """Static configuration of one instance.

    Attributes:
      n: ring degree (power of two).
      moduli: RNS moduli; the last one is the key-switch special prime P
        and the first ``n_limbs`` are ciphertext limbs.
      psi / ipsi: 2N-th primitive roots of unity (and inverses) per modulus.
      mod_width: modulus bit width w (Barrett shifts depend on it).
    """

    n: int = N_DEFAULT
    moduli: Tuple[int, ...] = MODULI_DEFAULT
    psi: Tuple[int, ...] = PSI_DEFAULT
    ipsi: Tuple[int, ...] = IPSI_DEFAULT
    mod_width: int = MOD_WIDTH

    def __post_init__(self):
        if self.n & (self.n - 1):
            raise ValueError("n must be a power of two")
        for q, p, ip in zip(self.moduli, self.psi, self.ipsi):
            if p * ip % q != 1:
                raise ValueError(f"ipsi is not the inverse of psi mod {q}")
        # the digit raise and the key-switch mod-down take single lazy
        # reductions, exact only when every residue of one modulus stays
        # below twice any other (reference: src/vp/vxu/modalu.sv:44-46)
        if max(self.moduli) >= 2 * min(self.moduli):
            raise ValueError(
                "moduli must be same-magnitude: max(moduli) < 2*min(moduli)"
            )
        _validate(self.n, tuple(self.moduli), tuple(self.psi))

    @property
    def logn(self) -> int:
        return self.n.bit_length() - 1

    @property
    def n_limbs(self) -> int:
        """Number of ciphertext limbs (all moduli except the special prime)."""
        return len(self.moduli) - 1

    @property
    def special_prime(self) -> int:
        return self.moduli[-1]

    @property
    def iq(self) -> Tuple[int, ...]:
        return tuple(barrett_iq(q, self.mod_width) for q in self.moduli)

    def pinv_mod(self, limb: int) -> int:
        """P^-1 mod q_limb (the reference's keyswitch immediates for defaults)."""
        return pow(self.special_prime, -1, self.moduli[limb])


DEFAULT_CONFIG = HEConfig()
