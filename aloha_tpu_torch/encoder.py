"""CKKS encoder on the host: cleartext slots <-> RNS plaintext coefficients.

The port's own copy of `aloha_tpu/encoder.py`: the float inverse canonical
embedding in float64 NumPy, then round-to-nearest, which reproduces the
reference's fixed-point pipeline (reference: src/encoder/) to ~1e-6
relative.  The device encoder, the port of `encoder_jax` that reproduces
the fixed-point pipeline word for word, is `encoder_torch` (on the card
through `he_torch.encode`).

  * a cleartext image holds n/2 complex slots interleaved:
    z_k = image[2k] + i*image[2k+1];
  * slot k lives at the evaluation point zeta^(3^k), zeta = e^(i*pi/N)
    (the hardware's position map, reference: src/encoder/addr_gen.sv);
  * the effective scale is Delta = 2^38: m(zeta^(3^k)) ~= Delta * z_k.
"""

from __future__ import annotations

import functools

import numpy as np

from aloha_tpu_torch.config import DEFAULT_CONFIG, HEConfig

#: Effective encode scale of the reference pipeline.
DELTA_LOG2 = 38
DELTA = float(1 << DELTA_LOG2)


@functools.lru_cache(maxsize=None)
def _slot_positions(n: int):
    """t_k = (3^k - 1)/2: spectrum position of slot k (and its mirror)."""
    m = 2 * n
    t = np.empty(n // 2, dtype=np.int64)
    v = 1
    for k in range(n // 2):
        t[k] = (v - 1) // 2
        v = (v * 3) % m
    return t


def slots_from_cleartext(cleartext: np.ndarray) -> np.ndarray:
    """Interleaved re/im image -> complex slot vector (n/2,)."""
    c = np.asarray(cleartext, dtype=np.float64).ravel()
    if c.size % 2:
        raise ValueError(
            f"cleartext length {c.size} is odd; expected interleaved re/im pairs"
        )
    return c[0::2] + 1j * c[1::2]


def cleartext_from_slots(z: np.ndarray) -> np.ndarray:
    out = np.empty(2 * z.size, dtype=np.float64)
    out[0::2] = z.real
    out[1::2] = z.imag
    return out


def encode(cleartext: np.ndarray, cfg: HEConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Cleartext image (N floats) -> (n_limbs, N) uint64 coefficient-domain
    RNS plaintext (`he_torch.encode_post` moves it to the NTT domain)."""
    n = cfg.n
    z = slots_from_cleartext(cleartext)
    if z.size != n // 2:
        raise ValueError(f"expected {n // 2} slots, got {z.size}")
    t = _slot_positions(n)
    spectrum = np.zeros(n, dtype=np.complex128)
    spectrum[t] += z
    np.add.at(spectrum, n - 1 - t, np.conj(z))
    i = np.arange(n)
    twist = np.exp(-1j * np.pi * i / n)
    m_int = np.rint((twist * np.fft.fft(spectrum)).real * (DELTA / n)).astype(np.int64)
    out = np.empty((cfg.n_limbs, n), dtype=np.uint64)
    for limb in range(cfg.n_limbs):
        # sign-fix: x < 0 -> x + q (reference: controller.sv:643)
        out[limb] = np.where(m_int < 0, m_int + cfg.moduli[limb], m_int).astype(np.uint64)
    return out


def decode(pt_coeff: np.ndarray, cfg: HEConfig = DEFAULT_CONFIG, limb: int = 0) -> np.ndarray:
    """(.., N) coefficient-domain residues (one limb) -> complex slots."""
    n = cfg.n
    q = cfg.moduli[limb]
    m = np.asarray(pt_coeff, dtype=np.uint64).reshape(-1, n)[limb if pt_coeff.ndim > 1 else 0]
    return decode_coeffs(np.where(m > q // 2, m.astype(np.float64) - float(q), m.astype(np.float64)),
                         cfg)


def decode_coeffs(mc: np.ndarray, cfg: HEConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Signed coefficients (..., N) as float64 -> complex slots (..., N/2)
    at the scale Delta: for a message whose integers exceed one limb, such
    as a product at Delta^2 recombined over the limbs."""
    n = cfg.n
    i = np.arange(n)
    v = n * np.fft.ifft(np.asarray(mc, dtype=np.float64) * np.exp(1j * np.pi * i / n))
    return v[..., _slot_positions(n)] / DELTA
