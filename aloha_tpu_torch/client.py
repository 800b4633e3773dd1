"""The client's side of an encrypted matrix-vector request.

Slot vectors are encoded on the host (`encoder`) and encrypted on the
secret key's device (`keys.encrypt`); the server applies
`he_torch.matvec_bsgs` and `rescale`; the client decrypts and decodes at
the rescaled scale Delta^2/q1 and compares with the cleartext product.

The slot error of such an answer is noise the scheme adds, not a property
of the matrix: it is the rescale's rounding (r0 + r1 s, r0 and r1 uniform
in [-1/2, 1/2) a coefficient) seen through the canonical embedding, where
s(zeta_k) multiplies r1 slot by slot, plus the float64 rounding of the
decoder's centred lift of each negative coefficient (one ulp of q0).  Its
per-slot standard deviation is `noise_sigma`; it does not grow with the
number of diagonals.  A correct answer keeps every slot's error under
`noise_bound` standard deviations, the level that all the slots checked
together pass but with probability `NOISE_P`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from aloha_tpu_torch import encoder, keys
from aloha_tpu_torch.config import HEConfig

#: chance that a correct batch fails `noise_bound` (complex Gaussian slot
#: errors: P(|e| > t sigma) = exp(-t^2) a slot, a union over the slots)
NOISE_P = 1e-6


def encode_signed(zs: np.ndarray, cfg: HEConfig) -> np.ndarray:
    """(B, N/2) complex slot vectors -> (B, N) int64 signed coefficients of
    their encodings under q0, as `keys.encrypt` takes them."""
    q0 = cfg.moduli[0]
    pts = np.stack([encoder.encode(encoder.cleartext_from_slots(z), cfg)[0] for z in zs])
    return np.where(pts > q0 // 2, pts.astype(np.int64) - np.int64(q0), pts.astype(np.int64))


def encrypt_slots(zs: np.ndarray, sk: keys.SecretKey, cfg: HEConfig,
                  generator: torch.Generator = None):
    """Encode (B, N/2) slot vectors on the host and encrypt them on sk's
    device: (a, b), each (B, L, N); the randomness from the OS unless a
    generator is given (`keys.draw_encryption`)."""
    signed = torch.from_numpy(encode_signed(zs, cfg)).to(sk.ntt.device)
    return keys.encrypt(signed, sk, cfg, generator)


def decode_rescaled(dec: np.ndarray, cfg: HEConfig) -> np.ndarray:
    """(B, N) signed coefficients under q0 of once-rescaled ciphertexts'
    decryptions -> their (B, N/2) slots at the scale Delta^2/q1."""
    q0 = cfg.moduli[0]
    res = np.where(dec < 0, dec + np.int64(q0), dec).astype(np.uint64)
    slots = np.stack([encoder.decode(r[None, :], cfg, limb=0) for r in res])
    return slots * (cfg.moduli[1] / encoder.DELTA)


def decrypt_rescaled(ct, sk: keys.SecretKey, cfg: HEConfig):
    """Once-rescaled ciphertexts (a, b), each (B, 1, N): (their (B, N/2)
    slots, their (B, N) signed coefficients under q0)."""
    dec = keys.decrypt(ct, sk, cfg).cpu().numpy()
    return decode_rescaled(dec, cfg), dec


def matvec_clear(dvecs, z: np.ndarray) -> np.ndarray:
    """The cleartext product of the wrapped diagonals `dvecs` with z."""
    return sum(d * np.roll(z, -k) for k, d in enumerate(dvecs))


def noise_sigma(dec: np.ndarray, sk: keys.SecretKey, cfg: HEConfig) -> np.ndarray:
    """(B, N/2) standard deviation of each slot's error in the decryptions
    `dec` ((B, N) signed coefficients under q0) of once-rescaled ciphertexts."""
    n = cfg.n
    s = encoder.decode_coeffs(sk.coeff.cpu().numpy().astype(np.float64), cfg) * encoder.DELTA
    ulp = 2.0 ** (cfg.moduli[0].bit_length() - 53)
    lift = (dec < 0).sum(axis=-1, keepdims=True) * ulp ** 2 / 12
    var = n / 12 * (1 + np.abs(s) ** 2) + lift
    return np.sqrt(var) / (encoder.DELTA ** 2 / cfg.moduli[1])


def noise_bound(n_slots: int, p: float = NOISE_P) -> float:
    """Errors in standard deviations that n_slots slots of a correct answer
    stay under together but with probability p."""
    return math.sqrt(math.log(n_slots / p))


def slot_errors(got: np.ndarray, want: np.ndarray, sigma: np.ndarray):
    """(largest |error| of each vector, then of all |error| / sigma the
    largest and the mean square, which the model puts at 1)."""
    err = np.abs(got - want)
    t = err / sigma
    return err.max(axis=-1), float(t.max()), float((t ** 2).mean())
