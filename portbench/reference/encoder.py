"""The CKKS slot encoding, in float64 NumPy.

The encoding is part of a request's inputs: the benchmark hands the same
cleartext slots to both sides, and each side encodes them.  `encode` is a
frozen copy, operation for operation, of the float pipeline that the system's
client encodes with (the inverse canonical embedding, then one rounding), so
that both sides round every coefficient alike; `decode` is the canonical
embedding that judges a decryption.

Slot k of n/2 lives at the evaluation point zeta^(3^k), zeta = e^(i pi/n);
the encode scale is 2^38.
"""

from __future__ import annotations

import functools

import numpy as np

SCALE_LOG2 = 38
SCALE = float(1 << SCALE_LOG2)


@functools.lru_cache(maxsize=None)
def slot_positions(n: int) -> np.ndarray:
    """t_k = (3^k - 1) / 2 mod 2n: the spectrum position of slot k."""
    t = np.empty(n // 2, dtype=np.int64)
    v = 1
    for k in range(n // 2):
        t[k] = (v - 1) // 2
        v = v * 3 % (2 * n)
    return t


def encode(z: np.ndarray, n: int) -> np.ndarray:
    """One vector of n/2 complex slots -> (n,) int64 message coefficients."""
    c = np.empty(2 * z.size, dtype=np.float64)
    c[0::2] = z.real
    c[1::2] = z.imag
    z = c[0::2] + 1j * c[1::2]
    t = slot_positions(n)
    spectrum = np.zeros(n, dtype=np.complex128)
    spectrum[t] += z
    np.add.at(spectrum, n - 1 - t, np.conj(z))
    i = np.arange(n)
    twist = np.exp(-1j * np.pi * i / n)
    return np.rint((twist * np.fft.fft(spectrum)).real * (SCALE / n)).astype(np.int64)


def encode_batch(zs: np.ndarray, n: int) -> np.ndarray:
    """(..., n/2) complex slots -> (..., n) int64, vector by vector."""
    flat = zs.reshape(-1, zs.shape[-1])
    return np.stack([encode(z, n) for z in flat]).reshape(zs.shape[:-1] + (n,))


def decode(coeffs: np.ndarray, scale: float) -> np.ndarray:
    """(..., n) signed coefficients (any real dtype) -> (..., n/2) complex
    slots at `scale`."""
    n = coeffs.shape[-1]
    i = np.arange(n)
    v = n * np.fft.ifft(np.asarray(coeffs, dtype=np.float64) * np.exp(1j * np.pi * i / n))
    return v[..., slot_positions(n)] / scale
