"""State carried between the JAX package (NumPy arrays) and the port (int64 tensors).

The JAX package holds a 64-bit word as a uint64 array (`he_np`, `keys`) or
as a pair of uint32 planes (`he_planes`, the kernels' layout); the port
holds it as an int64 tensor with the same bits.  Residues are below 2^60,
so the int64 view of a residue is the residue itself; Shoup companions
use all 64 bits and keep their bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from aloha_tpu_torch import keys
from aloha_tpu_torch.config import HEConfig


def from_u64(arr, device) -> torch.Tensor:
    """uint64 array (any shape) -> int64 tensor on `device`, same bits."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64)).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> uint64 array on the host, same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def from_planes(lo, hi, device) -> torch.Tensor:
    """(lo, hi) uint32 planes -> int64 tensor: hi << 32 | lo."""
    lo = np.asarray(lo, dtype=np.uint32).astype(np.uint64)
    hi = np.asarray(hi, dtype=np.uint32).astype(np.uint64)
    return from_u64(lo | (hi << np.uint64(32)), device)


def to_planes(t: torch.Tensor):
    """int64 tensor -> (lo, hi) uint32 planes on the host."""
    a = to_u64(t)
    return (
        (a & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (a >> np.uint64(32)).astype(np.uint32),
    )


def ct_from_np(ct, device):
    """A ciphertext of the JAX package (`.a`, `.b` uint64 arrays) -> (a, b)
    tensors."""
    return from_u64(ct.a, device), from_u64(ct.b, device)


def ct_to_np(ct):
    """(a, b) tensors -> (a, b) uint64 arrays on the host."""
    return to_u64(ct[0]), to_u64(ct[1])


def sk_from_np(sk, device) -> keys.SecretKey:
    """A secret key of the JAX package (`.coeff` int64, `.ntt` uint64
    arrays) -> the port's `keys.SecretKey`."""
    return keys.SecretKey(
        coeff=torch.from_numpy(np.ascontiguousarray(sk.coeff, dtype=np.int64)).to(device),
        ntt=from_u64(sk.ntt, device),
    )


def ksk_from_np(ksk, cfg: HEConfig, device) -> torch.Tensor:
    """A key-switch key image -> (2L(L+1), N) int64 tensor.  The image
    holds, per modulus m, the L digits' (a, b) pairs: row 2L m + 2j + part
    (aloha_tpu/ops/ks_kernel.py:276).  Accepts the flat dump form too."""
    L = cfg.n_limbs
    k = np.asarray(ksk, dtype=np.uint64)
    if k.size != 2 * L * (L + 1) * cfg.n:
        raise ValueError(
            f"key of {k.size} words; expected 2L(L+1) x N = "
            f"{2 * L * (L + 1)} x {cfg.n}"
        )
    return from_u64(k.reshape(2 * L * (L + 1), cfg.n), device)


def tables_from_planes(planes, q: int, inverse: bool, device):
    """The JAX package's per-element twiddle planes -> the port's compact
    (w, wshoup) int64 tensors (n,), as `ntt_torch.twiddles_np` makes them.

    `planes` is `ntt_pallas._tables_np`'s four (w_lo, w_hi, s_lo, s_hi) or
    `ntt_stream._tables6_np`'s six (w_lo, w_hi and the four 16-bit limbs of
    the Shoup companion), each (logn, rows, 128) uint32.  Stage s's plane
    holds at element i the twiddle of i's butterfly group: compact entry
    2^s + (i >> (logn - s)) forward, n/2^(s+1) + (i >> (s+1)) inverse.
    Entry 0, which no stage reads, is root^0 = 1 and floor(2^64 / q).
    Raises when a group's elements disagree."""
    p = [np.asarray(x, dtype=np.uint32).astype(np.uint64) for x in planes]
    if len(p) == 4:
        s = p[2] | (p[3] << np.uint64(32))
    elif len(p) == 6:
        s = p[2] | (p[3] << np.uint64(16)) | (p[4] << np.uint64(32)) | (p[5] << np.uint64(48))
    else:
        raise ValueError(f"{len(p)} planes: 4 (_tables_np) or 6 (_tables6_np) expected")
    logn = p[0].shape[0]
    n = 1 << logn
    wp = (p[0] | (p[1] << np.uint64(32))).reshape(logn, -1)
    sp = s.reshape(logn, -1)
    if wp.shape[1] != n:
        raise ValueError(f"planes of {wp.shape[1]} elements for {logn} stages: 2^{logn} expected")
    w = np.zeros(n, dtype=np.uint64)
    ws = np.zeros(n, dtype=np.uint64)
    w[0], ws[0] = 1, (1 << 64) // q
    i = np.arange(n)
    for st in range(logn):
        idx = (n >> (st + 1)) + (i >> (st + 1)) if inverse else (1 << st) + (i >> (logn - st))
        w[idx], ws[idx] = wp[st], sp[st]
        if not (np.array_equal(w[idx], wp[st]) and np.array_equal(ws[idx], sp[st])):
            raise ValueError(f"stage {st}: a butterfly group's elements hold different twiddles")
    return from_u64(w, device), from_u64(ws, device)


def prepared_from_planes(planes, cfg: HEConfig, device):
    """The JAX `ks_kernel.prepare_ksk` planes (klo, khi, s0, s1, s2, s3),
    each (2L(L+1), rows, 128) uint32 with s0..s3 the 16-bit limbs of the
    Shoup companions, -> the port's (k, kshoup) tensors (2L(L+1), N)."""
    L = cfg.n_limbs
    shape = (2 * L * (L + 1), cfg.n)
    klo, khi, *limbs = (np.asarray(p, dtype=np.uint32).reshape(shape) for p in planes)
    s = np.zeros(shape, dtype=np.uint64)
    for i, v in enumerate(limbs):
        s |= v.astype(np.uint64) << np.uint64(16 * i)
    return from_planes(klo, khi, device), from_u64(s, device)
