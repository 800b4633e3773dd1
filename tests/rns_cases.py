"""The words, moduli and layouts `rns_torch`'s kernel path is held on.

Shared by tests/test_torch_rns_kernel.py (the NumPy model of `csrc/rns.cu`
on the CPU) and tests/test_torch_rns_cuda.py (the kernel on the card), so
both hold the kernel on one list.  Imports no JAX.
"""

import numpy as np
import torch

from aloha_tpu_torch.config import DEFAULT_CONFIG

U64 = np.uint64
#: the three-limb ring's four moduli (tests/test_torch_multilimb.py)
P3 = (576460752303439873, 576460752303702017, 576460752304439297, 576460752304619521)
#: every modulus of the configurations: q0, q1, P and the three-limb ring's
MODULI = DEFAULT_CONFIG.moduli + P3


def edges(q: int) -> np.ndarray:
    """0, 1, q-1, q, q+1, 2q-1, 2q, 2^60-1, 2^63-1, 2^63 and 2^64-1."""
    return np.array([0, 1, q - 1, q, q + 1, 2 * q - 1, 2 * q, (1 << 60) - 1, (1 << 63) - 1,
                     1 << 63, (1 << 64) - 1], dtype=U64)


def words(q: int, seed: int, size: int = 512) -> tuple:
    """(a, b): the edge words crossed, then seeded random uint64 patterns
    and words below 2q; an even count, so the kernel takes 16-byte units."""
    rng = np.random.default_rng(seed)
    e = edges(q)
    a = np.concatenate([np.repeat(e, e.size), rng.integers(0, 1 << 64, size - 1, dtype=U64),
                        rng.integers(0, 2 * q, size, dtype=U64)])
    b = np.concatenate([np.tile(e, e.size), rng.integers(0, 1 << 64, size - 1, dtype=U64),
                        rng.integers(0, 2 * q, size, dtype=U64)])
    return a, b


def tensor(x, device="cpu") -> torch.Tensor:
    """uint64 words as the int64 tensor of their bit patterns, on device."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=U64).view(np.int64)).to(device)


def drawer(seed: int, device="cpu"):
    """draw(*shape): seeded uint64 patterns as an int64 tensor on device."""
    rng = np.random.default_rng(seed)
    return lambda *shape: tensor(rng.integers(0, 1 << 64, shape, dtype=U64), device)


#: (x, y) builders over draw(*shape), whose layouts take single words
#: (odd n, an offset view, a column broadcast) or 16-byte units after a
#: collapse or a copy (leading axes apart, every other row, a limb
#: broadcast, a lower rank); the kernel's operands under two moduli
LAYOUTS = {
    "odd_n": lambda g: (g(4, 2, 7), g(4, 2, 7)),
    "offset_view": lambda g: (g(3, 2, 17)[..., 1:], g(3, 2, 16)),
    "column_broadcast": lambda g: (g(3, 2, 8), g(2, 1).expand(3, 2, 8)),
    "leading_axes_apart": lambda g: (g(2, 3, 2, 8),
                                     g(3, 1, 2, 8).expand(3, 2, 2, 8).transpose(0, 1)),
    "every_other_row": lambda g: (g(3, 4, 2, 8)[:, ::2], g(3, 2, 2, 8)),
    "limb_broadcast": lambda g: (g(3, 2, 8), g(3, 1, 8)),
    "lower_rank": lambda g: (g(3, 2, 8), g(8)),
}
#: the layouts the wrapper hands over in 16-byte units
VECTOR_LAYOUTS = ("leading_axes_apart", "limb_broadcast", "lower_rank", "every_other_row")

#: (shape of x, shape of y) under one modulus: scalars, a broadcast, an
#: empty tensor (no launch)
BROADCAST_SHAPES = [((), ()), ((5,), ()), ((4, 6), (6,)), ((3, 4, 1), (4, 5)), ((0, 8), (8,))]
