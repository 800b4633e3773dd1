"""ALOHA on PyTorch and CUDA: the RNS-CKKS serving path for one NVIDIA H100.

The port of `aloha_tpu` (JAX on a TPU) to PyTorch.  A value is one int64
tensor with entries below 2^60 (Hopper has 64-bit integer lanes, so the
TPU's u32 (lo, hi) plane split is gone); a ciphertext is ``(a, b)``, each
``(..., L, N)`` in NTT-domain bit-reversed order, as in `aloha_tpu.he_np`.

Layers (bottom-up): `rns_torch` modular arithmetic -> `ntt_torch`
transforms and tables -> `ops/` kernel wrappers (CUDA C++ under `csrc/`,
each with a plain PyTorch version beside it) -> `he_torch` ciphertext ops.
`convert` carries state between the two packages.  Key generation,
encryption and encoding stay host-side NumPy in `aloha_tpu` and are used
from there.  Nothing here imports JAX.
"""

from aloha_tpu.config import DEFAULT_CONFIG, HEConfig  # noqa: F401
