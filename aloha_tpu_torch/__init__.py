"""ALOHA on PyTorch and CUDA: the RNS-CKKS serving path for one NVIDIA H100.

The port of `aloha_tpu` (JAX on a TPU) to PyTorch.  A value is one int64
tensor with entries below 2^60 (Hopper has 64-bit integer lanes, so the
TPU's u32 (lo, hi) plane split is gone); a ciphertext is ``(a, b)``, each
``(..., L, N)`` in NTT-domain bit-reversed order, as in `aloha_tpu.he_np`.

Layers (bottom-up): `config` and the NumPy golden model `ntt_np` ->
`rns_torch` modular arithmetic -> `ntt_torch` transforms and tables ->
`ops/` kernel wrappers (CUDA C++ under `csrc/`, each with a plain PyTorch
version beside it) -> `keys` (key generation, encryption), `encoder`
(host-side NumPy) and `he_torch` ciphertext ops -> `parallel/` (over
`torch.distributed`: the coefficient-sharded NTT, the digit-sharded
rotation with one all_reduce, and the coefficient-sharded rotation with
one all-to-all) -> the entry points `entry` (the flagship rotation and
the multi-device dry run) and `scaling` (the rotation's scaling bench and
collective census).  `convert` carries state from the JAX package.  The port keeps its own copies of what it
needs and imports neither JAX nor `aloha_tpu`.
"""

from aloha_tpu_torch.config import DEFAULT_CONFIG, HEConfig  # noqa: F401
