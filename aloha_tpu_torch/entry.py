"""Entry points of the port: the flagship step and the multi-device dry run.

The port of `__graft_entry__.py`.  `entry` returns the flagship step, one
slot rotation at N = 8192 by step 2 (`he_torch.rotate`: the fused
ks_head/ks_tail pair, csrc/ks.cu), with its example inputs on the card.
`dryrun_multichip` runs the dry run's smoke tier and production workloads
(`parallel.dryrun`) on local ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch.parallel import dryrun

STEP = 2  # the flagship rotation's step (__graft_entry__.py:45)
DRYRUN_TIMEOUT_S = 600  # each spawned workload's ranks


def entry(device=None):
    """(fn, (a, b, ksk)): fn(a, b, ksk) rotates the ciphertext (a, b) by
    step 2 with `he_torch.rotate`.  The inputs are drawn as
    __graft_entry__.py:39-42 draws them (default_rng(0): a and b (2, N),
    the key (12, N), words below q0) and are int64 tensors on `device`:
    the card unless the caller passes another (the CPU runs the kernels'
    plain versions)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device (pass device='cpu' for the plain path)")
    n, q0 = CFG.n, CFG.moduli[0]
    rng = np.random.default_rng(0)
    a = rng.integers(0, q0, size=(2, n), dtype=np.uint64)
    b = rng.integers(0, q0, size=(2, n), dtype=np.uint64)
    ksk = rng.integers(0, q0, size=(12, n), dtype=np.uint64)

    def fn(ct_a, ct_b, key):
        return ht.rotate((ct_a, ct_b), STEP, key, CFG)

    return fn, tuple(cv.from_u64(x, device) for x in (a, b, ksk))


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The port of __graft_entry__.dryrun_multichip over local ranks: the
    smoke tier (the coefficient-sharded rotation on a dp x coeff mesh of
    the largest power of two <= n_devices ranks, dp = 2 where it divides),
    then the production workloads at N = 8192 (the sharded NTT on the same
    mesh, the digit-sharded rotation on a (max(1, R/L), L) mesh) and the
    hoisted and BSGS workloads at n = 1024 (dp = R).  Ranks share the
    cards over gloo where they outnumber them; `device` "cpu" runs gloo CPU
    ranks.  Raises when a rank fails."""
    R = 1 << (n_devices.bit_length() - 1)
    dp = 2 if R % 2 == 0 and R > 1 else 1
    L = CFG.n_limbs
    dp2 = max(1, R // L)
    base = ["--device", device]
    for ranks, argv in (
            (R, ["--workload", "smoke", "--dp", str(dp)]),
            (R, ["--workload", "ntt", "--dp", str(dp), "--batch", str(2 * dp)]),
            (dp2 * L, ["--workload", "keyswitch", "--dp", str(dp2), "--batch", str(dp2)]),
            (R, ["--workload", "hoisted", "--workload", "bsgs", "--n", "1024",
                 "--batch", str(R)])):
        dryrun.spawn(ranks, base + argv, DRYRUN_TIMEOUT_S)
