"""The coefficient-domain automorphism (`ops/aut`, `csrc/aut.cu`) on the CPU.

- a NumPy model of exactly the kernel's index arithmetic (einv = e^-1 mod
  2n, t = d einv mod 2n, src = t mod n, sign = t >= n) against the scatter
  maps of `ntt_torch._aut_maps` and the JAX package's `ntt_np.automorphism`:
  every odd e at n = 128 and 1024, the 12 rotation exponents 3^(2^k) and
  2N - 1 at n = 8192;
- the wrapper on CPU tensors (its plain version) against `ntt_np` and
  `ntt_jax`, with rows of 0 and q (the literal q - x: 0 -> q, q -> 0);
- even exponents and lengths outside 128-8192 raise;
- `he_torch.automorphism` is the wrapper.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
Exact integer arithmetic: every comparison is word-exact.
"""

import jax
import numpy as np
import pytest
import torch

from aloha_tpu import ntt_jax, ntt_np
from aloha_tpu.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch.ops import aut

torch.set_num_threads(2)

CPU = torch.device("cpu")
N = CFG.n


def kernel_model(x: np.ndarray, e: int, q: int) -> np.ndarray:
    """csrc/aut.cu's gather on uint64 words: y[d] = t >= n ? q - x[t mod n]
    : x[t mod n] with t = d * einv mod 2n (u64 wrap-around in q - x)."""
    n = x.shape[-1]
    einv = pow(e, -1, 2 * n)
    t = (np.arange(n, dtype=np.int64) * einv) & (2 * n - 1)
    v = x[..., t & (n - 1)]
    with np.errstate(over="ignore"):
        return np.where(t >= n, np.uint64(q) - v, v)


def rotation_exponents(n: int):
    return [pow(3, 1 << k, 2 * n) for k in range(12)] + [2 * n - 1]


@pytest.mark.parametrize("n", [128, 1024])
def test_kernel_index_map_every_odd_exponent(n):
    """The gather form gives _aut_maps' (src, sign) for every odd e."""
    q = CFG.moduli[0]
    x = np.random.default_rng(n).integers(0, q, size=n, dtype=np.uint64)
    for e in range(1, 2 * n, 2):
        einv = pow(e, -1, 2 * n)
        t = (np.arange(n) * einv) % (2 * n)
        src, neg = _aut_maps(n, e)
        assert np.array_equal(t % n, src) and np.array_equal(t >= n, neg), e
        assert np.array_equal(kernel_model(x, e, q), ntt_np.automorphism(x, e, q)), e


def _aut_maps(n, e):
    src, neg = ntt_torch._aut_maps(n, e, CPU)
    return src.numpy(), neg.numpy()


@pytest.mark.parametrize("e", rotation_exponents(N))
def test_kernel_index_map_rotation_exponents_n8192(e):
    q = CFG.moduli[1]
    x = np.random.default_rng(e).integers(0, q, size=(2, N), dtype=np.uint64)
    x[1, ::7] = 0
    x[1, 1::7] = np.uint64(q)
    src, neg = _aut_maps(N, e)
    einv = pow(e, -1, 2 * N)
    t = (np.arange(N) * einv) % (2 * N)
    assert np.array_equal(t % N, src) and np.array_equal(t >= N, neg)
    assert np.array_equal(kernel_model(x, e, q), ntt_np.automorphism(x, e, q))


@pytest.mark.parametrize("m", [0, 1, 2])
def test_wrapper_on_cpu_matches_ntt_np_and_ntt_jax(m):
    """nb = 3 rows under q0, q1 and P; row 1 holds 0 and q (the sign rule's
    literal q - x turns 0 into q and q into 0)."""
    q = CFG.moduli[m]
    e = pow(3, 5, 2 * N)
    x = np.random.default_rng(40 + m).integers(0, q, size=(3, N), dtype=np.uint64)
    x[1, : N // 2] = 0
    x[1, N // 2 :] = np.uint64(q)
    before = aut.automorphism.launches
    got = cv.to_u64(aut.automorphism(cv.from_u64(x, CPU), e, q))
    assert aut.automorphism.launches == before  # the CPU takes the plain version
    assert np.array_equal(got, ntt_np.automorphism(x, e, q))
    assert np.array_equal(got, np.asarray(jax.jit(ntt_jax.automorphism, static_argnums=2)(x, e, q)))
    assert np.array_equal(got, kernel_model(x, e, q))


def test_even_exponent_and_bad_length_raise():
    x = torch.zeros((2, N), dtype=torch.int64)
    with pytest.raises(ValueError, match="even"):
        aut.automorphism(x, 4, CFG.moduli[0])
    with pytest.raises(ValueError, match="even"):
        aut.automorphism(x, 2 * N + 2, CFG.moduli[0])  # taken mod 2N
    for n in (64, 16384, 1000):
        with pytest.raises(ValueError, match="power of two"):
            aut.automorphism(torch.zeros((1, n), dtype=torch.int64), 3, CFG.moduli[0])
    with pytest.raises(ValueError, match="no kernel"):
        aut.automorphism(x.to("meta"), 3, CFG.moduli[0])


def test_he_torch_automorphism_is_the_wrapper():
    q = CFG.moduli[0]
    x = cv.from_u64(np.random.default_rng(5).integers(0, q, size=(2, 2, N), dtype=np.uint64), CPU)
    e = 2 * N - 1
    assert torch.equal(ht.automorphism(x, e, q), aut.automorphism_plain(x, e, q))
    with pytest.raises(ValueError, match="even"):
        ht.automorphism(x, 2, q)
