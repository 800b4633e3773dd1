"""rns_torch against the JAX u64 path (rns_xla) and the NumPy oracle (rns_np).

Exact integer arithmetic: every comparison is word-exact.  Inputs are made
with numpy from a seed and include the edge values 0, 1, q-1, q, 2q-1 and
2^60-1.
"""

import numpy as np
import pytest
import torch

from aloha_tpu import rns_jax, rns_np, rns_xla
from aloha_tpu.config import DEFAULT_CONFIG as CFG
from aloha_tpu.config import shoup
from aloha_tpu_torch import rns_torch as rt

torch.set_num_threads(2)

MODULI = CFG.moduli


def _operands(q: int, seed: int):
    """Random values in [0, 2q) plus every pair of edge values."""
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, q - 1, q, 2 * q - 1, (1 << 60) - 1], dtype=np.uint64)
    a = np.concatenate([rng.integers(0, 2 * q, 4096, dtype=np.uint64),
                        np.repeat(edges, edges.size)])
    b = np.concatenate([rng.integers(0, 2 * q, 4096, dtype=np.uint64),
                        np.tile(edges, edges.size)])
    return a, b


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


def _u(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("q", MODULI)
@pytest.mark.parametrize("name", ["mulmod", "barrett", "addmod", "submod"])
def test_binary_ops_match_xla_and_numpy(name, q):
    a, b = _operands(q, 1)
    if name == "barrett":  # the bare chain takes inputs below q
        a, b = rns_np.lazy_reduce(a, q), rns_np.lazy_reduce(b, q)
        want = rns_np._barrett(a, b, q, CFG.mod_width)
    else:
        want = getattr(rns_np, name)(a, b, q)
    got = _u(getattr(rt, name)(_t(a), _t(b), q))
    xla = np.asarray(getattr(rns_xla, name)(a, b, q))
    assert np.array_equal(got, want)
    assert np.array_equal(got, xla)


@pytest.mark.parametrize("q", MODULI)
@pytest.mark.parametrize("name", ["lazy_reduce", "halfmod", "modred"])
def test_unary_ops_match_xla_and_numpy(name, q):
    a, _ = _operands(q, 2)
    if name == "halfmod":  # halving takes canonical inputs
        a = rns_np.lazy_reduce(rns_np.lazy_reduce(a, q), q)
    got = _u(getattr(rt, name)(_t(a), q))
    assert np.array_equal(got, getattr(rns_np, name)(a, q))
    assert np.array_equal(got, np.asarray(getattr(rns_xla, name)(a, q)))


@pytest.mark.parametrize("q", MODULI)
def test_mulmod_is_exact(q):
    a, b = _operands(q, 3)
    got = _u(rt.mulmod(_t(a), _t(b), q))
    exact = [(int(x) % q) * (int(y) % q) % q if x < 2 * q and y < 2 * q else None
             for x, y in zip(a, b)]
    for g, e in zip(got, exact):
        if e is not None:
            assert int(g) == e


@pytest.mark.parametrize("q", MODULI)
def test_mulmod_shoup_constant_matches_rns_jax(q):
    rng = np.random.default_rng(4)
    w = int(rng.integers(0, q))
    x = np.concatenate([rng.integers(0, 4 * q, 4096, dtype=np.uint64),
                        np.array([0, q - 1, q, 2 * q - 1, 4 * q - 1], dtype=np.uint64)])
    got = _u(rt.mulmod_shoup(_t(x), w, shoup(w, q), q))
    lo, hi = rns_jax.mulmod_shoup64(
        (x & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (x >> np.uint64(32)).astype(np.uint32), w, shoup(w, q), q,
    )
    jax_words = np.asarray(lo).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint64) << np.uint64(32)
    )
    assert np.array_equal(got, jax_words)
    assert got.max() < 2 * q
    assert all(int(g) % q == int(v) * w % q for g, v in zip(got, x))


@pytest.mark.parametrize("q", MODULI)
def test_mulmod_shoup_per_element_companions(q):
    """Tensor w with its u64 Shoup companions (the prepared-key form,
    companions above 2^63 held as negative int64 bit patterns)."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 4 * q, 2048, dtype=np.uint64)
    w = rng.integers(0, q, 2048, dtype=np.uint64)
    w[:2] = (0, q - 1)
    ws = np.array([shoup(int(v), q) for v in w], dtype=np.uint64)
    got = _u(rt.mulmod_shoup(_t(x), _t(w), _t(ws), q))
    assert got.max() < 2 * q
    assert all(int(g) % q == int(a) * int(b) % q for g, a, b in zip(got, x, w))
