"""ops.ks_kernel against the TPU key-switch kernels, word for word.

The plain `ks_head` (with and without the automorphism) and `ks_tail` (one
key with Shoup or Barrett products, batched keys, shared inputs) are held
against the JAX `ks_head`/`ks_tail` run through the Pallas interpreter at
n=1024 (the scaled roots of __graft_entry__._small_cfg), with
ALOHA_KS_NTT=stream so the JAX head's output is canonical.  prepare_ksk's
words are held against the JAX prepare_ksk.  The CUDA kernels are held
against their plain versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import __graft_entry__
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch.ops import ks_kernel

torch.set_num_threads(2)

CPU = torch.device("cpu")
CFG = __graft_entry__._small_cfg(1024)
L, N = CFG.n_limbs, CFG.n
ROWS = N // 128


@pytest.fixture
def interpret(monkeypatch):
    pytest.importorskip("jax.experimental.pallas")
    monkeypatch.setenv("ALOHA_STREAM_INTERPRET", "1")
    monkeypatch.setenv("ALOHA_KS_NTT", "stream")
    from aloha_tpu.ops import ks_kernel as tpu_ks

    return tpu_ks


def _residues(rng, lead, moduli, cfg=CFG):
    """(len(moduli),) + lead + (n,) canonical residues, modulus per row."""
    return np.stack([rng.integers(0, q, size=lead + (cfg.n,), dtype=np.uint64)
                     for q in moduli])


def _key(rng, cfg=CFG):
    """A random key in the KSK layout: row p under modulus p // 2L."""
    stride = 2 * cfg.n_limbs
    return np.stack([rng.integers(0, cfg.moduli[p // stride], size=cfg.n, dtype=np.uint64)
                     for p in range(stride * (cfg.n_limbs + 1))])


def _planes(a):
    """uint64 (..., n) -> JAX (lo, hi) planes (..., rows, 128)."""
    import jax.numpy as jnp

    lo, hi = cv.to_planes(cv.from_u64(a, CPU))
    shape = a.shape[:-1] + (ROWS, 128)
    return jnp.asarray(lo.reshape(shape)), jnp.asarray(hi.reshape(shape))


def _words(lo, hi):
    lo, hi = np.asarray(lo), np.asarray(hi)
    return cv.to_u64(cv.from_planes(lo, hi, CPU)).reshape(lo.shape[:-2] + (N,))


def test_ks_head_matches_tpu_kernel_interpreted(interpret):
    from aloha_tpu import ntt_np

    rng = np.random.default_rng(1)
    coeff = _residues(rng, (2,), CFG.moduli[:L])
    coeff[:, :, :64] = 0  # zero digits become the literal q_j under the automorphism
    b = np.stack([ntt_np.ntt(coeff[j], CFG.moduli[j], CFG.psi[j]) for j in range(L)])
    for step_exp in (pow(3, 2, 2 * N), None):
        want = _words(*interpret.ks_head(*_planes(b), step_exp, CFG))
        got = ks_kernel.ks_head(cv.from_u64(b, CPU), step_exp, CFG)
        assert got.shape == (L + 1, 2, L, N)
        assert np.array_equal(cv.to_u64(got), want), step_exp


def test_ks_tail_modes_match_tpu_kernel_interpreted(interpret):
    """Single key (Shoup and Barrett products), batched keys (K=2, one
    ciphertext each) and shared inputs (K=2 keys over one ciphertext)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    nd = _residues(rng, (2, L), CFG.moduli)  # (L+1, nb=2, L, n)
    rider = _residues(rng, (2,), CFG.moduli[:L])
    keys = [_key(rng) for _ in range(2)]
    prepared = [interpret.prepare_ksk(_planes(k), CFG) for k in keys]
    ours = [cv.prepared_from_planes(p, CFG, CPU) for p in prepared]

    def tail(nd_, rider_, kk, shoup, **kw):
        klo = jnp.stack([p[0] for p in kk]) if len(kk) > 1 else kk[0][0]
        khi = jnp.stack([p[1] for p in kk]) if len(kk) > 1 else kk[0][1]
        ks = None
        if shoup:
            ks = tuple(jnp.stack([p[2 + i] for p in kk]) if len(kk) > 1 else kk[0][2 + i]
                       for i in range(4))
        return _words(*interpret.ks_tail(*_planes(nd_), *_planes(rider_), klo, khi, CFG,
                                         kshoup=ks, **kw))

    t_nd, t_rider = cv.from_u64(nd, CPU), cv.from_u64(rider, CPU)
    # single key, prepared (Shoup) and raw (Barrett)
    got = ks_kernel.ks_tail(t_nd, t_rider, ours[0][0], CFG, kshoup=ours[0][1])
    assert np.array_equal(cv.to_u64(got), tail(nd, rider, prepared[:1], True))
    got = ks_kernel.ks_tail(t_nd, t_rider, cv.from_u64(keys[0], CPU), CFG)
    assert np.array_equal(cv.to_u64(got), tail(nd, rider, [_planes(keys[0])], False))
    # batched keys: ciphertext c under key c
    k2 = torch.stack([o[0] for o in ours])
    s2 = torch.stack([o[1] for o in ours])
    got = ks_kernel.ks_tail(t_nd, t_rider, k2, CFG, kshoup=s2)
    assert np.array_equal(cv.to_u64(got), tail(nd, rider, prepared, True))
    # shared inputs: both keys over ciphertext 0, key-major output
    got = ks_kernel.ks_tail(t_nd[:, :1], t_rider[:, :1], k2, CFG, kshoup=s2,
                            shared_inputs=True)
    assert got.shape == (L, 2, 2, N)
    want = tail(nd[:, :1], rider[:, :1], prepared, True, shared_inputs=True)
    assert np.array_equal(cv.to_u64(got), want)


@pytest.mark.parametrize("aut_exp", [None, pow(3, 3, 2 * N), 2 * N - 1])
def test_prepare_ksk_matches_tpu_prepare(aut_exp):
    from aloha_tpu.ops import ks_kernel as tpu_ks

    k = _key(np.random.default_rng(3))
    want = cv.prepared_from_planes(tpu_ks.prepare_ksk(_planes(k), CFG, aut_exp=aut_exp),
                                   CFG, CPU)
    got = ks_kernel.prepare_ksk(cv.from_u64(k, CPU), CFG, aut_exp=aut_exp)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_prepare_ksk_caches_by_key_identity_and_version():
    key = cv.from_u64(_key(np.random.default_rng(4)), CPU)
    first = ks_kernel.prepare_ksk(key, CFG)
    assert ks_kernel.prepare_ksk(key, CFG) is first
    key[0, 0] = 0  # an in-place edit is a new key
    assert ks_kernel.prepare_ksk(key, CFG) is not first


def test_batched_tail_rejects_uneven_key_blocks():
    rng = np.random.default_rng(5)
    nd = cv.from_u64(_residues(rng, (3, L), CFG.moduli), CPU)
    rider = cv.from_u64(_residues(rng, (3,), CFG.moduli[:L]), CPU)
    keys = torch.stack([cv.from_u64(_key(rng), CPU)] * 2)
    with pytest.raises(ValueError, match="key blocks"):
        ks_kernel.ks_tail(nd, rider, keys, CFG)
