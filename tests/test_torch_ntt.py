"""ntt_torch and ops.ntt_stream against the JAX package.

The plain transforms are held word-exact against ntt_jax (the XLA path)
and ntt_np (the NumPy oracle) at n=1024 and n=8192; the batched
multi-modulus wrapper against the TPU kernel ntt_stream.ntt_planes_multi /
intt_planes_multi run through the Pallas interpreter, as
tests/test_ntt_stream_interpret.py runs it.  The CUDA kernel itself is
held against its plain version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import __graft_entry__
from aloha_tpu import ntt_jax, ntt_np
from aloha_tpu.config import DEFAULT_CONFIG, shoup
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch.ops import ntt_stream

torch.set_num_threads(2)

CPU = torch.device("cpu")
CFGS = {1024: __graft_entry__._small_cfg(1024), 8192: DEFAULT_CONFIG}


@pytest.mark.parametrize("n", [1024, 8192])
@pytest.mark.parametrize("limb", [0, 1, 2])
def test_ntt_intt_match_ntt_jax_and_ntt_np(n, limb):
    cfg = CFGS[n]
    q, psi, ipsi = cfg.moduli[limb], cfg.psi[limb], cfg.ipsi[limb]
    rng = np.random.default_rng(n + limb)
    a = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    a[0, :3] = (0, q - 1, 1)
    fwd = cv.to_u64(ntt_torch.ntt(cv.from_u64(a, CPU), q, psi))
    assert np.array_equal(fwd, ntt_np.ntt(a, q, psi))
    assert np.array_equal(fwd, np.asarray(ntt_jax.ntt(a, q, psi)))
    inv = cv.to_u64(ntt_torch.intt(cv.from_u64(a, CPU), q, ipsi))
    assert np.array_equal(inv, ntt_np.intt(a, q, ipsi))
    assert np.array_equal(inv, np.asarray(ntt_jax.intt(a, q, ipsi)))
    back = cv.to_u64(ntt_torch.intt(cv.from_u64(fwd, CPU), q, ipsi))
    assert np.array_equal(back, a)


def test_forward_accepts_the_harvey_window():
    """Forward inputs below 4q (e.g. the automorphism's literal q) give
    the transform of their residues."""
    cfg = CFGS[1024]
    q, psi = cfg.moduli[0], cfg.psi[0]
    rng = np.random.default_rng(3)
    a = rng.integers(0, q, size=(1024,), dtype=np.uint64)
    lazy = a + np.uint64(q) * rng.integers(0, 4, size=a.shape, dtype=np.uint64)
    lazy[lazy >= 4 * q] -= np.uint64(q)
    got = cv.to_u64(ntt_torch.ntt(cv.from_u64(lazy, CPU), q, psi))
    assert np.array_equal(got, ntt_np.ntt(a, q, psi))


@pytest.mark.parametrize("step", [3, 5, 2 * 1024 - 1])
def test_automorphism_matches_ntt_np_and_ntt_jax(step):
    cfg = CFGS[1024]
    q = cfg.moduli[1]
    rng = np.random.default_rng(step)
    a = rng.integers(0, q, size=(2, 1024), dtype=np.uint64)
    a[:, :4] = 0  # zeros exercise the literal q - 0 = q
    got = cv.to_u64(ntt_torch.automorphism(cv.from_u64(a, CPU), step, q))
    assert np.array_equal(got, ntt_np.automorphism(a, step, q))
    assert np.array_equal(got, np.asarray(ntt_jax.automorphism(a, step, q)))


def test_ntt_domain_aut_is_the_coefficient_round_trip():
    cfg = CFGS[1024]
    q, psi, ipsi = cfg.moduli[0], cfg.psi[0], cfg.ipsi[0]
    e = pow(3, 7, 2 * 1024)
    a = np.random.default_rng(9).integers(0, q, size=(1024,), dtype=np.uint64)
    want = ntt_np.ntt(ntt_np.automorphism(ntt_np.intt(a, q, ipsi), e, q), q, psi)
    got = cv.to_u64(ntt_torch.ntt_domain_aut(cv.from_u64(a, CPU), e))
    assert np.array_equal(got, want)


def test_tables_hold_twiddles_and_shoup_companions():
    cfg = CFGS[1024]
    w, ws, q = ntt_torch.tables(1024, cfg.moduli, cfg.psi, CPU)
    assert w.shape == ws.shape == (3, 1024) and q.tolist() == list(cfg.moduli)
    for m, (qm, psi) in enumerate(zip(cfg.moduli, cfg.psi)):
        want = ntt_np.psi_powers_bitrev(1024, psi, qm)
        assert np.array_equal(cv.to_u64(w[m]), want)
        assert [int(v) for v in cv.to_u64(ws[m][:64])] == [
            shoup(int(v), qm) for v in want[:64]
        ]


@pytest.mark.parametrize("inverse", [False, True])
def test_transform_on_cpu_is_the_plain_version(inverse):
    cfg = CFGS[1024]
    roots = cfg.ipsi if inverse else cfg.psi
    rng = np.random.default_rng(11)
    x = cv.from_u64(
        np.stack([rng.integers(0, q, size=(3, 1024), dtype=np.uint64) for q in cfg.moduli]),
        CPU,
    )
    got = ntt_stream.transform(x, cfg.moduli, roots, inverse)
    assert torch.equal(got, ntt_stream.transform_plain(x, cfg.moduli, roots, inverse))
    fn = ntt_np.intt if inverse else ntt_np.ntt
    for m, (q, r) in enumerate(zip(cfg.moduli, roots)):
        assert np.array_equal(cv.to_u64(got[m]), fn(cv.to_u64(x[m]), q, r))


def test_transform_plain_matches_tpu_stream_kernel_interpreted(monkeypatch):
    """ntt_planes_multi / intt_planes_multi (the TPU kernels this module
    replaces) through the Pallas interpreter at n=1024, M=3, nb=2."""
    pytest.importorskip("jax.experimental.pallas")
    from aloha_tpu.ops import ntt_stream as tpu_stream

    monkeypatch.setenv("ALOHA_STREAM_INTERPRET", "1")
    monkeypatch.setenv("ALOHA_STREAM_BP", "2")
    cfg = CFGS[1024]
    qs = cfg.moduli
    rng = np.random.default_rng(5)
    a = np.stack([rng.integers(0, q, size=(2, 1024), dtype=np.uint64) for q in qs])
    lo, hi = cv.to_planes(cv.from_u64(a, CPU))
    olo, ohi = tpu_stream.ntt_planes_multi(
        lo.reshape(3, 2, 8, 128), hi.reshape(3, 2, 8, 128), qs, cfg.psi
    )
    fwd = ntt_stream.transform(cv.from_u64(a, CPU), qs, cfg.psi, False)
    assert torch.equal(fwd, cv.from_planes(olo, ohi, CPU).reshape(3, 2, 1024))
    blo, bhi = tpu_stream.intt_planes_multi(olo, ohi, qs, cfg.ipsi)
    inv = ntt_stream.transform(fwd, qs, cfg.ipsi, True)
    assert torch.equal(inv, cv.from_planes(blo, bhi, CPU).reshape(3, 2, 1024))
    assert np.array_equal(cv.to_u64(inv), a)
