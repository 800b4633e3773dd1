"""The port's 4-step NTT (`aloha_tpu_torch.ops.ntt_mxu`) against the JAX package.

Inputs are seeded NumPy arrays fed to both packages; every comparison is
word-exact (integer arithmetic, tolerance 0):
- the digit tables equal `aloha_tpu.ops.ntt_mxu._fwd_tables_np` /
  `_inv_tables_np` (planes converted back to u64);
- `transform_plain` and `chain_plain` equal `ntt_np` and the JAX MXU kernel
  run in Pallas interpret mode, as tests/test_ntt_mxu_interpret.py runs it;
- the fragment order of the kernel's tables is the m16n8k32 s8 register
  layout of the PTX ISA;
- inputs >= q, bad moduli and bad ring degrees;
- the bench refuses to run without CUDA, and names no form that is not
  bit-exact.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from aloha_tpu import ntt_np
from aloha_tpu.config import DEFAULT_CONFIG
from aloha_tpu.ops import ntt_mxu as jax_mxu
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch.ops import ntt_mxu

pytest.importorskip("jax.experimental.pallas")

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
C1K = __graft_entry__._small_cfg(1024)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ALOHA_STREAM_INTERPRET", "1")
    monkeypatch.setenv("ALOHA_STREAM_BP", "2")


def _u64(lo, hi):
    return np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << np.uint64(32))


def _residues(rng, q, shape):
    a = rng.integers(0, q, size=shape, dtype=np.uint64)
    a.reshape(-1, shape[-1])[0, :3] = (0, q - 1, 1)
    return a


def _planes(a):
    nb, n = a.shape
    return (jnp.asarray((a & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(nb, -1, 128)),
            jnp.asarray((a >> np.uint64(32)).astype(np.uint32).reshape(nb, -1, 128)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("limb", [0, 2])
def test_tables_equal_jax(limb, inverse):
    q, psi = C1K.moduli[limb], C1K.psi[limb]
    got = ntt_mxu.tables_np(1024, q, psi, inverse)
    build = jax_mxu._inv_tables_np if inverse else jax_mxu._fwd_tables_np
    row, lane, dp, ca, cb = build(1024, q, psi)
    crow, ccol = (cb, ca) if inverse else (ca, cb)
    assert np.array_equal(got.row, row) and got.row.dtype == np.int8
    assert np.array_equal(got.lane, lane) and got.lane.dtype == np.int8
    assert np.array_equal(got.tw, _u64(dp[0], dp[1]))
    shoup = sum(dp[2 + i].astype(np.uint64) << np.uint64(16 * i) for i in range(4))
    assert np.array_equal(got.tws, shoup)
    assert np.array_equal(got.crow, _u64(*crow)[:, 0])
    assert np.array_equal(got.ccol, _u64(*ccol)[0, :])


@pytest.mark.parametrize("n", [1024, 8192])
def test_plain_matches_ntt_np(n):
    """All three moduli in one call (M=3) at n=1024; q0 at n=8192."""
    cfg = C1K if n == 1024 else DEFAULT_CONFIG
    limbs = range(3) if n == 1024 else range(1)
    qs = tuple(cfg.moduli[m] for m in limbs)
    rng = np.random.default_rng(n)
    a = np.stack([_residues(rng, q, (2, n)) for q in qs])
    x = cv.from_u64(a, CPU)
    fwd = cv.to_u64(ntt_mxu.transform_plain(x, qs, [cfg.psi[m] for m in limbs], False))
    inv = cv.to_u64(ntt_mxu.transform_plain(x, qs, [cfg.ipsi[m] for m in limbs], True))
    for i, m in enumerate(limbs):
        assert np.array_equal(fwd[i], ntt_np.ntt(a[i], qs[i], cfg.psi[m]))
        assert np.array_equal(inv[i], ntt_np.intt(a[i], qs[i], cfg.ipsi[m]))


def test_plain_matches_jax_interpret(interpret):
    q, psi, ipsi = C1K.moduli[0], C1K.psi[0], C1K.ipsi[0]
    a = _residues(np.random.default_rng(3), q, (2, 1024))
    x = cv.from_u64(a[None], CPU)
    fwd = cv.to_u64(ntt_mxu.transform_plain(x, (q,), (psi,), False)[0])
    assert np.array_equal(fwd, np.asarray(jax_mxu.ntt(jnp.asarray(a), q, psi)))
    inv = cv.to_u64(ntt_mxu.transform_plain(x, (q,), (ipsi,), True)[0])
    assert np.array_equal(inv, np.asarray(jax_mxu.intt(jnp.asarray(a), q, ipsi)))


@pytest.mark.parametrize("inverse", [False, True])
def test_chain_plain_matches_jax_chain_and_ntt_np(interpret, inverse):
    """k=3: the root of an inverse chain is psi^-1, as in ntt_chain_planes."""
    q, k = C1K.moduli[0], 3
    root = C1K.ipsi[0] if inverse else C1K.psi[0]
    a = _residues(np.random.default_rng(7), q, (2, 1024))
    want = a
    for _ in range(k):
        want = (ntt_np.intt if inverse else ntt_np.ntt)(want, q, root)
    got = cv.to_u64(ntt_mxu.chain_plain(cv.from_u64(a, CPU), q, root, k, inverse))
    assert np.array_equal(got, want)
    lo, hi = jax_mxu.ntt_chain_planes(*_planes(a), q, root, k, inverse=inverse)
    assert np.array_equal(_u64(lo, hi).reshape(2, 1024), want)


@pytest.mark.parametrize("limb", [0, 2])
def test_inputs_at_or_above_q_give_the_same_words(limb):
    """Any int64 >= 0 is taken mod q: the digit split reads all 64 bits."""
    q, psi = C1K.moduli[limb], C1K.psi[limb]
    rng = np.random.default_rng(11 + limb)
    big = rng.integers(0, (1 << 63) - 1, size=(2, 1024), dtype=np.int64).astype(np.uint64)
    big[0, :4] = (q, 2 * q - 1, (1 << 63) - 1, 16 * q + 5)
    want = ntt_np.ntt(big % np.uint64(q), q, psi)
    got = ntt_mxu.transform_plain(cv.from_u64(big[None], CPU), (q,), (psi,), False)
    assert np.array_equal(cv.to_u64(got[0]), want)
    chained = ntt_mxu.chain_plain(cv.from_u64(big, CPU), q, psi, 2, False)
    assert np.array_equal(cv.to_u64(chained), ntt_np.ntt(want, q, psi))


@pytest.mark.parametrize("n, q, match", [
    (1024, (1 << 59) - 1, "outside"),
    (1024, 1 << 60 | 1, "outside"),
    (1024, (1 << 60) - 1, "fold margin"),
    (128, DEFAULT_CONFIG.moduli[0], "ring degree"),
    (1000, DEFAULT_CONFIG.moduli[0], "ring degree"),
])
def test_bad_moduli_and_rings_raise(n, q, match):
    with pytest.raises(ValueError, match=match):
        ntt_mxu.check_modulus(n, q)
    with pytest.raises(ValueError, match=match):
        ntt_mxu.transform(torch.zeros((1, 1, n), dtype=torch.int64), (q,), (3,), False)
    with pytest.raises(ValueError, match=match):
        ntt_mxu.chain(torch.zeros((1, n), dtype=torch.int64), q, 3, 2, False)


def test_cpu_tensors_take_the_plain_version():
    q, psi = C1K.moduli[1], C1K.psi[1]
    x = cv.from_u64(_residues(np.random.default_rng(5), q, (1, 2, 1024)), CPU)
    before = (ntt_mxu.transform.launches, ntt_mxu.chain.launches)
    assert torch.equal(ntt_mxu.transform(x, (q,), (psi,), False),
                       ntt_mxu.transform_plain(x, (q,), (psi,), False))
    assert torch.equal(ntt_mxu.chain(x[0], q, psi, 2, False),
                       ntt_mxu.chain_plain(x[0], q, psi, 2, False))
    assert (ntt_mxu.transform.launches, ntt_mxu.chain.launches) == before
    with pytest.raises(ValueError, match="chain length"):
        ntt_mxu.chain(x[0], q, psi, 0, False)
    with pytest.raises(ValueError, match="groups"):
        ntt_mxu.transform(x, (q, q), (psi, psi), False)


def _ptx_a(frag):
    """Rebuild (8, R, K) from A fragments by the PTX ISA's m16n8k32 .s8 table:
    element i of lane (g, t) is byte i % 4 of register i // 4, at row
    g + 8 ((i // 4) % 2) and column 4 t + (i % 4) + 16 (i >= 8)."""
    nd, mtiles, ksteps = frag.shape[:3]
    out = np.zeros((nd, 16 * mtiles, 32 * ksteps), dtype=np.int8)
    regs = frag.reshape(nd, mtiles, ksteps, 32, 16)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(16):
            row = g + 8 * ((i // 4) % 2)
            col = 4 * t + (i % 4) + (16 if i >= 8 else 0)
            for mt in range(mtiles):
                out[:, 16 * mt + row, col::32] = regs[:, mt, :, lane, i]
    return out


def _ptx_b(frag):
    """Rebuild (8, K, 128) from B fragments: element i of lane (g, t) is
    byte i % 4 of register i // 4, at row 4 t + (i % 4) + 16 (i >= 4),
    column g."""
    nd, ntiles, ksteps = frag.shape[:3]
    out = np.zeros((nd, 32 * ksteps, 8 * ntiles), dtype=np.int8)
    regs = frag.reshape(nd, ntiles, ksteps, 32, 8)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(8):
            row = 4 * t + (i % 4) + (16 if i >= 4 else 0)
            for nt in range(ntiles):
                out[:, row::32, 8 * nt + g] = regs[:, nt, :, lane, i]
    return out


def test_fragment_order_is_the_mma_register_layout():
    tb = ntt_mxu.tables_np(DEFAULT_CONFIG.n, DEFAULT_CONFIG.moduli[0], DEFAULT_CONFIG.psi[0],
                           False)
    assert np.array_equal(_ptx_a(ntt_mxu.frag_rows(tb.row)), tb.row)
    assert np.array_equal(_ptx_b(ntt_mxu.frag_lanes(tb.lane)), tb.lane)


def test_bench_without_cuda_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", "aloha_tpu_torch.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    for line in res.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        assert "metric" not in rec


def test_bench_best_takes_only_bit_exact_forms():
    from aloha_tpu_torch import bench

    recs = [{"metric": "a", "value": 3.0, "bitexact": False},
            {"metric": "b", "value": 2.0, "bitexact": True},
            {"metric": "c", "value": 1.0, "bitexact": True}]
    assert bench.best(recs)["metric"] == "b"
    assert bench.best([dict(r, bitexact=False) for r in recs]) is None
