"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere.  The file imports
no JAX (only the NumPy layer of aloha_tpu), so it also runs on a machine
without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Exact integer arithmetic: every comparison is word-exact (torch.equal).
"""

import numpy as np
import pytest
import torch

from aloha_tpu import he_np, keys
from aloha_tpu.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch.ops import ks_kernel, ntt_mxu, ntt_stream

pytestmark = pytest.mark.cuda

L, N = CFG.n_limbs, CFG.n


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda", 0)


def _residues(rng, lead, moduli, dev):
    return cv.from_u64(
        np.stack([rng.integers(0, q, size=lead + (N,), dtype=np.uint64) for q in moduli]),
        dev,
    )


def _key(rng, dev):
    stride = 2 * L
    return cv.from_u64(
        np.stack([rng.integers(0, CFG.moduli[p // stride], size=N, dtype=np.uint64)
                  for p in range(stride * (L + 1))]),
        dev,
    )


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_matches_plain(dev, inverse):
    roots = CFG.ipsi if inverse else CFG.psi
    x = _residues(np.random.default_rng(1), (4,), CFG.moduli, dev)
    before = ntt_stream.transform.launches
    got = ntt_stream.transform(x, CFG.moduli, roots, inverse)
    torch.cuda.synchronize()
    assert ntt_stream.transform.launches == before + 1
    assert torch.equal(got, ntt_stream.transform_plain(x, CFG.moduli, roots, inverse))


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_mxu_kernel_matches_plain(dev, inverse):
    """q0, q1 and P in one launch (M=3) at N=8192; one polynomial of each
    group holds words >= q, up to 2^63 - 1."""
    roots = CFG.ipsi if inverse else CFG.psi
    rng = np.random.default_rng(7)
    x = _residues(rng, (4,), CFG.moduli, dev)
    x[:, 3] = torch.from_numpy(rng.integers(0, (1 << 63) - 1, size=(3, N), dtype=np.int64)).to(dev)
    before = ntt_mxu.transform.launches
    got = ntt_mxu.transform(x, CFG.moduli, roots, inverse)
    torch.cuda.synchronize()
    assert ntt_mxu.transform.launches == before + 1
    assert torch.equal(got, ntt_mxu.transform_plain(x, CFG.moduli, roots, inverse))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", [0, 2])
def test_ntt_mxu_chain_matches_plain(dev, m, inverse):
    root = (CFG.ipsi if inverse else CFG.psi)[m]
    x = _residues(np.random.default_rng(8 + m), (4,), CFG.moduli[m:m + 1], dev)[0]
    before = ntt_mxu.chain.launches
    got = ntt_mxu.chain(x, CFG.moduli[m], root, 3, inverse)
    torch.cuda.synchronize()
    assert ntt_mxu.chain.launches == before + 1
    assert torch.equal(got, ntt_mxu.chain_plain(x, CFG.moduli[m], root, 3, inverse))


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_mxu_kernel_at_n4096(dev, inverse):
    q = CFG.moduli[1]
    root = pow((CFG.ipsi if inverse else CFG.psi)[1], 2, q)
    x = cv.from_u64(np.random.default_rng(9).integers(0, q, size=(1, 4, 4096), dtype=np.uint64),
                    dev)
    got = ntt_mxu.transform(x, (q,), (root,), inverse)
    torch.cuda.synchronize()
    assert torch.equal(got, ntt_mxu.transform_plain(x, (q,), (root,), inverse))


def test_ntt_mxu_rejects_bad_operands(dev):
    q, psi = CFG.moduli[0], CFG.psi[0]
    x = torch.zeros((1, 2, N), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        ntt_mxu.transform(x.to(torch.int32), (q,), (psi,), False)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_mxu.transform(torch.zeros((1, N, 2), dtype=torch.int64, device=dev).transpose(1, 2),
                          (q,), (psi,), False)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_mxu.chain(torch.zeros((N, 2), dtype=torch.int64, device=dev).t(), q, psi, 2, False)
    with pytest.raises(ValueError, match="ring degree"):
        ntt_mxu.transform(torch.zeros((1, 2, 2048), dtype=torch.int64, device=dev),
                          (q,), (psi,), False)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_ntt_with_tables_kernel_matches_plain(dev, D, inverse):
    """The NTT kernel fed each shard's tables (every d) at N=8192 under q0;
    one row holds words at the top of the input window (< 4q forward,
    < 2q inverse)."""
    q = CFG.moduli[0]
    root = (CFG.ipsi if inverse else CFG.psi)[0]
    rng = np.random.default_rng(10 + D)
    x = rng.integers(0, q, size=(4, N // D), dtype=np.uint64)
    x[3] += np.uint64(q) * rng.integers(1, 2 if inverse else 4, size=N // D, dtype=np.uint64)
    x = cv.from_u64(x, dev)
    for d in range(D):
        w, ws, _ = ntt_torch.shard_tables(N, q, root, D, d, inverse, dev)
        before = ntt_stream.transform_with_tables.launches
        got = ntt_stream.transform_with_tables(x, w, ws, q, inverse)
        torch.cuda.synchronize()
        assert ntt_stream.transform_with_tables.launches == before + 1
        assert torch.equal(got, ntt_stream.transform_with_tables_plain(x, w, ws, q, inverse))


@pytest.mark.parametrize("step_exp", [None, pow(3, 5, 2 * N), 2 * N - 1])
def test_ks_head_kernel_matches_plain(dev, step_exp):
    b = _residues(np.random.default_rng(2), (4,), CFG.moduli[:L], dev)
    got = ks_kernel.ks_head(b, step_exp, CFG)
    torch.cuda.synchronize()
    assert torch.equal(got, ks_kernel.ks_head_plain(b, step_exp, CFG))


@pytest.mark.parametrize("mode", ["single-barrett", "single-shoup", "batched", "shared"])
def test_ks_tail_kernel_matches_plain(dev, mode):
    rng = np.random.default_rng(3)
    nd = _residues(rng, (4, L), CFG.moduli, dev)
    rider = _residues(rng, (4,), CFG.moduli[:L], dev)
    raw = [_key(rng, dev) for _ in range(2)]
    prep = [ks_kernel.prepare_ksk(k, CFG, aut_exp=pow(3, i + 1, 2 * N))
            for i, k in enumerate(raw)]
    stacked = (torch.stack([p[0] for p in prep]), torch.stack([p[1] for p in prep]))
    key, kshoup, shared = {
        "single-barrett": (raw[0], None, False),
        "single-shoup": (prep[0][0], prep[0][1], False),
        "batched": (*stacked, False),
        "shared": (*stacked, True),
    }[mode]
    got = ks_kernel.ks_tail(nd, rider, key, CFG, kshoup=kshoup, shared_inputs=shared)
    torch.cuda.synchronize()
    assert torch.equal(got, ks_kernel.ks_tail_plain(nd, rider, key, CFG,
                                                    shared_inputs=shared))


def test_serving_chain_on_card_matches_he_np(dev):
    """rotate and matvec_bsgs (D=4, g=2) + rescale through the kernels,
    word-exact against the NumPy oracle."""
    rng = np.random.default_rng(4)
    ct = he_np.Ciphertext(a=rng.integers(0, CFG.moduli[0], (L, N), dtype=np.uint64),
                          b=rng.integers(0, CFG.moduli[0], (L, N), dtype=np.uint64))
    sk = keys.gen_secret(CFG, rng=np.random.default_rng(5))
    ksks = {s: keys.gen_rotation_key(sk, s, CFG, rng=np.random.default_rng(6 + s))
            for s in (1, 2)}
    tk = {s: cv.ksk_from_np(k, CFG, dev) for s, k in ksks.items()}
    got = ht.rotate(cv.ct_from_np(ct, dev), 2, tk[2], CFG)
    want = he_np.rotate(he_np.Ciphertext(a=ct.a.copy(), b=ct.b.copy()), 2, ksks[2], CFG)
    assert np.array_equal(cv.to_u64(got[0]), want.a)
    assert np.array_equal(cv.to_u64(got[1]), want.b)
    diags = [rng.integers(0, CFG.moduli[0], (L, N), dtype=np.uint64) for _ in range(4)]
    got = ht.rescale(ht.matvec_bsgs(cv.ct_from_np(ct, dev),
                                    [cv.from_u64(d, dev) for d in diags],
                                    [tk[1]], [tk[2]], CFG, g=2), CFG)
    want = he_np.rescale(he_np.matvec_bsgs(
        he_np.Ciphertext(a=ct.a.copy(), b=ct.b.copy()), diags, [ksks[1]], [ksks[2]],
        CFG, g=2), CFG)
    assert np.array_equal(cv.to_u64(got[0]), want.a)
    assert np.array_equal(cv.to_u64(got[1]), want.b)
