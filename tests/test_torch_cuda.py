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
from aloha_tpu_torch.config import HEConfig
from aloha_tpu_torch.ops import aut, ks_kernel, ntt_mxu, ntt_pallas, ntt_stream
from aloha_tpu_torch.probes import common as probe_common
from aloha_tpu_torch.probes import (dma_bisect, dma_bisect_doublebuf, dma_bisect_stages,
                                    dma_bisect_tblread, op_probe, probe_dynstage, probe_dynsub,
                                    probe_mxu, probe_mxu_parts, stream_prof, stream_prof2,
                                    stream_prof3)

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


def _key(rng, dev, cfg=CFG):
    stride = 2 * cfg.n_limbs
    return cv.from_u64(
        np.stack([rng.integers(0, cfg.moduli[p // stride], size=N, dtype=np.uint64)
                  for p in range(stride * (cfg.n_limbs + 1))]),
        dev,
    )


#: a three-limb ring (+P) at N = 8192 (tests/test_multilimb.py:19-24)
_P3 = [(576460752303439873, 572686754113469876, 509288606595595249),
       (576460752303702017, 518640146586316029, 547209705829931988),
       (576460752304439297, 191393272803421785, 427853369549297084),
       (576460752304619521, 151596679657857464, 439393009888152773)]
CFG3 = HEConfig(moduli=tuple(p[0] for p in _P3), psi=tuple(p[1] for p in _P3),
                ipsi=tuple(p[2] for p in _P3))


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_matches_plain(dev, inverse):
    roots = CFG.ipsi if inverse else CFG.psi
    x = _residues(np.random.default_rng(1), (4,), CFG.moduli, dev)
    before = ntt_stream.transform.launches
    got = ntt_stream.transform(x, CFG.moduli, roots, inverse)
    torch.cuda.synchronize()
    assert ntt_stream.transform.launches == before + 1
    assert torch.equal(got, ntt_stream.transform_plain(x, CFG.moduli, roots, inverse))


def _ring(n: int, M: int, inverse: bool):
    """M moduli of length-n transforms and their roots: q0, q1, P up to N,
    q0, q1, q0 at 2N (2N does not divide P - 1)."""
    qs = (CFG.moduli if n <= N else (CFG.moduli[0], CFG.moduli[1], CFG.moduli[0]))[:M]
    roots = []
    for m, q in enumerate(qs):
        if n <= N:
            psi = pow(CFG.psi[m], N // n, q)
        else:
            psi = next(r for r in (pow(g, (q - 1) // (2 * n), q) for g in range(2, 100))
                       if pow(r, n, q) == q - 1)
        roots.append(pow(psi, -1, q) if inverse else psi)
    return tuple(qs), tuple(roots)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [2, 16, 128, 1024, 2048, 4096, 8192, 16384])
def test_ntt_kernel_at_every_length_batch_and_window_top(dev, n, inverse):
    """csrc/ntt.cu's register passes (csrc/ntt_regs.cuh) at the lengths
    callers use and the template's ends, nb = 1 (one CTA: the ISA's shape),
    131-133 (about one wave of 132 SMs) and 264, M = 1 and 3: words lifted
    to random points of the input window, every third row all at its top
    (4q - 1 forward, 2q - 1 inverse)."""
    top = 2 if inverse else 4
    for M in (1, 3):
        qs, roots = _ring(n, M, inverse)
        for nb in (1, 131, 132, 133, 264):
            rng = np.random.default_rng(n + M + nb)
            a = np.stack([rng.integers(0, q, size=(nb, n), dtype=np.uint64)
                          + np.uint64(q) * rng.integers(0, top, size=(nb, n), dtype=np.uint64)
                          for q in qs])
            for m, q in enumerate(qs):
                a[m, ::3] = top * q - 1
            x = cv.from_u64(a, dev)
            before = ntt_stream.transform.launches
            got = ntt_stream.transform(x, qs, roots, inverse)
            torch.cuda.synchronize()
            assert ntt_stream.transform.launches == before + 1
            assert torch.equal(got, ntt_stream.transform_plain(x, qs, roots, inverse)), (M, nb)


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_on_a_view_8_bytes_off_16(dev, inverse):
    """A contiguous input that starts 8 bytes past a 16-byte boundary: the
    kernel moves each pair of adjacent words as two 8-byte accesses."""
    qs, roots = _ring(N, 1, inverse)
    a = np.random.default_rng(7).integers(0, qs[0], size=3 * N + 1, dtype=np.uint64)
    x = cv.from_u64(a, dev)[1:].view(1, 3, N)
    assert x.data_ptr() % 16 == 8 and x.is_contiguous()
    got = ntt_stream.transform(x, qs, roots, inverse)
    assert torch.equal(got, ntt_stream.transform_plain(x, qs, roots, inverse))


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [2048, 8192])
def test_ntt_kernel_on_each_cluster_size(dev, n, inverse, C):
    """csrc/ntt.cu with each polynomial forced onto a cluster of C CTAs
    (ntt_stream._launch's internal argument) at nb = 1 to 264, M = 1 and
    3, inputs at the top of the window: the plain version's words.  An
    inverse below n = 4096 has no cluster instance: C > 1 raises there."""
    top = 2 if inverse else 4
    for M in (1, 3):
        qs, roots = _ring(n, M, inverse)
        w, ws, q = ntt_torch.tables(n, qs, roots, dev)
        for nb in (1, 2, 16, 33, 64, 131, 132, 264):
            rng = np.random.default_rng(n + M + nb + C)
            a = np.stack([rng.integers(0, qq, size=(nb, n), dtype=np.uint64)
                          + np.uint64(qq) * rng.integers(0, top, size=(nb, n), dtype=np.uint64)
                          for qq in qs])
            for m, qq in enumerate(qs):
                a[m, ::3] = top * qq - 1
            x = cv.from_u64(a, dev)
            if C > ntt_stream.max_cluster(n, inverse):
                with pytest.raises(RuntimeError, match="CUDA error"):
                    ntt_stream._launch(x, w, ws, q, inverse, "ntt", cluster=C)
                continue
            got, launched = ntt_stream._launch(x, w, ws, q, inverse, "ntt", cluster=C)
            torch.cuda.synchronize()
            assert launched
            assert torch.equal(got, ntt_stream.transform_plain(x, qs, roots, inverse)), (M, nb)


def test_ntt_kernel_splits_small_launches_over_clusters(dev):
    """The kernel's own choice: a cluster (C > 1) at the encode shape nb =
    16 and at the ISA's nb = 1, 2 CTAs a polynomial where they fill three
    quarters of the SMs, one CTA a polynomial from one wave up, below n =
    1024 and for an inverse below n = 4096; the grid wrapper at nb = 16
    gives the plain version's words."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for inverse in (False, True):
        assert ntt_stream.cluster_size(dev, 1, 16, N, inverse) > 1
        assert ntt_stream.cluster_size(dev, 1, 1, N, inverse) == 4
        assert ntt_stream.cluster_size(dev, 1, sms // 2, N, inverse) == 2
        assert ntt_stream.cluster_size(dev, 1, sms - 1, N, inverse) == 2
        assert ntt_stream.cluster_size(dev, 1, sms, N, inverse) == 1
        assert ntt_stream.cluster_size(dev, 3, 64, N, inverse) == 1
        assert ntt_stream.cluster_size(dev, 1, 16, 512, inverse) == 1
        assert ntt_stream.cluster_size(dev, 1, 64, 4096, inverse) == 2
    assert ntt_stream.cluster_size(dev, 1, 1, 1024, False) == 2
    assert ntt_stream.cluster_size(dev, 1, 64, 2048, False) == 2
    assert ntt_stream.cluster_size(dev, 1, 1, 1024, True) == 1
    assert ntt_stream.cluster_size(dev, 1, 64, 2048, True) == 1
    q, psi = CFG.moduli[0], CFG.psi[0]
    x = _residues(np.random.default_rng(8), (16,), (q,), dev)[0]
    assert torch.equal(ntt_pallas.ntt(x, q, psi), ntt_pallas.ntt_plain(x, q, psi))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [512, 1024, 2048, 4096, 16384])
def test_ntt_kernel_has_the_cluster_instances_max_cluster_names(dev, n, inverse):
    """`ntt_stream.max_cluster` mirrors the kernel's instances (C <= 4,
    n/16/C >= 32 threads a CTA, an inverse from n = 4096): forced onto it
    the kernel gives the plain version's words; a cluster twice as wide is
    an error, not a launch at another size."""
    qs, roots = _ring(n, 1, inverse)
    w, ws, q = ntt_torch.tables(n, qs, roots, dev)
    rng = np.random.default_rng(n)
    x = cv.from_u64(np.stack([rng.integers(0, qq, size=(2, n), dtype=np.uint64) for qq in qs]),
                    dev)
    most = ntt_stream.max_cluster(n, inverse)
    got, _ = ntt_stream._launch(x, w, ws, q, inverse, "ntt", cluster=most)
    assert torch.equal(got, ntt_stream.transform_plain(x, qs, roots, inverse))
    with pytest.raises(RuntimeError, match="CUDA error"):
        ntt_stream._launch(x, w, ws, q, inverse, "ntt", cluster=2 * most)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [128, 1024, 8192])
def test_grid_wrapper_equals_the_stream_wrapper_on_the_card(dev, n, inverse):
    """`ntt_pallas.transform` and `ntt_stream.transform` at M = 1 both
    launch csrc/ntt.cu, each with its own shapes and tables: the same
    words, and the plain version's, under P at nb = 3, 16 and 64 (a
    cluster below one wave from n = 1024), on an (nb, n) view 8 bytes off
    16, the last row at the top of the window."""
    q = CFG.moduli[2]
    root = pow((CFG.ipsi if inverse else CFG.psi)[2], N // n, q)
    top = 2 if inverse else 4
    for nb in (3, 16, 64):
        rng = np.random.default_rng(60 + n + nb)
        a = rng.integers(0, q, size=(nb * n + 1,), dtype=np.uint64)
        a[-n:] = top * q - 1
        x = cv.from_u64(a, dev)[1:].view(nb, n)
        before = ntt_pallas.transform.launches
        got = ntt_pallas.transform(x, q, root, inverse)
        torch.cuda.synchronize()
        assert ntt_pallas.transform.launches == before + 1
        assert torch.equal(got, ntt_stream.transform(x[None], (q,), (root,), inverse)[0]), nb
        plain = ntt_pallas.intt_plain if inverse else ntt_pallas.ntt_plain
        assert torch.equal(got, plain(x, q, root)), nb


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


def _fold_ends(nb, n, q, seed):
    """(nb, n) int64: polynomial p all zeros, all q - 1, all 2^63 - 1 or
    random words below 2^63, by p mod 4 (the ends of the fold's range)."""
    x = np.random.default_rng(seed).integers(0, (1 << 63) - 1, size=(nb, n), dtype=np.int64)
    x[0::4], x[1::4], x[2::4] = 0, q - 1, (1 << 63) - 1
    return x


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", ntt_mxu.KERNEL_RINGS)
def test_ntt_mxu_shapes_and_fold_ends(dev, n, inverse):
    """transform and chain (k = 1, 2, 3) at every ring the kernel takes, on
    1, 132 P - 1, 132 P, 132 P + 1 and 264 P polynomials (P a CTA: one CTA,
    about one wave of 132 SMs, two waves; the last CTA short of P by one)."""
    (q,), (root,) = _ring(n, 1, inverse)
    P = ntt_mxu.geometry(n)[1]
    for nb in (1, 132 * P - 1, 132 * P, 132 * P + 1, 264 * P):
        x = torch.from_numpy(_fold_ends(nb, n, q, nb)).to(dev)
        before = (ntt_mxu.transform.launches, ntt_mxu.chain.launches)
        got = ntt_mxu.transform(x[None], (q,), (root,), inverse)
        torch.cuda.synchronize()
        assert torch.equal(got, ntt_mxu.transform_plain(x[None], (q,), (root,), inverse)), nb
        for k in (1, 2, 3):
            got = ntt_mxu.chain(x, q, root, k, inverse)
            torch.cuda.synchronize()
            assert torch.equal(got, ntt_mxu.chain_plain(x, q, root, k, inverse)), (nb, k)
        assert (ntt_mxu.transform.launches, ntt_mxu.chain.launches) == (before[0] + 1,
                                                                        before[1] + 3)


def test_ntt_mxu_compiles_to_integer_warpgroup_products(dev):
    """Each instance of the transform (one a ring) holds IGMMA (wgmma on s8)
    in its SASS and no IMMA (mma.sync)."""
    from aloha_tpu_torch import _build

    listing = _build.sass_listing("ntt_mxu_kernel")
    assert len(listing) == len(ntt_mxu.KERNEL_RINGS), sorted(listing)
    for name, code in listing.items():
        words = [w for line in code for w in line.split()]
        assert any(w == "IGMMA" or w.startswith("IGMMA.") for w in words), name
        assert not any(w == "IMMA" or w.startswith("IMMA.") for w in words), name


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
    for n in (128, 1000, 32768):
        with pytest.raises(ValueError, match="ring degree"):
            ntt_mxu.transform(torch.zeros((1, 2, n), dtype=torch.int64, device=dev),
                              (q,), (psi,), False)
        with pytest.raises(ValueError, match="ring degree"):
            ntt_mxu.chain(torch.zeros((2, n), dtype=torch.int64, device=dev), q, psi, 2, False)


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


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", [0, 1, 2])
@pytest.mark.parametrize("n", [128, 1024, 8192])
def test_ntt_grid_kernel_matches_plain(dev, n, m, inverse):
    """The grid kernel under q0, q1 and P at n = 128, 1024 and 8192 with the
    roots psi^(N/n); one row at the top of the input window (< 4q forward,
    < 2q inverse) and a (2, 3, n) batch shape."""
    q = CFG.moduli[m]
    root = pow((CFG.ipsi if inverse else CFG.psi)[m], N // n, q)
    rng = np.random.default_rng(20 + m)
    x = rng.integers(0, q, size=(2, 3, n), dtype=np.uint64)
    x[1, 2] += np.uint64(q) * rng.integers(1, 2 if inverse else 4, size=n, dtype=np.uint64)
    x = cv.from_u64(x, dev)
    before = ntt_pallas.transform.launches
    got = ntt_pallas.transform(x, q, root, inverse)
    torch.cuda.synchronize()
    assert ntt_pallas.transform.launches == before + 1
    plain = ntt_pallas.intt_plain if inverse else ntt_pallas.ntt_plain
    assert torch.equal(got, plain(x, q, root))


def test_he_torch_encode_on_card_matches_cpu(dev):
    """The fixed-point encoder and the per-limb grid transforms on the card
    give the CPU's words, for a batch of three cleartexts."""
    from aloha_tpu_torch import encoder_torch

    c = torch.from_numpy(np.random.default_rng(30).uniform(-1, 1, size=(3, N)))
    assert torch.equal(encoder_torch.encode(c.to(dev), CFG).cpu(), encoder_torch.encode(c, CFG))
    assert torch.equal(ht.encode(c.to(dev), CFG).cpu(), ht.encode(c, CFG))


#: batches that span csrc/ks.cu's cluster rule at N = 8192: ks_tail takes
#: C = 4 at few CTAs (every mode at nb = 1, the single key at nb = 16),
#: C = 1 nearer and above one wave; ks_head always C = 1
KS_NBS = [1, 16, 48, 64]


@pytest.mark.parametrize("nb", KS_NBS)
@pytest.mark.parametrize("step_exp", [None, 1, pow(3, 5, 2 * N), 2 * N - 1])
def test_ks_head_kernel_matches_plain(dev, step_exp, nb):
    b = _residues(np.random.default_rng(2), (nb,), CFG.moduli[:L], dev)
    got = ks_kernel.ks_head(b, step_exp, CFG)
    torch.cuda.synchronize()
    assert torch.equal(got, ks_kernel.ks_head_plain(b, step_exp, CFG))


def _tail_case(mode, nb, dev, cfg=CFG):
    """(nd, rider, key, kshoup, shared) of a ks_tail launch in `mode` with
    nb ciphertexts in (batched keys: two blocks of nb, one per key)."""
    rng = np.random.default_rng(3)
    nl = cfg.n_limbs
    nb_in = 2 * nb if mode == "batched" else nb
    nd = _residues(rng, (nb_in, nl), cfg.moduli, dev)
    rider = _residues(rng, (nb_in,), cfg.moduli[:nl], dev)
    raw = [_key(rng, dev, cfg) for _ in range(2)]
    prep = [ks_kernel.prepare_ksk(k, cfg, aut_exp=pow(3, i + 1, 2 * N))
            for i, k in enumerate(raw)]
    stacked = (torch.stack([p[0] for p in prep]), torch.stack([p[1] for p in prep]))
    key, kshoup, shared = {
        "single-barrett": (raw[0], None, False),
        "single-shoup": (prep[0][0], prep[0][1], False),
        "batched": (*stacked, False),
        "shared": (*stacked, True),
    }[mode]
    return nd, rider, key, kshoup, shared


@pytest.mark.parametrize("nb", KS_NBS)
@pytest.mark.parametrize("mode", ["single-barrett", "single-shoup", "batched", "shared"])
def test_ks_tail_kernel_matches_plain(dev, mode, nb):
    nd, rider, key, kshoup, shared = _tail_case(mode, nb, dev)
    got = ks_kernel.ks_tail(nd, rider, key, CFG, kshoup=kshoup, shared_inputs=shared)
    torch.cuda.synchronize()
    assert torch.equal(got, ks_kernel.ks_tail_plain(nd, rider, key, CFG,
                                                    shared_inputs=shared))


@pytest.mark.parametrize("nb", [1, 16, 48])
@pytest.mark.parametrize("step_exp", [None, pow(3, 5, 2 * N)])
def test_ks_head_kernel_matches_plain_at_three_limbs(dev, step_exp, nb):
    """csrc/ks.cu's head at L = 3: a grid of (nb, L+1, L) CTAs."""
    b = _residues(np.random.default_rng(12), (nb,), CFG3.moduli[:3], dev)
    got = ks_kernel.ks_head(b, step_exp, CFG3)
    torch.cuda.synchronize()
    assert got.shape == (4, nb, 3, N)
    assert torch.equal(got, ks_kernel.ks_head_plain(b, step_exp, CFG3))


@pytest.mark.parametrize("nb", [1, 16, 48])
@pytest.mark.parametrize("mode", ["single-barrett", "single-shoup", "batched", "shared"])
def test_ks_tail_kernel_matches_plain_at_three_limbs(dev, mode, nb):
    """csrc/ks.cu's tail at L = 3 (key stride 2L(L+1) = 24 rows), at the
    cluster it chooses and at each cluster it has an instance for."""
    nd, rider, key, kshoup, shared = _tail_case(mode, nb, dev, CFG3)
    want = ks_kernel.ks_tail_plain(nd, rider, key, CFG3, shared_inputs=shared)
    for c in (0,) + ks_kernel.tail_clusters(N):
        got = ks_kernel.ks_tail(nd, rider, key, CFG3, kshoup=kshoup, shared_inputs=shared,
                                cluster=c)
        torch.cuda.synchronize()
        assert torch.equal(got, want), c


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_at_four_moduli(dev, inverse):
    """csrc/ntt.cu at M = 4 (the L+1 moduli of a three-limb ring: the
    raised digits' launch) on words lifted to its input window, every third
    row at the top."""
    top = 2 if inverse else 4
    qs, roots = CFG3.moduli, CFG3.ipsi if inverse else CFG3.psi
    for nb in (1, 131, 132, 133, 264):
        rng = np.random.default_rng(40 + nb)
        a = np.stack([rng.integers(0, q, size=(nb, N), dtype=np.uint64)
                      + np.uint64(q) * rng.integers(0, top, size=(nb, N), dtype=np.uint64)
                      for q in qs])
        for m, q in enumerate(qs):
            a[m, ::3] = top * q - 1
        x = cv.from_u64(a, dev)
        got = ntt_stream.transform(x, qs, roots, inverse)
        torch.cuda.synchronize()
        assert torch.equal(got, ntt_stream.transform_plain(x, qs, roots, inverse)), nb


@pytest.mark.parametrize("nb", KS_NBS)
def test_ks_kernels_at_one_cta_equal_the_chosen_cluster(dev, nb):
    """Each ks_tail launch forced onto every cluster it has an instance for
    (`tail_clusters`: one CTA a polynomial and 4) gives the words of the
    cluster the kernel chooses; a cluster with no instance (2) raises."""
    for mode in ("single-shoup", "shared", "batched"):
        nd, rider, key, kshoup, shared = _tail_case(mode, nb, dev)

        def run(c):
            return ks_kernel.ks_tail(nd, rider, key, CFG, kshoup=kshoup, shared_inputs=shared,
                                     cluster=c)

        want = run(0)
        for c in ks_kernel.tail_clusters(N):
            assert torch.equal(run(c), want), (mode, c)
        with pytest.raises(RuntimeError, match="ks_tail"):
            run(2)
    torch.cuda.synchronize()


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


def test_multiply_chain_on_card_matches_he_np(dev):
    """ct_mul -> relinearize -> rescale through the key-switch kernels, and
    the per-transform rotation through the grid kernel, word-exact against
    the NumPy oracle."""
    rng = np.random.default_rng(31)
    mk = lambda: rng.integers(0, CFG.moduli[0], (L, N), dtype=np.uint64)  # noqa: E731
    c1 = he_np.Ciphertext(a=mk(), b=mk())
    c2 = he_np.Ciphertext(a=mk(), b=mk())
    sk = keys.gen_secret(CFG, rng=np.random.default_rng(32))
    rlk = keys.gen_relin_key(sk, CFG, rng=np.random.default_rng(33))
    rk = keys.gen_rotation_key(sk, 1, CFG, rng=np.random.default_rng(34))
    d = ht.ct_mul(cv.ct_from_np(c1, dev), cv.ct_from_np(c2, dev), CFG)
    relin = ht.relinearize(*d, cv.ksk_from_np(rlk, CFG, dev), CFG)
    got = ht.rescale(relin, CFG)
    want = he_np.relinearize(*he_np.ct_mul(c1, c2, CFG), rlk, CFG)
    assert np.array_equal(cv.to_u64(relin[0]), want.a)
    assert np.array_equal(cv.to_u64(relin[1]), want.b)
    want_rs = he_np.rescale(he_np.Ciphertext(a=want.a.copy(), b=want.b.copy()), CFG)
    assert np.array_equal(cv.to_u64(got[0]), want_rs.a)
    assert np.array_equal(cv.to_u64(got[1]), want_rs.b)
    before = ntt_pallas.transform.launches
    before_aut = aut.automorphism.launches
    rot = ht.rotate_per_transform(relin, 1, cv.ksk_from_np(rk, CFG, dev), CFG)
    assert ntt_pallas.transform.launches == before + 3 * L + 2
    assert aut.automorphism.launches == before_aut + 2 * L  # no index_select automorphism
    want_rot = he_np.rotate(he_np.Ciphertext(a=want.a.copy(), b=want.b.copy()), 1, rk, CFG)
    assert np.array_equal(cv.to_u64(rot[0]), want_rot.a)
    assert np.array_equal(cv.to_u64(rot[1]), want_rot.b)


@pytest.mark.parametrize("m", [0, 1, 2])
@pytest.mark.parametrize("n", [128, 1024, 8192])
def test_aut_kernel_matches_plain(dev, n, m):
    """The automorphism kernel under q0, q1 and P at n = 128, 1024, 8192 for
    the rotation exponents 3^(2^k) and 2n - 1; one row holds 0 and q (the
    literal q - x turns them into q and 0)."""
    q = CFG.moduli[m]
    x = np.random.default_rng(50 + m).integers(0, q, size=(2, 3, n), dtype=np.uint64)
    x[1, 1, : n // 2] = 0
    x[1, 1, n // 2 :] = np.uint64(q)
    x = cv.from_u64(x, dev)
    for e in [pow(3, 1 << k, 2 * n) for k in range(12)] + [2 * n - 1]:
        before = aut.automorphism.launches
        got = aut.automorphism(x, e, q)
        torch.cuda.synchronize()
        assert aut.automorphism.launches == before + 1
        assert torch.equal(got, aut.automorphism_plain(x, e, q)), e


@pytest.mark.parametrize("n", [128, 1024, 8192])
@pytest.mark.parametrize("nb", [1, 16, 133])
def test_aut_kernel_strided_rows_match_plain(dev, nb, n):
    """The automorphism kernel on rows at stride 2n (each half of (nb, 2, n)
    pairs, as rotate_per_transform hands them in) and on the same rows
    made contiguous, under q0, q1 and P, for the rotation exponents and 2n
    - 1; the last pair holds 0 and q.  One launch a call; the output is
    contiguous."""
    exps = [pow(3, 1 << k, 2 * n) for k in range(12)] + [2 * n - 1]
    for m in range(3):
        q = CFG.moduli[m]
        x = np.random.default_rng(70 + nb + n + m).integers(0, q, size=(nb, 2, n), dtype=np.uint64)
        x[-1, :, ::3] = 0
        x[-1, :, 1::3] = np.uint64(q)
        pairs = cv.from_u64(x, dev)
        assert aut.rows(pairs[:, 0, :])[1] == (2 * n if nb > 1 else n)
        for rows in (pairs[:, 0, :], pairs[:, 1, :], pairs[:, 1, :].contiguous()):
            for e in exps:
                before = aut.automorphism.launches
                got = aut.automorphism(rows, e, q)
                torch.cuda.synchronize()
                assert aut.automorphism.launches == before + 1
                assert got.is_contiguous()
                assert torch.equal(got, aut.automorphism_plain(rows, e, q)), (m, e)


def test_rotate_per_transform_hands_strided_rows_to_aut(dev, monkeypatch):
    """rotate_per_transform's 2L automorphisms take the INTT's (b, a) pairs
    in place (row stride 2N: no copy before the kernel), and its words
    equal the fused rotate's."""
    from aloha_tpu_torch import _build

    real, strides = _build.lib(), []

    class Recorder:
        def __getattr__(self, name):
            return getattr(real, name)

        def aloha_aut(self, *args):
            strides.append(args[7])
            return real.aloha_aut(*args)

    rng = np.random.default_rng(71)
    a, b = (_residues(rng, (3,), CFG.moduli[:L], dev).transpose(0, 1).contiguous()
            for _ in range(2))
    rk = keys.gen_rotation_key(keys.gen_secret(CFG, rng=np.random.default_rng(72)), 1, CFG,
                               rng=np.random.default_rng(73))
    tk = cv.ksk_from_np(rk, CFG, dev)
    fused = ht.rotate((a, b), 1, tk, CFG)
    monkeypatch.setattr(_build, "lib", lambda: Recorder())
    per = ht.rotate_per_transform((a, b), 1, tk, CFG)
    torch.cuda.synchronize()
    assert strides == [2 * N] * (2 * L)
    assert torch.equal(per[0], fused[0]) and torch.equal(per[1], fused[1])


def test_isa_device_on_card_matches_cpu(dev):
    """The ISA key-switch, mul_plain and hom_add through AlohaDevice on the
    card equal the same launches on CPU tensors; the key-switch launches the
    NTT and automorphism kernels."""
    from aloha_tpu_torch.runtime.device import AlohaDevice

    rng = np.random.default_rng(60)
    ct = np.concatenate([rng.integers(0, CFG.moduli[i % L], N, dtype=np.uint64)
                         for i in range(2 * L)])
    pt = np.concatenate([rng.integers(0, CFG.moduli[i], N, dtype=np.uint64) for i in range(L)])
    key = _key(rng, dev)
    outs = []
    for d in (AlohaDevice(CFG, device=dev), AlohaDevice(CFG, device="cpu")):
        d.load_cipher(0, ct)
        d.load_poly(256, pt)
        d.dma_load_ksk(key, row=d.rotation_ksk_ptr(2))
        ntt0, aut0 = ntt_stream.transform.launches, aut.automorphism.launches
        d.run_rotate(dest=512, src=0, step=2)
        d.run_mul_plain(dest=768, src_ct=512, src_pt=256)
        d.run_hom_add(dest=1024, src1=768, src2=0)
        if d.device.type == "cuda":
            torch.cuda.synchronize()
            # vntt: L(L+1) raised digits, L of aut(a), 2L corrections; vintt: 2L + 2
            assert ntt_stream.transform.launches - ntt0 == L * L + 6 * L + 2
            assert aut.automorphism.launches - aut0 == 2 * L
        outs.append([d.store_cipher(r) for r in (512, 768, 1024)])
    for got, want in zip(*outs):
        assert np.array_equal(got, want)


def test_isa_aut_output_at_q_feeds_the_ntt_kernel(dev):
    """vaut on the card turns 0 into q (the literal q - x), and the next
    vntt (csrc/ntt.cu) takes those words: equal to the replay on CPU
    tensors."""
    from aloha_tpu_torch.isa import programs
    from aloha_tpu_torch.isa.interp import LaunchArgs, VectorProcessor
    from aloha_tpu_torch.torch_backend import TorchBackend

    q, pr = CFG.moduli[0], N // 128
    x = np.random.default_rng(61).integers(0, q, size=N, dtype=np.uint64)
    x[::3] = 0
    x[1::3] = np.uint64(q)
    spm = np.zeros((4 * pr, 128), dtype=np.uint64)
    spm[:pr] = x.reshape(pr, 128)
    a = programs.Asm()
    a.vsetvl(N * 64).vsetq(q).vle(0, 0, 0).vaut(2, 0, 0).vntt(4, 2)
    a.vse(2, 2, 0).vse(4, 2, N * 8).vbreak()
    args = LaunchArgs(rslt=pr, step=pow(3, 2, 2 * N))
    outs = []
    for d in (dev, torch.device("cpu")):
        be = TorchBackend(d)
        ntt0, aut0 = ntt_stream.transform.launches, aut.automorphism.launches
        outs.append(be.unwrap(VectorProcessor(CFG, be).run(a.prog, be.wrap(spm), None, args)))
        assert (ntt_stream.transform.launches - ntt0, aut.automorphism.launches - aut0) == (
            (1, 1) if d.type == "cuda" else (0, 0))
    assert np.array_equal(outs[0], outs[1])
    assert (outs[0][pr : 2 * pr] == np.uint64(q)).sum() > N // 4


# ------------------------------------------------------------------ probes
#: the lane kernel's edge sweep: stage counts that take s mod 7 and s mod 13
#: apart (0, one stage, one turn of the 7 distances, two, two turns of the 13 rows)
LANE_EDGE_NSTAGES = (0, 1, 7, 14, 26)
PROBE_CASES = ([("ops", v, None) for v in op_probe.VARIANTS] + [("fwd_reps", None, None)]
               + [("stage_modes", m, None) for m in stream_prof.MODES]
               + [("lane_stages", m, k) for m in stream_prof2.MODES
                  for k in stream_prof2.NSTAGES + LANE_EDGE_NSTAGES])


@pytest.mark.parametrize("kind,mode,nstages", PROBE_CASES)
def test_probe_kernels_match_plain(dev, kind, mode, nstages):
    """Each probe kernel (csrc/probe_ops.cu, csrc/probe_stages.cu) in every
    variant and mode equals its plain version at nb = 8, REPS 1 and 3, and
    at the measured shape (nb = NB_TIME) at the module's lower REPS; the
    lane kernel also at nb = 1, 3 and 133 with 0 and 3 repetitions, at the
    measured stage counts and LANE_EDGE_NSTAGES; the building-block and
    stage-modes kernels also at nb = 1, 3, 133 and 264 (past one wave at
    two CTAs an SM) with 0, 1 and 2 repetitions, the stage modes also on
    the edge words 0, q - 1, 2q and 4q - 1 (`stream_prof.edge_data`)."""
    fn, plain, args, timed_reps = {
        "ops": (op_probe.probe_ops, op_probe.probe_ops_plain, (mode,), op_probe.REPS),
        "fwd_reps": (stream_prof3.fwd_reps, stream_prof3.fwd_reps_plain, (), stream_prof3.REPS),
        "stage_modes": (stream_prof.stage_modes, stream_prof.stage_modes_plain, (mode,),
                        stream_prof.REPS),
        "lane_stages": (stream_prof2.lane_stages, stream_prof2.lane_stages_plain,
                        (mode, nstages), stream_prof2.REPS),
    }[kind]
    data = probe_common.resident_data
    shapes = [(8, 1, data), (8, 3, data), (probe_common.NB_TIME, timed_reps[0], data)]
    if kind == "lane_stages":
        shapes += [(nb, reps, data) for nb in (1, 3, 133) for reps in (0, 3)]
    if kind in ("ops", "fwd_reps", "stage_modes"):
        shapes += [(nb, reps, data) for nb in (1, 3, 133, 264) for reps in (0, 1, 2)]
    if kind in ("fwd_reps", "stage_modes"):
        shapes += [(3, reps, stream_prof.edge_data) for reps in (0, 1, 2)]
    for nb, reps, make in shapes:
        x = make(nb, dev)
        before = fn.launches
        got = fn(x, *args, reps)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(got, plain(x, *args, reps)), (nb, reps)


MXU_PROBE_CASES = ([("rate", None)] + [("parts", v) for v in probe_mxu_parts.VARIANTS]
                   + [("dynstage", None), ("dynsub", None)])


@pytest.mark.parametrize("kind,variant", MXU_PROBE_CASES)
def test_mxu_and_dyn_probe_kernels_match_plain(dev, kind, variant):
    """csrc/probe_mxu.cu (the rate probe, the three parts variants) and
    csrc/probe_dyn.cu equal their plain versions at small shapes, REPS 1
    and 3, and at the measured shape (BP or nb = NB_TIME) at the lower
    REPS; the parts also at EDGE_NBS and 0-3 repetitions on `edge_data`
    (words of 0, q - 1 and 2^63 - 1); the dyn probes also at
    probe_dynstage.EDGE_NBS (1, 131, 132, 133, 264) and 0-3 repetitions,
    and on a block (and a table) of the edge words 0, 1, 2^31, 2^32 - 1;
    each launch counts once."""
    big = probe_common.NB_TIME
    if kind == "rate":
        fn, plain, reps = probe_mxu.digit_products, probe_mxu.digit_products_plain, probe_mxu.REPS
        inputs = lambda nb: probe_mxu.data(nb, dev)  # noqa: E731
        shapes = ((2, 1), (2, 3), (probe_mxu.BP_CHECK, 3))
    elif kind == "parts":
        fn = lambda x, r: probe_mxu_parts.parts(x, variant, r)  # noqa: E731
        plain = lambda x, r: probe_mxu_parts.parts_plain(x, variant, r)  # noqa: E731
        reps = probe_mxu_parts.REPS
        inputs = lambda nb: (probe_mxu_parts.data(nb, dev),)  # noqa: E731
        shapes = ((8, 1), (8, 3))
    elif kind == "dynstage":
        fn, plain = probe_dynstage.dynstage, probe_dynstage.dynstage_plain
        reps = probe_dynstage.REPS
        inputs = lambda nb: (probe_dynstage.data(nb, dev), probe_dynstage.table(dev))  # noqa: E731
        shapes = ((1, 1), (3, 3))
    else:
        fn, plain, reps = probe_dynsub.dynsub, probe_dynsub.dynsub_plain, probe_dynsub.REPS
        inputs = lambda nb: (probe_dynstage.data(nb, dev),)  # noqa: E731
        shapes = ((1, 1), (3, 3))
    counter = probe_mxu_parts.parts if kind == "parts" else fn
    cases = [(inputs, nb, r) for nb, r in shapes + ((big, reps[0]),)]
    if kind == "parts":
        edge = lambda nb: (probe_mxu_parts.edge_data(nb, dev),)  # noqa: E731
        cases += [(edge, nb, r) for nb in probe_mxu_parts.EDGE_NBS for r in range(4)]
    if kind in ("dynstage", "dynsub"):
        seeded = lambda nb: (probe_dynstage.data(nb, dev, seed=nb),  # noqa: E731
                             probe_dynstage.table(dev, seed=nb))
        edge = lambda nb: (probe_dynstage.edge_data(nb, dev),  # noqa: E731
                           probe_dynstage.edge_table(dev))
        take = (lambda f: f) if kind == "dynstage" else (lambda f: lambda nb: f(nb)[:1])
        cases += [(take(seeded), nb, r) for nb in probe_dynstage.EDGE_NBS for r in range(4)]
        cases += [(take(edge), nb, r) for nb in (1, 3) for r in range(4)]
    for make, nb, r in cases:
        args = make(nb)
        before = counter.launches
        got = fn(*args, r)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert torch.equal(got, plain(*args, r)), (nb, r)


def test_dyn_kernels_hold_their_blocks_in_registers(dev):
    """ptxas reports no spill for csrc/probe_dyn.cu's two kernels and their
    SASS holds no local-memory load or store; dynsub_kernel's none of
    shuffles, shared memory or barriers either."""
    from aloha_tpu_torch import _build

    for kernel in probe_dynstage.KERNELS:
        usage = list(_build.ptxas_usage(kernel).values())
        assert len(usage) == 1 and usage[0][1:] == (0, 0), (kernel, usage)
        sass = _build.sass_counts(kernel, probe_dynstage.SASS_OPS)
        assert not (sass["LDL"] or sass["STL"]), (kernel, sass)
        if kernel == "dynsub_kernel":
            assert not any(sass[o] for o in ("SHFL", "LDS", "STS", "BAR")), sass
        else:
            assert sass["SHFL"] and sass["LDS"], sass


@pytest.mark.parametrize("bad", ["device=-1", "device=64", "nb=0", "reps=-1"])
def test_dyn_entries_refuse_bad_arguments(dev, bad):
    """aloha_probe_dynstage and aloha_probe_dynsub, called through the
    library, return cudaErrorInvalidValue (1) for a device outside [0,
    64), nb < 1 or reps < 0, and launch nothing: y keeps its words."""
    from aloha_tpu_torch import _build

    args = {"device": dev.index, "nb": 1, "reps": 1}
    key, value = bad.split("=")
    args[key] = int(value)
    x, w = probe_dynstage.data(1, dev), probe_dynstage.table(dev)
    y = torch.zeros_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.lib()
    assert lib.aloha_probe_dynstage(args["device"], x.data_ptr(), y.data_ptr(), w.data_ptr(),
                                    args["nb"], args["reps"], stream) == 1
    assert lib.aloha_probe_dynsub(args["device"], x.data_ptr(), y.data_ptr(), args["nb"],
                                  args["reps"], stream) == 1
    torch.cuda.synchronize()
    assert not y.any()


def test_probe_mxu_parts_compile_to_integer_warpgroup_products(dev):
    """full and mxu hold IGMMA and no IMMA or HMMA in their SASS; vpu none."""
    from aloha_tpu_torch import _build

    for v in probe_mxu_parts.VARIANTS:
        sass = _build.sass_counts(probe_mxu_parts.kernel_name(v), probe_mxu_parts.SASS_OPS)
        assert bool(sass["IGMMA"]) == (v != "vpu") and not (sass["IMMA"] or sass["HMMA"]), (
            v, sass)


#: (BP, reps) of the wgmma rate kernel: one 64-row tile, a full 128-row tile,
#: a full and a half tile, 133 tiles (more CTAs than SMs, the last half),
#: each at 0, 1 and 3 repetitions; the measured BP at one
RATE_SHAPES = ([(bp, r) for bp in (1, 2, 3, 133) for r in (0, 1, 3)]
               + [(probe_common.NB_TIME, 1)])


@pytest.mark.parametrize("bp,reps", RATE_SHAPES)
def test_rate_kernel_matches_plain_at_every_tile_shape(dev, bp, reps):
    """csrc/probe_mxu.cu's wgmma rate kernel equals its plain version on
    whole and half tiles, at 0, 1 and 3 repetitions; w laid out once by
    `w_image` gives the same words as through `digit_products`."""
    x, w = probe_mxu.data(bp, dev, seed=bp + reps)
    before = probe_mxu.digit_products.launches
    got = probe_mxu.digit_products(x, w, reps)
    again = probe_mxu.launch_rate(x, probe_mxu.w_image(w), reps)
    torch.cuda.synchronize()
    assert probe_mxu.digit_products.launches == before + 2
    assert torch.equal(got, probe_mxu.digit_products_plain(x, w, reps)), (bp, reps)
    assert torch.equal(again, got)


@pytest.mark.parametrize("mode", dma_bisect.MODES)
@pytest.mark.parametrize("nb", [1, 131, 132, 133, 2048])
def test_dma_copy_matches_plain_around_the_grid(dev, nb, mode):
    """csrc/probe_dma.cu's one-slot pipeline equals its plain version at a
    batch of one block, around one block per SM and at the timed batch."""
    x = dma_bisect.blocks(nb, dev, seed=nb)
    before = dma_bisect.dma_copy.launches
    got = dma_bisect.dma_copy(x, mode)
    torch.cuda.synchronize()
    assert dma_bisect.dma_copy.launches == before + 1
    assert torch.equal(got, dma_bisect.dma_copy_plain(x, mode)), (nb, mode)


DMA_PROBE_CASES = ([("copy", m) for m in dma_bisect.MODES] + [("doublebuf", None),
                   ("tblread", None)]
                   + [("stages", k) for k in range(dma_bisect_stages.MAX_STAGES + 1)])


@pytest.mark.parametrize("kind,arg", DMA_PROBE_CASES)
def test_dma_probe_kernels_match_plain(dev, kind, arg):
    """csrc/probe_dma.cu's four pipelines equal their plain versions at nb =
    1, 16, 32 (the scripts' batches) and 133 (more chunks than SMs, not a
    multiple of them), and on a view that starts at block 1; each launch
    counts once.  The stages, at every stage count 0-7, also at nb = 264
    (528 chunks: more than two CTAs an SM hold, not a multiple of them) and
    on the edge words 0, q - 1, 2q, 4q - 1."""
    nbs = (1, 16, 32, 133)
    if kind == "copy":
        fn = lambda x: dma_bisect.dma_copy(x, arg)  # noqa: E731
        plain = lambda x: dma_bisect.dma_copy_plain(x, arg)  # noqa: E731
        counter, data = dma_bisect.dma_copy, dma_bisect.blocks
    elif kind == "doublebuf":
        fn, plain = dma_bisect_doublebuf.doublebuf, dma_bisect_doublebuf.doublebuf_plain
        counter, data = fn, dma_bisect.blocks
    elif kind == "tblread":
        t = dma_bisect_tblread.table(dev)
        fn = lambda x: dma_bisect_tblread.tblread(t, x)  # noqa: E731
        plain = lambda x: dma_bisect_tblread.tblread_plain(t, x)  # noqa: E731
        counter, data = dma_bisect_tblread.tblread, dma_bisect.blocks
    else:
        fn = lambda x: dma_bisect_stages.stages(x, arg)  # noqa: E731
        plain = lambda x: dma_bisect_stages.stages_plain(x, arg)  # noqa: E731
        counter, data = dma_bisect_stages.stages, probe_common.resident_data
        nbs += (264,)
    inputs = [data(nb + 1, dev, seed=nb) for nb in nbs]
    if kind == "stages":
        inputs.append(stream_prof.edge_data(4, dev, seed=arg))
    for x in inputs:
        nb = x.shape[0] - 1
        for xs in (x[:nb], x[1:]):
            before = counter.launches
            got = fn(xs)
            torch.cuda.synchronize()
            assert counter.launches == before + 1
            assert torch.equal(got, plain(xs)), nb


#: (program, word range of the input, whether the transform takes it)
WINDOW_CASES = [("encode_post", (2, 4), True), ("encode_post", (4, None), False),
                ("encode_post", (None, None), False), ("rotate", (0, 2), True),
                ("rotate", (2, 4), False)]


@pytest.mark.parametrize("program,span,ok", WINDOW_CASES)
def test_isa_transform_windows_on_card_match_cpu(dev, program, span, ok):
    """vntt (encode_post) and vintt (the key-switch's first transform) on
    AlohaDevice(device="cuda") raise on exactly the words on which the
    replay on CPU tensors raises (forward from 4q, including words >= 2^63;
    inverse from 2q), and give its words inside the windows.  Ranges in
    multiples of q; (None, None) is [2^63, 2^64)."""
    from aloha_tpu_torch.runtime.device import AlohaDevice

    rng = np.random.default_rng(70)
    ct = np.concatenate([rng.integers(0, CFG.moduli[i % L], N, dtype=np.uint64)
                         for i in range(2 * L)])
    q = CFG.moduli[0]
    lo, hi = span
    words = (rng.integers(1 << 63, 1 << 64, N, dtype=np.uint64) if lo is None else
             rng.integers(lo * q, (hi * q) if hi else 1 << 63, N, dtype=np.uint64))
    ct[(L if program == "rotate" else 0) * N:][:N] = words  # limb 0 of b, or of the plaintext
    key = _key(rng, dev)
    outs = []
    for d in (AlohaDevice(CFG, device=dev, spm_rows=512, ksk_rows=768),
              AlohaDevice(CFG, device="cpu", spm_rows=512, ksk_rows=768)):
        d.load_cipher(0, ct)
        d.dma_load_ksk(key, row=d.rotation_ksk_ptr(2))
        run = ((lambda: d.run_rotate(dest=256, src=0, step=2)) if program == "rotate"
               else (lambda: d.run_encode_post(dest=256, src=0)))
        if ok:
            run()
            outs.append(d.store_cipher(256))
        else:
            with pytest.raises(ValueError, match="window"):
                run()
    if ok:
        assert np.array_equal(outs[0], outs[1])
