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
PROBE_CASES = ([("ops", v, None) for v in op_probe.VARIANTS] + [("fwd_reps", None, None)]
               + [("stage_modes", m, None) for m in stream_prof.MODES]
               + [("lane_stages", m, k) for m in stream_prof2.MODES for k in stream_prof2.NSTAGES])


@pytest.mark.parametrize("kind,mode,nstages", PROBE_CASES)
def test_probe_kernels_match_plain(dev, kind, mode, nstages):
    """Each probe kernel (csrc/probe_ops.cu, csrc/probe_stages.cu) in every
    variant and mode equals its plain version at nb = 8, REPS 1 and 3, and
    at the measured shape (nb = NB_TIME) at the module's lower REPS."""
    fn, plain, args, timed_reps = {
        "ops": (op_probe.probe_ops, op_probe.probe_ops_plain, (mode,), op_probe.REPS),
        "fwd_reps": (stream_prof3.fwd_reps, stream_prof3.fwd_reps_plain, (), stream_prof3.REPS),
        "stage_modes": (stream_prof.stage_modes, stream_prof.stage_modes_plain, (mode,),
                        stream_prof.REPS),
        "lane_stages": (stream_prof2.lane_stages, stream_prof2.lane_stages_plain,
                        (mode, nstages), stream_prof2.REPS),
    }[kind]
    for nb, reps in ((8, 1), (8, 3), (probe_common.NB_TIME, timed_reps[0])):
        x = probe_common.resident_data(nb, dev)
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
    REPS; each launch counts once."""
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
    for nb, r in shapes + ((big, reps[0]),):
        args = inputs(nb)
        before = counter.launches
        got = fn(*args, r)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert torch.equal(got, plain(*args, r)), (nb, r)


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
                   ("tblread", None)] + [("stages", k) for k in (0, 1, 4, 7)])


@pytest.mark.parametrize("kind,arg", DMA_PROBE_CASES)
def test_dma_probe_kernels_match_plain(dev, kind, arg):
    """csrc/probe_dma.cu's four pipelines equal their plain versions at nb =
    1, 16, 32 (the scripts' batches) and 133 (more chunks than SMs, not a
    multiple of them), and on a view that starts at block 1; each launch
    counts once."""
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
    for nb in (1, 16, 32, 133):
        x = data(nb + 1, dev, seed=nb)
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
