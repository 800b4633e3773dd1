"""he_torch, the serving slice as a whole, against the JAX package at N=8192.

The ops are held word-exact against he_planes (its XLA path, as
tests/test_he_planes.py runs it on the CPU) and against the NumPy oracle
he_np.  The hoisted and batched rotations and matvec_bsgs are held against
he_np.rotate_hoisted / he_np.matvec_bsgs, to which the TPU kernel path is
word-exact (he_planes' non-kernel fallback rotates step by step and is
not: he_planes.py:446-449).  A decrypt check closes the loop.
"""

import numpy as np
import pytest
import torch

from aloha_tpu import encoder, he_np, he_planes, keys
from aloha_tpu.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import he_torch as ht

torch.set_num_threads(2)

CPU = torch.device("cpu")
L, N = CFG.n_limbs, CFG.n


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    cts = [he_np.Ciphertext(
        a=rng.integers(0, CFG.moduli[0], size=(L, N), dtype=np.uint64),
        b=rng.integers(0, CFG.moduli[0], size=(L, N), dtype=np.uint64),
    ) for _ in range(2)]
    pt = rng.integers(0, CFG.moduli[0], size=(L, N), dtype=np.uint64)
    sk = keys.gen_secret(CFG, rng=np.random.default_rng(1))
    ksks = {s: keys.gen_rotation_key(sk, s, CFG, rng=np.random.default_rng(10 + s))
            for s in (1, 2, 3)}
    return cts, pt, sk, ksks


def _np_ct(ct):
    return he_np.Ciphertext(a=ct.a.copy(), b=ct.b.copy())


def _planes_ct(ct):
    return he_planes.from_u64(ct.a), he_planes.from_u64(ct.b)


def _assert_ct(got, want):
    """got: (a, b) tensors; want: he_np.Ciphertext or planes pair."""
    if isinstance(want, he_np.Ciphertext):
        wa, wb = want.a, want.b
    else:
        wa, wb = (np.asarray(he_planes.to_u64(p)) for p in want)
    assert np.array_equal(cv.to_u64(got[0]), wa)
    assert np.array_equal(cv.to_u64(got[1]), wb)


@pytest.mark.parametrize("op", ["hom_add", "hom_sub"])
def test_ct_ct_ops(data, op):
    (c1, c2), *_ = data
    got = getattr(ht, op)(cv.ct_from_np(c1, CPU), cv.ct_from_np(c2, CPU), CFG)
    _assert_ct(got, getattr(he_np, op)(_np_ct(c1), _np_ct(c2), CFG))
    _assert_ct(got, getattr(he_planes, op)(_planes_ct(c1), _planes_ct(c2), CFG))


@pytest.mark.parametrize("op", ["add_plain", "mul_plain"])
def test_ct_pt_ops(data, op):
    (c1, _), pt, *_ = data
    got = getattr(ht, op)(cv.ct_from_np(c1, CPU), cv.from_u64(pt, CPU), CFG)
    _assert_ct(got, getattr(he_np, op)(_np_ct(c1), pt, CFG))
    _assert_ct(got, getattr(he_planes, op)(_planes_ct(c1), he_planes.from_u64(pt), CFG))


def test_encode_post(data):
    _, pt, *_ = data
    got = cv.to_u64(ht.encode_post(cv.from_u64(pt, CPU), CFG))
    assert np.array_equal(got, he_np.encode_post(pt, CFG))
    want = he_planes.to_u64(he_planes.encode_post(he_planes.from_u64(pt), CFG))
    assert np.array_equal(got, np.asarray(want))


def test_rotate(data):
    (c1, _), _, _, ksks = data
    got = ht.rotate(cv.ct_from_np(c1, CPU), 2, cv.ksk_from_np(ksks[2], CFG, CPU), CFG)
    _assert_ct(got, he_np.rotate(_np_ct(c1), 2, ksks[2], CFG))
    _assert_ct(got, he_planes.rotate(_planes_ct(c1), 2, he_planes.from_u64(ksks[2]), CFG))


def test_rotate_batch_axis_is_per_ciphertext(data):
    cts, _, _, ksks = data
    batch = (cv.from_u64(np.stack([c.a for c in cts]), CPU),
             cv.from_u64(np.stack([c.b for c in cts]), CPU))
    got = ht.rotate(batch, 1, cv.ksk_from_np(ksks[1], CFG, CPU), CFG)
    for i, c in enumerate(cts):
        _assert_ct((got[0][i], got[1][i]), he_np.rotate(_np_ct(c), 1, ksks[1], CFG))


def test_conjugate_and_galois(data):
    (c1, _), _, sk, _ = data
    cjk = keys.gen_conjugation_key(sk, CFG, rng=np.random.default_rng(5))
    got = ht.conjugate(cv.ct_from_np(c1, CPU), cv.ksk_from_np(cjk, CFG, CPU), CFG)
    _assert_ct(got, he_np.conjugate(_np_ct(c1), cjk, CFG))
    gk = keys.gen_galois_key(sk, 5, CFG, rng=np.random.default_rng(6))
    got = ht.galois(cv.ct_from_np(c1, CPU), 5, cv.ksk_from_np(gk, CFG, CPU), CFG)
    _assert_ct(got, he_np.galois(_np_ct(c1), 5, gk, CFG))


def test_rescale(data):
    (c1, _), *_ = data
    got = ht.rescale(cv.ct_from_np(c1, CPU), CFG)
    assert got[0].shape == (L - 1, N)
    _assert_ct(got, he_np.rescale(_np_ct(c1), CFG))
    _assert_ct(got, he_planes.rescale(_planes_ct(c1), CFG))


def test_rotate_hoisted(data):
    (c1, _), _, _, ksks = data
    steps = [1, 2, 3]
    got = ht.rotate_hoisted(cv.ct_from_np(c1, CPU), steps,
                            [cv.ksk_from_np(ksks[s], CFG, CPU) for s in steps], CFG)
    want = he_np.rotate_hoisted(_np_ct(c1), steps, [ksks[s] for s in steps], CFG)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_ct(g, w)


def test_rotate_batch(data):
    cts, _, _, ksks = data
    steps = [3, 1]
    got = ht.rotate_batch([cv.ct_from_np(c, CPU) for c in cts], steps,
                          [cv.ksk_from_np(ksks[s], CFG, CPU) for s in steps], CFG)
    for g, c, s in zip(got, cts, steps):
        _assert_ct(g, he_np.rotate_hoisted(_np_ct(c), [s], [ksks[s]], CFG)[0])


def test_pt_rotate(data):
    _, pt, *_ = data
    got = cv.to_u64(ht.pt_rotate(cv.from_u64(pt, CPU), -3, CFG))
    assert np.array_equal(got, he_np.pt_rotate(pt, -3, CFG))


def test_matvec_bsgs_batch_matches_oracle(data):
    """D=4 diagonals, g=2, over a batch of two ciphertexts: each output is
    word-exact against he_np.matvec_bsgs."""
    cts, _, _, ksks = data
    rng = np.random.default_rng(8)
    diags = [rng.integers(0, CFG.moduli[0], size=(L, N), dtype=np.uint64)
             for _ in range(4)]
    batch = (cv.from_u64(np.stack([c.a for c in cts]), CPU),
             cv.from_u64(np.stack([c.b for c in cts]), CPU))
    got = ht.matvec_bsgs(batch, [cv.from_u64(d, CPU) for d in diags],
                         [cv.ksk_from_np(ksks[1], CFG, CPU)],
                         [cv.ksk_from_np(ksks[2], CFG, CPU)], CFG, g=2)
    for i, c in enumerate(cts):
        want = he_np.matvec_bsgs(_np_ct(c), diags, [ksks[1]], [ksks[2]], CFG, g=2)
        _assert_ct((got[0][i], got[1][i]), want)


def test_encrypted_matvec_decrypts_within_envelope(data):
    """encode -> encrypt -> matvec_bsgs -> rescale -> decrypt -> decode
    (examples/encrypted_matvec.py on the port): max error < 0.15."""
    _, _, sk, ksks = data
    rng = np.random.default_rng(7)
    S = N // 2
    z = rng.uniform(-1, 1, size=S) + 1j * rng.uniform(-1, 1, size=S)
    pt = encoder.encode(encoder.cleartext_from_slots(z), CFG)
    q0 = CFG.moduli[0]
    signed = np.where(pt[0] > q0 // 2, pt[0].astype(np.int64) - np.int64(q0),
                      pt[0].astype(np.int64))
    ct = keys.encrypt(signed, sk, CFG, rng=np.random.default_rng(9))
    dvecs = [rng.uniform(-1, 1, size=S) for _ in range(4)]
    coeff = np.stack([encoder.encode(encoder.cleartext_from_slots(d + 0j), CFG)
                      for d in dvecs])
    diags = ht.encode_post(cv.from_u64(coeff, CPU), CFG)
    out = ht.rescale(ht.matvec_bsgs(
        cv.ct_from_np(ct, CPU), list(diags), [cv.ksk_from_np(ksks[1], CFG, CPU)],
        [cv.ksk_from_np(ksks[2], CFG, CPU)], CFG, g=2), CFG)
    m = keys.decrypt(he_np.Ciphertext(*cv.ct_to_np(out)), sk, CFG)
    res = np.where(m < 0, m + np.int64(q0), m).astype(np.uint64)
    got = encoder.decode(res[None, :], CFG, limb=0) * (CFG.moduli[1] / encoder.DELTA)
    want = sum(d * np.roll(z, -k) for k, d in enumerate(dvecs))
    assert np.abs(got - want).max() < 0.15


# --------------------------------------- the per-transform surface of he_jax
@pytest.fixture(scope="module")
def batch2(data):
    """The two ciphertexts as one B = 2 batch, with zeros in ciphertext 0's
    a-part, which the automorphism turns into the literal q."""
    cts, *_ = data
    a = np.stack([c.a for c in cts])
    b = np.stack([c.b for c in cts])
    a[0, 0, :5] = 0
    return a, b


def test_rotate_per_transform_equals_he_np_and_the_fused_rotate(data, batch2):
    _, _, _, ksks = data
    a, b = batch2
    ct = (cv.from_u64(a, CPU), cv.from_u64(b, CPU))
    got = ht.rotate_per_transform(ct, 1, cv.ksk_from_np(ksks[1], CFG, CPU), CFG)
    fused = ht.rotate(ct, 1, cv.ksk_from_np(ksks[1], CFG, CPU), CFG)
    assert torch.equal(got[0], fused[0]) and torch.equal(got[1], fused[1])
    for i in range(2):
        want = he_np.rotate(he_np.Ciphertext(a=a[i].copy(), b=b[i].copy()), 1, ksks[1], CFG)
        _assert_ct((got[0][i], got[1][i]), want)


def test_rotate_per_transform_equals_he_jax_rotate(data, batch2):
    """he_jax.rotate itself (on the CPU its transforms take the XLA route)."""
    from aloha_tpu import he_jax

    _, _, _, ksks = data
    a, b = batch2
    got = ht.rotate_per_transform((cv.from_u64(a, CPU), cv.from_u64(b, CPU)), 3,
                                  cv.ksk_from_np(ksks[3], CFG, CPU), CFG)
    wa, wb = he_jax.rotate((a, b), 3, ksks[3], CFG)
    assert np.array_equal(cv.to_u64(got[0]), np.asarray(wa))
    assert np.array_equal(cv.to_u64(got[1]), np.asarray(wb))


def test_ct_mul_relinearize_rescale_equal_he_jax_and_he_np(data):
    """The leveled multiply against he_jax's u64 wrappers (the he_planes
    path) and he_np, as tests/test_he_jax.py holds them."""
    from aloha_tpu import he_jax

    (c1, c2), _, sk, _ = data
    rlk = keys.gen_relin_key(sk, CFG, rng=np.random.default_rng(9))
    d = ht.ct_mul(cv.ct_from_np(c1, CPU), cv.ct_from_np(c2, CPU), CFG)
    jd = he_jax.ct_mul((c1.a, c1.b), (c2.a, c2.b), CFG)
    w = he_np.ct_mul(_np_ct(c1), _np_ct(c2), CFG)
    for got, jwant, want in zip(d, jd, w):
        assert np.array_equal(cv.to_u64(got), np.asarray(jwant))
        assert np.array_equal(cv.to_u64(got), want)
    out = ht.relinearize(*d, cv.ksk_from_np(rlk, CFG, CPU), CFG)
    _assert_ct(out, he_np.relinearize(*w, rlk, CFG))
    ja, jb = he_jax.relinearize(*jd, rlk, CFG)
    assert np.array_equal(cv.to_u64(out[0]), np.asarray(ja))
    assert np.array_equal(cv.to_u64(out[1]), np.asarray(jb))
    rs = ht.rescale(out, CFG)
    assert rs[0].shape == (L - 1, N)
    ra, rb = he_jax.rescale((ja, jb), CFG)
    assert np.array_equal(cv.to_u64(rs[0]), np.asarray(ra))
    assert np.array_equal(cv.to_u64(rs[1]), np.asarray(rb))


def test_relinearize_head_without_automorphism_gives_the_same_words(data):
    """The key-switch head with e = 1 (the identity) and the hoisted head
    (no automorphism) raise the same digits for relinearize."""
    from aloha_tpu_torch.ops import ks_kernel

    (c1, _), *_ = data
    b = cv.from_u64(c1.b, CPU)[:, None]  # (L, nb, N), the head's layout
    assert torch.equal(ks_kernel.ks_head_plain(b, 1, CFG), ks_kernel.ks_head_plain(b, None, CFG))
