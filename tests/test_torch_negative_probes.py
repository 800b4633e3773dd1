"""Negative probes and serving-chain checks of the port, on the CPU.

The port's counterparts of tests/test_negative_probes.py:29-83: exact
integer math, so a wrong key or a corrupted key word must give wholesale
or precisely localised word mismatches through `he_torch`'s fused
key-switch pair (`ks_head`/`ks_tail`) and its hoisted form, never a near
miss a tolerance could absorb.  And three serving-chain checks with no
other torch test: `matvec_bsgs` with D not divisible by g
(tests/test_matvec.py:69), `pt_rotate`'s decode semantics (:82) and
`galois_hoisted` for the conjugate (tests/test_hoisted.py:284), each
word-exact against `he_np` and decrypting within its envelope.  Keys and
encryptions are made by `aloha_tpu.keys` and carried across by `convert`.
"""

import numpy as np
import pytest
import torch

from aloha_tpu import encoder, he_np, keys
from aloha_tpu.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch import keys as torch_keys
from aloha_tpu_torch import ntt_torch

torch.set_num_threads(2)

CPU = torch.device("cpu")
L, N = CFG.n_limbs, CFG.n
S = N // 2
q0 = CFG.moduli[0]


def _t(x):
    return cv.from_u64(x, CPU)


def _u64(ct):
    return tuple(cv.to_u64(x) for x in ct)


@pytest.fixture(scope="module")
def material():
    """tests/test_negative_probes.py's: random words and two rotation keys."""
    rng = np.random.default_rng(77)
    a = rng.integers(0, q0, size=(L, N), dtype=np.uint64)
    b = rng.integers(0, q0, size=(L, N), dtype=np.uint64)
    sk = keys.gen_secret(CFG, np.random.default_rng(78))
    ksk2 = keys.gen_rotation_key(sk, 2, CFG, np.random.default_rng(79))
    ksk4 = keys.gen_rotation_key(sk, 4, CFG, np.random.default_rng(80))
    return (_t(a), _t(b)), ksk2, ksk4


def test_wrong_step_key_mismatches_wholesale(material):
    ct, ksk2, ksk4 = material
    good = ht.rotate(ct, 2, _t(ksk2), CFG)
    want = he_np.rotate(he_np.Ciphertext(*_u64(ct)), 2, ksk2, CFG)
    assert np.array_equal(cv.to_u64(good[0]), want.a) and np.array_equal(cv.to_u64(good[1]), want.b)
    bad = ht.rotate(ct, 2, _t(ksk4), CFG)
    frac = (cv.to_u64(bad[1]) != cv.to_u64(good[1])).mean()
    assert frac > 0.99, f"only {frac:.3f} of b-part words differ"


def _assert_localized(good, bad):
    """One flipped q0-lane key word: b and the other limbs untouched, 1-2
    words of a[0] changed."""
    ga, gb = _u64(good)
    ba, bb = _u64(bad)
    assert np.array_equal(bb, gb)
    assert np.array_equal(ba[1:], ga[1:])
    ndiff = int((ba[0] != ga[0]).sum())
    assert 1 <= ndiff <= 2, f"{ndiff} words differ in a[0]"


def test_tampered_ksk_word_localizes(material):
    ct, ksk2, _ = material
    tampered = ksk2.copy()
    tampered[0, 123] ^= np.uint64(1)  # modulus 0, digit 0, a-part
    _assert_localized(ht.rotate(ct, 2, _t(ksk2), CFG), ht.rotate(ct, 2, _t(tampered), CFG))


def test_tampered_special_prime_row_fans_out(material):
    ct, ksk2, _ = material
    tampered = ksk2.copy()
    tampered[2 * L * L, 123] ^= np.uint64(1)  # P, digit 0, a-part
    good = ht.rotate(ct, 2, _t(ksk2), CFG)
    bad = ht.rotate(ct, 2, _t(tampered), CFG)
    frac = (cv.to_u64(bad[0]) != cv.to_u64(good[0])).mean()
    assert frac > 0.99, f"only {frac:.3f} of a-part words differ"


def test_tampered_ksk_word_localizes_hoisted(material):
    ct, ksk2, _ = material
    tampered = ksk2.copy()
    tampered[0, 123] ^= np.uint64(1)
    good, = ht.rotate_hoisted(ct, [2], [_t(ksk2)], CFG)
    bad, = ht.rotate_hoisted(ct, [2], [_t(tampered)], CFG)
    _assert_localized(good, bad)


@pytest.fixture(scope="module")
def matvec_material():
    """tests/test_matvec.py's: an encrypted vector, D = 4 diagonals, keys
    of the baby step 1 and the giant step 2."""
    rng = np.random.default_rng(50)
    sk = keys.gen_secret(CFG, np.random.default_rng(51))
    z = rng.uniform(-1, 1, size=S) + 1j * rng.uniform(-1, 1, size=S)
    pt = encoder.encode(encoder.cleartext_from_slots(z), CFG)
    signed = np.where(pt[0] > q0 // 2, pt[0].astype(np.int64) - np.int64(q0),
                      pt[0].astype(np.int64))
    ct = keys.encrypt(signed, sk, CFG, np.random.default_rng(52))
    dvecs = [rng.uniform(-1, 1, size=S) for _ in range(4)]
    diags = [he_np.encode_post(encoder.encode(encoder.cleartext_from_slots(d + 0j), CFG), CFG)
             for d in dvecs]
    ksb = [keys.gen_rotation_key(sk, 1, CFG, np.random.default_rng(61))]
    ksg = [keys.gen_rotation_key(sk, 2, CFG, np.random.default_rng(71))]
    return sk, z, ct, dvecs, diags, ksb, ksg


def _slots(ct, sk, scale=1.0):
    m = torch_keys.decrypt(ct, cv.sk_from_np(sk, CPU), CFG).numpy()
    res = np.where(m < 0, m + np.int64(q0), m).astype(np.uint64)
    return encoder.decode(res[None, :], CFG, limb=0) * scale


def test_matvec_uneven_groups(matvec_material):
    """D = 3, g = 2: the last giant group holds one diagonal."""
    sk, z, ct, dvecs, diags, ksb, ksg = matvec_material
    D3, g = 3, 2
    out = ht.matvec_bsgs(cv.ct_from_np(ct, CPU), [_t(d) for d in diags[:D3]],
                         [_t(k) for k in ksb], [_t(k) for k in ksg], CFG, g=g)
    want = he_np.matvec_bsgs(ct, diags[:D3], ksb, ksg, CFG, g=g)
    assert np.array_equal(cv.to_u64(out[0]), want.a) and np.array_equal(cv.to_u64(out[1]), want.b)
    got = _slots(ht.rescale(out, CFG), sk, CFG.moduli[1] / encoder.DELTA)
    expect = sum(d * np.roll(z, -k) for k, d in enumerate(dvecs[:D3]))
    assert np.abs(got - expect).max() < 0.15


def test_pt_rotate_matches_ct_semantics(matvec_material):
    """pt_rotate(encode(z), r) decodes to roll(z, -r), word-exact against
    he_np.pt_rotate."""
    _, _, _, dvecs, diags, _, _ = matvec_material
    rot = ht.pt_rotate(_t(diags[0]), 3, CFG)
    assert np.array_equal(cv.to_u64(rot), he_np.pt_rotate(diags[0], 3, CFG))
    coeff = ntt_torch.intt(rot[0], q0, CFG.ipsi[0])
    got = encoder.decode(cv.to_u64(coeff)[None, :], CFG, limb=0)
    assert np.abs(got - np.roll(dvecs[0], -3)).max() < 1e-4


def test_galois_hoisted_conjugate(matvec_material):
    """Hoisted conjugation (exponent 2N - 1) through galois_hoisted:
    word-exact against he_np and decrypting to the conjugated slots."""
    sk, z, ct, *_ = matvec_material
    cjk = keys.gen_conjugation_key(sk, CFG, np.random.default_rng(90))
    e = 2 * N - 1
    out, = ht.galois_hoisted(cv.ct_from_np(ct, CPU), [e], [_t(cjk)], CFG)
    want, = he_np.galois_hoisted(ct, [e], [cjk], CFG)
    assert np.array_equal(cv.to_u64(out[0]), want.a) and np.array_equal(cv.to_u64(out[1]), want.b)
    assert np.abs(_slots(out, sk) - np.conj(z)).max() < 1e-4
