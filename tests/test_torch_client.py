"""The client's side of a matvec request (`aloha_tpu_torch.client`) on the CPU.

- `encode_signed` and `decode_rescaled` against the JAX package's
  `encoder` on the same slot vectors and words (exact words; the slots to
  the last bit, both decoders being the same float64 FFT);
- `encrypt_slots` -> `he_torch.matvec_bsgs` -> `rescale` ->
  `decrypt_rescaled` against `he_np` on the JAX keys carried across by
  `convert` (exact words);
- the noise model: over a batch of answers at D = 1 and D = 16 the slot
  errors measured in `noise_sigma` standard deviations have a mean
  square within 0.85-1.2 of 1 and stay under `noise_bound` (the model's
  variance is the rescale's rounding through the key's embedding plus the
  decoder's float64 lift, and does not grow with D).
"""

import math

import numpy as np
import pytest
import torch

from aloha_tpu import encoder as jencoder
from aloha_tpu import he_np
from aloha_tpu import keys as jkeys
from aloha_tpu.config import DEFAULT_CONFIG as JCFG
from aloha_tpu_torch import client, encoder
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG

torch.set_num_threads(2)

CPU = torch.device("cpu")
N, S = CFG.n, CFG.n // 2


@pytest.fixture(scope="module")
def ring():
    """JAX keys (sk rng(21), step s rng(30 + s)) and the port's copies."""
    sk = jkeys.gen_secret(JCFG, np.random.default_rng(21))
    steps = (1, 2, 3, 4, 8, 12)
    rot = {s: jkeys.gen_rotation_key(sk, s, JCFG, np.random.default_rng(30 + s)) for s in steps}
    return sk, rot, cv.sk_from_np(sk, CPU), {s: cv.ksk_from_np(k, CFG, CPU) for s, k in rot.items()}


def _slots(rng, shape):
    return rng.uniform(-1, 1, shape + (S,)) + 1j * rng.uniform(-1, 1, shape + (S,))


def _answers(ring, d, g, nb, seed):
    """nb vectors through a D = d, g = g matvec: (zs, dvecs, input and
    output ciphertexts, got slots, signed decryptions)."""
    _, _, sk, rot = ring
    rng = np.random.default_rng(seed)
    zs, dvecs = _slots(rng, (nb,)), [rng.uniform(-1, 1, S) for _ in range(d)]
    diags = ht.encode_post(cv.from_u64(np.stack(
        [encoder.encode(encoder.cleartext_from_slots(v + 0j), CFG) for v in dvecs]), CPU), CFG)
    ct = client.encrypt_slots(zs, sk, CFG, torch.Generator().manual_seed(seed))
    baby = [rot[j] for j in range(1, g)]
    giant = [rot[g * i] for i in range(1, -(-d // g))]
    out = ht.rescale(ht.matvec_bsgs(ct, list(diags), baby, giant, CFG, g=g), CFG)
    got, dec = client.decrypt_rescaled(out, sk, CFG)
    return zs, dvecs, ct, out, got, dec


def test_encode_signed_is_the_jax_encoding():
    zs = _slots(np.random.default_rng(3), (2,))
    q0 = JCFG.moduli[0]
    for z, got in zip(zs, client.encode_signed(zs, CFG)):
        pt = jencoder.encode(jencoder.cleartext_from_slots(z), JCFG)[0]
        want = np.where(pt > q0 // 2, pt.astype(np.int64) - np.int64(q0), pt.astype(np.int64))
        assert got.dtype == np.int64 and np.array_equal(got, want)


def test_decode_rescaled_is_the_jax_decoder():
    rng = np.random.default_rng(4)
    dec = rng.integers(-(1 << 40), 1 << 40, size=(2, N), dtype=np.int64)
    got = client.decode_rescaled(dec, CFG)
    q0 = JCFG.moduli[0]
    for d, g in zip(dec, got):
        res = np.where(d < 0, d + np.int64(q0), d).astype(np.uint64)
        want = jencoder.decode(res[None, :], JCFG, limb=0) * (JCFG.moduli[1] / jencoder.DELTA)
        assert np.array_equal(g, want)


def test_request_against_he_np(ring):
    """Each answer's words are he_np's on the same encryption, its
    decryption the JAX keys', its slot error under 0.15."""
    jsk, jrot = ring[:2]
    zs, dvecs, ct, out, got, dec = _answers(ring, 4, 2, 2, 5)
    jdiags = [he_np.encode_post(jencoder.encode(jencoder.cleartext_from_slots(v + 0j), JCFG), JCFG)
              for v in dvecs]
    for i in range(2):
        c = he_np.Ciphertext(a=cv.to_u64(ct[0])[i], b=cv.to_u64(ct[1])[i])
        want = he_np.rescale(he_np.matvec_bsgs(c, jdiags, [jrot[1]], [jrot[2]], JCFG, g=2), JCFG)
        assert np.array_equal(cv.to_u64(out[0])[i], want.a)
        assert np.array_equal(cv.to_u64(out[1])[i], want.b)
        assert np.array_equal(dec[i], jkeys.decrypt(want, jsk, JCFG))
    want = np.stack([client.matvec_clear(dvecs, z) for z in zs])
    err, _, _ = client.slot_errors(got, want, client.noise_sigma(dec, ring[2], CFG))
    assert err.shape == (2,) and err.max() < 0.15


@pytest.mark.parametrize("d, g, nb", [(1, 1, 8), (16, 4, 2)])
def test_noise_model_fits_the_slot_errors(ring, d, g, nb):
    zs, dvecs, _, _, got, dec = _answers(ring, d, g, nb, 6 + d)
    sigma = client.noise_sigma(dec, ring[2], CFG)
    want = np.stack([client.matvec_clear(dvecs, z) for z in zs])
    t = np.abs(got - want) / sigma
    err, ratio, square = client.slot_errors(got, want, sigma)
    assert sigma.shape == (nb, S) and 0.85 < square < 1.2
    assert square == pytest.approx(float((t ** 2).mean()), rel=1e-12)
    assert ratio == t.max() < client.noise_bound(nb * S)
    assert np.array_equal(err, np.abs(got - want).max(axis=-1))


def test_noise_bound_is_the_union_level():
    assert client.noise_bound(4096) == math.sqrt(math.log(4096 / client.NOISE_P))
    assert client.noise_bound(1 << 20) > client.noise_bound(4096)
    assert client.noise_bound(4096, p=1e-3) < client.noise_bound(4096)
