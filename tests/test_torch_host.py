"""The port's host layer against the JAX package's, word for word.

- `aloha_tpu_torch.config` keeps `aloha_tpu.config`'s fields and constants;
- `aloha_tpu_torch.ntt_np` equals `aloha_tpu.ntt_np` at n = 1024 and 8192;
- `keys`' deterministic cores equal `aloha_tpu.keys` on the same draws: the
  port draws from a `torch.Generator` and the JAX functions are handed the
  same numbers through `Replay`, in the order they ask for them;
- the seeded draws reduce 128 bits of slack: the secret and the b-parts
  equal the Python integers of three 63-bit `random_` words of the same
  generator mod 3 or q;
- `keys.decrypt` of a ciphertext of the JAX package is word-exact, with its
  secret carried across by `convert.sk_from_np`;
- a rotation key made by the port rotates: `he_torch.rotate`, then decrypt,
  gives the rotated message within 0.15;
- the relinearization and conjugation keys' cores equal the JAX package's,
  and the multiply chain on the port's keys and device encoder decrypts
  within 1e-4 (relinearized, at Delta^2) and 0.15 (rescaled);
- `encoder` equals `aloha_tpu.encoder`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aloha_tpu import config as jax_config
from aloha_tpu import encoder as jax_encoder
from aloha_tpu import keys as jax_keys
from aloha_tpu import ntt_np as jax_ntt_np
from aloha_tpu_torch import config, encoder, keys, ntt_np
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch.ops import ntt_pallas

torch.set_num_threads(2)

CPU = torch.device("cpu")
CFG, JCFG = config.DEFAULT_CONFIG, jax_config.DEFAULT_CONFIG
N = CFG.n


class Replay:
    """Stands in for the numpy Generator the JAX key functions take: hands
    back the given arrays one call at a time, checking each call's range."""

    def __init__(self, draws):
        self.draws = [np.asarray(d) for d in draws]

    def _next(self, size):
        d = self.draws.pop(0)
        assert d.shape == (size,)
        return d

    def integers(self, low, high, size=None, dtype=np.int64):
        d = self._next(size)
        assert ((d >= low) & (d < high)).all()
        return d.astype(dtype)

    def normal(self, loc=0.0, scale=1.0, size=None):
        assert (loc, scale) == (0.0, keys.SIGMA)
        return self._next(size).astype(np.float64)


def test_config_equals_the_jax_package():
    for f in dataclasses.fields(jax_config.HEConfig):
        assert getattr(CFG, f.name) == getattr(JCFG, f.name), f.name
    assert (CFG.logn, CFG.n_limbs, CFG.special_prime, CFG.iq) == (
        JCFG.logn, JCFG.n_limbs, JCFG.special_prime, JCFG.iq)
    assert [CFG.pinv_mod(m) for m in range(2)] == list(jax_config.PINV_MOD_Q)
    for name in ("N_DEFAULT", "Q0", "Q1", "SP", "MODULI_DEFAULT", "PSI_DEFAULT",
                 "IPSI_DEFAULT", "MOD_WIDTH"):
        assert getattr(config, name) == getattr(jax_config, name), name
    for q in CFG.moduli:
        assert config.barrett_iq(q) == jax_config.barrett_iq(q)
        assert config.shoup(q - 5, q) == jax_config.shoup(q - 5, q)
    with pytest.raises(ValueError):
        config.barrett_iq(1 << 40)
    with pytest.raises(ValueError):
        config.HEConfig(n=1000)
    with pytest.raises(ValueError):
        config.HEConfig(psi=(2,) + CFG.psi[1:], ipsi=(pow(2, -1, CFG.moduli[0]),) + CFG.ipsi[1:])
    with pytest.raises(ValueError):
        config.HEConfig(moduli=(3 * 2**58,) + CFG.moduli[1:])


@pytest.mark.parametrize("n", [1024, 8192])
def test_ntt_np_equals_the_jax_package(n):
    k = N // n
    rng = np.random.default_rng(n)
    for m, q in enumerate(CFG.moduli):
        psi, ipsi = pow(CFG.psi[m], k, q), pow(CFG.ipsi[m], k, q)
        x = rng.integers(0, q, size=(2, n), dtype=np.uint64)
        y = ntt_np.ntt(x, q, psi)
        assert np.array_equal(y, jax_ntt_np.ntt(x, q, psi))
        assert np.array_equal(ntt_np.intt(y, q, ipsi), jax_ntt_np.intt(y, q, ipsi))
        assert np.array_equal(ntt_np.intt(y, q, ipsi), x)
        assert np.array_equal(ntt_np.psi_powers_bitrev(n, psi, q),
                              jax_ntt_np.psi_powers_bitrev(n, psi, q))
    assert np.array_equal(ntt_np.bitrev_permutation(n), jax_ntt_np.bitrev_permutation(n))
    for e in (pow(3, 5, 2 * n), 2 * n - 1):
        assert np.array_equal(ntt_np.ntt_aut_perm(n, e), jax_ntt_np.ntt_aut_perm(n, e))


@pytest.fixture(scope="module")
def secret():
    """The port's secret from its draws, and the JAX package's from the same."""
    coeff = keys.draw_secret(CFG, torch.Generator().manual_seed(1))
    return keys.secret_key(coeff, CFG), jax_keys.gen_secret(JCFG, rng=Replay([coeff.numpy()]))


def test_secret_key_core_and_carry_across(secret):
    sk, jsk = secret
    assert set(np.unique(sk.coeff.numpy())) <= {-1, 0, 1}
    assert np.array_equal(sk.coeff.numpy(), jsk.coeff)
    assert np.array_equal(cv.to_u64(sk.ntt), jsk.ntt)
    carried = cv.sk_from_np(jsk, CPU)
    assert torch.equal(carried.coeff, sk.coeff) and torch.equal(carried.ntt, sk.ntt)
    assert torch.equal(keys.gen_secret(CFG, torch.Generator().manual_seed(1), CPU).ntt, sk.ntt)


def _ksk_draws(chunks, noise):
    """The draws of `draw_ksk` in the order the JAX key functions ask for
    them: per digit the uniform chunks, then the error."""
    draws = []
    for j in range(CFG.n_limbs):
        draws += [c.numpy().view(np.uint64) for c in chunks[j]] + [noise[j].numpy()]
    return draws


def test_rotation_key_core_equals_the_jax_package(secret):
    sk, jsk = secret
    step = 3
    chunks, noise = keys.draw_ksk(CFG, torch.Generator().manual_seed(2))
    assert chunks.shape == (CFG.n_limbs, keys.uniform_chunks(CFG), N)
    assert bool((chunks >= 0).all())
    got = keys.ksk_from_draws(keys.galois_secret(sk, pow(3, step, 2 * N), CFG), sk,
                              chunks, noise, CFG)
    want = jax_keys.gen_rotation_key(jsk, step, JCFG, rng=Replay(_ksk_draws(chunks, noise)))
    assert np.array_equal(cv.to_u64(got), want)
    wrapped = keys.gen_rotation_key(sk, step, CFG, torch.Generator().manual_seed(2))
    assert torch.equal(wrapped, got)


def test_relin_key_core_equals_the_jax_package(secret):
    sk, jsk = secret
    s = sk.coeff.numpy()
    s2 = np.zeros(N, dtype=np.int64)  # the negacyclic square, summed directly
    for shift in np.flatnonzero(s):
        s2[shift:] += s[shift] * s[:N - shift]
        s2[:shift] -= s[shift] * s[N - shift:]
    assert np.array_equal(keys.relin_secret(sk, CFG).numpy(), s2)
    chunks, noise = keys.draw_ksk(CFG, torch.Generator().manual_seed(11))
    got = keys.ksk_from_draws(keys.relin_secret(sk, CFG), sk, chunks, noise, CFG)
    want = jax_keys.gen_relin_key(jsk, JCFG, rng=Replay(_ksk_draws(chunks, noise)))
    assert np.array_equal(cv.to_u64(got), want)
    assert torch.equal(keys.gen_relin_key(sk, CFG, torch.Generator().manual_seed(11)), got)


def test_conjugation_key_core_equals_the_jax_package(secret):
    sk, jsk = secret
    chunks, noise = keys.draw_ksk(CFG, torch.Generator().manual_seed(12))
    got = keys.ksk_from_draws(keys.galois_secret(sk, 2 * N - 1, CFG), sk, chunks, noise, CFG)
    want = jax_keys.gen_conjugation_key(jsk, JCFG, rng=Replay(_ksk_draws(chunks, noise)))
    assert np.array_equal(cv.to_u64(got), want)
    assert torch.equal(keys.gen_conjugation_key(sk, CFG, torch.Generator().manual_seed(12)), got)


def test_encrypt_core_equals_the_jax_package(secret):
    sk, jsk = secret
    m = np.random.default_rng(3).integers(-(1 << 40), 1 << 40, size=(2, N))
    e, b = keys.draw_encryption(CFG, torch.Generator().manual_seed(4), (2,))
    a, b_out = keys.encrypt_with(torch.from_numpy(m), sk, e, b, CFG)
    assert b_out is b
    for i in range(2):
        want = jax_keys.encrypt(m[i], jsk, JCFG, rng=Replay([e[i].numpy(), *b[i].numpy()]))
        assert np.array_equal(cv.to_u64(a[i]), want.a)
        assert np.array_equal(cv.to_u64(b[i]), want.b)


def _mod_words(words, span):
    """(k, ...) int64 words in [0, 2^63), low first -> their integer mod
    span, in Python integers."""
    w = words.numpy().astype(object)
    return sum(w[k] << (63 * k) for k in range(len(w))) % span


@pytest.mark.parametrize("draw", ["secret", "encryption"])
def test_seeded_draws_reduce_128_bits_of_slack(draw):
    """A seeded uniform draw mod a span is three 63-bit words of the
    generator (189 bits >= bit_length + 128 for 3 and the 60-bit moduli)
    reduced exactly, in the order the draws ask for them."""
    g = torch.Generator().manual_seed(4)
    words = lambda shape: torch.empty((3,) + shape, dtype=torch.int64).random_(generator=g)
    if draw == "secret":
        got = keys.draw_secret(CFG, torch.Generator().manual_seed(4))
        assert np.array_equal(got.numpy().astype(object), _mod_words(words((N,)), 3) - 1)
        return
    e, b = keys.draw_encryption(CFG, torch.Generator().manual_seed(4), (2,))
    noise = torch.round(torch.normal(0.0, keys.SIGMA, (2, N), generator=g,
                                     dtype=torch.float64)).to(torch.int64)
    assert torch.equal(e, noise)
    for m, q in enumerate(CFG.moduli[:CFG.n_limbs]):
        assert np.array_equal(b[:, m].numpy().astype(object), _mod_words(words((2, N)), q))


@pytest.mark.parametrize("limb", [0, 1])
def test_decrypt_of_a_jax_ciphertext_is_word_exact(secret, limb):
    _, jsk = secret
    m = np.random.default_rng(5).integers(-(1 << 40), 1 << 40, size=N)
    jct = jax_keys.encrypt(m, jsk, JCFG, rng=np.random.default_rng(6))
    got = keys.decrypt(cv.ct_from_np(jct, CPU), cv.sk_from_np(jsk, CPU), CFG, limb=limb)
    assert np.array_equal(got.numpy(), jax_keys.decrypt(jct, jsk, JCFG, limb=limb))


def test_port_rotation_key_rotates(secret):
    sk, _ = secret
    gen = torch.Generator().manual_seed(7)
    z = np.random.default_rng(8).uniform(-1, 1, N // 2) + 0.5j
    pt = encoder.encode(encoder.cleartext_from_slots(z), CFG)
    q0 = CFG.moduli[0]
    signed = np.where(pt[0] > q0 // 2, pt[0].astype(np.int64) - np.int64(q0), pt[0].astype(np.int64))
    ct = keys.encrypt(torch.from_numpy(signed), sk, CFG, gen)
    rot = ht.rotate(ct, 2, keys.gen_rotation_key(sk, 2, CFG, gen), CFG)
    m = keys.decrypt(rot, sk, CFG).numpy()
    got = encoder.decode(np.where(m < 0, m + np.int64(q0), m).astype(np.uint64), CFG)
    assert np.abs(got - np.roll(z, -2)).max() < 0.15


def test_encoder_equals_the_jax_package():
    rng = np.random.default_rng(9)
    z = rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
    clear = encoder.cleartext_from_slots(z)
    assert np.array_equal(clear, jax_encoder.cleartext_from_slots(z))
    assert np.array_equal(encoder.slots_from_cleartext(clear), jax_encoder.slots_from_cleartext(clear))
    pt = encoder.encode(clear, CFG)
    assert np.array_equal(pt, jax_encoder.encode(clear, JCFG))
    for limb in (0, 1):
        assert np.array_equal(encoder.decode(pt, CFG, limb=limb),
                              jax_encoder.decode(pt, JCFG, limb=limb))
    assert np.abs(encoder.decode(pt, CFG) - z).max() < 1e-6
    assert encoder.DELTA == jax_encoder.DELTA
    with pytest.raises(ValueError):
        encoder.slots_from_cleartext(np.zeros(3))
    with pytest.raises(ValueError):
        encoder.encode(np.zeros(N - 2), CFG)


def test_multiply_chain_decrypts_within_envelopes(secret):
    """The device encoder, encryption with the port's keys, ct_mul ->
    relinearize -> rescale: the relinearized product decrypts (CRT over both
    limbs at Delta^2) within 1e-4 of z1 z2, the rescaled one within 0.15
    (tests/test_keys.py's envelopes for the JAX package)."""
    sk, _ = secret
    gen = torch.Generator().manual_seed(13)
    rng = np.random.default_rng(14)
    q0, q1 = CFG.moduli[0], CFG.moduli[1]
    zs = [rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2) for _ in range(2)]
    cts = []
    for z in zs:
        pt = ht.encode(torch.from_numpy(encoder.cleartext_from_slots(z)), CFG)
        m = ntt_pallas.intt(pt[0], q0, CFG.ipsi[0])  # limb 0, centred
        cts.append(keys.encrypt(torch.where(m > q0 // 2, m - q0, m), sk, CFG, gen))
    relin = ht.relinearize(*ht.ct_mul(*cts, CFG), keys.gen_relin_key(sk, CFG, gen), CFG)
    r0, r1 = (keys.decrypt(relin, sk, CFG, limb=k).numpy().astype(object) for k in (0, 1))
    Q = q0 * q1
    x = (r0 * (q1 * pow(q1, -1, q0)) + r1 * (q0 * pow(q0, -1, q1))) % Q
    x = np.where(x > Q // 2, x - Q, x)
    got = encoder.decode_coeffs((x / float(encoder.DELTA)).astype(np.float64), CFG)
    assert np.abs(got - zs[0] * zs[1]).max() < 1e-4
    m = keys.decrypt(ht.rescale(relin, CFG), sk, CFG).numpy()
    got = encoder.decode_coeffs(m.astype(np.float64), CFG) * (q1 / encoder.DELTA)
    assert np.abs(got - zs[0] * zs[1]).max() < 0.15
