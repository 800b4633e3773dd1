"""Key material and encryption randomness: the port's OS draws and its
reduction without modular bias.

- With `os.urandom` replaced by one seeded byte stream (restarted between
  the packages), the port's `gen_secret`, `gen_rotation_key`,
  `gen_conjugation_key`, `gen_relin_key` and `encrypt` with no generator
  equal `aloha_tpu.keys`' calls with no rng (its `SecureRng`) word for word
  and read as many bytes, at N = 8192 and on the three-limb ring at
  n = 1024; a batch of 3 encryptions equals 3 sequential JAX calls;
- `keys.reduce_words` equals Python integer arithmetic on edge words;
- at span 3 * 2^61 the seeded draws (`uniform_below`) and the OS reduction
  (`os_integers_from`) put 2/3 of 4 * 10^5 draws below 2^62, within
  0.005 (6.7 standard deviations); one 64-bit word reduced with no slack,
  as `torch.randint` reduces it, puts 3/4 there and falls outside, and so
  does `torch.randint` itself;
- the OS draws' statistics (ternary counts, the noise's mean and standard
  deviation) lie within 6 standard deviations of their laws;
- keys drawn from the OS decrypt an encryption within its noise and
  rotate within 0.15.
"""

import os

import numpy as np
import pytest
import torch

from aloha_tpu import keys as jax_keys
from aloha_tpu.config import DEFAULT_CONFIG as JCFG
from aloha_tpu.config import HEConfig as JaxHEConfig
from aloha_tpu_torch import config, encoder, keys
from aloha_tpu_torch import he_torch as ht
from test_torch_multilimb import FIELDS3_1024

torch.set_num_threads(2)

CPU = torch.device("cpu")
CFG = config.DEFAULT_CONFIG
RINGS = {
    "N=8192": (CFG, JCFG),
    "L=3,n=1024": (config.HEConfig(**FIELDS3_1024), JaxHEConfig(**FIELDS3_1024)),
}


class ByteStream:
    """Stands in for `os.urandom`: one seeded byte stream, the same bytes in
    the same order however the reads are split."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.buf = bytearray()
        self.pos = 0

    def __call__(self, k):
        while len(self.buf) - self.pos < k:
            self.buf += self.rng.bytes(1 << 20)
        self.pos += k
        return bytes(self.buf[self.pos - k:self.pos])


def _both(seed, port_fn, jax_fn):
    """(port result, JAX result), each on the stream restarted at `seed`;
    both must read the same number of bytes."""
    out, read = [], []
    for fn in (port_fn, jax_fn):
        stream = ByteStream(seed)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(os, "urandom", stream)
            out.append(fn())
        read.append(stream.pos)
    assert read[0] == read[1] > 0
    return out


def _u64(t):
    return t.numpy().view(np.uint64)


@pytest.fixture(scope="module", params=list(RINGS))
def ring(request):
    """(cfg, jax cfg, port secret, JAX secret), both secrets from the OS on
    one stream."""
    cfg, jcfg = RINGS[request.param]
    sk, jsk = _both(1, lambda: keys.gen_secret(cfg, device=CPU), lambda: jax_keys.gen_secret(jcfg))
    return cfg, jcfg, sk, jsk


def test_os_secret_equals_the_jax_package(ring):
    cfg, _, sk, jsk = ring
    assert sk.coeff.device == CPU
    assert np.array_equal(sk.coeff.numpy(), jsk.coeff)
    assert np.array_equal(_u64(sk.ntt), jsk.ntt)
    assert set(np.unique(jsk.coeff)) == {-1, 0, 1}


KSKS = {
    "rotation": (lambda sk, cfg: keys.gen_rotation_key(sk, 3, cfg),
                 lambda jsk, jcfg: jax_keys.gen_rotation_key(jsk, 3, jcfg)),
    "conjugation": (lambda sk, cfg: keys.gen_conjugation_key(sk, cfg),
                    lambda jsk, jcfg: jax_keys.gen_conjugation_key(jsk, jcfg)),
    "relin": (lambda sk, cfg: keys.gen_relin_key(sk, cfg),
              lambda jsk, jcfg: jax_keys.gen_relin_key(jsk, jcfg)),
}


@pytest.mark.parametrize("kind", list(KSKS))
def test_os_key_switch_keys_equal_the_jax_package(ring, kind):
    cfg, jcfg, sk, jsk = ring
    port_fn, jax_fn = KSKS[kind]
    got, want = _both(2, lambda: port_fn(sk, cfg), lambda: jax_fn(jsk, jcfg))
    assert got.shape == want.shape == (2 * cfg.n_limbs * (cfg.n_limbs + 1), cfg.n)
    assert np.array_equal(_u64(got), want)


@pytest.mark.parametrize("batch", [None, 3])
def test_os_encryption_equals_the_jax_package(ring, batch):
    """One encryption, and a batch of 3 against 3 sequential JAX calls on
    one stream."""
    cfg, jcfg, sk, jsk = ring
    lead = () if batch is None else (batch,)
    m = np.random.default_rng(3).integers(-(1 << 40), 1 << 40, size=lead + (cfg.n,))
    (a, b), want = _both(
        3, lambda: keys.encrypt(torch.from_numpy(m), sk, cfg),
        lambda: [jax_keys.encrypt(mi, jsk, jcfg) for mi in m.reshape(-1, cfg.n)])
    L = cfg.n_limbs
    assert a.shape == b.shape == lead + (L, cfg.n)
    for i, ct in enumerate(want):
        assert np.array_equal(_u64(a.reshape(-1, L, cfg.n)[i]), ct.a)
        assert np.array_equal(_u64(b.reshape(-1, L, cfg.n)[i]), ct.b)


@pytest.mark.parametrize("span", [1, 2, 3, 5, config.Q0, config.SP, 3 << 61, (1 << 63) - 25,
                                  1 << 62, 1 << 63])
@pytest.mark.parametrize("word_bits", [32, 63])
def test_reduce_words_is_exact(span, word_bits):
    rng = np.random.default_rng(span % 1000 + word_bits)
    top = (1 << word_bits) - 1
    k = 4
    words = rng.integers(0, top, size=(k, 300), dtype=np.int64, endpoint=True)
    words[:, 0], words[:, 1] = 0, top  # the integers 0 and 2^(k word_bits) - 1
    words[:, 2], words[:, 3] = [top, 0] * (k // 2), [0, top] * (k // 2)
    got = keys.reduce_words(torch.from_numpy(words).unbind(0), word_bits, span)
    big = sum(words[j].astype(object) << (word_bits * j) for j in range(k))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy().astype(object), big % span)


@pytest.mark.parametrize("span", [0, (1 << 63) + 1])
def test_reduce_words_rejects_a_span_out_of_range(span):
    with pytest.raises(ValueError):
        keys.reduce_words([torch.zeros(2, dtype=torch.int64)], 32, span)


SPAN = 3 << 61  # 2^64 = 2 SPAN + 2^62: a 64-bit word mod SPAN lands below 2^62 with chance 3/4
DRAWS = 400_000
WINDOW = 0.005  # 6.7 standard deviations of the fraction at 4e5 draws


@pytest.mark.parametrize("source", ["seeded", "os"])
def test_uniform_draws_have_no_modular_bias(source):
    """2/3 of the draws below 2^62, as a uniform law puts there; the same
    bytes reduced as one 64-bit word each fall at 3/4, outside the window."""
    if source == "seeded":
        x = keys.uniform_below(SPAN, (DRAWS,), torch.Generator().manual_seed(25))
    else:
        raw = np.random.default_rng(25).integers(
            0, 256, size=(DRAWS, keys.os_int_bytes(SPAN)), dtype=np.uint8)
        x = keys.os_integers_from(raw, SPAN)
        low = torch.from_numpy(raw[:, :8].copy().view("<u4").astype(np.int64))
        biased = keys.reduce_words(low.unbind(-1), 32, SPAN)
        assert abs((biased < (1 << 62)).double().mean().item() - 0.75) < WINDOW
    assert x.shape == (DRAWS,) and bool((x >= 0).all()) and bool((x < SPAN).all())
    assert abs((x < (1 << 62)).double().mean().item() - 2 / 3) < WINDOW


def test_the_window_rejects_torch_randint():
    """`torch.randint` reduces one 64-bit word mod a span of 2^32 or more,
    so it puts about 3/4 of the draws below 2^62: the window above rejects
    it, which is why no draw of the port uses it."""
    x = torch.randint(0, SPAN, (DRAWS,), generator=torch.Generator().manual_seed(25))
    assert abs((x < (1 << 62)).double().mean().item() - 2 / 3) >= WINDOW


def test_os_words_take_the_slack_of_secure_rng():
    """Bytes per element as `SecureRng.integers` reads them: 17 for the
    ternary secret, 24 for a 60-bit modulus and for a 63-bit chunk."""
    assert keys.os_int_bytes(3) == 17
    assert [keys.os_int_bytes(q) for q in CFG.moduli] == [24, 24, 24]
    assert keys.os_int_bytes(1 << 63) == 24


def test_os_secret_is_uniform_ternary():
    n = 4 * CFG.n
    s = torch.cat([keys.draw_secret(CFG) for _ in range(4)]).numpy()
    counts = np.bincount(s + 1, minlength=3)
    assert counts.sum() == n
    assert np.abs(counts - n / 3).max() < 6 * np.sqrt(n * (1 / 3) * (2 / 3))


def test_os_noise_has_the_law_of_the_reference():
    e = keys.draw_noise(CFG, None, (4,)).numpy().astype(np.float64)
    n = e.size
    assert e.shape == (4, CFG.n)
    assert abs(e.mean()) < 6 * keys.SIGMA / np.sqrt(n)
    assert abs(e.std() - keys.SIGMA) < 6 * keys.SIGMA / np.sqrt(2 * n)


def _signed(pt, q0):
    return np.where(pt > q0 // 2, pt.astype(np.int64) - np.int64(q0), pt.astype(np.int64))


def test_os_keys_round_trip():
    """An OS secret decrypts an OS encryption to m + e under both limbs,
    |e| within 16 sigma; an OS rotation key rotates the slots within 0.15."""
    sk = keys.gen_secret(CFG, device=CPU)
    m = np.random.default_rng(4).integers(-(1 << 40), 1 << 40, size=CFG.n)
    ct = keys.encrypt(torch.from_numpy(m), sk, CFG)
    for limb in (0, 1):
        err = keys.decrypt(ct, sk, CFG, limb=limb).numpy() - m
        assert np.abs(err).max() < 16 * keys.SIGMA and err.any()
    q0 = CFG.moduli[0]
    z = np.random.default_rng(5).uniform(-1, 1, CFG.n // 2) + 0.5j
    pt = encoder.encode(encoder.cleartext_from_slots(z), CFG)
    ct = keys.encrypt(torch.from_numpy(_signed(pt[0], q0)), sk, CFG)
    rot = ht.rotate(ct, 2, keys.gen_rotation_key(sk, 2, CFG), CFG)
    dec = keys.decrypt(rot, sk, CFG).numpy()
    got = encoder.decode(np.where(dec < 0, dec + np.int64(q0), dec).astype(np.uint64), CFG)
    assert np.abs(got - np.roll(z, -2)).max() < 0.15
