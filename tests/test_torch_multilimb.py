"""The port on a three-limb ring (+P) against the JAX package at the same config.

The port is written for any limb count, the JAX package holds its L = 3
ring in tests/test_multilimb.py and tests/test_hoisted.py:113-200; their
constants are copied here (the package keeps no such ring).  Word for word:

- the rotation key's core on the same draws (KSK shape (24, N): stride 2L
  per modulus) equals `aloha_tpu.keys`';
- `he_torch.rotate` and `rotate_hoisted` of an encryption at N = 8192
  equal `he_np`'s and decrypt within 1e-4 of the rotated slots;
- `rotate_hoisted` at n = 1024 on random words equals `he_np.rotate_hoisted`;
- the SPM-spilling ISA key-switch (`isa/programs._keyswitch_spill`) through
  the port's `AlohaDevice` on the CPU equals `aloha_tpu`'s device and
  `he_torch.rotate` on the output rows (the spill clobbers rows past them);
- the port's own copies of tests/test_multilimb.py:79 and :86.
"""

import numpy as np
import pytest
import torch

from aloha_tpu import he_np
from aloha_tpu import keys as jax_keys
from aloha_tpu.config import HEConfig as JaxHEConfig
from aloha_tpu.runtime.device import AlohaDevice as JaxAlohaDevice
from aloha_tpu_torch import config, encoder, keys
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch.runtime.device import AlohaDevice
from test_torch_host import Replay

torch.set_num_threads(2)

CPU = torch.device("cpu")

#: 60-bit NTT-friendly primes (q - 1 divisible by 2N) with 2N-th roots and
#: their inverses: 3 ciphertext limbs + the special prime
#: (tests/test_multilimb.py:19-24)
_P3 = [
    (576460752303439873, 572686754113469876, 509288606595595249),
    (576460752303702017, 518640146586316029, 547209705829931988),
    (576460752304439297, 191393272803421785, 427853369549297084),
    (576460752304619521, 151596679657857464, 439393009888152773),
]
FIELDS3 = dict(moduli=tuple(p[0] for p in _P3), psi=tuple(p[1] for p in _P3),
               ipsi=tuple(p[2] for p in _P3))
CFG3, JCFG3 = config.HEConfig(**FIELDS3), JaxHEConfig(**FIELDS3)
#: the same moduli at n = 1024 (tests/test_hoisted.py:159-180)
FIELDS3_1024 = dict(
    n=1024, moduli=FIELDS3["moduli"],
    psi=(94501300158356233, 476326773003166877, 148318682470543905, 148537735488545494),
    ipsi=(351196243136101305, 354588920078794975, 101101274619666410, 39851676782494322),
)
L, N = CFG3.n_limbs, CFG3.n


def _ksk_draws(chunks, noise):
    """The draws of `draw_ksk` in the order the JAX key functions ask for them."""
    draws = []
    for j in range(L):
        draws += [c.numpy().view(np.uint64) for c in chunks[j]] + [noise[j].numpy()]
    return draws


@pytest.fixture(scope="module")
def secret():
    """The port's secret and the JAX package's from the same draws."""
    coeff = keys.draw_secret(CFG3, torch.Generator().manual_seed(0))
    return keys.secret_key(coeff, CFG3), jax_keys.gen_secret(JCFG3, rng=Replay([coeff.numpy()]))


@pytest.fixture(scope="module")
def rotation_keys(secret):
    """{step: (port key, JAX key)} for steps 1, 2, 3 on the same draws."""
    sk, jsk = secret
    out = {}
    for step in (1, 2, 3):
        chunks, noise = keys.draw_ksk(CFG3, torch.Generator().manual_seed(10 + step))
        got = keys.ksk_from_draws(keys.galois_secret(sk, pow(3, step, 2 * N), CFG3), sk,
                                  chunks, noise, CFG3)
        want = jax_keys.gen_rotation_key(jsk, step, JCFG3, rng=Replay(_ksk_draws(chunks, noise)))
        out[step] = got, want
    return out


def test_three_limb_keys_equal_the_jax_package(secret, rotation_keys):
    sk, jsk = secret
    assert np.array_equal(cv.to_u64(sk.ntt), jsk.ntt) and sk.ntt.shape == (L + 1, N)
    for step, (got, want) in rotation_keys.items():
        assert got.shape == (2 * L * (L + 1), N) == (24, N)  # stride 2L per modulus
        assert np.array_equal(cv.to_u64(got), want), step


def _encrypted_slots(sk):
    """An encryption of 8 small slots (tests/test_multilimb.py:36-44)."""
    z = np.zeros(N // 2, complex)
    z[:8] = np.arange(8) * 0.1
    raw = encoder.encode(encoder.cleartext_from_slots(z), CFG3)[0]
    q0 = CFG3.moduli[0]
    m = np.where(raw > q0 // 2, raw.astype(np.int64) - q0, raw.astype(np.int64))
    return z, keys.encrypt(torch.from_numpy(m), sk, CFG3, torch.Generator().manual_seed(2))


def _slots(ct, sk):
    q0 = CFG3.moduli[0]
    m = keys.decrypt(ct, sk, CFG3).numpy()
    return encoder.decode(np.where(m < 0, m + q0, m).astype(np.uint64)[None, :], CFG3, 0)


def test_three_limb_rotations_decrypt_and_equal_he_np(secret, rotation_keys):
    sk, _ = secret
    z, ct = _encrypted_slots(sk)
    jct = he_np.Ciphertext(*(cv.to_u64(x) for x in ct))
    rot = ht.rotate(ct, 2, rotation_keys[2][0], CFG3)
    want = he_np.rotate(jct, 2, rotation_keys[2][1], JCFG3)
    assert np.array_equal(cv.to_u64(rot[0]), want.a) and np.array_equal(cv.to_u64(rot[1]), want.b)
    assert np.abs(_slots(rot, sk)[:16] - np.roll(z, -2)[:16]).max() < 1e-4
    steps = [1, 3]
    outs = ht.rotate_hoisted(ct, steps, [rotation_keys[s][0] for s in steps], CFG3)
    wants = he_np.rotate_hoisted(jct, steps, [rotation_keys[s][1] for s in steps], JCFG3)
    for s, out, w in zip(steps, outs, wants):
        assert np.array_equal(cv.to_u64(out[0]), w.a) and np.array_equal(cv.to_u64(out[1]), w.b)
        assert np.abs(_slots(out, sk) - np.roll(z, -s)).max() < 1e-4, s


def test_three_limb_rotate_hoisted_at_n1024_equals_he_np():
    cfg, jcfg = config.HEConfig(**FIELDS3_1024), JaxHEConfig(**FIELDS3_1024)
    rng = np.random.default_rng(17)
    a, b = (rng.integers(0, cfg.moduli[0], size=(L, cfg.n), dtype=np.uint64) for _ in "ab")
    sk = keys.gen_secret(cfg, torch.Generator().manual_seed(3), CPU)
    steps = [1, 4]
    ksks = [keys.gen_rotation_key(sk, s, cfg, torch.Generator().manual_seed(4 + s))
            for s in steps]
    outs = ht.rotate_hoisted((cv.from_u64(a, CPU), cv.from_u64(b, CPU)), steps, ksks, cfg)
    wants = he_np.rotate_hoisted(he_np.Ciphertext(a=a, b=b), steps,
                                 [cv.to_u64(k) for k in ksks], jcfg)
    for s, out, w in zip(steps, outs, wants):
        assert np.array_equal(cv.to_u64(out[0]), w.a), s
        assert np.array_equal(cv.to_u64(out[1]), w.b), s


def test_isa_keyswitch_three_limbs_equals_the_jax_device(rotation_keys):
    """The spilling key-switch replays word for word on both devices
    (tests/test_multilimb.py:56-77); only the 2L output rows are held, the
    spill clobbers the rows after them."""
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, CFG3.moduli[0], size=(L, N), dtype=np.uint64) for _ in "ab")
    key, jkey = rotation_keys[2]
    rows = N // 128
    dest = 2 * L * rows * 4
    outs = []
    for dev in (AlohaDevice(CFG3, device="cpu"), JaxAlohaDevice(JCFG3)):
        dev.dma_load_ksk(cv.to_u64(key) if isinstance(dev, AlohaDevice) else jkey)
        dev.dma_write_spm(0, np.concatenate([a, b]))
        dev.run_rotate(dest=dest, src=0, step=2)
        outs.append(dev.dma_read_spm(dest, 2 * L * rows).reshape(2 * L, N))
    assert np.array_equal(outs[0], outs[1])
    want = ht.rotate((cv.from_u64(a, CPU), cv.from_u64(b, CPU)), 2, key, CFG3)
    assert np.array_equal(outs[0][:L], cv.to_u64(want[0]))
    assert np.array_equal(outs[0][L:], cv.to_u64(want[1]))


def test_small_modulus_rejected():
    with pytest.raises(ValueError, match="Barrett"):
        config.barrett_iq((1 << 50) + 1)


def test_rotate_step_validation():
    dev = AlohaDevice(device="cpu")
    for bad in (0, 1, 3, 6):
        with pytest.raises(ValueError, match="power of two"):
            dev.run_rotate(dest=256, src=0, step=bad)
