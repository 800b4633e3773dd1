"""The port's fixed-point encoder against the JAX package's, word for word.

- `aloha_tpu_torch.encoder_hw` (the port's NumPy copy) has the tables of
  `aloha_tpu.encoder_hw` (phase factors with PHASE_FIX, the DIT output
  permutation, the combine ROMs) and its `encode` (`rtl` and `cmodel`);
- `encoder_torch.encode` (int64 tensor ops) equals
  `aloha_tpu.encoder_jax.encode` on random cleartexts, the tie-prone input
  of tests/test_encoder_jax.py and a batch of three;
- `he_torch.encode` (the encoder, then one grid transform per limb) equals
  `he_jax.encode`.

Both packages read the same ROM source: the port's `ROM_DIR` is pointed at
the directory the JAX package loads when that directory exists, and left at
the ideal table otherwise (as the JAX package falls back).
"""

import inspect
import os

import numpy as np
import pytest
import torch

from aloha_tpu import encoder_hw as jax_hw
from aloha_tpu import encoder_jax, he_jax
from aloha_tpu.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch import config, encoder_hw, encoder_torch
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import he_torch as ht

torch.set_num_threads(2)

N = CFG.n
_JAX_ROMS = inspect.signature(jax_hw.load_combine_roms.__wrapped__).parameters["path"].default


@pytest.fixture(autouse=True, scope="module")
def same_rom_source():
    old = encoder_hw.ROM_DIR
    encoder_hw.ROM_DIR = _JAX_ROMS if os.path.isdir(_JAX_ROMS) else None
    yield
    encoder_hw.ROM_DIR = old


@pytest.fixture(scope="module")
def cleartexts():
    rng = np.random.default_rng(60)
    c = rng.uniform(-1, 1, size=(3, N))
    tie = np.zeros(N)
    tie[0::2] = np.linspace(-0.5, 0.5, N // 2)
    tie[1::2] = 2.0**-33  # quantizes to the 0.5 ULP tie
    return c, tie


@pytest.mark.parametrize("L", [8, 32, 128, 512, 2048])
def test_tables_equal_the_jax_package(L):
    mine, theirs = encoder_hw._tw_tables(L), jax_hw._tw_tables(L)
    for q in (1, 2, 3):
        assert np.array_equal(mine[q][0], theirs[q][0])
        assert np.array_equal(mine[q][1], theirs[q][1])
    assert np.array_equal(encoder_hw._dit_perm(L), jax_hw._dit_perm(L))


def test_constants_and_roms_equal_the_jax_package():
    assert encoder_hw.PHASE_FIX == jax_hw.PHASE_FIX
    assert (encoder_hw.TIE_SHIFT, encoder_hw.TIE_PROD) == (jax_hw.TIE_SHIFT, jax_hw.TIE_PROD)
    assert np.array_equal(encoder_hw.get_combine_roms(), jax_hw.get_combine_roms())
    assert np.array_equal(encoder_hw.combine_roms_np(), jax_hw.combine_roms_np())
    if os.path.isdir(_JAX_ROMS):
        assert np.array_equal(encoder_hw.load_combine_roms(_JAX_ROMS),
                              jax_hw.load_combine_roms(_JAX_ROMS))


@pytest.mark.parametrize("combine", ["rtl", "cmodel"])
def test_numpy_encode_equals_the_jax_package(cleartexts, combine):
    c, tie = cleartexts
    for x in (*c[:2], tie):
        assert np.array_equal(encoder_hw.encode(x, config.DEFAULT_CONFIG, combine),
                              jax_hw.encode(x, CFG, combine))
    sr, si = encoder_hw.build_st1(*encoder_hw.quantize_slots(c[2]), N)
    jr, ji = jax_hw.build_st1(*jax_hw.quantize_slots(c[2]), N)
    assert np.array_equal(sr, jr) and np.array_equal(si, ji)
    for mine, theirs in zip(encoder_hw.channel_ffts(sr, si), jax_hw.channel_ffts(jr, ji)):
        assert np.array_equal(mine, theirs)


def test_encoder_torch_equals_encoder_jax(cleartexts):
    c, tie = cleartexts
    got = encoder_torch.encode(torch.from_numpy(c), CFG)  # a batch of three
    assert got.shape == (3, CFG.n_limbs, N) and got.dtype == torch.int64
    want = np.asarray(encoder_jax.encode(c, CFG))
    assert np.array_equal(cv.to_u64(got), want)
    for i in range(3):  # one at a time, as the JAX tests run it
        assert np.array_equal(cv.to_u64(encoder_torch.encode(torch.from_numpy(c[i]), CFG)),
                              np.asarray(encoder_jax.encode(c[i], CFG)))
    assert np.array_equal(cv.to_u64(encoder_torch.encode(torch.from_numpy(tie), CFG)),
                          np.asarray(encoder_jax.encode(tie, CFG)))
    assert np.array_equal(cv.to_u64(got[0]), jax_hw.encode(c[0], CFG))


def test_encoder_torch_rejects_other_rings():
    with pytest.raises(ValueError, match="cleartext"):
        encoder_torch.encode(torch.zeros(N - 2, dtype=torch.float64), CFG)
    k = N // 1024
    small = config.HEConfig(n=1024, psi=tuple(pow(p, k, q) for p, q in zip(CFG.psi, CFG.moduli)),
                            ipsi=tuple(pow(p, k, q) for p, q in zip(CFG.ipsi, CFG.moduli)))
    with pytest.raises(NotImplementedError):
        encoder_torch.encode(torch.zeros(1024, dtype=torch.float64), small)


def test_he_torch_encode_equals_he_jax(cleartexts):
    c, _ = cleartexts
    got = ht.encode(torch.from_numpy(c[:2]), CFG)
    want = np.asarray(he_jax.encode(c[:2], CFG))
    assert np.array_equal(cv.to_u64(got), want)
    # the same words as the serve path's single multi-modulus launch
    coeff = encoder_torch.encode(torch.from_numpy(c[:2]), CFG)
    assert torch.equal(got, ht.encode_post(coeff, CFG))
