"""`TorchBackend` on every uint64 word: the NumPy oracle's word, or ValueError.

Words outside the moduli's range reach an ISA launch through DMA
(`dma_write_spm`, `HostRunner` loads).  For each op of the backend and each
word range (< 2q, [2q, 4q), [4q, 2^63), >= 2^63; q = q0, N = 8192, random
words plus the range's ends) the port on CPU tensors must give
`aloha_tpu.isa.interp.NumpyBackend`'s word or raise `ValueError`, never a
different word:

- the ALU ops (`lazy_reduce`, `addmod`, `submod`, `mulmod`, `modred`, and
  the scalar forms) give the oracle's word in every range;
- `vntt` gives it below 4q and raises from 4q on; `vintt` gives it below 2q
  and raises from 2q on.  Both raise at the end of the launch
  (`VectorProcessor.run`), from one flag on the device;
- a constructed input with every word below 2^63 on which the oracle's
  forward transform is not the transform of the reduced word (its first
  output stays near 3q): the reason the forward window is 4q and not 2^63.

Also `make_executable(..., program_key=...)`, as
tests/test_jax_backend.py:114 calls the JAX package's.
"""

import numpy as np
import pytest
import torch

import __graft_entry__
from aloha_tpu import ntt_np
from aloha_tpu.config import DEFAULT_CONFIG as JCFG
from aloha_tpu.isa import interp as jinterp
from aloha_tpu.isa import programs as jprog
from aloha_tpu.jax_backend import JaxBackend
from aloha_tpu.jax_backend import make_executable as jax_make_executable
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch.config import NUM_LANES, HEConfig
from aloha_tpu_torch.isa import programs
from aloha_tpu_torch.isa.interp import LaunchArgs, VectorProcessor
from aloha_tpu_torch.torch_backend import TorchBackend, make_executable

torch.set_num_threads(2)

N, Q = CFG.n, CFG.moduli[0]
PR = N // NUM_LANES
BE, NP = TorchBackend("cpu"), jinterp.NumpyBackend()
RANGES = {"lt2q": (0, 2 * Q), "2q_4q": (2 * Q, 4 * Q), "4q_2e63": (4 * Q, 1 << 63),
          "ge2e63": (1 << 63, 1 << 64)}
ALU = ["lazy_reduce", "modred", "addmod", "submod", "mulmod", "addmod_scalar",
       "submod_scalar", "submod_scalar_rev", "mulmod_scalar"]
#: the ranges in which each transform gives the oracle's word; it raises in the rest
IN_WINDOW = {"ntt": ("lt2q", "2q_4q"), "intt": ("lt2q",)}


def words(rng, rng_name, size=N):
    lo, hi = RANGES[rng_name]
    w = rng.integers(lo, hi, size=size, dtype=np.uint64)
    w[:2] = [lo, hi - 1]
    return w


def alu(be, op, a, b, s):
    if op in ("lazy_reduce", "modred"):
        return getattr(be, op)(a, Q)
    if op.endswith("_scalar"):
        return getattr(be, op)(a, s, Q)
    if op == "submod_scalar_rev":
        return be.submod_scalar(a, s, Q, reverse=True)
    return getattr(be, op)(a, b, Q)


@pytest.mark.parametrize("rng_name", sorted(RANGES))
@pytest.mark.parametrize("op", ALU)
def test_alu_ops_give_the_oracles_word_in_every_range(op, rng_name):
    rng = np.random.default_rng(ALU.index(op) * 10 + sorted(RANGES).index(rng_name))
    a, b = words(rng, rng_name), words(rng, rng_name)[::-1].copy()
    s = int(rng.integers(0, 1 << 60))  # an immediate inside the datapath
    got = BE.unwrap(alu(BE, op, BE.wrap(a), BE.wrap(b), s))
    assert np.array_equal(got, alu(NP, op, a, b, s)), op


def one_transform(asm_cls, cfg, inverse: bool):
    a = asm_cls()
    a.vsetvl(cfg.n * 64).set_modulus(cfg, 0).vle(0, 0, 0)
    (a.vintt if inverse else a.vntt)(2, 0)
    a.vse(2, 2, 0).vbreak()
    return a.prog


def spm_of(x):
    spm = np.zeros((2 * PR, NUM_LANES), dtype=np.uint64)
    spm[:PR] = x.reshape(PR, NUM_LANES)
    return spm


@pytest.mark.parametrize("rng_name", sorted(RANGES))
@pytest.mark.parametrize("op", ["ntt", "intt"])
def test_transforms_give_the_oracles_word_or_raise(op, rng_name):
    inverse = op == "intt"
    spm = spm_of(words(np.random.default_rng(7 + sorted(RANGES).index(rng_name)), rng_name))
    want = jinterp.VectorProcessor(JCFG).run(one_transform(jprog.Asm, JCFG, inverse), spm.copy(),
                                             None, jinterp.LaunchArgs(rslt=PR))
    vp = VectorProcessor(CFG, BE)
    prog, args = one_transform(programs.Asm, CFG, inverse), LaunchArgs(rslt=PR)
    if rng_name in IN_WINDOW[op]:
        assert np.array_equal(BE.unwrap(vp.run(prog, BE.wrap(spm), None, args)), want)
    else:
        with pytest.raises(ValueError, match="window"):
            vp.run(prog, BE.wrap(spm), None, args)
        # the flag is per launch: the next launch in the window runs
        ok = spm_of(words(np.random.default_rng(1), "lt2q"))
        vp.run(prog, BE.wrap(ok), None, args)


def test_forward_window_stops_at_4q():
    """Every word below 2^63, yet the oracle's forward transform is not the
    transform of the reduced word: x[0] = 2^63 - 1 and the partners of
    element 0 chosen so that each stage's twiddle product is q - 1, which
    takes only q + 1 off x[0] per stage.  The port raises on it."""
    psis = ntt_np.psi_powers_bitrev(N, CFG.psi[0], Q)
    x = np.zeros(N, dtype=np.uint64)
    x[0] = np.uint64((1 << 63) - 1)
    for k in range(CFG.logn):
        x[N >> (k + 1)] = np.uint64((Q - 1) * pow(int(psis[1 << k]), -1, Q) % Q)
    ref = ntt_np.ntt(x, Q, CFG.psi[0])
    assert int(x.max()) < 1 << 63 and int(ref[0]) >= 2 * Q
    assert not np.array_equal(ref, ntt_np.ntt(x % np.uint64(Q), Q, CFG.psi[0]))
    with pytest.raises(ValueError, match="window"):
        VectorProcessor(CFG, BE).run(one_transform(programs.Asm, CFG, False), BE.wrap(spm_of(x)),
                                     None, LaunchArgs(rslt=PR))


def test_make_executable_accepts_program_key():
    """make_executable(cfg, program, args, program_key=...) as the JAX
    package's is called: the key is ignored, the cache stays keyed by the
    program's contents; the key-switch at n = 1024 against the JAX one."""
    k = CFG.n // 1024
    cfg = HEConfig(n=1024, psi=tuple(pow(p, k, q) for p, q in zip(CFG.psi, CFG.moduli)),
                   ipsi=tuple(pow(p, k, q) for p, q in zip(CFG.ipsi, CFG.moduli)))
    jcfg = __graft_entry__._small_cfg(1024)
    rng = np.random.default_rng(5)
    pr = cfg.n // NUM_LANES
    spm = np.zeros((16 * pr, NUM_LANES), dtype=np.uint64)
    for i in range(4):
        spm[i * pr:(i + 1) * pr] = rng.integers(0, cfg.moduli[i % 2], (pr, NUM_LANES),
                                                dtype=np.uint64)
    ksk = np.stack([rng.integers(0, cfg.moduli[p // 4], size=cfg.n, dtype=np.uint64)
                    for p in range(12)]).reshape(-1, NUM_LANES)
    step = pow(3, 2, 2 * cfg.n)
    exe = make_executable(cfg, programs.keyswitch(cfg), LaunchArgs(rslt=8 * pr, step=step),
                          program_key="keyswitch-test")
    jbe = JaxBackend()
    jexe = jax_make_executable(jcfg, jprog.keyswitch(jcfg),
                               jinterp.LaunchArgs(rslt=8 * pr, step=step),
                               program_key="keyswitch-test")
    want = jbe.unwrap(jexe(jbe.wrap(spm), jbe.wrap(ksk)))
    got = BE.unwrap(exe(BE.wrap(spm), BE.wrap(ksk)))
    assert np.array_equal(got, want)
    assert make_executable(cfg, programs.keyswitch(cfg), LaunchArgs(rslt=8 * pr, step=step),
                           program_key="another-key") is exe
    assert make_executable(cfg, programs.hom_add(cfg), LaunchArgs(rslt=8 * pr, step=step),
                           program_key="keyswitch-test") is not exe
