"""The port's HE vector ISA (`aloha_tpu_torch.isa`, `torch_backend`) against the JAX package's.

- program images: the four canned programs and the full instruction-RAM
  image, hex for hex against `aloha_tpu.isa.programs`, at the default
  config and at an n = 1024 config (roots scaled as
  `__graft_entry__._small_cfg` scales them); encode/decode round trips;
- instructions: every instruction form through `TorchBackend("cpu")`
  against `interp.NumpyBackend` (the program of
  tests/test_runtime_aux.py::test_remaining_isa_instructions);
- replays: each program on a random SPM against
  `VectorProcessor(NumpyBackend)` at N = 8192 (one key-switch replay) and
  against `jax_backend.make_executable` at n = 1024; the caller's SPM stays
  untouched; the port's `make_executable` caches by content and CSRs;
- errors: an even `vaut` step raises, and so does an immediate wider than
  the 60-bit datapath.

Exact integer arithmetic: every comparison is word-exact.
"""

import numpy as np
import pytest
import torch

import __graft_entry__
from aloha_tpu.config import DEFAULT_CONFIG as JCFG
from aloha_tpu.isa import encoding as jenc
from aloha_tpu.isa import interp as jinterp
from aloha_tpu.isa import programs as jprog
from aloha_tpu.jax_backend import JaxBackend
from aloha_tpu.jax_backend import make_executable as jax_make_executable
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch.config import NUM_LANES, HEConfig
from aloha_tpu_torch.isa import encoding, programs
from aloha_tpu_torch.isa.interp import LaunchArgs, VectorProcessor
from aloha_tpu_torch.torch_backend import TorchBackend, make_executable

torch.set_num_threads(2)

N = CFG.n
POLY_ROWS = N // NUM_LANES
BE = TorchBackend("cpu")
PROGRAMS = ["encode_post", "mul_plain", "hom_add", "keyswitch"]


def small_cfg(n: int) -> HEConfig:
    """The port's config at ring degree n, roots psi^(N/n) (the scaling of
    __graft_entry__._small_cfg)."""
    k = CFG.n // n
    return HEConfig(n=n, psi=tuple(pow(p, k, q) for p, q in zip(CFG.psi, CFG.moduli)),
                    ipsi=tuple(pow(p, k, q) for p, q in zip(CFG.ipsi, CFG.moduli)))


CONFIGS = {8192: (CFG, JCFG), 1024: (small_cfg(1024), __graft_entry__._small_cfg(1024))}


def random_spm(cfg, rng, rows):
    """SPM with a random 4-poly ciphertext at row 0 (residues of each limb)
    and a random plaintext at the next 4-poly region."""
    pr = cfg.n // NUM_LANES
    spm = np.zeros((rows, NUM_LANES), dtype=np.uint64)
    for base in (0, 4 * pr):
        for limb in range(cfg.n_limbs):
            for part in range(2):
                row = base + (part * cfg.n_limbs + limb) * pr
                spm[row : row + pr] = rng.integers(
                    0, cfg.moduli[limb], size=(pr, NUM_LANES), dtype=np.uint64)
    return spm


def random_ksk(cfg, rng):
    stride = 2 * cfg.n_limbs
    return np.stack([rng.integers(0, cfg.moduli[p // stride], size=cfg.n, dtype=np.uint64)
                     for p in range(stride * (cfg.n_limbs + 1))]).reshape(-1, NUM_LANES)


def launch_args(cfg, name, cls):
    pr = cfg.n // NUM_LANES
    step = pow(3, 2, 2 * cfg.n) if name == "keyswitch" else 0
    return cls(src0=0, src1=4 * pr, rslt=8 * pr, step=step)


# --------------------------------------------------------------- images
@pytest.mark.parametrize("n", sorted(CONFIGS))
@pytest.mark.parametrize("name", PROGRAMS + ["isram_image"])
def test_program_images_hex_identical(n, name):
    cfg, jcfg = CONFIGS[n]
    ours = [i.hex() for i in getattr(programs, name)(cfg)]
    assert ours == [i.hex() for i in getattr(jprog, name)(jcfg)]
    assert len(ours) == (4096 if name == "isram_image" else len(ours))


def test_isram_offsets_and_keyswitch_mix():
    assert (programs.ISRAM_ENCODE_POST, programs.ISRAM_MUL_PLAIN, programs.ISRAM_HOM_ADD,
            programs.ISRAM_KEYSWITCH) == (jprog.ISRAM_ENCODE_POST, jprog.ISRAM_MUL_PLAIN,
                                          jprog.ISRAM_HOM_ADD, jprog.ISRAM_KEYSWITCH)
    mix = [i.funct6 for i in programs.keyswitch(CFG)]
    F = encoding.Funct6
    L = CFG.n_limbs
    assert (mix.count(F.VNTT), mix.count(F.VINTT), mix.count(F.VAUT)) == (
        L * (L + 1) + L + 2 * L, 2 * L + 2, 2 * L)


def test_encode_decode_roundtrip_and_disasm():
    for name in PROGRAMS:
        for instr, jinstr in zip(getattr(programs, name)(CFG), getattr(jprog, name)(JCFG)):
            assert encoding.Instr.decode(instr.hex()) == instr
            assert encoding.Instr.decode(instr.encode()) == instr
            assert instr.disasm() == jinstr.disasm()
            assert jenc.Instr.decode(instr.hex()).encode() == instr.encode()
    prog = programs.keyswitch(CFG)
    text = "// a comment line\n" + encoding.dump_program(prog)
    assert encoding.load_program(text.splitlines()) == prog
    assert encoding.dump_program(prog) == jenc.dump_program(jprog.keyswitch(JCFG))


def test_vv_bank_constraint_enforced():
    with pytest.raises(ValueError, match="bank"):
        programs.Asm().vfqadd(2, 0, 2)  # both even


# ----------------------------------------------------------- instructions
def _all_forms(asm_cls, cfg):
    """vroli / vcpy / vfqmod / vfqsub.sv / vaut with an immediate, and the
    .vv/.vs ALU forms (tests/test_runtime_aux.py:62, extended)."""
    a = asm_cls()
    a.vsetvl(cfg.n * 64)
    a.set_modulus(cfg, 1)
    a.vle(0, 0, 0)
    a.vroli(2, 0, 5)             # cyclic rotate by 5
    a.vse(2, 2, 0)
    a.set_modulus(cfg, 0)
    a.vfqmod(4, 0)               # reduce q1-residues into q0
    a.vse(4, 2, 0x10000)
    a.vfqsub_sv(6, 4, 12345)     # 12345 - x mod q0
    a.vse(6, 2, 0x20000)
    a.vcpy(8, 6)
    a.vaut(8, 8, 3)              # aut with immediate step (csr step = 0)
    a.vse(8, 2, 0x30000)
    a.vle(1, 1, 0)
    a.vfqmul(10, 8, 1)
    a.vfqadd(12, 10, 1)
    a.vfqsub(14, 12, 1)
    a.vfqmul_vs(16, 14, cfg.pinv_mod(0))
    a.vfqadd_vs(18, 16, (cfg.special_prime - 1) // 2)
    a.vfqsub_vs(20, 18, 777)
    a.vntt(22, 20)
    a.vintt(24, 22)
    a.vse(24, 2, 0x40000)
    a.vbreak()
    return a.prog


def test_every_instruction_form_against_numpy_backend():
    rng = np.random.default_rng(23)
    q0, q1 = CFG.moduli[0], CFG.moduli[1]
    spm = np.zeros((1024, NUM_LANES), dtype=np.uint64)
    spm[:POLY_ROWS] = rng.integers(0, q1, size=(POLY_ROWS, NUM_LANES), dtype=np.uint64)
    spm[POLY_ROWS : 2 * POLY_ROWS] = rng.integers(0, q0, size=(POLY_ROWS, NUM_LANES),
                                                  dtype=np.uint64)
    jargs = jinterp.LaunchArgs(src1=POLY_ROWS, rslt=256)
    want_trace, got_trace = [], []
    want = jinterp.VectorProcessor(JCFG).run(_all_forms(jprog.Asm, JCFG), spm.copy(), None,
                                             jargs, trace=want_trace)
    got = VectorProcessor(CFG, BE).run(_all_forms(programs.Asm, CFG), BE.wrap(spm), None,
                                       LaunchArgs(src1=POLY_ROWS, rslt=256), trace=got_trace)
    assert np.array_equal(BE.unwrap(got), want)
    assert len(got_trace) == len(want_trace) == 20
    for (pc, instr, val), (jpc, jinstr, jval) in zip(got_trace, want_trace):
        assert pc == jpc and instr.encode() == jinstr.encode()
        assert np.array_equal(val, jval), instr.disasm()


def aut_then_ntt(asm_cls, cfg):
    """vaut, then vntt of its output: the literal q - x turns a 0 into q,
    so the transform is fed words at q (inside its < 4q window)."""
    a = asm_cls()
    a.vsetvl(cfg.n * 64)
    a.set_modulus(cfg, 0)
    a.vle(0, 0, 0)
    a.vaut(2, 0, 0)
    a.vntt(4, 2)
    a.vse(2, 2, 0)
    a.vse(4, 2, cfg.n * 8)
    a.vbreak()
    return a.prog


def aut_window_spm(cfg, rng):
    """One polynomial under q0 with every third word 0 and every third q."""
    q, pr = cfg.moduli[0], cfg.n // NUM_LANES
    x = rng.integers(0, q, size=cfg.n, dtype=np.uint64)
    x[::3] = 0
    x[1::3] = np.uint64(q)
    spm = np.zeros((4 * pr, NUM_LANES), dtype=np.uint64)
    spm[:pr] = x.reshape(pr, NUM_LANES)
    return spm


def test_aut_output_at_q_feeds_the_ntt():
    spm = aut_window_spm(CFG, np.random.default_rng(29))
    step = pow(3, 2, 2 * N)
    want = jinterp.VectorProcessor(JCFG).run(aut_then_ntt(jprog.Asm, JCFG), spm.copy(), None,
                                             jinterp.LaunchArgs(rslt=POLY_ROWS, step=step))
    got = BE.unwrap(VectorProcessor(CFG, BE).run(aut_then_ntt(programs.Asm, CFG), BE.wrap(spm),
                                                 None, LaunchArgs(rslt=POLY_ROWS, step=step)))
    assert np.array_equal(got, want)
    assert (got[POLY_ROWS : 2 * POLY_ROWS] == np.uint64(CFG.moduli[0])).sum() > N // 4


# ----------------------------------------------------------------- replays
@pytest.mark.parametrize("name", PROGRAMS)
def test_replay_against_numpy_backend_n8192(name):
    """Each program at N = 8192 on a random SPM (and random keys) against
    the NumPy oracle; the caller's SPM and KSK tensors stay untouched."""
    rng = np.random.default_rng(31 + PROGRAMS.index(name))
    spm, ksk = random_spm(CFG, rng, 1024), random_ksk(CFG, rng)
    want = jinterp.VectorProcessor(JCFG).run(getattr(jprog, name)(JCFG), spm.copy(), ksk,
                                             launch_args(JCFG, name, jinterp.LaunchArgs))
    s, k = BE.wrap(spm), BE.wrap(ksk)
    got = VectorProcessor(CFG, BE).run(getattr(programs, name)(CFG), s, k,
                                       launch_args(CFG, name, LaunchArgs))
    assert np.array_equal(BE.unwrap(got), want)
    assert np.array_equal(BE.unwrap(s), spm) and np.array_equal(BE.unwrap(k), ksk)
    assert not np.array_equal(want, spm)


@pytest.mark.parametrize("name", PROGRAMS)
def test_make_executable_against_jax_make_executable_n1024(name):
    cfg, jcfg = CONFIGS[1024]
    rng = np.random.default_rng(41 + PROGRAMS.index(name))
    spm, ksk = random_spm(cfg, rng, 128), random_ksk(cfg, rng)
    jbe = JaxBackend()
    jexe = jax_make_executable(jcfg, getattr(jprog, name)(jcfg),
                               launch_args(jcfg, name, jinterp.LaunchArgs))
    want = jbe.unwrap(jexe(jbe.wrap(spm), jbe.wrap(ksk)))
    args = launch_args(cfg, name, LaunchArgs)
    exe = make_executable(cfg, getattr(programs, name)(cfg), args)
    s = BE.wrap(spm)
    got = exe(s, BE.wrap(ksk))
    assert np.array_equal(BE.unwrap(got), want)
    assert np.array_equal(BE.unwrap(s), spm)
    # a second launch reuses the executable and gives the same words
    assert make_executable(cfg, getattr(programs, name)(cfg), args) is exe
    assert torch.equal(exe(s, BE.wrap(ksk)), got)


def test_make_executable_is_keyed_by_content_and_csrs():
    cfg = CONFIGS[1024][0]
    args = LaunchArgs(rslt=64)
    exe = make_executable(cfg, programs.hom_add(cfg), args)
    assert make_executable(cfg, programs.mul_plain(cfg), args) is not exe
    assert make_executable(cfg, programs.hom_add(cfg), LaunchArgs(rslt=128)) is not exe
    assert make_executable(cfg, list(programs.hom_add(cfg)), LaunchArgs(rslt=64)) is exe


# ------------------------------------------------------------------ errors
def test_even_vaut_step_raises():
    """X -> X^e is no bijection for an even e: the NumPy oracle leaves
    slots unwritten, the port raises."""
    cfg = CONFIGS[1024][0]
    spm = BE.wrap(random_spm(cfg, np.random.default_rng(3), 128))
    vp = VectorProcessor(cfg, BE)
    with pytest.raises(ValueError, match="even"):
        vp.run(programs.keyswitch(cfg), spm, BE.zeros((96, NUM_LANES)), LaunchArgs(step=4))
    a = programs.Asm()
    a.vle(0, 0, 0).vaut(2, 0, 1).vse(2, 2, 0).vbreak()
    vp.run(a.prog, spm, None, LaunchArgs(rslt=64, step=2))  # 2 + 1 is odd
    with pytest.raises(ValueError, match="even"):
        vp.run(a.prog, spm, None, LaunchArgs(rslt=64, step=1))


def test_immediate_wider_than_datapath_raises():
    a = programs.Asm()
    a.vsetvl(1024 * 64).vle(0, 0, 0).vfqadd_vs(2, 0, 1 << 61).vbreak()
    with pytest.raises(ValueError, match="60-bit"):
        VectorProcessor(CONFIGS[1024][0], BE).run(a.prog, BE.zeros((64, NUM_LANES)))


def test_bad_modulus_and_barrett_constant_raise():
    cfg = CONFIGS[1024][0]
    vp = VectorProcessor(cfg, BE)
    with pytest.raises(ValueError, match="not in config"):
        vp.run(programs.Asm().vsetq(97).vbreak().prog, BE.zeros((8, NUM_LANES)))
    with pytest.raises(ValueError, match="inconsistent"):
        vp.run(programs.Asm().vsetq(cfg.moduli[0]).vsetiq(5).vbreak().prog,
               BE.zeros((8, NUM_LANES)))
