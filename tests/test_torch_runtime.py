"""The port's runtime against the JAX package's.

`runtime.device`, `runtime.host`, `trace_db` and `profiling`:

- devices: the port's `AlohaDevice(device="cpu")` and the JAX package's
  driven side by side with keys from `aloha_tpu.keys` carried across (the
  tests/test_keys.py:67-114 flows: `run_rotate` step 4, `run_rotate_any`
  step 5 = 1 + 4 and a single-bit step), word-exact against each other and
  against `he_np.rotate`, decrypting to the rotated slots;
- host runner: one op-list (load, encode through the caller's encoder,
  mul_plain, hom_add, rotate, store) through both `HostRunner`s;
- files across packages: checkpoints and `.tdb` traces written by one
  package and read by the other, with words of all 64 bits;
- status, version check, the profiler and its device trace.

The key-switch flows run at n = 1024 (roots scaled as
`__graft_entry__._small_cfg` scales them; the N = 8192 replay is in
tests/test_torch_isa.py).  Exact integer arithmetic: every comparison of
words is word-exact.
"""

import functools
import json

import numpy as np
import pytest
import torch

import __graft_entry__
from aloha_tpu import encoder as jencoder
from aloha_tpu import he_np, keys
from aloha_tpu import trace_db as jtrace_db
from aloha_tpu.isa import interp as jinterp
from aloha_tpu.isa import programs as jprog
from aloha_tpu.runtime import device as jdevice
from aloha_tpu.runtime import host as jhost
from aloha_tpu_torch import encoder, profiling, trace_db
from aloha_tpu_torch.config import DEFAULT_CONFIG, NUM_LANES, HEConfig
from aloha_tpu_torch.isa import programs
from aloha_tpu_torch.isa.interp import LaunchArgs, VectorProcessor
from aloha_tpu_torch.runtime import device as tdevice
from aloha_tpu_torch.runtime import host as thost
from aloha_tpu_torch.torch_backend import TorchBackend

torch.set_num_threads(2)

n = 1024
JCFG = __graft_entry__._small_cfg(n)
CFG = HEConfig(n=n, psi=JCFG.psi, ipsi=JCFG.ipsi)
S = n // 2
PR = n // NUM_LANES
CT_WORDS = 4 * n
BE = TorchBackend("cpu")


@pytest.fixture(scope="module")
def sk():
    return keys.gen_secret(JCFG, np.random.default_rng(7))


def _encrypt_slots(z, sk, seed):
    pt = jencoder.encode(jencoder.cleartext_from_slots(z), JCFG)
    q = JCFG.moduli[0]
    signed = np.where(pt[0] > q // 2, pt[0].astype(np.int64) - np.int64(q),
                      pt[0].astype(np.int64))
    return keys.encrypt(signed, sk, JCFG, np.random.default_rng(seed))


def _slots(flat, sk):
    m = keys.decrypt(he_np.Ciphertext.from_flat(flat), sk, JCFG)
    res = np.where(m < 0, m + np.int64(JCFG.moduli[0]), m).astype(np.uint64)
    return jencoder.decode(res[None, :], JCFG, limb=0)


def _devices():
    return tdevice.AlohaDevice(CFG, device="cpu"), jdevice.AlohaDevice(JCFG)


def test_defaults_and_layout_match_the_jax_device():
    dev = tdevice.AlohaDevice(DEFAULT_CONFIG, device="cpu")
    jdev = jdevice.AlohaDevice()
    assert dev.device == torch.device("cpu") and tdevice.VERSION == jdevice.VERSION
    assert dev.status() == jdev.status()
    assert tuple(dev.spm.shape) == (16384, NUM_LANES) and tuple(dev.ksk_mem.shape) == (9216, 128)
    assert dev.spm.dtype == torch.int64
    assert dev.ksk_slot_rows() == jdev.ksk_slot_rows()
    for c in (1, 2, 4, 8, 2048):
        assert dev.rotation_ksk_ptr(c) == jdev.rotation_ksk_ptr(c)
    assert dev.rotation_ksk_ptr(1) + dev.ksk_slot_rows() == 9216  # the last slot
    assert TorchBackend().device.type == "cuda"  # the card unless the caller asks
    for bad in (3, 0):
        with pytest.raises(ValueError):
            dev.rotation_ksk_ptr(bad)
    with pytest.raises(ValueError, match="power of two"):
        dev.run_rotate(dest=256, src=0, step=3)


def test_run_rotate_step4_side_by_side(sk):
    """tests/test_keys.py::test_rotation_key_through_isa_replay on both devices."""
    rng = np.random.default_rng(1)
    z = rng.uniform(-1, 1, size=S) + 1j * rng.uniform(-1, 1, size=S)
    ct = _encrypt_slots(z, sk, 6)
    ksk = keys.gen_rotation_key(sk, 4, JCFG, np.random.default_rng(8))
    dev, jdev = _devices()
    for d in (dev, jdev):
        d.dma_load_ksk(ksk, row=(2 - 1) * 12 * d.poly_rows)  # slot for step 4
        d.load_cipher(0, ct.to_flat())
        d.run_rotate(dest=4 * PR, src=0, step=4)
    out = dev.store_cipher(4 * PR)
    assert np.array_equal(out, jdev.store_cipher(4 * PR))
    assert np.array_equal(out, he_np.rotate(ct, 4, ksk, JCFG).to_flat())
    assert np.abs(_slots(out, sk) - np.roll(z, -4)).max() < 1e-4
    assert np.array_equal(dev.store_cipher(0), ct.to_flat())  # the source is kept


def test_run_rotate_any_step5_side_by_side(sk):
    """tests/test_keys.py::test_rotate_any_composition on both devices; the
    step-1 key sits in the last KSK slot."""
    rng = np.random.default_rng(2)
    z = rng.uniform(-1, 1, size=S) + 1j * rng.uniform(-1, 1, size=S)
    ct = _encrypt_slots(z, sk, 14)
    ksk = {c: keys.gen_rotation_key(sk, c, JCFG, np.random.default_rng(20 + c)) for c in (1, 4)}
    dev, jdev = _devices()
    for d in (dev, jdev):
        for c, k in ksk.items():
            d.dma_load_ksk(k, row=d.rotation_ksk_ptr(c))
        d.load_cipher(0, ct.to_flat())
        d.run_rotate_any(dest=4 * PR, src=0, step=5, scratch=8 * PR)
    out = dev.store_cipher(4 * PR)
    assert np.array_equal(out, jdev.store_cipher(4 * PR))
    func = he_np.rotate(he_np.rotate(ct, 1, ksk[1], JCFG), 4, ksk[4], JCFG)
    assert np.array_equal(out, func.to_flat())
    assert np.abs(_slots(out, sk) - np.roll(z, -5)).max() < 1e-4
    with pytest.raises(ValueError, match="scratch"):
        dev.run_rotate_any(dest=4 * PR, src=0, step=5)
    # single-bit steps need no scratch; the key may come as a tensor
    dev.dma_load_ksk(torch.from_numpy(ksk[4].view(np.int64)), row=dev.rotation_ksk_ptr(4))
    dev.run_rotate_any(dest=4 * PR, src=0, step=4)
    assert np.array_equal(dev.store_cipher(4 * PR), he_np.rotate(ct, 4, ksk[4], JCFG).to_flat())


def test_host_runner_op_list_against_jax_host_runner(sk):
    rng = np.random.default_rng(3)
    cts = [_encrypt_slots(rng.uniform(-1, 1, S) + 1j * rng.uniform(-1, 1, S), sk, 30 + i)
           for i in range(2)]
    clear = jencoder.cleartext_from_slots(rng.uniform(-1, 1, S) + 1j * rng.uniform(-1, 1, S))
    ksk2 = keys.gen_rotation_key(sk, 2, JCFG, np.random.default_rng(33))
    ct_bytes = CT_WORDS * 8
    prog = "\n".join([
        f"10000000,00000000,{0:08x}",                 # load ct0 -> row 0
        f"10000{4 * PR:03x},00000000,{ct_bytes:08x}",  # load ct1 -> row 4PR
        f"30000{8 * PR:03x},00000000,00000000",        # encode clear -> row 8PR
        f"50000{12 * PR:03x},00000000,{8 * PR:08x}",   # mul_plain ct0 x pt
        f"60000{16 * PR:03x},{12 * PR:08x},{4 * PR:08x}",  # hom_add
        f"70000{20 * PR:03x},00000002,{16 * PR:08x}",  # rotate by 2
        f"40000{24 * PR:03x},{8 * PR:08x},00000000",   # encode_post of the pt
        f"20000{20 * PR:03x},00000000,{2 * ct_bytes:08x}",  # store
        f"20000{12 * PR:03x},00000000,{3 * ct_bytes:08x}",
    ])
    words = 1 << 21
    runner = thost.HostRunner(tdevice.AlohaDevice(CFG, device="cpu"), CFG, dram_words=words,
                              encoder=functools.partial(encoder.encode, cfg=CFG))
    jrunner = jhost.HostRunner(jdevice.AlohaDevice(JCFG), JCFG, dram_words=words,
                               encoder=functools.partial(jencoder.encode, cfg=JCFG))
    for r in (runner, jrunner):
        for i, ct in enumerate(cts):
            r.load_dram(thost.DRAM_VP_BASE + i * ct_bytes, ct.to_flat())
        r.load_dram(thost.DRAM_ENCODER_BASE, clear.view(np.uint64))
        r.dev.dma_load_ksk(ksk2, row=0)
        r.run(prog)
    assert [vars(t[0]) for t in runner.trace] == [vars(t[0]) for t in jrunner.trace]
    assert np.array_equal(runner.dram, jrunner.dram)
    assert np.array_equal(runner.dev.store_poly(24 * PR, 2), jrunner.dev.store_poly(24 * PR, 2))
    assert np.array_equal(BE.unwrap(runner.dev.spm), jrunner.dev.spm)
    stored = runner.read_dram(thost.DRAM_VP_BASE + 2 * ct_bytes, CT_WORDS)
    assert stored.any()
    assert thost.parse_op_list(prog) == [thost.Op(**vars(o)) for o in jhost.parse_op_list(prog)]


def test_encode_without_encoder_raises():
    r = thost.HostRunner(tdevice.AlohaDevice(CFG, device="cpu"), CFG, dram_words=1 << 21)
    with pytest.raises(NotImplementedError, match="encoder"):
        r.run("30000100,00000000,00000000")
    with pytest.raises(ValueError, match="unknown op"):
        thost.parse_op_list("90000000,00000000,00000000")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_across_packages(tmp_path, writer):
    """A checkpoint of either device loads into the other, every bit kept
    (words up to 2^64 - 1: the port holds them as an int64 bit view)."""
    rng = np.random.default_rng(4)
    spm = rng.integers(0, 1 << 64, size=(64, NUM_LANES), dtype=np.uint64)
    ksk = rng.integers(0, 1 << 64, size=(32, NUM_LANES), dtype=np.uint64)
    spm[0, :4] = [0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    port = tdevice.AlohaDevice(CFG, device="cpu", spm_rows=64, ksk_rows=32)
    jax_dev = jdevice.AlohaDevice(JCFG, spm_rows=64, ksk_rows=32)
    src, dst = (port, jax_dev) if writer == "port" else (jax_dev, port)
    src.dma_write_spm(0, spm)
    src.dma_load_ksk(ksk)
    path = tmp_path / "ckpt.npz"
    src.save_state(path)
    dst.load_state(path)
    assert np.array_equal(dst.dma_read_spm(0, 64), spm)
    assert np.array_equal(np.asarray(dst.be.unwrap(dst.ksk_mem)), ksk)
    assert dst.status() == src.status()


def test_checkpoint_version_mismatch(tmp_path):
    dev = tdevice.AlohaDevice(CFG, device="cpu", spm_rows=8, ksk_rows=8)
    p = tmp_path / "ckpt.npz"
    dev.save_state(p)
    with np.load(p) as d:
        np.savez(p, spm=d["spm"], ksk_mem=d["ksk_mem"], version=np.uint64(0xDEAD))
    with pytest.raises(ValueError, match="version"):
        dev.load_state(p)


def _trace_spm():
    rng = np.random.default_rng(17)
    spm = np.zeros((16 * PR, NUM_LANES), dtype=np.uint64)
    for i in range(8):
        spm[i * PR:(i + 1) * PR] = rng.integers(0, CFG.moduli[i % 2], size=(PR, NUM_LANES),
                                               dtype=np.uint64)
    return spm


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trace_files_across_packages(tmp_path, writer):
    """A .tdb recorded and written by one package is read by the other and
    verifies instruction by instruction against its replay."""
    spm = _trace_spm()
    path = tmp_path / "mul_plain.tdb"
    if writer == "port":
        rows = trace_db.record(VectorProcessor(CFG, BE), programs.mul_plain(CFG), BE.wrap(spm),
                               None, LaunchArgs(src1=4 * PR, rslt=8 * PR))
        trace_db.write(path, rows, n)
        back = jtrace_db._read_python(path)
        bad = jtrace_db.verify(jinterp.VectorProcessor(JCFG), jprog.mul_plain(JCFG), spm.copy(),
                               None, jinterp.LaunchArgs(src1=4 * PR, rslt=8 * PR), back)
    else:
        rows = jtrace_db.record(jinterp.VectorProcessor(JCFG), jprog.mul_plain(JCFG), spm.copy(),
                                None, jinterp.LaunchArgs(src1=4 * PR, rslt=8 * PR))
        jtrace_db.write(path, rows, n)
        back = trace_db.read(path)
        bad = trace_db.verify(VectorProcessor(CFG, BE), programs.mul_plain(CFG), BE.wrap(spm),
                              None, LaunchArgs(src1=4 * PR, rslt=8 * PR), back)
    assert len(back) == len(rows) > 0
    for a, b in zip(rows, back):
        assert a.pc == b.pc and a.instr.encode() == b.instr.encode()
        assert np.array_equal(a.result, b.result)
    assert bad == []


def test_trace_verify_reports_divergence_and_bad_files(tmp_path):
    spm = _trace_spm()
    args = LaunchArgs(src1=4 * PR, rslt=8 * PR)
    vp = VectorProcessor(CFG, BE)
    rows = trace_db.record(vp, programs.hom_add(CFG), BE.wrap(spm), None, args)
    rows[3].result = rows[3].result.copy()
    rows[3].result[:5] ^= np.uint64(1)
    bad = trace_db.verify(vp, programs.hom_add(CFG), BE.wrap(spm), None, args, rows)
    assert bad == [(rows[3].pc, rows[3].instr.disasm(), 5)]
    with pytest.raises(ValueError, match="length"):
        trace_db.verify(vp, programs.hom_add(CFG), BE.wrap(spm), None, args, rows[:-1])
    junk = tmp_path / "junk.tdb"
    junk.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="not a trace"):
        trace_db.read(junk)


def test_profiler_records_launches_and_exports_a_trace(tmp_path):
    prof = profiling.Profiler(trace_dir=str(tmp_path))
    dev = profiling.profile_device(tdevice.AlohaDevice(CFG, device="cpu", spm_rows=128,
                                                       ksk_rows=8), prof)
    with prof.device_trace("hom_add") as p:
        dev.run_hom_add(dest=8 * PR, src1=0, src2=0)
    dev.run_hom_add(dest=8 * PR, src1=0, src2=0)
    summary = prof.summary()
    (name,) = summary
    assert name == f"run_vp[pc={programs.ISRAM_HOM_ADD}]"
    assert summary[name]["count"] == 2 and summary[name]["total_s"] > 0
    assert summary[name]["max_s"] >= summary[name]["mean_s"] > 0
    assert p is not None and len(p.key_averages()) > 0
    assert "traceEvents" in json.loads((tmp_path / "hom_add.json").read_text())
    with profiling.Profiler().device_trace() as none:
        assert none is None


@pytest.mark.parametrize("starts, busy", [((0.0, 10.0, 20.0), 4.0), ((0.0, 1.5, 2.0), 2.5)],
                         ids=["apart", "overlapping"])
def test_trace_device_events_counts_the_cards_work(tmp_path, starts, busy):
    """The busy time of a trace is the union of the intervals of its
    kernels, copies and fills: apart they add, overlapping (a copy beside a
    kernel, [0, 2.5) with [1.5, 2.5) and [2, 2.5)) they count once; host
    events do not count (a CPU trace has none of the card's)."""
    events = [{"cat": "kernel", "ts": starts[0], "dur": 2.5},
              {"cat": "gpu_memcpy", "ts": starts[1], "dur": 1.0},
              {"cat": "gpu_memset", "ts": starts[2], "dur": 0.5},
              {"cat": "cpu_op", "ts": 0.0, "dur": 100.0},
              {"cat": "cuda_runtime", "ts": 0.0, "dur": 7.0}, {"ph": "M"}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiling.trace_device_events(path) == (3, busy)
    prof = profiling.Profiler(trace_dir=str(tmp_path))
    with prof.device_trace("cpu"):
        torch.ones(64).sum()
    assert profiling.trace_device_events(tmp_path / "cpu.json") == (0, 0)
