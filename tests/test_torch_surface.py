"""The port's surface: no JAX, no CPU fallback on the card path, state conversion.

- `import aloha_tpu_torch` and every submodule works with `jax` and
  `aloha_tpu` blocked (checked in a fresh interpreter), and no module of
  the port nor `chip_smoke.py` imports either (checked with `ast`);
- the CUDA wrappers import and dispatch without nvcc; building without
  nvcc raises instead of falling back;
- `python chip_smoke.py` on a host without CUDA exits nonzero and prints
  no result, in the repo and alone in an empty directory;
- convert round-trips u64 arrays, (lo, hi) planes and tensors.
"""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from aloha_tpu import he_planes
from aloha_tpu.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch import _build, convert as cv
from aloha_tpu_torch.ops import aut, dispatch, ks_kernel, ntt_mxu, ntt_pallas, ntt_stream
from aloha_tpu_torch.probes import (dma_bisect, dma_bisect_doublebuf, dma_bisect_stages,
                                    dma_bisect_tblread, op_probe, probe_dynstage, probe_dynsub,
                                    probe_mxu, probe_mxu_parts, stream_prof, stream_prof2,
                                    stream_prof3)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _run(args, cwd, timeout=300):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


BLOCKED = ("jax", "jaxlib", "aloha_tpu")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_import_leaves_jax_out():
    """Every module of the port imports with jax and aloha_tpu blocked (an
    entry of None in sys.modules makes their import raise), and neither
    they nor chip_smoke.py name either package in an import statement."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"for name in {BLOCKED!r}: sys.modules[name] = None\n"
        "import aloha_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(aloha_tpu_torch.__path__,"
        " 'aloha_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "assert {'aloha_tpu_torch.ops.ntt_mxu', 'aloha_tpu_torch.bench', 'aloha_tpu_torch.keys',"
        " 'aloha_tpu_torch.parallel.dryrun', 'aloha_tpu_torch.ops.ntt_pallas',"
        " 'aloha_tpu_torch.encoder_torch', 'aloha_tpu_torch.encoder_hw', 'aloha_tpu_torch.ops.aut',"
        " 'aloha_tpu_torch.isa.encoding', 'aloha_tpu_torch.isa.programs',"
        " 'aloha_tpu_torch.isa.interp', 'aloha_tpu_torch.torch_backend',"
        " 'aloha_tpu_torch.runtime.device', 'aloha_tpu_torch.runtime.host',"
        " 'aloha_tpu_torch.trace_db', 'aloha_tpu_torch.profiling',"
        " 'aloha_tpu_torch.probes.common', 'aloha_tpu_torch.probes.op_probe',"
        " 'aloha_tpu_torch.probes.stream_prof', 'aloha_tpu_torch.probes.stream_prof2',"
        " 'aloha_tpu_torch.probes.stream_prof3', 'aloha_tpu_torch.probes.probe_mxu',"
        " 'aloha_tpu_torch.probes.probe_mxu_parts', 'aloha_tpu_torch.probes.probe_dynstage',"
        " 'aloha_tpu_torch.probes.probe_dynsub', 'aloha_tpu_torch.probes.dma_bisect',"
        " 'aloha_tpu_torch.probes.dma_bisect_doublebuf',"
        " 'aloha_tpu_torch.probes.dma_bisect_stages',"
        " 'aloha_tpu_torch.probes.dma_bisect_tblread', 'aloha_tpu_torch.opbench',"
        " 'aloha_tpu_torch.native', 'aloha_tpu_torch.client',"
        " 'aloha_tpu_torch.parallel.coeff_sharded', 'aloha_tpu_torch.scaling',"
        " 'aloha_tpu_torch.entry'} <= set(names)\n"
        "print(len(names), sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'triton', 'aloha_tpu') and sys.modules[k] is not None))\n"
    )
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr
    count, loaded = res.stdout.strip().split(" ", 1)
    assert int(count) >= 30
    assert loaded == "[]"
    files = sorted((ROOT / "aloha_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        roots = set(_imported_roots(ast.parse(f.read_text())))
        assert not roots & set(BLOCKED), (f, roots & set(BLOCKED))
    assert "aloha_tpu_torch" in set(_imported_roots(ast.parse((ROOT / "chip_smoke.py").read_text())))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "lib.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert list(tmp_path.iterdir()) == []


def test_library_is_named_by_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libaloha_kernels_") and path.suffix == ".so"
    assert {p.name for p in _build._sources()} >= {"ntt.cu", "ks.cu", "ntt_mxu.cu", "aut.cu",
                                                 "probe_ops.cu", "probe_stages.cu", "probe_mxu.cu",
                                                 "probe_dyn.cu", "probe_dma.cu", "modarith.cuh",
                                                 "mxu_core.cuh"}
    assert set(_build.SIGNATURES) >= {"aloha_ntt", "aloha_ntt_cluster", "aloha_aut",
                                      "aloha_probe_ops",
                                      "aloha_probe_stage_modes",
                                      "aloha_probe_lane_stages", "aloha_probe_mxu_rate",
                                      "aloha_probe_mxu_parts", "aloha_probe_dynstage",
                                      "aloha_probe_dynsub", "aloha_probe_dma_copy",
                                      "aloha_probe_dma_doublebuf", "aloha_probe_dma_tblread",
                                      "aloha_probe_dma_stages"}


def test_library_is_named_by_the_build_commands(monkeypatch):
    """A changed nvcc command line (a flag of the compile or of the link)
    names another library, so a build with other flags is never reused."""
    path = _build.library_path()
    compile_command, link_command = _build.compile_command, _build.link_command
    monkeypatch.setattr(_build, "compile_command",
                        lambda *a: compile_command(*a) + ["-maxrregcount=128"])
    changed = _build.library_path()
    assert changed != path and changed.parent == path.parent
    monkeypatch.setattr(_build, "compile_command", compile_command)
    assert _build.library_path() == path
    monkeypatch.setattr(_build, "link_command", lambda *a: link_command(*a) + ["-lcuda"])
    assert _build.library_path() not in (path, changed)


def test_build_runs_the_hashed_commands(monkeypatch, tmp_path):
    """build() runs compile_command per source, then link_command, and
    moves the library and ptxas' log into place (a stand-in for nvcc
    writes each -o file)."""
    ran = []

    def fake_run(cmds):
        for cmd in cmds:
            ran.append(cmd)
            pathlib.Path(cmd[cmd.index("-o") + 1]).write_text("built")
        return ["ptxas info\n"] * len(cmds)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "cuda_tool", lambda name="nvcc": "nvcc")
    monkeypatch.setattr(_build, "_run_all", fake_run)
    out = _build.build()
    srcs = sorted(_build.CSRC.glob("*.cu"))
    assert [c[:-1] for c in ran[:-1]] == [
        _build.compile_command("nvcc", str(src), "OBJ")[:-1] for src in srcs]
    assert ran[-1][:-len(srcs) - 1] == _build.link_command("nvcc", "LIB", [])[:-1]
    assert ran[-1][-len(srcs):] == [c[-1] for c in ran[:-1]]
    assert out == _build.library_path() and out.read_text() == "built"
    assert _build.log_path().read_text() == "ptxas info\n" * (len(srcs) + 1)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([out.name, _build.log_path().name])


def test_dispatch_routes_by_device():
    x = torch.zeros(3, dtype=torch.int64)
    assert dispatch.use_kernel(x) is False
    with pytest.raises(ValueError, match="no kernel"):
        dispatch.use_kernel(x.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        dispatch.use_kernel(x, x.to("meta"))


def test_wrappers_raise_off_cpu_instead_of_falling_back():
    x = torch.zeros((1, 2, 1024), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        ntt_stream.transform(x, CFG.moduli[:1], CFG.psi[:1], False)
    with pytest.raises(ValueError):
        ntt_mxu.transform(x, CFG.moduli[:1], CFG.psi[:1], False)
    with pytest.raises(ValueError):
        ntt_mxu.chain(x[0], CFG.moduli[0], CFG.psi[0], 2, False)
    with pytest.raises(ValueError):
        ntt_pallas.ntt(x, CFG.moduli[0], pow(CFG.psi[0], 8, CFG.moduli[0]))
    with pytest.raises(ValueError):
        ks_kernel.ks_head(torch.zeros((2, 1, 8192), dtype=torch.int64, device="meta"),
                          None, CFG)
    with pytest.raises(ValueError):
        aut.automorphism(x, 3, CFG.moduli[0])
    p = torch.zeros((2, CFG.n), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        op_probe.probe_ops(p, "v0", 1)
    with pytest.raises(ValueError):
        stream_prof.stage_modes(p, "full", 1)
    with pytest.raises(ValueError):
        stream_prof2.lane_stages(p, "full", 13, 1)
    with pytest.raises(ValueError):
        stream_prof3.fwd_reps(p, 1)
    with pytest.raises(ValueError):
        probe_mxu_parts.parts(p, "full", 1)
    x8 = torch.zeros((8, 64, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        probe_mxu.digit_products(x8, torch.zeros((8, 128, 128), dtype=torch.int8, device="meta"),
                                 1)
    blocks = torch.zeros((2, 64, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        probe_dynstage.dynstage(blocks, torch.zeros((13, 64, 128), dtype=torch.int32,
                                                            device="meta"), 1)
    with pytest.raises(ValueError):
        probe_dynsub.dynsub(blocks, 1)
    with pytest.raises(ValueError):
        dma_bisect.dma_copy(blocks, "copy")
    with pytest.raises(ValueError):
        dma_bisect_doublebuf.doublebuf(blocks)
    with pytest.raises(ValueError):
        dma_bisect_tblread.tblread(torch.zeros((13, 64, 128), dtype=torch.int32, device="meta"),
                                   blocks)
    with pytest.raises(ValueError):
        dma_bisect_stages.stages(p, 4)


@pytest.mark.parametrize("module", ["op_probe", "stream_prof", "stream_prof2", "stream_prof3",
                                    "probe_mxu", "probe_mxu_parts", "probe_dynstage",
                                    "probe_dynsub", "dma_bisect", "dma_bisect_doublebuf",
                                    "dma_bisect_tblread", "dma_bisect_stages", "aut_timing",
                                    "stage_modes_timing", "mxu_timing"])
def test_probe_entry_points_refuse_to_run_without_cuda(module):
    """`python -m aloha_tpu_torch.probes.<module>` measures the card: with
    no CUDA it exits nonzero and prints no measurement (no CPU fallback)."""
    res = _run(["-m", f"aloha_tpu_torch.probes.{module}"], ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "GPU" in res.stderr


def test_opbench_refuses_to_run_without_cuda():
    """`python -m aloha_tpu_torch.opbench` times the card: with no CUDA it
    exits nonzero and prints no row (no CPU fallback unless --device cpu)."""
    res = _run(["-m", "aloha_tpu_torch.opbench", "--ops", "hom_add"], ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "GPU" in res.stderr


def test_device_entry_points_default_to_the_card():
    """AlohaDevice (and so HostRunner) and the ISA backend put their
    memories on `cuda` unless the caller names another device; without a
    card that raises instead of falling back to the CPU."""
    from aloha_tpu_torch.runtime.device import AlohaDevice
    from aloha_tpu_torch.torch_backend import TorchBackend

    assert TorchBackend().device == torch.device("cuda")
    if torch.cuda.is_available():
        assert AlohaDevice().spm.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            AlohaDevice()
    assert AlohaDevice(device="cpu", spm_rows=8, ksk_rows=8).spm.device == CPU


def test_gen_secret_draws_from_the_os_onto_the_card(monkeypatch):
    """`keys.gen_secret(cfg)` with no generator and no device reads its
    coefficients from the OS (17 bytes each, as the JAX package's
    `SecureRng`) and puts the key on `cuda`; without a card that raises
    instead of falling back to the CPU."""
    from aloha_tpu_torch import config, keys

    cfg = config.DEFAULT_CONFIG
    read = []
    urandom = os.urandom
    monkeypatch.setattr(os, "urandom", lambda k: read.append(k) or urandom(k))
    if torch.cuda.is_available():
        assert keys.gen_secret(cfg).ntt.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            keys.gen_secret(cfg)
    assert read == [17 * cfg.n]


def test_check_rejects_bad_operands():
    x = torch.zeros((2, 4), dtype=torch.int64)
    dispatch.check(x, (2, 4), "x")
    with pytest.raises(TypeError):
        dispatch.check(x.to(torch.int32), (2, 4), "x")
    with pytest.raises(ValueError, match="shape"):
        dispatch.check(x, (4, 2), "x")
    with pytest.raises(ValueError, match="contiguous"):
        dispatch.check(x.t(), (4, 2), "x")


def _assert_no_result(res):
    assert res.returncode != 0
    lines = res.stdout.strip().splitlines()
    if lines:
        try:
            last = json.loads(lines[-1])
        except ValueError:
            return
        assert last.get("ok") is not True


def test_chip_smoke_fails_without_cuda():
    _assert_no_result(_run(["chip_smoke.py"], ROOT))


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    _assert_no_result(res)


def test_convert_round_trips_u64_planes_tensors():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 64, size=(2, 3, 256), dtype=np.uint64)
    t = cv.from_u64(a, CPU)
    assert t.dtype == torch.int64 and t.shape == a.shape
    assert np.array_equal(cv.to_u64(t), a)
    lo, hi = cv.to_planes(t)
    assert torch.equal(cv.from_planes(lo, hi, CPU), t)
    jlo, jhi = he_planes.from_u64(a)  # the he_planes form
    assert np.array_equal(np.asarray(jlo), lo) and np.array_equal(np.asarray(jhi), hi)
    assert np.array_equal(np.asarray(he_planes.to_u64((jlo, jhi))), a)


def test_convert_ciphertexts_and_keys():
    from aloha_tpu import he_np

    rng = np.random.default_rng(2)
    L, n = CFG.n_limbs, CFG.n
    ct = he_np.Ciphertext(a=rng.integers(0, CFG.moduli[0], (L, n), dtype=np.uint64),
                          b=rng.integers(0, CFG.moduli[0], (L, n), dtype=np.uint64))
    back_a, back_b = cv.ct_to_np(cv.ct_from_np(ct, CPU))
    assert np.array_equal(back_a, ct.a) and np.array_equal(back_b, ct.b)
    flat = rng.integers(0, CFG.moduli[0], 2 * L * (L + 1) * n, dtype=np.uint64)
    k = cv.ksk_from_np(flat, CFG, CPU)
    assert k.shape == (2 * L * (L + 1), n)
    assert np.array_equal(cv.to_u64(k).ravel(), flat)
    with pytest.raises(ValueError, match="2L"):
        cv.ksk_from_np(flat[:-1], CFG, CPU)


def test_prepared_planes_round_trip():
    """The JAX prepare_ksk plane form (k lo/hi + four 16-bit Shoup limb
    planes) converts to the port's (k, kshoup) words."""
    L, n = CFG.n_limbs, CFG.n
    k, ks = ks_kernel.prepare_ksk(
        cv.from_u64(np.random.default_rng(3).integers(
            0, CFG.moduli[0], (2 * L * (L + 1), n), dtype=np.uint64), CPU), CFG)
    s = cv.to_u64(ks)
    klo, khi = cv.to_planes(k)
    limbs = [((s >> np.uint64(16 * i)) & np.uint64(0xFFFF)).astype(np.uint32)
             for i in range(4)]
    shape = (-1, n // 128, 128)
    planes = [p.reshape(shape) for p in (klo, khi, *limbs)]
    k2, ks2 = cv.prepared_from_planes(planes, CFG, CPU)
    assert torch.equal(k2, k) and torch.equal(ks2, ks)


def test_every_signature_matches_its_c_entry():
    """Each ctypes signature names an `extern "C"` entry of csrc/*.cu with
    as many parameters as it has argument types (ctypes passes what it is
    told, so a missing argument would shift the rest silently)."""
    import re

    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    for name, argtypes in _build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
