"""The port's native library (`aloha_tpu_torch.native`), its readers and the JAX package's.

- the port's C++ `.tdb` reader and its Python reader agree row for row on
  traces the port records, and a `.tdb` written by either package reads in
  the other through either package's readers;
- `parse_u64_file`/`write_u64_file` round-trip against `np.loadtxt`/
  `np.savetxt` and `aloha_tpu.native`, words of all 64 bits;
- a file with a bad magic, a short header or a short payload raises
  ValueError from both readers;
- a missing compiler raises, and nothing falls back to Python; two
  processes building into one empty directory at once both load the library.

Exact integer words throughout.
"""

import os
import pathlib
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__
from aloha_tpu import native as jnative
from aloha_tpu import trace_db as jtrace_db
from aloha_tpu.isa import interp as jinterp
from aloha_tpu.isa import programs as jprog
from aloha_tpu_torch import native, trace_db
from aloha_tpu_torch.config import NUM_LANES, HEConfig
from aloha_tpu_torch.isa import programs
from aloha_tpu_torch.isa.interp import LaunchArgs, VectorProcessor
from aloha_tpu_torch.torch_backend import TorchBackend

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
n = 1024
JCFG = __graft_entry__._small_cfg(n)
CFG = HEConfig(n=n, psi=JCFG.psi, ipsi=JCFG.ipsi)
PR = n // NUM_LANES
BE = TorchBackend("cpu")
PROGRAMS = ("mul_plain", "hom_add", "encode_post")


def _spm(seed=5):
    rng = np.random.default_rng(seed)
    spm = np.zeros((32 * PR, NUM_LANES), dtype=np.uint64)
    for limb in range(2):
        q = CFG.moduli[limb]
        for part in range(2):
            for base in (0, 4 * PR):
                row = base + (part * 2 + limb) * PR
                spm[row:row + PR] = rng.integers(0, q, size=(PR, NUM_LANES), dtype=np.uint64)
    spm[-1] = rng.integers(0, 1 << 64, size=NUM_LANES, dtype=np.uint64)  # all 64 bits
    return spm


def _same_rows(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.pc == y.pc and x.instr.encode() == y.instr.encode()
        assert x.result.dtype == y.result.dtype == np.uint64
        assert np.array_equal(x.result, y.result)


def _port_trace(name, path):
    args = LaunchArgs(src1=4 * PR, rslt=8 * PR)
    rows = trace_db.record(VectorProcessor(CFG, BE), getattr(programs, name)(CFG),
                           BE.wrap(_spm()), None, args)
    trace_db.write(path, rows, n)
    return rows


@pytest.mark.parametrize("name", PROGRAMS)
def test_native_and_python_readers_agree(tmp_path, name):
    path = tmp_path / f"{name}.tdb"
    rows = _port_trace(name, path)
    _same_rows(trace_db.read(path), rows)
    _same_rows(trace_db._read_python(path), rows)
    _same_rows(trace_db.read(path), trace_db._read_python(path))


def test_read_runs_the_native_reader(tmp_path, monkeypatch):
    path = tmp_path / "t.tdb"
    rows = _port_trace("hom_add", path)
    calls = []
    real = native.read_tdb
    monkeypatch.setattr(native, "read_tdb", lambda p: calls.append(p) or real(p))
    _same_rows(trace_db.read(path), rows)
    assert calls == [path]
    assert native.read_tdb(path).shape == (len(rows), 3 + n)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("name", PROGRAMS)
def test_files_across_packages_and_readers(tmp_path, writer, name):
    """A .tdb written by either package reads in the other through both of
    its readers, and the JAX package's own readers agree."""
    path = tmp_path / f"{name}.tdb"
    args = (jinterp.LaunchArgs(src1=4 * PR, rslt=8 * PR))
    if writer == "port":
        rows = _port_trace(name, path)
    else:
        rows = jtrace_db.record(jinterp.VectorProcessor(JCFG), getattr(jprog, name)(JCFG),
                                _spm(), None, args)
        jtrace_db.write(path, rows, n)
    readers = [trace_db.read, trace_db._read_python, jtrace_db._read_python]
    if jnative.available():
        readers.append(lambda p: jtrace_db._read_native(jnative.load(), p))
    for read in readers:
        _same_rows(read(path), rows)


def test_empty_trace_reads_in_both(tmp_path):
    path = tmp_path / "empty.tdb"
    trace_db.write(path, [], n)
    assert trace_db.read(path) == [] == trace_db._read_python(path)
    assert jtrace_db._read_python(path) == []


def _header(magic=trace_db._MAGIC, n_rows=1, row_words=3 + n):
    names = b"pcinstrresult"
    head = struct.pack("<IIII", magic, trace_db._VERSION, 3, len(names))
    head += struct.pack("<QQ", n_rows, row_words)
    for off, ln, woff, wlen in ((0, 2, 0, 1), (2, 5, 1, 2), (7, 6, 3, n)):
        head += struct.pack("<IIII", off, ln, woff, wlen)
    return head + names


@pytest.mark.parametrize("case", ["magic", "short_header", "short_payload", "zeros",
                                  "names_past_pool"])
def test_bad_files_raise_in_both_readers(tmp_path, case):
    path = tmp_path / "bad.tdb"
    good_payload = np.zeros(3 + n, dtype="<u8").tobytes()
    data = {
        "magic": _header(magic=0x12345678) + good_payload,
        "short_header": _header()[:20],
        "short_payload": _header() + good_payload[:-8],
        "zeros": b"\0" * 64,
        "names_past_pool": _header().replace(struct.pack("<IIII", 7, 6, 3, n),
                                             struct.pack("<IIII", 7, 60, 3, n)) + good_payload,
    }[case]
    path.write_bytes(data)
    with pytest.raises(ValueError):
        native.read_tdb(path)
    with pytest.raises(ValueError):
        trace_db.read(path)
    if case in ("magic", "zeros"):
        with pytest.raises(ValueError, match="not a trace"):
            trace_db._read_python(path)
        with pytest.raises(ValueError, match="not a trace"):
            jtrace_db._read_python(path)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        trace_db.read(tmp_path / "absent.tdb")
    with pytest.raises(FileNotFoundError):
        native.parse_u64_file(tmp_path / "absent.txt")


@pytest.mark.parametrize("size", [0, 1, 4097])
def test_u64_files_round_trip(tmp_path, size):
    rng = np.random.default_rng(size)
    vals = rng.integers(0, 1 << 64, size=size, dtype=np.uint64)
    if size:
        vals[0] = np.uint64((1 << 64) - 1)
    ours, np_file, jax_file = (tmp_path / f"{k}.txt" for k in ("ours", "np", "jax"))
    native.write_u64_file(ours, vals)
    np.savetxt(np_file, vals, fmt="%d")
    assert ours.read_bytes() == np_file.read_bytes()
    for path in (ours, np_file):
        got = native.parse_u64_file(path)
        assert got.dtype == np.uint64 and np.array_equal(got, vals)
        if size:  # np.loadtxt warns on a file with no words
            assert np.array_equal(np.loadtxt(path, dtype=np.uint64).reshape(-1), vals)
        assert np.array_equal(jnative.parse_u64_file(path), vals)
    jnative.write_u64_file(jax_file, vals)
    assert jax_file.read_bytes() == ours.read_bytes()


def test_parse_takes_any_whitespace_and_max_count(tmp_path):
    path = tmp_path / "dump.txt"
    path.write_text("1 2\t3\n\n18446744073709551615\r\n42")
    want = np.array([1, 2, 3, (1 << 64) - 1, 42], dtype=np.uint64)
    assert np.array_equal(native.parse_u64_file(path), want)
    assert np.array_equal(native.parse_u64_file(path), jnative.parse_u64_file(path))
    assert np.array_equal(native.parse_u64_file(path, max_count=3), want[:3])


def test_library_is_named_by_its_source_and_apart_from_the_kernels():
    from aloha_tpu_torch import _build

    path = native.library_path()
    assert path.parent == native.BUILD_DIR == _build.BUILD_DIR
    assert path.name.startswith("libaloha_native_") and path.suffix == ".so"
    assert native.SOURCE.name == "aloha_native.cpp" and native.SOURCE.parent == _build.CSRC
    assert native.SOURCE not in _build._sources()
    src = native.SOURCE.read_text()
    for name in native.SIGNATURES:
        assert f" {name}(" in src, name
    # the port's copy carries the JAX package's functions unchanged
    jsrc = (ROOT / "native" / "aloha_native.cpp").read_text()
    assert src[src.index("#include"):] == jsrc[jsrc.index("#include"):]


def test_missing_compiler_raises_without_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.load()
    path = tmp_path / "t.tdb"
    trace_db.write(path, [], n)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        trace_db.read(path)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.parse_u64_file(path)
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").iterdir())


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        native.build()
    assert "broken.cpp" in str(info.value)
    assert list((tmp_path / "build").iterdir()) == []


def test_two_processes_building_at_once_both_load(tmp_path):
    code = (
        "import pathlib, sys\n"
        "from aloha_tpu_torch import native\n"
        "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "lib = native.load()\n"
        "print(native.library_path(), lib.aloha_tdb_rows(None))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.split()[0] for out, _ in outs}
    assert len(paths) == 1 and all(out.split()[1] == "-1" for out, _ in outs)
    assert [p.name for p in tmp_path.iterdir()] == [pathlib.Path(paths.pop()).name]
