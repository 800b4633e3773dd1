"""The port's native library: the `.tdb` reader and decimal dump IO in C++.

The port of `aloha_tpu/native.py:25-117`, with its own copy of the source,
`csrc/aloha_native.cpp` (the functions and file format of the JAX
package's `native/aloha_native.cpp`).  At first use the system C++
compiler builds it (`g++ -O3 -shared -fPIC -std=c++17`) into `_build/`
beside this file (listed in `.gitignore`), named by a hash of the source:
an edit rebuilds, an unchanged source reuses the last build.  The build
goes to a temporary directory and then `os.replace`s into place, so
processes that build at once each load a whole library.

There is no quiet fallback: a missing compiler or a failed build raises
with the compiler's output.  The `.so` is not part of the nvcc build
(`_build` compiles `csrc/*.cu` alone), so it changes no kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "aloha_native.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_U64P = ctypes.POINTER(ctypes.c_uint64)

#: C entry points: (restype, argtypes)
SIGNATURES = {
    "aloha_parse_u64_file": (_LL, [ctypes.c_char_p, _U64P, _LL]),
    "aloha_write_u64_file": (_LL, [ctypes.c_char_p, _U64P, _LL]),
    "aloha_tdb_open": (_P, [ctypes.c_char_p]),
    "aloha_tdb_rows": (_LL, [_P]),
    "aloha_tdb_row_words": (_LL, [_P]),
    "aloha_tdb_n_fields": (ctypes.c_int, [_P]),
    "aloha_tdb_field": (_LL, [_P, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]),
    "aloha_tdb_read": (_LL, [_P, _LL, _LL, _U64P]),
    "aloha_tdb_close": (None, [_P]),
}


def compiler() -> str:
    """The C++ compiler on PATH."""
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the native library cannot be built")
    return found


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libaloha_native_{digest}.so"


def build() -> pathlib.Path:
    """Compile the library unless one of the current source exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = compiler()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib_tmp = os.path.join(tmp, out.name)
        res = subprocess.run([cxx, "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE),
                              "-o", lib_tmp], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(lib_tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    return _load(str(build()))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def parse_u64_file(path, max_count: int | None = None) -> np.ndarray:
    """The ASCII decimal words of a reference-style dump (any whitespace
    between them), as a flat uint64 array."""
    lib = load()
    if max_count is None:  # at least two bytes a value: a digit and a separator
        max_count = pathlib.Path(path).stat().st_size // 2 + 16
    out = np.empty(max_count, dtype=np.uint64)
    n = lib.aloha_parse_u64_file(os.fsencode(path), _ptr(out), max_count)
    if n < 0:
        raise FileNotFoundError(str(path))
    return out[:n].copy()


def write_u64_file(path, vals) -> None:
    """Write uint64 words as decimal lines (the reference dump format)."""
    vals = np.ascontiguousarray(np.asarray(vals, dtype=np.uint64).ravel())
    n = load().aloha_write_u64_file(os.fsencode(path), _ptr(vals), vals.size)
    if n != vals.size:
        raise OSError(f"short write to {path}: {n} of {vals.size} words")


def read_tdb(path) -> np.ndarray:
    """The payload of a trace database, (rows, row_words) uint64; raises
    ValueError for a file that is not one (bad magic, short header, a field
    table past the name pool, a short payload)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(str(path))
    lib = load()
    h = lib.aloha_tdb_open(os.fsencode(path))
    if not h:
        raise ValueError(f"{path}: not a trace database")
    try:
        n_rows, row_words = lib.aloha_tdb_rows(h), lib.aloha_tdb_row_words(h)
        if n_rows * row_words * 8 > os.path.getsize(path):
            raise ValueError(f"{path}: a payload of {n_rows} x {row_words} words is cut short")
        out = np.empty((n_rows, row_words), dtype=np.uint64)
        got = lib.aloha_tdb_read(h, 0, n_rows, _ptr(out)) if n_rows else 0
    finally:
        lib.aloha_tdb_close(h)
    if got != n_rows:
        raise ValueError(f"{path}: {got} of {n_rows} rows in the payload")
    return out
