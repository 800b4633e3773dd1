"""Build the CUDA kernels under `csrc/` at first use and load them with ctypes.

`nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC` compiles every `csrc/*.cu` into one shared library with a
plain C interface (no PyTorch headers: a few seconds of build instead of
minutes).  The library goes to `_build/` beside this file (listed in
`.gitignore`), named by a hash of the sources, so an edit rebuilds and an
unchanged tree reuses the last build.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int

#: C entry points and their argument types: (device, pointers..., ints..., stream).
SIGNATURES = {
    "aloha_ntt": [_I] + [_P] * 5 + [_I] * 4 + [_P],
    "aloha_ks_head": [_I] + [_P] * 7 + [_I] * 4 + [_P],
    "aloha_ks_tail": [_I] + [_P] * 12 + [_I] * 6 + [_P],
    "aloha_ntt_mxu": [_I] + [_P] * 9 + [_I] * 5 + [_P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libaloha_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels unless a library of the current sources exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        *(["-Xptxas", "-v"] if verbose else []),
        "-o", tmp, *(str(p) for p in sorted(CSRC.glob("*.cu"))),
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
        if verbose:
            print(res.stdout + res.stderr, file=sys.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    so = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return so


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
