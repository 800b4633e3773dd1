"""Build the CUDA kernels under `csrc/` at first use and load them with ctypes.

`nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC`
compiles each `csrc/*.cu` (all at once, one process per source) and one
`nvcc -shared` links them into a shared library with a plain C interface
(no PyTorch headers: seconds of build instead of minutes).  The library
goes to `_build/` beside this file (listed in `.gitignore`), named by a
hash of the sources and of the nvcc command lines, so an edit of either
rebuilds and an unchanged tree reuses the last build.  Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

from aloha_tpu_torch.profiling import span

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint64
_L = ctypes.c_int64

#: C entry points and their argument types: (device, pointers..., ints..., stream).
SIGNATURES = {
    "aloha_ntt": [_I] + [_P] * 5 + [_I] * 5 + [_P],
    "aloha_ntt_cluster": [_I] * 5,
    "aloha_ks_head": [_I] + [_P] * 7 + [_I] * 4 + [_P],
    "aloha_ks_tail": [_I] + [_P] * 12 + [_I] * 6 + [_P],
    "aloha_ks_tail_c": [_I] + [_P] * 12 + [_I] * 7 + [_P],
    "aloha_ks_cluster": [_I] * 3,
    "aloha_ntt_mxu": [_I] + [_P] * 8 + [_I] * 5 + [_P],
    "aloha_aut": [_I] + [_P] * 2 + [_U] + [_I] * 3 + [_L, _P],
    "aloha_rns": [_I] * 3 + [_P] * 2,
    "aloha_probe_ops": [_I] + [_P] * 4 + [_U] + [_I] * 3 + [_P],
    "aloha_probe_stage_modes": [_I] + [_P] * 4 + [_U] + [_I] * 3 + [_P],
    "aloha_probe_lane_stages": [_I] + [_P] * 4 + [_U] + [_I] * 4 + [_P],
    "aloha_probe_mxu_rate": [_I] + [_P] * 3 + [_I] * 2 + [_P],
    "aloha_probe_mxu_parts": [_I] + [_P] * 7 + [_U] + [_I] * 3 + [_P],
    "aloha_probe_dynstage": [_I] + [_P] * 3 + [_I] * 2 + [_P],
    "aloha_probe_dynsub": [_I] + [_P] * 2 + [_I] * 2 + [_P],
    "aloha_probe_dma_copy": [_I] + [_P] * 2 + [_I] * 2 + [_P],
    "aloha_probe_dma_doublebuf": [_I] + [_P] * 2 + [_I] + [_P],
    "aloha_probe_dma_tblread": [_I] + [_P] * 3 + [_I] + [_P],
    "aloha_probe_dma_stages": [_I] + [_P] * 4 + [_U] + [_I] * 2 + [_P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump) on PATH or under CUDA_HOME."""
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which(name)
    if found:
        return found
    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / name).exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / name)
    raise RuntimeError(f"{name} not found: the CUDA kernels cannot be built")


ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]


def compile_command(nvcc: str, src: str, obj: str) -> list:
    """The nvcc command that compiles one source into an object file."""
    return [nvcc, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-c", src, "-o", obj]


def link_command(nvcc: str, lib: str, objs: list) -> list:
    """The nvcc command that links the object files into the library."""
    return [nvcc, *ARCH, "-shared", "-o", lib, *objs]


def library_path() -> pathlib.Path:
    """The library of the current sources and command lines (their hash)."""
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for cmd in (compile_command("nvcc", "SRC", "OBJ"), link_command("nvcc", "LIB", ["OBJ"])):
        h.update("\0".join(cmd).encode())
    return BUILD_DIR / f"libaloha_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> list:
    """Run the commands at once; raise with the output of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [(p, *p.communicate()) for p in procs]
    for p, out, err in outs:
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}\n{err}")
    return [out + err for _, out, err in outs]


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels unless a library of the current sources exists:
    one nvcc per source, all started together, then one link.  ptxas'
    report of every kernel (registers, spills) goes to `log_path()`, and to
    stderr when `verbose`."""
    out = library_path()
    if out.exists():
        return out
    nvcc = cuda_tool()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in srcs]
        logs = _run_all([compile_command(nvcc, str(src), obj) for src, obj in zip(srcs, objs)])
        lib_tmp = os.path.join(tmp, out.name)
        logs += _run_all([link_command(nvcc, lib_tmp, objs)])
        if verbose:
            print("".join(logs), file=sys.stderr)
        log_tmp = os.path.join(tmp, log_path().name)
        pathlib.Path(log_tmp).write_text("".join(logs))
        os.replace(log_tmp, log_path())
        os.replace(lib_tmp, out)
    return out


def log_path() -> pathlib.Path:
    """ptxas' report of the build of the current sources."""
    return library_path().with_suffix(".log")


def ptxas_usage(kernel: str) -> dict:
    """{mangled name: (registers, spill store bytes, spill load bytes)} of
    the built kernels whose mangled name contains `kernel`, from ptxas'
    report (`log_path`)."""
    build()
    usage, name, spill = {}, None, (0, 0)
    for line in log_path().read_text().splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name and kernel in name:
            usage[name] = (int(m.group(1)), *spill)
    return usage


@functools.lru_cache(maxsize=None)
@span("aloha.build.library")
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (an
    `aloha.build.library` span under a profiler)."""
    so = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return so


@functools.lru_cache(maxsize=None)
def _sass(library: str) -> str:
    return subprocess.run([cuda_tool("cuobjdump"), "--dump-sass", library],
                          capture_output=True, text=True, timeout=300, check=True).stdout


def sass_counts(kernel: str, opcodes) -> dict:
    """{opcode: count} of the SASS instructions of the built library's
    functions whose name contains `kernel` (cuobjdump --dump-sass, run
    once a library)."""
    sass = _sass(str(build()))
    counts = dict.fromkeys(opcodes, 0)
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            words = line.replace(";", " ").split()
            for op in opcodes:
                counts[op] += any(w == op or w.startswith(op + ".") for w in words)
    return counts


def sass_listing(kernel: str, library=None) -> dict:
    """{function: [instruction text]} of the functions of `library` (the
    current build when None) whose name contains `kernel`, as cuobjdump
    --dump-sass gives them with the offsets and encodings stripped, and
    the hash nvcc gives the file's anonymous namespace taken out of the
    name: two builds whose listings are equal compiled the kernel to the
    same code."""
    sass = _sass(str(library or build()))
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N_",
                          line.split("Function :", 1)[1].strip())
            name = name if kernel in name else None
            if name:
                out[name] = []
        elif name and (m := re.search(r"\*/\s+(.*?)\s*;", line)):
            out[name].append(m.group(1))
    return out


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
