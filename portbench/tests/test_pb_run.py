"""A run's frame: no card, no program, forbidden modules, and sound runs on
the CPU at a small ring."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness, run
from portbench.tests.conftest import REPO, cell_names


def _cli(cwd, *extra):
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "matvec16.b256",
                           "--seed", "5000000001", "--seconds", "1", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_it_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _cli(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_program_it_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / harness.DATA, tmp_path / harness.DATA,
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    code = ("import time; from portbench import harness; "
            "harness.run(harness.load_cell('rotsum.b256'), 1, 0.1, False, 'cpu', time.perf_counter())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "aloha_tpu_torch" in out.stderr


def test_forbidden_names_compared_whole():
    assert run.forbidden_modules(["aloha_tpu_torch", "aloha_tpu_torch.he_torch", "jaxtyping",
                                  "numpy"]) == []
    assert run.forbidden_modules(["aloha_tpu.he_np", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["aloha_tpu", "flax", "jax", "jaxlib"]


REFERENCE = sorted((REPO / harness.DATA / "reference").glob("*.py"))
ALLOWED = {"__future__", "dataclasses", "functools", "numpy", "torch", "portbench.reference"}


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_system(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module]
        else:
            continue
        for name in names:
            assert name in ALLOWED or name.startswith("portbench.reference."), (path, name)


def test_a_run_loads_no_forbidden_module(tmp_path):
    """In a fresh process: the harness, the reference and a whole run on the
    CPU leave none of jax, jaxlib, flax, aloha_tpu in sys.modules."""
    code = f"""
import json, pathlib, sys, time
sys.path.insert(0, {str(REPO)!r})
from portbench import harness, run
from portbench.tests.conftest import small_root
root = small_root(pathlib.Path({str(tmp_path)!r}))
harness.run(harness.load_cell("dotprod.b256", root), 3, 0.1, True, "cpu", time.perf_counter(),
            log=lambda m: None)
print(json.dumps(run.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []


@pytest.mark.parametrize("trace", [False, True], ids=["window", "trace"])
@pytest.mark.parametrize("cell", cell_names())
def test_sound_run_is_correct(small, cell, trace):
    r = harness.run(harness.load_cell(cell, small), 2 ** 32 + 11, 0.5, trace, "cpu", 0.0,
                    log=lambda m: None)
    assert r["correct"] and r["failed"] == 0, r
    assert r["checks"]["mismatched_words"]["value"] == 0
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device"] + \
        (["breakdown"] if trace else []) + ["checks"]
    names = harness.load_cell(cell, small).per_layer if trace else \
        harness.load_cell(cell, small).end_to_end
    assert set(r["metrics"]) <= set(names)
    json.dumps(r)
