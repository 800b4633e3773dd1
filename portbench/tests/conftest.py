"""Fixtures of the benchmark's own tests: a checkout root holding a cut-down
copy of the benchmark (small rings and batches) for runs on the CPU."""

from __future__ import annotations

import json
import pathlib
import shutil

import pytest

from portbench import harness

REPO = harness.ROOT


def small_root(tmp: pathlib.Path, n: int = 1024, batch: int = 4, pool: int = 2,
               keep=None, seconds=None) -> pathlib.Path:
    """A root whose BENCHMARK.json names the benchmark's cells, their
    configurations cut to ring degree n (psi raised to the power N / n, the
    rotate-and-sum's steps cut to n / 4) and their traffic to `batch`."""
    data = tmp / harness.DATA
    shutil.copytree(REPO / harness.DATA / "kernels", data / "kernels")
    (data / "workloads").mkdir(parents=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        k = cfg["ring"]["n"] // n
        cfg["ring"]["n"] = n
        cfg["ring"]["psi"] = [pow(p, k, q) for p, q in zip(cfg["ring"]["psi"], cfg["ring"]["moduli"])]
        if cfg["keys"]["relinearization"]:
            cfg["keys"]["rotations"] = [1 << i for i in range((n // 2).bit_length() - 1)]
        path = tmp / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        name = f"{w['traffic']}.json"
        t = json.loads((REPO / harness.DATA / "workloads" / name).read_text())
        t.update(batch=batch, pool=pool, trace_requests=2)
        if keep is not None:
            t["keep"] = keep
        (data / "workloads" / name).write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def cell_names() -> list:
    return [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("small"))
