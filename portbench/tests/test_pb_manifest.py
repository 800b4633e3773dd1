"""BENCHMARK.json against the files the harness finds by name."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from portbench import harness
from portbench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == [harness.DATA.as_posix()]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    """Each cell's configuration, traffic, request kind and metrics exist."""
    c = harness.load_cell(cell)
    assert c.chips == 1
    assert c.config["name"] in {x["name"] for x in BENCH["configs"]}
    for mod in (c.reference(), c.program(), c.counts()):
        assert mod is not None
    assert set(c.traffic["limits"]) == {"mismatched_words", "max_slot_error"}
    assert c.traffic["limits"]["mismatched_words"] == 0
    for name in list(c.end_to_end) + list(c.per_layer):
        assert callable(harness.reader(name))
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer


def test_every_metric_and_layer():
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
        importlib.import_module(f"portbench.metrics.{m['name']}")


def test_config_files():
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == []


def test_extra_cell_is_picked_up(tmp_path):
    """A new cell is a traffic file and a manifest entry: no code edited."""
    root = tmp_path
    data = root / harness.DATA / "workloads"
    data.mkdir(parents=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        (root / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (root / c["file"]).write_text((REPO / c["file"]).read_text())
    traffic = json.loads((REPO / harness.DATA / "workloads" / "matvec16.b256.json").read_text())
    traffic["batch"] = 16
    (data / "matvec16.b16.json").write_text(json.dumps(traffic))
    bench["workloads"].append({"name": "matvec16.b16", "config": "ckks8192-matvec16",
                               "traffic": "matvec16.b16", "chips": 1, "why": "a test"})
    bench["per_layer"][0]["workloads"].append("matvec16.b16")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("matvec16.b16", root)
    assert cell.traffic["batch"] == 16 and cell.kind == "matvec"
    assert bench["per_layer"][0]["name"] in cell.per_layer
    assert "ntt_roofline" not in cell.per_layer
    with pytest.raises(KeyError):
        harness.load_cell("matvec16.b16", REPO)
