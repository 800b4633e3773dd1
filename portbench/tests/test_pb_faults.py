"""`correct` comes out false when the timed path is broken underneath: a
step that returns its state unchanged, half of the batch left out, an answer
altered where it is produced; and for the control, the reference with its
products in float64 in the system's place.  Small rings on the CPU."""

from __future__ import annotations

import importlib

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import cell_names


def unchanged(monkeypatch):
    from aloha_tpu_torch import he_torch

    monkeypatch.setattr(he_torch, "rotate", lambda ct, *a, **k: ct)
    monkeypatch.setattr(he_torch, "rotate_hoisted", lambda ct, steps, *a, **k: [ct] * len(steps))
    monkeypatch.setattr(he_torch, "rotate_batch", lambda cts, *a, **k: list(cts))


def _wrap_serve(monkeypatch, cell, fn):
    mod = importlib.import_module(f"portbench.requests.{cell.kind}")
    serve = mod.serve
    monkeypatch.setattr(mod, "serve", lambda cfg, prepared, cts: fn(serve, cfg, prepared, cts))


def half_batch(monkeypatch, cell):
    """The first half of the batch served, its answers given for the rest."""
    def fn(serve, cfg, prepared, cts):
        h = cts[0][0].shape[0] // 2
        out = serve(cfg, prepared, [(a[:h], b[:h]) for a, b in cts])
        return tuple(torch.cat([x, x]) for x in out)
    _wrap_serve(monkeypatch, cell, fn)


def altered(monkeypatch, cell):
    """One word of the last ciphertext of the answer changed."""
    def fn(serve, cfg, prepared, cts):
        a, b = serve(cfg, prepared, cts)
        b = b.clone()
        b[-1, 0, 5] = (b[-1, 0, 5] + 1) % cfg.moduli[0]
        return a, b
    _wrap_serve(monkeypatch, cell, fn)


FAULTS = {"unchanged": lambda mp, cell: unchanged(mp), "half_batch": half_batch,
          "altered": altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", cell_names())
def test_fault_is_not_correct(small, name, fault, monkeypatch):
    cell = harness.load_cell(name, small)
    FAULTS[fault](monkeypatch, cell)
    r = harness.run(cell, 2 ** 31 + 99, 0.2, False, "cpu", 0.0, log=lambda m: None)
    assert not r["correct"] and r["failed"] > 0, r


@pytest.mark.parametrize("name", cell_names())
def test_control_is_not_correct(small, name):
    cell = harness.load_cell(name, small)
    r = harness.run(cell, 2 ** 31 + 5, 0.0, False, "cpu", 0.0, control=True,
                    log=lambda m: None)
    assert not r["correct"], r
    assert r["checks"]["mismatched_words"]["value"] > 0
    assert r["checks"]["max_slot_error"]["value"] > r["checks"]["max_slot_error"]["limit"]
