"""On the card (marked cuda; skipped without one): each cell at its own size
comes out correct, and its control (the reference with its products in
float64 in the system's place) does not.

    python -m pytest portbench/tests/test_pb_card.py -m cuda
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import cell_names

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("name", cell_names())
def test_cell_on_the_card(name):
    _card()
    r = harness.run(harness.load_cell(name), 4000000007, 2.0, False, "cuda",
                    time.perf_counter(), log=lambda m: None)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("seed", [4000000011, 4000000013, 4000000017])
@pytest.mark.parametrize("name", cell_names())
def test_control_on_the_card(name, seed):
    _card()
    r = harness.run(harness.load_cell(name), seed, 0.0, False, "cuda", time.perf_counter(),
                    control=True, log=lambda m: None)
    assert not r["correct"], r["checks"]
