"""The port's entry points (`aloha_tpu_torch.entry`) against `__graft_entry__`.

- `entry(device="cpu")`: the same draws as `__graft_entry__.entry()` at
  N = 8192, and its fn's rotation word for word equal to the JAX entry's fn
  (he_jax.rotate on the XLA path it pins), exact;
- `entry()` without a card raises: no CPU fallback;
- `dryrun_multichip(2, "cpu")`: the smoke tier and the production
  workloads over 2 spawned gloo CPU ranks, every rank's check passing.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from aloha_tpu.ops import dispatch
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import entry

torch.set_num_threads(2)


@pytest.fixture
def jax_entry():
    """__graft_entry__.entry(), with the NTT path it pins restored after."""
    old = dispatch._impl
    yield __graft_entry__.entry()
    dispatch.set_impl(old)


def test_entry_on_the_cpu_equals_the_jax_entry(jax_entry):
    jfn, jargs = jax_entry
    fn, args = entry.entry(device="cpu")
    for got, want in zip(args, jargs):
        assert got.device.type == "cpu" and got.dtype == torch.int64
        assert np.array_equal(cv.to_u64(got), want)
    want_a, want_b = jax.jit(jfn)(*jargs)
    got_a, got_b = fn(*args)
    assert got_a.shape == (2, 8192)
    assert np.array_equal(cv.to_u64(got_a), np.asarray(want_a))
    assert np.array_equal(cv.to_u64(got_b), np.asarray(want_b))


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()


def test_dryrun_multichip_over_two_cpu_ranks(capfd):
    entry.dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip smoke OK (coefficient-sharded rotate): mesh dp=2 x coeff=1, " \
           "ring n=256, batch=4" in out
    for line in out.splitlines():
        if line.startswith("dryrun ") and ": " in line:
            assert line.endswith(": True"), line
    for workload in ("keyswitch", "hoisted", "bsgs"):
        assert f"dryrun {workload} rank 1/2" in out
