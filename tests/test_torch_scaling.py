"""The port's scaling bench and collective census (`aloha_tpu_torch.scaling`).

On the CPU at n = 1024, over gloo ranks:

- a world of one and 2 spawned ranks (dp = 2 x coeff = 1, dp = 1 x coeff
  = 2): each process's JSON record holds the keys of tools/bench_scaling.py,
  `devices` is the world, the rate is above 0 and each rank's warm-up
  block equals the plain `he_torch.rotate`;
- --census: exactly log2(D) exchanges of nb C 8 bytes per sharded NTT, one
  all_reduce of 2(L+1) nb n 8 bytes per digit-sharded rotation, (3L+2)
  log2(D) exchanges of 18 nb C 8 log2(D) bytes in all (L = 2) and one
  all-to-all of 2L nb C 8 bytes per coefficient-sharded rotation (D the
  coeff axis);
- the run exits nonzero when one word of the sharded rotation is flipped.

Every count is compared exactly.
"""

import json

import pytest
import torch
import torch.distributed as dist

from aloha_tpu_torch import scaling
from aloha_tpu_torch.parallel import coeff_sharded

torch.set_num_threads(2)

JOIN_TIMEOUT_S = 120
N = 1024
L = 2
ARGS = ["--device", "cpu", "--n", str(N), "--iters", "2", "--batch-per-device", "2", "--census"]
#: the keys of tools/bench_scaling.py's line (:86-95)
REFERENCE_KEYS = {"metric", "devices", "hosts", "value", "per_device", "unit"}


def _check_record(rec, world, dp):
    assert REFERENCE_KEYS <= rec.keys()
    assert rec["metric"] == "rotate_throughput" and rec["unit"] == "rotations/s"
    assert rec["devices"] == world and rec["hosts"] == 1
    assert rec["dp"] == dp and rec["coeff"] == world // dp
    assert rec["value"] > 0 and rec["per_device"] == rec["value"] / world
    assert "card" not in rec  # the CPU has no card to name
    assert rec["exact"] is True
    if rec["rank"] == 0:
        assert rec["fused_value"] > 0
    else:
        assert rec["fused_value"] is None


def _check_census(rec, world):
    D = rec["coeff"]
    logD = D.bit_length() - 1
    nb, C = 2, N // D
    cen = rec["census"]
    want_ntt = {"exchange": [logD, logD * nb * C * 8]} if logD else {}
    assert cen["ntt_sharded"]["counted"] == want_ntt and cen["ntt_sharded"]["ok"]
    if world % L == 0:
        assert cen["rotate_sharded"]["counted"] == {"all_reduce": [1, 2 * (L + 1) * nb * N * 8]}
        assert cen["rotate_sharded"]["ok"]
    else:
        assert cen["rotate_sharded"]["ok"] is None
    counted = cen["coeff_sharded.rotate"]["counted"]
    assert counted.pop("all_to_all") == [1, 2 * L * nb * C * 8]
    assert counted == ({"exchange": [(3 * L + 2) * logD, 18 * nb * C * 8 * logD]} if logD else {})
    assert cen["coeff_sharded.rotate"]["ok"]
    assert cen["balance"]["a_block"] == [nb, L, C] and cen["balance"]["seconds"] > 0


def test_scaling_as_a_world_of_one(tmp_path, capsys):
    assert scaling.main(ARGS + ["--out", str(tmp_path)]) == 0
    assert not dist.is_initialized()
    rec = json.loads((tmp_path / "rank0_scaling.json").read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    _check_record(rec, 1, 1)
    _check_census(rec, 1)


@pytest.mark.parametrize("dp", [2, 1])
def test_scaling_over_two_spawned_ranks(dp):
    recs = scaling.spawned(2, ARGS + ["--dp", str(dp)], JOIN_TIMEOUT_S)
    for r, rec in enumerate(recs):
        assert rec["rank"] == r
        _check_record(rec, 2, dp)
        _check_census(rec, 2)


def test_scaling_exits_nonzero_when_a_word_differs(monkeypatch, capsys):
    rotate = coeff_sharded.rotate

    def flipped(*args, **kwargs):
        a, b = rotate(*args, **kwargs)
        a = a.clone()
        a[0, 0, 0] ^= 1
        return a, b

    monkeypatch.setattr(coeff_sharded, "rotate", flipped)
    assert scaling.main(ARGS) == 1
    assert not dist.is_initialized()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["exact"] is False
