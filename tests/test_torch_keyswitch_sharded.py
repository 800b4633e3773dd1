"""The digit-sharded rotation of the port against the JAX package's.

- `parallel.keyswitch_sharded.rotate_sharded` over gloo CPU ranks (the dry
  run's `keyswitch` workload, spawned): 2 ranks at N = 8192 (L = 2), a
  2 x 2 (dp, digit) mesh at n = 1024, and 3 ranks at n = 1024 on a
  three-limb ring (the constants of tests/test_hoisted.py:159-180).  The
  ranks' limbs, put together, equal `aloha_tpu.parallel.keyswitch_sharded.
  rotate_sharded` on the 8-virtual-device CPU mesh and `he_np.rotate`,
  word for word;
- a digit group whose size is not L, or shards that are not one limb,
  raise `ValueError`;
- the dry run's `hoisted` and `bsgs` workloads on 2 ranks: every rank's
  rows equal `he_np.rotate_hoisted` / `he_np.matvec_bsgs` on the port's
  keys.

The ranks are spawned processes running `aloha_tpu_torch.parallel.dryrun`,
which imports no JAX; each join has a timeout that kills the ranks.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from aloha_tpu import he_np
from aloha_tpu.config import HEConfig as JaxHEConfig
from aloha_tpu.parallel import keyswitch_sharded as jax_ks
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch.parallel import dryrun
from aloha_tpu_torch.parallel.keyswitch_sharded import rotate_sharded

torch.set_num_threads(2)

CPU = torch.device("cpu")
JOIN_TIMEOUT_S = 120

#: a three-limb ring at n = 1024 (+ P): tests/test_hoisted.py:159-180
MODULI3 = (576460752303439873, 576460752303702017, 576460752304439297, 576460752304619521)
PSI3_1024 = (94501300158356233, 476326773003166877, 148318682470543905, 148537735488545494)


def _jax_cfg(cfg):
    return JaxHEConfig(n=cfg.n, moduli=cfg.moduli, psi=cfg.psi, ipsi=cfg.ipsi)


def _ring_args(L):
    if L == 2:
        return []
    return ["--moduli", ",".join(map(str, MODULI3)), "--psi", ",".join(map(str, PSI3_1024))]


@pytest.mark.parametrize("n,L,dp,batch", [(8192, 2, 1, 1), (1024, 2, 2, 4), (1024, 3, 1, 2)])
def test_rotate_sharded_over_gloo_ranks_equals_jax_rotate_sharded(tmp_path, n, L, dp, batch):
    world = dp * L
    dryrun.spawn(world, ["--device", "cpu", "--workload", "keyswitch", "--n", str(n),
                         "--dp", str(dp), "--batch", str(batch), "--out", str(tmp_path)]
                 + _ring_args(L), JOIN_TIMEOUT_S)
    cfg = dryrun.ring(n, *((MODULI3, PSI3_1024) if L == 3 else ()))
    assert cfg.n_limbs == L
    a, b = dryrun.ciphertexts(cfg, batch)
    ksk = dryrun.random_key(cfg)
    got_a, got_b = np.zeros_like(a), np.zeros_like(b)
    for r in range(world):
        res = np.load(tmp_path / f"rank{r}_keyswitch.npz")
        assert bool(res["exact"])
        rows, j = slice(*res["rows"]), int(res["digit"])
        assert res["a"].shape == (batch // dp, 1, n)
        got_a[rows, j], got_b[rows, j] = res["a"][:, 0], res["b"][:, 0]
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(dp, L), ("dp", "digit"))
    sh = NamedSharding(mesh, P("dp", "digit", None))
    # jitted: one compile instead of shard_map's op-by-op dispatch (~10 x faster)
    ja, jb = jax.jit(lambda a, b: jax_ks.rotate_sharded(
        (a, b), dryrun.KS_STEP, ksk, mesh, _jax_cfg(cfg), dp_axis="dp"))(
        jax.device_put(a, sh), jax.device_put(b, sh))
    assert np.array_equal(got_a, np.asarray(ja))
    assert np.array_equal(got_b, np.asarray(jb))
    for i in range(batch):
        want = he_np.rotate(he_np.Ciphertext(a=a[i].copy(), b=b[i].copy()), dryrun.KS_STEP,
                            ksk, _jax_cfg(cfg))
        assert np.array_equal(got_a[i], want.a) and np.array_equal(got_b[i], want.b), i


def test_rotate_sharded_rejects_a_wrong_digit_group_or_shard():
    cfg = dryrun.ring(1024)
    a, b = (cv.from_u64(x, CPU) for x in dryrun.ciphertexts(cfg, 2))
    ksk = cv.from_u64(dryrun.random_key(cfg), CPU)
    dryrun.init_world_of_one(CPU)
    try:
        with pytest.raises(ValueError, match="digit axis"):
            rotate_sharded((a[:, :1], b[:, :1]), 2, ksk, cfg)
        one_limb = dryrun.ring(1024, (cfg.moduli[0], cfg.moduli[-1]), (cfg.psi[0], cfg.psi[-1]))
        with pytest.raises(ValueError, match="limb shards"):
            rotate_sharded((a, b), 2, ksk, one_limb)
        with pytest.raises(ValueError, match="does not split"):
            rotate_sharded((a[0, :1], b[0, :1]), 2, ksk, one_limb, dp_group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def serving_runs(tmp_path_factory):
    """The dry run's hoisted and bsgs workloads on 2 gloo CPU ranks at
    n = 1024, batch 4: the ranks' results, the ring, batch and keys."""
    out = tmp_path_factory.mktemp("serving")
    n, batch, world = 1024, 4, 2
    dryrun.spawn(world, ["--device", "cpu", "--workload", "hoisted", "--workload", "bsgs",
                         "--n", str(n), "--batch", str(batch), "--out", str(out)],
                 JOIN_TIMEOUT_S)
    cfg = dryrun.ring(n)
    ksk = {s: cv.to_u64(k) for s, k in dryrun.serving_keys(cfg, CPU).items()}
    runs = {w: [dict(np.load(out / f"rank{r}_{w}.npz")) for r in range(world)]
            for w in ("hoisted", "bsgs")}
    return runs, cfg, dryrun.ciphertexts(cfg, batch), ksk


def test_dryrun_hoisted_workload_equals_he_np(serving_runs):
    runs, cfg, (a, b), ksk = serving_runs
    steps = list(dryrun.HOISTED_STEPS)
    for res in runs["hoisted"]:
        assert bool(res["exact"])
        for k, i in enumerate(range(*res["rows"])):
            want = he_np.rotate_hoisted(he_np.Ciphertext(a=a[i].copy(), b=b[i].copy()), steps,
                                        [ksk[s] for s in steps], _jax_cfg(cfg))
            for s, w in zip(steps, want):
                assert np.array_equal(res[f"a{s}"][k], w.a), (i, s)
                assert np.array_equal(res[f"b{s}"][k], w.b), (i, s)


def test_dryrun_bsgs_workload_equals_he_np(serving_runs):
    runs, cfg, (a, b), ksk = serving_runs
    diags = list(dryrun.diagonals(cfg))
    for res in runs["bsgs"]:
        assert bool(res["exact"])
        for k, i in enumerate(range(*res["rows"])):
            want = he_np.matvec_bsgs(he_np.Ciphertext(a=a[i].copy(), b=b[i].copy()), diags,
                                     [ksk[1]], [ksk[dryrun.BSGS_G]], _jax_cfg(cfg),
                                     g=dryrun.BSGS_G)
            assert np.array_equal(res["a"][k], want.a) and np.array_equal(res["b"][k], want.b), i
