"""The coefficient-sharded NTT of the port against the JAX package's.

- `ntt_torch.shard_tables` plus the plain `ntt_stream.transform_with_tables`
  equal the JAX package's `ntt_stream.ntt_planes_with_tables` (interpret
  mode, as tests/test_parallel.py runs it) on the same shard inputs, for
  n=2048, D in {2, 4}, every shard, both directions;
- a one-process model of the sharded transform over every shard's tables
  (D in {1, 2, 4, 8}, both directions) equals `ntt_np.ntt` and round-trips;
- `parallel.ntt_sharded` / `intt_sharded` over 2 and 4 gloo CPU ranks (the
  dry run's rank body, spawned) equal `aloha_tpu.parallel.ntt_sharded` on
  the 8-virtual-device CPU mesh and `ntt_np.ntt`, and round-trip exactly;
- `multihost.initialize()` does nothing with a single process.

The ranks are spawned processes running `aloha_tpu_torch.parallel.dryrun`,
which imports no JAX; each join has a timeout that kills the ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from aloha_tpu import ntt_np as jax_ntt_np
from aloha_tpu.ops import ntt_stream as jax_ntt_stream
from aloha_tpu.parallel import ntt_sharded as jax_sharded
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import ntt_np, ntt_torch
from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.ops import ntt_stream
from aloha_tpu_torch.parallel import dryrun, multihost

torch.set_num_threads(2)

CPU = torch.device("cpu")
JOIN_TIMEOUT_S = 120


def _planes(x):
    return (jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((x >> np.uint64(32)).astype(np.uint32)))


def _u64(lo, hi):
    return np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << np.uint64(32))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("D", [2, 4])
def test_shard_kernel_plain_equals_jax_interpret_kernel(monkeypatch, D, inverse):
    monkeypatch.setenv("ALOHA_STREAM_INTERPRET", "1")
    monkeypatch.setenv("ALOHA_STREAM_BP", "2")
    n, nb = 2048, 2
    q, psi, ipsi = dryrun.roots(n)
    root = ipsi if inverse else psi
    C = n // D
    logD, logC, rows = D.bit_length() - 1, C.bit_length() - 1, C // 128
    # the JAX composed form's tables: the global (logn, rows, 128) planes,
    # this shard's stages (inverse: the first logC, forward: the last) and rows
    t6 = jax_sharded._tables6_global_np(n, root, q, inverse)
    rng = np.random.default_rng(20 + D)
    for d in range(D):
        x = rng.integers(0, q, size=(nb, C), dtype=np.uint64)
        local = tuple(jnp.asarray((t[:logC] if inverse else t[logD:])[:, d * rows:(d + 1) * rows])
                      for t in t6)
        lo, hi = _planes(x.reshape(nb, rows, 128))
        want = _u64(*jax_ntt_stream.ntt_planes_with_tables(lo, hi, local, q, inverse))
        w, ws, _ = ntt_torch.shard_tables(n, q, root, D, d, inverse, CPU)
        got = ntt_stream.transform_with_tables(cv.from_u64(x, CPU), w, ws, q, inverse)
        assert np.array_equal(cv.to_u64(got), want.reshape(nb, C)), d


def _model_sharded(x, q, root, D, inverse):
    """The sharded transform of (nb, n) x in one process: the cross stages
    on whole blocks with each shard's scalar twiddle, the local stages
    through the plain transform_with_tables with each shard's tables."""
    n = x.shape[-1]
    C = n // D
    blocks = [x[:, d * C:(d + 1) * C] for d in range(D)]
    tabs = [ntt_torch.shard_tables(n, q, root, D, d, inverse, CPU) for d in range(D)]

    def local(bs):
        return [ntt_stream.transform_with_tables(b, w, ws, q, inverse)
                for b, (w, ws, _) in zip(bs, tabs)]

    def cross(bs, s, k):
        out = []
        for d, b in enumerate(bs):
            other, tw = bs[d ^ k], torch.full_like(b, tabs[d][2][s])
            if inverse:
                v = rt.mulmod(rt.submod(other, b, q), tw, q) if d & k else rt.addmod(b, other, q)
                out.append(rt.halfmod(v, q))
            else:
                out.append(rt.submod(other, rt.mulmod(b, tw, q), q) if d & k
                           else rt.addmod(b, rt.mulmod(other, tw, q), q))
        return out

    logD = D.bit_length() - 1
    if inverse:
        blocks = local(blocks)
    for s in range(logD):
        blocks = cross(blocks, s, (1 << s) if inverse else D >> (s + 1))
    if not inverse:
        blocks = local(blocks)
    return torch.cat(blocks, dim=-1)


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_shard_tables_of_every_shard_model_the_whole_transform(D):
    n = 1024
    q, psi, ipsi = dryrun.roots(n)
    x = np.random.default_rng(30 + D).integers(0, q, size=(3, n), dtype=np.uint64)
    y = _model_sharded(cv.from_u64(x, CPU), q, psi, D, False)
    assert np.array_equal(cv.to_u64(y), ntt_np.ntt(x, q, psi))
    assert np.array_equal(cv.to_u64(_model_sharded(y, q, ipsi, D, True)), x)


def test_shard_tables_of_one_shard_are_the_whole_ring():
    n, (q, psi, _) = 1024, dryrun.roots(1024)
    w, ws, cross = ntt_torch.shard_tables(n, q, psi, 1, 0, False, CPU)
    gw, gws, _ = ntt_torch.tables(n, (q,), (psi,), CPU)
    assert torch.equal(w, gw[0]) and torch.equal(ws, gws[0]) and cross == ()
    for bad in [(3, 0), (4, 4), (4, -1), (2048, 0)]:
        with pytest.raises(ValueError):
            ntt_torch.shard_tables(n, q, psi, *bad, False, CPU)


@pytest.mark.parametrize("world,dp", [(2, 1), (4, 1), (4, 2)])
def test_sharded_over_gloo_ranks_equals_jax_sharded(tmp_path, world, dp):
    n, batch = 2048, 4
    dryrun.spawn(world, ["--device", "cpu", "--n", str(n), "--batch", str(batch),
                         "--dp", str(dp), "--out", str(tmp_path)], JOIN_TIMEOUT_S)
    q, psi, ipsi = dryrun.roots(n)
    x = np.random.default_rng(dryrun.SEED).integers(0, q, size=(batch, n), dtype=np.uint64)
    y = np.zeros_like(x)
    back = np.zeros_like(x)
    for r in range(world):
        res = np.load(tmp_path / f"rank{r}.npz")
        assert int(res["D"]) == world // dp
        assert bool(res["forward_ok"]) and bool(res["roundtrip_ok"])
        rows, cols = slice(*res["rows"]), slice(*res["cols"])
        assert np.array_equal(res["x"], x[rows, cols])
        y[rows, cols], back[rows, cols] = res["y"], res["back"]
    coeff = world // dp
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(dp, coeff), ("dp", "coeff"))
    xd = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("dp", "coeff")))
    yj = jax_sharded.ntt_sharded(xd, q, psi, mesh, axis="coeff")
    assert np.array_equal(y, np.asarray(yj))
    assert np.array_equal(y, jax_ntt_np.ntt(x, q, psi))
    assert np.array_equal(back, np.asarray(jax_sharded.intt_sharded(yj, q, ipsi, mesh, axis="coeff")))
    assert np.array_equal(back, x)


def test_dryrun_as_a_world_of_one():
    assert dryrun.main(["--device", "cpu", "--n", "1024", "--batch", "2"]) == 0
    assert not dist.is_initialized()


def test_initialize_is_a_noop_with_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize("cpu")
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    multihost.initialize("cuda")
    assert not dist.is_initialized()
    assert multihost.backend_for("cuda") == "nccl" and multihost.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        multihost.backend_for("meta")
