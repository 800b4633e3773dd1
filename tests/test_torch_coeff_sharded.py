"""The coefficient-sharded rotation of the port against the JAX package's.

`parallel.coeff_sharded` splits the ring over the ranks of a coefficient
group, as the JAX package's partitioner splits `he_jax.rotate` on a
(dp, coeff) mesh (__graft_entry__.py:49-145).  Over gloo CPU ranks
(`dryrun.spawn`), every comparison exact (integers):

- `automorphism_sharded` over D = 2 and 4 ranks for e = 3, 9 and 2n - 1, on
  inputs holding 0, under one modulus and one a polynomial: each rank's
  block equals `ntt_torch.automorphism` and `aloha_tpu.ntt_jax.automorphism`
  of the whole ring (0 becomes q);
- its index maps: the uneven block-to-block counts at n = 8192, D = 4;
- `coeff_sharded.rotate` over (dp, coeff) = (1, 2), (2, 2) and (1, 4) at the
  ring max(256, 8 coeff), with the smoke tier's draws and with a key from
  `keys.gen_rotation_key`: the ranks' blocks put together equal
  `aloha_tpu.he_jax.rotate` (the XLA path `entry()` pins) of the whole
  batch at `__graft_entry__._small_cfg`, and each rotation made (3L+2)
  log2(D) exchanges of (L^2+6L+2) nb C log2(D) words in all and one
  all-to-all of 2L nb C words;
- the dry run's smoke workload as a world of one and spawned;
- a group of 3 ranks, and blocks or a key of the wrong width, raise
  `ValueError`.

The rank bodies run in spawned processes; each join has a timeout that
kills the ranks.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__
from aloha_tpu import he_jax, keys as jax_keys, ntt_jax
from aloha_tpu.ops import dispatch
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch.parallel import coeff_sharded, dryrun, multihost

torch.set_num_threads(2)

CPU = torch.device("cpu")
JOIN_TIMEOUT_S = 120
STEP = dryrun.KS_STEP


def _rank_main(argv) -> int:
    """One spawned rank: `argv` = [directory, dp].  Reads the directory's
    in.npz; on the (dp, coeff) mesh, the automorphisms of its x and xm
    blocks (coefficients over coeff) and the rotations of its block of (a,
    b) under each key; writes rank<r>.npz.  With n_reject in the inputs, a
    rotation over the whole world instead, which must raise."""
    import pathlib

    out, dp = pathlib.Path(argv[0]), int(argv[1])
    multihost.initialize("cpu")
    try:
        r = dist.get_rank()
        inp = np.load(out / "in.npz")
        res = {}
        if "n_reject" in inp:
            cfg = dryrun.ring(int(inp["n_reject"]))
            C = cfg.n // dist.get_world_size()
            z = torch.zeros((1, cfg.n_limbs, C), dtype=torch.int64)
            key = torch.zeros((2 * cfg.n_limbs * (cfg.n_limbs + 1), C), dtype=torch.int64)
            try:
                coeff_sharded.rotate((z, z), STEP, key, cfg)
            except ValueError as err:
                res["error"] = str(err)
            np.savez(out / f"rank{r}.npz", **res)
            return 0
        n = int(inp["n"])
        cfg = dryrun.ring(n)
        mesh = multihost.pod_mesh(("dp", "coeff"), dp, "cpu")
        group = mesh.get_group("coeff")
        D, d, i = mesh.size(1), mesh.get_local_rank("coeff"), mesh.get_local_rank("dp")
        a, b = inp["a"], inp["b"]
        nbl, C = a.shape[0] // dp, n // D
        rows, cols = slice(i * nbl, (i + 1) * nbl), slice(d * C, (d + 1) * C)
        res.update(rows=(rows.start, rows.stop), cols=(cols.start, cols.stop))
        qs = inp["qs"]
        q = torch.tensor(qs, dtype=torch.int64).view(-1, 1, 1)
        for e in inp["es"]:
            res[f"x{e}"] = cv.to_u64(coeff_sharded.automorphism_sharded(
                cv.from_u64(inp["x"][:, cols], CPU), int(e), int(qs[0]), group))
            res[f"xm{e}"] = cv.to_u64(coeff_sharded.automorphism_sharded(
                cv.from_u64(inp["xm"][..., cols], CPU), int(e), q, group))
        block = (cv.from_u64(a[rows, :, cols], CPU), cv.from_u64(b[rows, :, cols], CPU))
        for k, ksk in enumerate(inp["keys"]):
            with multihost.collectives() as counts:
                oa, ob = coeff_sharded.rotate(block, STEP, cv.from_u64(ksk[:, cols], CPU), cfg,
                                              group)
            res[f"a{k}"], res[f"b{k}"] = cv.to_u64(oa), cv.to_u64(ob)
            for kind, (calls, nbytes) in counts.items():
                res[f"{kind}{k}"] = (calls, nbytes)
        np.savez(out / f"rank{r}.npz", **res)
        return 0
    finally:
        dist.destroy_process_group()


def _spawn(world, directory, dp=1, **inputs):
    np.savez(directory / "in.npz", **inputs)
    dryrun.spawn(world, [str(directory), str(dp)], JOIN_TIMEOUT_S, target=_rank_main)
    return [dict(np.load(directory / f"rank{r}.npz")) for r in range(world)]


MESHES = [(1, 2), (2, 2), (1, 4)]


def _real_key(n):
    """A rotation key by step 2 from the JAX package's key generator."""
    cfg = __graft_entry__._small_cfg(n)
    sk = jax_keys.gen_secret(cfg, rng=np.random.default_rng(50))
    return jax_keys.gen_rotation_key(sk, STEP, cfg, rng=np.random.default_rng(51))


def _aut_inputs(n, qs, seed):
    """x (3, n) under qs[0] and xm (len(qs), 2, n), each with zeros: the
    zeros must come back as q where negated."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, qs[0], size=(3, n), dtype=np.uint64)
    x[0, ::7] = 0
    x[1] = 0
    xm = np.stack([rng.integers(0, q, size=(2, n), dtype=np.uint64) for q in qs])
    xm[:, :, ::5] = 0
    return x, xm


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Each mesh of MESHES spawned once at the ring max(256, 8 coeff), batch
    2 dp: its inputs and its ranks' results."""
    runs = {}
    for dp, coeff in MESHES:
        n = dryrun.smoke_ring(coeff)
        cfg = dryrun.ring(n)
        a, b, ksk = dryrun.smoke_inputs(cfg, 2 * dp)
        qs = np.array(cfg.moduli[:2], dtype=np.uint64)
        x, xm = _aut_inputs(n, qs, 40 + coeff)
        inputs = dict(n=n, a=a, b=b, keys=np.stack([ksk, _real_key(n)]), qs=qs, x=x, xm=xm,
                      es=np.array([3, 9, 2 * n - 1]))
        ranks = _spawn(dp * coeff, tmp_path_factory.mktemp(f"mesh{dp}x{coeff}"), dp, **inputs)
        runs[dp, coeff] = inputs, ranks
    return runs


@pytest.fixture
def xla_path():
    """he_jax on its XLA transforms, as __graft_entry__.entry() pins it; the
    previous choice restored after the test."""
    old = dispatch._impl
    dispatch.set_impl("xla")
    yield
    dispatch.set_impl(old)


def test_aut_maps_splits_are_uneven_at_the_production_ring():
    n, D = 8192, 4
    for e, lo, hi in ((9, 454, 682), (3, 0, 683), (2 * n - 1, 0, 2047)):
        counts = []
        for d in range(D):
            _, send, recv, place, neg = coeff_sharded._aut_maps(n, e, D, d, CPU)
            assert sum(send) == sum(recv) == n // D
            assert sorted(place.tolist()) == list(range(n // D))
            counts += send
        assert (min(counts), max(counts)) == (lo, hi), e


@pytest.mark.parametrize("D", [2, 4])
def test_automorphism_sharded_equals_the_whole_ring(mesh_runs, D):
    inputs, ranks = mesh_runs[1, D]
    x, xm, qs = inputs["x"], inputs["xm"], inputs["qs"]
    for e in inputs["es"]:
        got = np.concatenate([r[f"x{e}"] for r in ranks], axis=-1)
        want = cv.to_u64(ntt_torch.automorphism(cv.from_u64(x, CPU), int(e), int(qs[0])))
        assert np.array_equal(got, want), e
        assert np.array_equal(got, np.asarray(ntt_jax.automorphism(x, int(e), int(qs[0])))), e
        assert (got == qs[0]).any(), "no 0 was negated into q"
        gotm = np.concatenate([r[f"xm{e}"] for r in ranks], axis=-1)
        for m, q in enumerate(qs):
            assert np.array_equal(gotm[m], np.asarray(ntt_jax.automorphism(xm[m], int(e), int(q))))


@pytest.mark.parametrize("dp,coeff", MESHES)
def test_rotate_over_gloo_ranks_equals_he_jax_rotate(mesh_runs, xla_path, dp, coeff):
    inputs, ranks = mesh_runs[dp, coeff]
    n, a, b = int(inputs["n"]), inputs["a"], inputs["b"]
    jcfg = __graft_entry__._small_cfg(n)
    L, C, logD = jcfg.n_limbs, n // coeff, coeff.bit_length() - 1
    rot = jax.jit(lambda x, y, k: he_jax.rotate((x, y), STEP, k, jcfg))
    for k, key in enumerate(inputs["keys"]):
        got_a, got_b = np.zeros_like(a), np.zeros_like(b)
        for res in ranks:
            rows, cols = slice(*res["rows"]), slice(*res["cols"])
            got_a[rows, :, cols], got_b[rows, :, cols] = res[f"a{k}"], res[f"b{k}"]
            nb = a.shape[0] // dp
            assert tuple(res[f"exchange{k}"]) == ((3 * L + 2) * logD,
                                                  (L * L + 6 * L + 2) * nb * C * 8 * logD)
            assert tuple(res[f"all_to_all{k}"]) == (1, 2 * L * nb * C * 8)
        want_a, want_b = rot(a, b, key)
        assert np.array_equal(got_a, np.asarray(want_a)), k
        assert np.array_equal(got_b, np.asarray(want_b)), k


def test_dryrun_smoke_workload(tmp_path, xla_path, capsys):
    assert dryrun.main(["--device", "cpu", "--workload", "smoke"]) == 0
    assert "dryrun_multichip smoke OK (coefficient-sharded rotate): mesh dp=1 x coeff=1, ring " \
           "n=256, batch=2" in capsys.readouterr().out
    assert not dist.is_initialized()
    dp, coeff = 1, 2
    dryrun.spawn(dp * coeff, ["--device", "cpu", "--workload", "smoke", "--dp", str(dp),
                              "--out", str(tmp_path)], JOIN_TIMEOUT_S)
    n = dryrun.smoke_ring(coeff)
    a, b, ksk = dryrun.smoke_inputs(dryrun.ring(n), 2 * dp)
    want = jax.jit(lambda x, y, k: he_jax.rotate((x, y), STEP, k, __graft_entry__._small_cfg(n)))(
        a, b, ksk)
    for r in range(dp * coeff):
        res = np.load(tmp_path / f"rank{r}_smoke.npz")
        assert bool(res["exact"]) and int(res["coeff"]) == coeff and int(res["n"]) == n
        rows, cols = slice(*res["rows"]), slice(*res["cols"])
        assert np.array_equal(res["a"], np.asarray(want[0])[rows, :, cols])
        assert np.array_equal(res["b"], np.asarray(want[1])[rows, :, cols])


def test_rotate_rejects_a_wrong_group_or_block(tmp_path):
    ranks = _spawn(3, tmp_path, n_reject=256)
    assert all("power of two" in str(r.get("error")) for r in ranks)
    cfg = dryrun.ring(256)
    a, b, ksk = (cv.from_u64(x, CPU) for x in dryrun.smoke_inputs(cfg, 2))
    dryrun.init_world_of_one(CPU)
    try:
        with pytest.raises(ValueError, match="blocks of shapes"):
            coeff_sharded.rotate((a[..., :128], b[..., :128]), STEP, ksk, cfg)
        with pytest.raises(ValueError, match="blocks of shapes"):
            coeff_sharded.rotate((a, b[:1]), STEP, ksk, cfg)
        with pytest.raises(ValueError, match="key block"):
            coeff_sharded.rotate((a, b), STEP, ksk[:, :128], cfg)
    finally:
        dist.destroy_process_group()
