"""The copy-pipeline probes against the TPU scripts' bodies in interpret mode.

Each port's wrapper on CPU tensors (its plain version) is held word for word
against the `body` of the `tools/dma_bisect*.py` script it ports, executed
from the script's source up to `with jax.enable_x64` (the scripts run at
import and read `sys.argv`, which is set for the execution), then wrapped
in its own `pl.pallas_call(..., interpret=True)` with the script's specs
(`pl.ANY` for the refs the body copies by DMA, `pltpu.VMEM` for the
tables), at the script's shapes:

- `dma_bisect` in both modes, on the script's `arange` and on seeded words;
- `dma_bisect_doublebuf` and `dma_bisect_tblread` on seeded words (and the
  tblread script's own all-ones table);
- `dma_bisect_stages` at NSTAGES 0, 1, 4 and 7 from seeded lo/hi planes,
  the port's int64 words split back into planes; the port's twiddle rows
  equal `_tables_np` rows 6-12.

A model of the two-slot pipelines' persistent chunk walk (rows 17 and 19)
checks that every chunk is taken once; the stage pipeline's model is
`test_torch_dma_stages_regs.py`.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from aloha_tpu.config import DEFAULT_CONFIG as JCFG
from aloha_tpu.ops import ntt_pallas as K
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch.probes import common
from aloha_tpu_torch.probes import (dma_bisect, dma_bisect_doublebuf, dma_bisect_stages,
                                    dma_bisect_tblread)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"
ROWS, LANES = 64, 128
CPU = torch.device("cpu")
U32 = jnp.uint32
HBM = pl.BlockSpec(memory_space=pl.ANY)
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _script(name, *argv):
    """The script's names after running its source up to `with
    jax.enable_x64`, with sys.argv = [script, *argv] (sys.argv and sys.path
    put back after)."""
    path = TOOLS / f"{name}.py"
    lines = path.read_text().splitlines(keepends=True)
    end = next(i for i, line in enumerate(lines) if line.startswith("with jax.enable_x64"))
    saved_argv, saved_path = sys.argv, list(sys.path)
    sys.argv = [str(path), *argv]
    try:
        ns = {"__file__": str(path), "__name__": f"tools_{name}"}
        exec(compile("".join(lines[:end]), str(path), "exec"), ns)
    finally:
        sys.argv, sys.path[:] = saved_argv, saved_path
    return ns


def _tpu(ns, in_specs, out_specs, out_shape, *args):
    with jax.enable_x64(False):
        out = pl.pallas_call(ns["body"], in_specs=in_specs, out_specs=out_specs,
                             out_shape=out_shape, interpret=True)(*[jnp.asarray(a) for a in args])
    return jax.tree_util.tree_map(np.asarray, out)


def _u32(x):
    return x.numpy().view(np.uint32)


def _blocks(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _inputs(kind, nb):
    """The script's arange, or seeded words over the whole u32 range."""
    if kind == "arange":
        return np.arange(nb * ROWS * LANES, dtype=np.uint32).reshape(nb, ROWS, LANES)
    return _u32(dma_bisect.blocks(nb, CPU, seed=7))


# ---------------------------------------------------------------- dma_bisect
@pytest.mark.parametrize("kind", ["arange", "seeded"])
@pytest.mark.parametrize("mode", dma_bisect.MODES)
def test_dma_copy_against_the_tpu_body(mode, kind):
    ns = _script("dma_bisect", mode)
    nb = ns["NB"]
    assert (nb, ns["R"], ns["L"], ns["BP"]) == (16, ROWS, LANES, 8)
    x = _inputs(kind, nb)
    want = _tpu(ns, [HBM], HBM, jax.ShapeDtypeStruct(x.shape, U32), x)
    got = _u32(dma_bisect.dma_copy(_blocks(x), mode))
    assert np.array_equal(got, want)
    assert np.array_equal(want, x * np.uint32(3) + np.uint32(1) if mode == "compute" else x)


# ----------------------------------------------------- dma_bisect_doublebuf
@pytest.mark.parametrize("seed", [3, 4])
def test_doublebuf_against_the_tpu_body(seed):
    ns = _script("dma_bisect_doublebuf")
    assert (ns["NB"], ns["NCH"]) == (32, 4)
    x = _u32(dma_bisect.blocks(ns["NB"], CPU, seed=seed))
    want = _tpu(ns, [HBM], HBM, jax.ShapeDtypeStruct(x.shape, U32), x)
    got = _u32(dma_bisect_doublebuf.doublebuf(_blocks(x)))
    assert np.array_equal(got, want)
    rolled = np.roll(x, 3, axis=2).reshape(-1, ROWS // 2, 2, LANES)[:, :, ::-1]
    assert np.array_equal(want, rolled.reshape(x.shape) * np.uint32(3) + np.uint32(1))


# ------------------------------------------------------- dma_bisect_tblread
@pytest.mark.parametrize("kind", ["script", "seeded"])
def test_tblread_against_the_tpu_body(kind):
    ns = _script("dma_bisect_tblread")
    nb = ns["NB"]
    if kind == "script":  # the script's own inputs: out = x + 13
        t = np.ones((13, ROWS, LANES), np.uint32)
        x = _inputs("arange", nb)
    else:
        t, x = _u32(dma_bisect_tblread.table(CPU)), _u32(dma_bisect.blocks(nb, CPU, seed=5))
    want = _tpu(ns, [VMEM, HBM], HBM, jax.ShapeDtypeStruct(x.shape, U32), t, x)
    got = _u32(dma_bisect_tblread.tblread(_blocks(t), _blocks(x)))
    assert np.array_equal(got, want)
    assert np.array_equal(want, x + t.sum(0, dtype=np.uint32))


# -------------------------------------------------------- dma_bisect_stages
def _planes(nb, seed):
    """The script's lo < 2^31 and hi < 2^27 planes, (nb, 64, 128) u32."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 31, size=(nb, ROWS, LANES), dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 27, size=(nb, ROWS, LANES), dtype=np.uint64).astype(np.uint32)
    return lo, hi


def _words(lo, hi):
    return (lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))).reshape(lo.shape[0], -1)


@pytest.mark.parametrize("nstages", [0, 1, 4, 7])
def test_stages_against_the_tpu_body(nstages):
    ns = _script("dma_bisect_stages", str(nstages))
    nb = ns["NB"]
    assert ns["NSTAGES"] == nstages and ns["q"] == common.Q
    lo, hi = _planes(nb, seed=11 + nstages)
    shape = jax.ShapeDtypeStruct(lo.shape, U32)
    want = _tpu(ns, [VMEM] * 4 + [HBM] * 2, [HBM] * 2, [shape] * 2, *ns["tbls"], lo, hi)
    got = dma_bisect_stages.stages(cv.from_u64(_words(lo, hi), CPU), nstages)
    glo, ghi = cv.to_planes(got)
    assert np.array_equal(glo.reshape(lo.shape), want[0])
    assert np.array_equal(ghi.reshape(hi.shape), want[1])
    assert int(cv.to_u64(got).max()) < 4 * common.Q  # lazy words, compared as they are


def test_stage_twiddles_are_the_tpu_rows():
    wlo, whi, slo, shi = K._tables_np(JCFG.n, JCFG.psi[0], JCFG.moduli[0], False)
    for s in range(dma_bisect_stages.FIRST, dma_bisect_stages.FIRST + dma_bisect_stages.MAX_STAGES):
        w, ws = common.twiddle_row(s, CPU)
        assert np.array_equal(cv.to_u64(w), _words(wlo[s][None], whi[s][None])[0])
        assert np.array_equal(cv.to_u64(ws), _words(slo[s][None], shi[s][None])[0])


@pytest.mark.parametrize("nchunks", [1, 16, 32, 133, 266, 8192])
def test_kernel_chunk_walk_covers_every_chunk_once(nchunks):
    """min(nchunks, SMs) persistent CTAs; CTA b takes chunks b + k G for k <
    n_b = (nchunks - b + G - 1) // G; slot k & 1 and parity (k >> 1) & 1."""
    sms = 132
    grid = min(nchunks, sms)
    seen = []
    for b in range(grid):
        n = (nchunks - b + grid - 1) // grid
        assert n >= 1
        chunks = [b + k * grid for k in range(n)]
        assert chunks[-1] < nchunks
        seen += chunks
        uses = [[k for k in range(n) if k & 1 == slot] for slot in (0, 1)]
        assert all([(k >> 1) & 1 for k in u] == [i & 1 for i in range(len(u))] for u in uses)
    assert sorted(seen) == list(range(nchunks))


# ------------------------------------------------------------------ surface
def test_dma_inputs_match_the_scripts():
    """`common.resident_data` draws the stages script's distribution; the
    u32 blocks and the table cover the whole u32 range."""
    x = cv.to_u64(common.resident_data(4, CPU))
    assert int((x & np.uint64(0xFFFFFFFF)).max()) < 1 << 31
    assert int((x >> np.uint64(32)).max()) < 1 << 27
    assert int(_u32(dma_bisect.blocks(8, CPU)).max()) > 1 << 31
    assert int(_u32(dma_bisect_tblread.table(CPU)).max()) > 1 << 31
    assert dma_bisect.BLOCK_BYTES * dma_bisect.NBS[0] > 50e6  # beyond the L2
    assert dma_bisect_stages.POLY_BYTES * dma_bisect_stages.NBS[0] > 50e6


def test_dma_wrappers_reject_bad_arguments():
    x, t = dma_bisect.blocks(2, CPU), dma_bisect_tblread.table(CPU)
    p = common.resident_data(1, CPU)
    with pytest.raises(ValueError, match="mode"):
        dma_bisect.dma_copy(x, "doublebuf")
    for fn in (lambda a: dma_bisect.dma_copy(a, "copy"), dma_bisect_doublebuf.doublebuf,
               lambda a: dma_bisect_tblread.tblread(t, a)):
        with pytest.raises(ValueError, match="dtype"):
            fn(x.to(torch.int64))
        with pytest.raises(ValueError, match="shape"):
            fn(x[:, :32])
        with pytest.raises(ValueError, match="shape"):
            fn(x[:0])
    with pytest.raises(ValueError, match="shape"):
        dma_bisect_tblread.tblread(t[:12], x)
    with pytest.raises(ValueError, match="dtype"):
        dma_bisect_tblread.tblread(t.to(torch.int64), x)
    for k in (-1, 8):
        with pytest.raises(ValueError, match="nstages"):
            dma_bisect_stages.stages(p, k)
    with pytest.raises(ValueError, match="dtype"):
        dma_bisect_stages.stages(p.to(torch.int32), 4)
    with pytest.raises(ValueError, match="shape"):
        dma_bisect_stages.stages(p[:, :4096], 4)
    with pytest.raises(ValueError, match="aligned"):
        dma_bisect.check_aligned(torch.zeros(9, dtype=torch.int32)[1:])
