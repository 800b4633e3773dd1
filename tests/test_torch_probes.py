"""`aloha_tpu_torch.probes` against the TPU probes' bodies, run in Pallas interpret mode.

Each probe's wrapper on CPU tensors (its plain version) is held against the
body of the `tools/` script it ports, on the same packed words at BP = 2,
the body wrapped in its own `pl.pallas_call(..., interpret=True)`:

- `op_probe`: the 15 variants of tools/op_probe.py (`VARIANTS`, imported
  from the script) with its `_tables6_np` row-5 tables;
- `stream_prof`: tools/stream_prof.py's `make_body` rebuilt from the live
  helpers (`S._make_stage_loops` with six tables for `full`,
  `K._ct_butterfly` with `K._tables_np` for `noroll`) and a copy of the
  `_dyn_partner` the script called, which the JAX package no longer has;
- `stream_prof2`: tools/stream_prof2.py's `make_body(mode, nstages)`, the
  same way;
- `stream_prof3`: tools/stream_prof3.py's body (`S._make_stage_loops`).

Tolerances: word-exact for v3-v9, `rollsonly`, `nobfly`, `stream_prof3`
and `full` (the last two also equal `ntt_np.ntt` applied REPS times);
port - TPU in {0, 1, 2} for v2 and v10 at REPS = 1 (the TPU's sloppy
high-half products); congruent mod q at REPS 1 and 3, with the port inside
its window (< 2q after a Shoup product, < 4q after a stage), for v0, v1,
v11-v14, `noroll` and `full`/`statT`/`statS` of the lane stages.  Also
`convert.tables_from_planes` against the port's own tables.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from aloha_tpu import ntt_np
from aloha_tpu.config import DEFAULT_CONFIG as JCFG
from aloha_tpu.ops import ntt_pallas as K
from aloha_tpu.ops import ntt_stream as S
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch.probes import common as C
from aloha_tpu_torch.probes import op_probe, stream_prof, stream_prof2, stream_prof3

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("tools_op_probe", ROOT / "tools" / "op_probe.py")
tools_op_probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tools_op_probe)

BP, ROWS, LANES = 2, 64, 128
Q, PSI = C.Q, C.PSI
I32 = jnp.int32
CPU = torch.device("cpu")
X = cv.to_u64(C.resident_data(BP, CPU))  # the TPU scripts' data: words < 2^59


def _interpret(body, tables, x, shape):
    """Run a TPU probe body in interpret mode on the words x (BP, N)."""
    lo = jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape))
    hi = jnp.asarray((x >> np.uint64(32)).astype(np.uint32).reshape(shape))
    with jax.enable_x64(False):
        call = pl.pallas_call(body, out_shape=[jax.ShapeDtypeStruct(shape, jnp.uint32)] * 2,
                              interpret=True)
        olo, ohi = call(*[jnp.asarray(t) for t in tables], lo, hi)
    return (np.asarray(olo).astype(np.uint64)
            | (np.asarray(ohi).astype(np.uint64) << np.uint64(32))).reshape(x.shape)


def _repeat(step, reps):
    """A probe body's carry loop: `reps` data-dependent steps."""
    def body(*refs):
        *tables, xl, xh, ol, oh = refs
        alo, ahi = jax.lax.fori_loop(I32(0), I32(reps), lambda i, c: step(c, tables),
                                     (xl[...], xh[...]))
        ol[...] = alo
        oh[...] = ahi
    return body


def _port(fn, *args):
    return cv.to_u64(fn(cv.from_u64(X, CPU), *args))


def _congruent_in_window(got, want, bound):
    q = np.uint64(Q)
    assert np.array_equal(got % q, want % q)
    assert int(got.max()) < bound


def _dyn_partner(a, bit, t, axis, size):
    """The XOR partner tools/stream_prof*.py called as S._dyn_partner (the
    JAX package's ntt_stream before it was removed)."""
    return jnp.where(bit, pltpu.roll(a, t, axis), pltpu.roll(a, size - t, axis))


# ------------------------------------------------------------- op_probe
EXACT = ("v3", "v4", "v5", "v6", "v7", "v8", "v9")
HI = ("v2", "v10")
WINDOW = {"v0": 4 * Q, "v13": 4 * Q, "v14": 4 * Q, "v1": 2 * Q, "v11": 2 * Q, "v12": 2 * Q}


@pytest.mark.parametrize("variant", op_probe.VARIANTS)
def test_op_probe_variant_against_the_tpu_body(variant):
    fn = tools_op_probe.VARIANTS[variant]
    for reps in (1,) if variant in HI else (1, 3):
        want = _interpret(_repeat(lambda c, t: fn(c[0], c[1], tuple(t)), reps),
                          tools_op_probe.tbl_np, X, (BP, ROWS, LANES))
        got = _port(op_probe.probe_ops, variant, reps)
        if variant in EXACT:
            assert np.array_equal(got, want), reps
        elif variant in HI:
            assert set(np.unique(got - want).tolist()) <= {0, 1, 2}
        else:
            _congruent_in_window(got, want, WINDOW[variant])


def test_op_probe_tables_are_the_tpu_scripts():
    """The probe's row-5 twiddles (from the port's ntt_np) are the words of
    row 5 of tools/op_probe.py's `_tables6_np` planes, and the whole plane
    set carries over to the port's compact tables."""
    t6 = tools_op_probe.tbl_np
    w, ws = C.twiddle_row(5, CPU)
    assert np.array_equal(cv.to_u64(w), (t6[0][5].astype(np.uint64)
                                         | (t6[1][5].astype(np.uint64) << np.uint64(32))).ravel())
    assert np.array_equal(cv.to_u64(ws), sum(t6[2 + k][5].astype(np.uint64) << np.uint64(16 * k)
                                             for k in range(4)).ravel())
    tw, tws = cv.tables_from_planes(t6, Q, False, CPU)
    pw, pws = C.tables(CPU)
    assert torch.equal(tw, pw) and torch.equal(tws, pws)


# ------------------------------------------------------------ stream_prof3
def _fwd_body(reps):
    def body(wl, wh, s0, s1, s2, s3, xl, xh, ol, oh):
        fwd, _ = S._make_stage_loops((wl, wh, s0, s1, s2, s3), Q, ROWS, BP, 13)
        alo, ahi = jax.lax.fori_loop(I32(0), I32(reps), lambda i, c: fwd(*c), (xl[...], xh[...]))
        ol[...] = alo
        oh[...] = ahi
    return body


def _ntt_np_reps(reps):
    x = X
    for _ in range(reps):
        x = ntt_np.ntt(x, Q, PSI)
    return x


@pytest.mark.parametrize("reps", [1, 3])
def test_stream_prof3_against_the_tpu_body(reps):
    want = _interpret(_fwd_body(reps), S._tables6_np(JCFG.n, PSI, Q, False), X, (BP, ROWS, LANES))
    assert np.array_equal(want, _ntt_np_reps(reps))
    assert np.array_equal(_port(stream_prof3.fwd_reps, reps), want)


# ------------------------------------------------------------- stream_prof
def _stage_modes_body(mode, reps):
    """tools/stream_prof.py's make_body(mode) on (BP * rows, 128) planes,
    `full` through the six-table stage loops."""
    R = BP * ROWS

    def body(*refs):
        *tbl, xlo_ref, xhi_ref, olo_ref, ohi_ref = refs
        lane_ids = jax.lax.broadcasted_iota(I32, (R, LANES), 1)
        row_ids = jax.lax.broadcasted_iota(I32, (R, LANES), 0) % np.int32(ROWS)

        def add_stage(axis_ids, axis, size):
            def f(s, c):
                alo, ahi = c
                t = I32(64) >> (s % I32(6) + I32(1))
                bit = (axis_ids & t) != 0
                return (alo + _dyn_partner(alo, bit, t, axis, size),
                        ahi + _dyn_partner(ahi, bit, t, axis, size))
            return f

        def noroll(s, c):
            alo, ahi = c
            w = (jnp.broadcast_to(ref[s][None], (BP, ROWS, LANES)).reshape(R, LANES)
                 for ref in tbl)
            (tlo, thi), _ = K._ct_butterfly(alo, ahi, alo, ahi, *w, Q)
            return tlo, thi

        def rep(i, c):
            alo, ahi = c
            if mode == "full":
                fwd, _ = S._make_stage_loops(tuple(tbl), Q, ROWS, BP, 13)
                alo, ahi = fwd(alo.reshape(BP, ROWS, LANES), ahi.reshape(BP, ROWS, LANES))
                return alo.reshape(R, LANES), ahi.reshape(R, LANES)
            if mode == "rollsonly":
                c = jax.lax.fori_loop(I32(0), I32(6), add_stage(row_ids, 0, I32(R)), (alo, ahi))
                return jax.lax.fori_loop(I32(0), I32(7), add_stage(lane_ids, 1, I32(LANES)), c)
            return jax.lax.fori_loop(I32(0), I32(13), noroll, (alo, ahi))

        alo, ahi = jax.lax.fori_loop(I32(0), I32(reps), rep, (xlo_ref[...], xhi_ref[...]))
        olo_ref[...] = alo
        ohi_ref[...] = ahi
    return body


@pytest.mark.parametrize("mode", stream_prof.MODES)
def test_stream_prof_against_the_tpu_body(mode):
    tables = (S._tables6_np(JCFG.n, PSI, Q, False) if mode == "full"
              else K._tables_np(JCFG.n, PSI, Q, False))
    for reps in (1, 3):
        want = _interpret(_stage_modes_body(mode, reps), tables, X, (BP * ROWS, LANES))
        got = _port(stream_prof.stage_modes, mode, reps)
        if mode == "noroll":
            _congruent_in_window(got, want, 4 * Q)
        else:
            assert np.array_equal(got, want), reps
        if mode == "full":
            assert np.array_equal(want, _ntt_np_reps(reps))


# ------------------------------------------------------------ stream_prof2
def _lane_stages_body(mode, nstages, reps):
    """tools/stream_prof2.py's make_body(mode, nstages)."""
    def body(wl, wh, sl, sh, x_lo, x_hi, o_lo, o_hi):
        lane_ids = jax.lax.broadcasted_iota(I32, (1, ROWS, LANES), 2)

        def stage(s, carry):
            alo, ahi = carry
            t = I32(ROWS * LANES) >> (s % I32(7) + I32(7))
            if mode == "statS":
                t = I32(16)
            bit = (lane_ids & t) != 0
            plo = _dyn_partner(alo, bit, t, 2, I32(LANES))
            phi = _dyn_partner(ahi, bit, t, 2, I32(LANES))
            ulo, uhi = jnp.where(bit, plo, alo), jnp.where(bit, phi, ahi)
            vlo, vhi = jnp.where(bit, alo, plo), jnp.where(bit, ahi, phi)
            if mode == "nobfly":
                return ulo + vlo, uhi + vhi
            si = I32(0) if mode == "statT" else (s % I32(13))
            w = (ref[si][None] for ref in (wl, wh, sl, sh))
            (tlo, thi), (blo, bhi) = K._ct_butterfly(ulo, uhi, vlo, vhi, *w, Q)
            return jnp.where(bit, blo, tlo), jnp.where(bit, bhi, thi)

        alo, ahi = jax.lax.fori_loop(
            I32(0), I32(reps), lambda i, c: jax.lax.fori_loop(I32(0), I32(nstages), stage, c),
            (x_lo[...], x_hi[...]))
        o_lo[...] = alo
        o_hi[...] = ahi
    return body


@pytest.mark.parametrize("nstages", stream_prof2.NSTAGES)
@pytest.mark.parametrize("mode", stream_prof2.MODES)
def test_stream_prof2_against_the_tpu_body(mode, nstages):
    for reps in (1, 3):
        want = _interpret(_lane_stages_body(mode, nstages, reps),
                          K._tables_np(JCFG.n, PSI, Q, False), X, (BP, ROWS, LANES))
        got = _port(stream_prof2.lane_stages, mode, nstages, reps)
        if mode == "nobfly":
            assert np.array_equal(got, want), reps
        else:
            _congruent_in_window(got, want, 4 * Q)


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", [0, 2])
def test_tables_from_planes_give_the_ports_tables(m, inverse):
    """Both plane forms of the JAX package, forward and inverse, carry over
    to ntt_torch.twiddles_np's (w, wshoup) word for word; planes whose
    group elements disagree raise."""
    q = JCFG.moduli[m]
    root = (JCFG.ipsi if inverse else JCFG.psi)[m]
    w, ws = ntt_torch.twiddles_np(JCFG.n, root, q)
    for planes in (K._tables_np(JCFG.n, root, q, inverse),
                   S._tables6_np(JCFG.n, root, q, inverse)):
        tw, tws = cv.tables_from_planes(planes, q, inverse, CPU)
        assert np.array_equal(cv.to_u64(tw), w) and np.array_equal(cv.to_u64(tws), ws)
    bad = [p.copy() for p in K._tables_np(JCFG.n, root, q, inverse)]
    bad[0][3, 0, 0] ^= np.uint32(1)
    with pytest.raises(ValueError, match="group"):
        cv.tables_from_planes(bad, q, inverse, CPU)
    with pytest.raises(ValueError, match="planes"):
        cv.tables_from_planes(bad[:3], q, inverse, CPU)


def test_probe_wrappers_reject_bad_arguments():
    x = cv.from_u64(X, CPU)
    with pytest.raises(ValueError, match="variant"):
        op_probe.probe_ops(x, "v15", 1)
    with pytest.raises(ValueError, match="mode"):
        stream_prof.stage_modes(x, "half", 1)
    with pytest.raises(ValueError, match="mode"):
        stream_prof2.lane_stages(x, "full-13", 13, 1)
    with pytest.raises(ValueError, match="reps"):
        stream_prof3.fwd_reps(x, -1)
    with pytest.raises(ValueError):
        op_probe.probe_ops(x.to("meta"), "v1", 1)
