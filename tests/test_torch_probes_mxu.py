"""The tensor-core and runtime-stage probes against the TPU scripts' bodies in interpret mode.

Each probe's wrapper on CPU tensors (its plain version) is held against the
body of the `tools/` script it ports, on the same seeded words at BP = 2,
the body wrapped in its own `pl.pallas_call(..., interpret=True)`:

- `probe_mxu`: tools/probe_mxu.py's `kernel`, imported with BP=2 in the
  environment; the TPU chain is REPS calls.  Word-exact, and equal to a
  NumPy int64 oracle; `torch._int_mm`'s accumulators equal the plain
  version's before the combine, and the kernel's image of w (`w_image`)
  equals a NumPy model of the swizzled layout its descriptors read;
- `probe_mxu_parts`: `make_stages` executed from tools/probe_mxu_parts.py's
  source (the script times at import), with `M._tables_jax` tables, REPS
  steps in one call over (BP, 64, 128), no chunk pipeline.  `full` and
  `mxu` word-exact (`full` also equal to `ntt_np.ntt` REPS times); `vpu`
  word-exact at every position where the TPU's 16-bit-limb Shoup step gave
  the exact Shoup word, and at the others the TPU's word is the exact one
  plus q, the port's below 2q;
- `probe_dynstage`, `probe_dynsub`: each script's `body` executed from its
  source up to `with jax.enable_x64`, and its NumPy oracle from its source;
  nb = 1 and 3 blocks, word-exact.
"""

import ast
import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from aloha_tpu import ntt_np
from aloha_tpu.config import DEFAULT_CONFIG as JCFG
from aloha_tpu.ops import ntt_mxu as M
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch.probes import probe_dynstage, probe_dynsub, probe_mxu, probe_mxu_parts

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"
BP, ROWS, LANES = 2, 64, 128
Q, PSI = JCFG.moduli[0], JCFG.psi[0]
CPU = torch.device("cpu")
I32, U32 = jnp.int32, jnp.uint32


def _import_probe_mxu():
    """tools/probe_mxu.py with BP=2 (read at import); its import sets a
    persistent compilation cache in JAX's config, put back here."""
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    old_bp = os.environ.get("BP")
    os.environ["BP"] = str(BP)
    try:
        spec = importlib.util.spec_from_file_location("tools_probe_mxu", TOOLS / "probe_mxu.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if old_bp is None:
            del os.environ["BP"]
        else:
            os.environ["BP"] = old_bp
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _source_until(path, marker):
    """The script's source up to the first line starting with `marker`."""
    lines = path.read_text().splitlines(keepends=True)
    end = next(i for i, line in enumerate(lines) if line.startswith(marker))
    return "".join(lines[:end])


def _exec(src, path, **names):
    ns = {"__file__": str(path), "__name__": f"tools_{path.stem}", **names}
    exec(compile(src, str(path), "exec"), ns)
    return ns


# ------------------------------------------------------------- probe_mxu
tools_probe_mxu = _import_probe_mxu()


def _mxu_oracle(x, w, reps):
    """NumPy int64: the 64 products, the combine, the next digit planes."""
    x = x.astype(np.int64)
    w = w.astype(np.int64)
    for _ in range(reps):
        acc = [sum(x[k] @ w[j] for k in range(8)) for j in range(8)]
        s = acc[0] + sum(acc[j] << (j % 4) for j in range(1, 8))
        s = (s + (1 << 31)) % (1 << 32) - (1 << 31)
        x = np.stack([((s >> k) + 128) % 256 - 128 for k in range(8)])
    return x.astype(np.int8)


@pytest.mark.parametrize("reps", [1, 3])
def test_probe_mxu_against_the_tpu_kernel(reps):
    assert tools_probe_mxu.BP == BP and tools_probe_mxu.M == BP * ROWS
    x, w = probe_mxu.data(BP, CPU)
    with jax.enable_x64(False):
        call = pl.pallas_call(tools_probe_mxu.kernel, interpret=True,
                              out_shape=jax.ShapeDtypeStruct(tuple(x.shape), jnp.int8))
        want = jnp.asarray(x.numpy())
        for _ in range(reps):
            want = call(want, jnp.asarray(w.numpy()))
        want = np.asarray(want)
    got = probe_mxu.digit_products(x, w, reps).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, _mxu_oracle(x.numpy(), w.numpy(), reps))


def _w_image_model(w):
    """NumPy: the bytes the rate kernel's B descriptors read for w_j, K-major
    (row n = column n of w_j) with the 128-byte swizzle: byte b of logical
    16-byte chunk c of row n at 128 n + 16 (c ^ (n mod 8)) + b."""
    img = np.empty((8, LANES * LANES), dtype=np.int8)
    for j in range(8):
        for n in range(LANES):
            for c in range(LANES // 16):
                at = LANES * n + 16 * (c ^ (n % 8))
                img[j, at:at + 16] = w[j, 16 * c:16 * c + 16, n]
    return img.reshape(-1)


def test_probe_mxu_library_call_gives_the_accumulators():
    """torch._int_mm of [x_0 ... x_7] (M, 1024) and Wcat (1024, 1024),
    Wcat[k 128 + a, j 128 + b] = w_j[a, b], holds acc_j in columns j 128 ..;
    the kernel's image of w is w_j^T, K-major, swizzled as its wgmma
    descriptors read it."""
    x, w = probe_mxu.data(BP, CPU)
    M_ = x.shape[1]
    X = x.permute(1, 0, 2).reshape(M_, 8 * LANES)
    Wcat = w.permute(1, 0, 2).reshape(LANES, 8 * LANES).repeat(8, 1)
    lib = torch._int_mm(X, Wcat).reshape(M_, 8, LANES).permute(1, 0, 2)
    assert torch.equal(lib.to(torch.int64), probe_mxu.accumulators_plain(x, w))
    assert np.array_equal(probe_mxu.w_image(w).numpy(), _w_image_model(w.numpy()))


def _fragment_places(warp, lane):
    """csrc/probe_mxu.cu's write_planes for one thread: {(row, column):
    byte offset in a plane of the warpgroup's 64 rows} of its 64
    accumulator words d[4i + 2h + c] (rows 16 warp + g + 8h, columns 8i +
    2t + c), at the swizzled places it stores them."""
    g, t = lane >> 2, lane & 3
    places = {}
    for h in range(2):
        row = 16 * warp + g + 8 * h
        for i in range(16):
            off = (((i >> 1) ^ g) << 4) + ((i & 1) << 3)
            for c in range(2):
                places[(row, 8 * i + 2 * t + c)] = row * LANES + 2 * t + off + c
    return places


def test_rate_kernel_writes_every_byte_at_its_swizzled_place():
    """The wgmma accumulator layout as the rate kernel writes it back: the
    128 threads of a warpgroup cover the 64 x 128 words once, and each byte
    lands where the 128-byte swizzle (the TMA map and the A descriptors)
    puts (row, column): chunk (column / 16) ^ (row mod 8)."""
    places = {}
    for warp in range(4):
        for lane in range(32):
            for rc, off in _fragment_places(warp, lane).items():
                assert rc not in places
                places[rc] = off
    assert len(places) == 64 * LANES
    for (row, col), off in places.items():
        assert off == row * LANES + 16 * ((col >> 4) ^ (row % 8)) + (col & 15)


# ------------------------------------------------------- probe_mxu_parts
def _make_stages():
    """`make_stages` of tools/probe_mxu_parts.py, executed from its source."""
    path = TOOLS / "probe_mxu_parts.py"
    src = path.read_text()
    node = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "make_stages")
    ns = {"M": M, "jnp": jnp, "q": Q, "rows": ROWS, "NDIG": M.NDIG, "I32": I32, "U32": U32,
          "LANES": LANES}
    exec(compile(ast.Module(body=[node], type_ignores=[]), str(path), "exec"), ns)
    return ns["make_stages"]


make_stages = _make_stages()
TABLES = [np.asarray(t) for t in M._tables_jax(JCFG.n, Q, PSI, False)]
X_PARTS = cv.to_u64(probe_mxu_parts.data(BP, CPU))  # the script's words, below q0


def _planes(x):
    shape = (BP, ROWS, LANES)
    return (jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)),
            jnp.asarray((x >> np.uint64(32)).astype(np.uint32).reshape(shape)))


def _words(lo, hi):
    return (np.asarray(lo).astype(np.uint64)
            | (np.asarray(hi).astype(np.uint64) << np.uint64(32))).reshape(BP, -1)


def _tpu_parts(variant, x, reps):
    """REPS steps of the TPU variant in one interpret call on x (BP, N)."""
    def body(A1, T3, dwl, dwh, ds0, ds1, ds2, ds3, c1l, c1h, c3l, c3h, xlo, xhi, olo, ohi):
        tbls = (A1, T3, (dwl[:], dwh[:], ds0[:], ds1[:], ds2[:], ds3[:]),
                (c1l[:], c1h[:]), (c3l[:], c3h[:]))
        stages = make_stages(variant, tbls, BP)
        alo, ahi = jax.lax.fori_loop(I32(0), I32(reps), lambda i, c: stages(*c),
                                     (xlo[...], xhi[...]))
        olo[...] = alo
        ohi[...] = ahi

    with jax.enable_x64(False):
        out = pl.pallas_call(body, interpret=True,
                             out_shape=[jax.ShapeDtypeStruct((BP, ROWS, LANES), U32)] * 2)(
            *[jnp.asarray(t) for t in TABLES], *_planes(x))
    return _words(*out)


def _port_parts(variant, x, reps):
    return cv.to_u64(probe_mxu_parts.parts(cv.from_u64(x, CPU), variant, reps))


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("variant", ["full", "mxu"])
def test_probe_mxu_parts_products_against_the_tpu_body(variant, reps):
    want = _tpu_parts(variant, X_PARTS, reps)
    assert np.array_equal(_port_parts(variant, X_PARTS, reps), want)
    if variant == "full":
        ref = X_PARTS
        for _ in range(reps):
            ref = ntt_np.ntt(ref, Q, PSI)
        assert np.array_equal(want, ref)


def _tpu_shoup(w):
    """The TPU's middle twiddle (M._shoup_const, 16-bit-limb quotient) of
    the words w (BP, N) by the forward D table."""
    lo, hi = _planes(w)
    with jax.enable_x64(False):
        ylo, yhi = M._shoup_const(lo, hi, tuple(jnp.asarray(t)[None] for t in TABLES[2:8]), Q)
    return _words(ylo, yhi)


def _exact_shoup_of_recombined(x):
    """The vpu's first fold of x (the port's), and the exact Shoup word."""
    tb = probe_mxu_parts._tables(CPU)
    t = cv.from_u64(x, CPU)
    w = probe_mxu_parts._fold59_wide(t & 0xFFFFFFFF, probe_mxu_parts.B_ROW,
                                     tb.crow.repeat_interleave(LANES))
    return cv.to_u64(w), cv.to_u64(probe_mxu_parts._shoup(w, tb.tw.reshape(-1),
                                                          tb.tws.reshape(-1)))


#: positions of X_PARTS at which the TPU's limb Shoup differs from the exact
#: one, over repetitions 1-3 of the vpu variant (about 1 in 10^5 words)
VPU_SHOUP_DIFFS = 2


def test_probe_mxu_parts_vpu_against_the_tpu_body():
    """Rep by rep: the port's step from the TPU's state gives the TPU's next
    state, except where the TPU's Shoup word is the exact one + q; the
    port's REPS = 1 and 3 equal the TPU's at every other position."""
    states = [X_PARTS] + [_tpu_parts("vpu", X_PARTS, r) for r in (1, 2, 3)]
    bad = np.zeros(X_PARTS.shape, dtype=bool)
    for r in (1, 2, 3):
        step = _port_parts("vpu", states[r - 1], 1)
        w, exact = _exact_shoup_of_recombined(states[r - 1])
        tpu = _tpu_shoup(w)
        shoup_off = tpu != exact
        assert int(exact.max()) < 2 * Q
        assert np.array_equal(tpu[shoup_off], exact[shoup_off] + np.uint64(Q))
        assert np.array_equal(step != states[r], shoup_off)
        bad |= shoup_off
        if r in (1, 3):
            got = _port_parts("vpu", X_PARTS, r)
            assert np.array_equal(got[~bad], states[r][~bad])
    assert int(bad.sum()) == VPU_SHOUP_DIFFS


def test_tpu_limb_shoup_is_q_too_large_on_few_words():
    """On 2^18 seeded words of the vpu's fold window, the TPU's Shoup word
    is the exact one or the exact one + q, the latter on about 1 in 10^5."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 64, size=(2 ** 18 // (BP * JCFG.n), BP, JCFG.n), dtype=np.uint64)
    diffs = 0
    for xi in x:
        w, exact = _exact_shoup_of_recombined(xi)
        tpu = _tpu_shoup(w)
        off = tpu != exact
        assert np.array_equal(tpu[off], exact[off] + np.uint64(Q))
        diffs += int(off.sum())
    assert diffs < 2 ** 18 // 10 ** 4


# ------------------------------------------------ probe_dynstage, dynsub
def _script(name):
    """(body, the oracle's source, the script's names) of a dyn script."""
    path = TOOLS / f"{name}.py"
    ns = _exec(_source_until(path, "with jax.enable_x64"), path)
    lines = path.read_text().splitlines(keepends=True)
    start = next(i for i, line in enumerate(lines) if line.startswith("a = np.asarray(x).copy()"))
    end = next(i for i, line in enumerate(lines) if line.startswith("ok = "))
    return ns, "".join(lines[start:end])


@pytest.mark.parametrize("nb", [1, 3])
def test_probe_dynstage_against_the_tpu_body(nb):
    ns, oracle = _script("probe_dynstage")
    x, w = probe_dynstage.data(nb, CPU), probe_dynstage.table(CPU)
    xs, wn = x.numpy().view(np.uint32), w.numpy().view(np.uint32)
    with jax.enable_x64(False):
        call = jax.jit(pl.pallas_call(ns["body"], interpret=True,
                                      out_shape=jax.ShapeDtypeStruct((ROWS, LANES), U32)))
        for reps in (1, 3):
            want = []
            for b in range(nb):
                a = jnp.asarray(xs[b])
                for _ in range(reps):
                    a = call(jnp.asarray(wn), a)
                want.append(np.asarray(a))
            want = np.stack(want)
            got = probe_dynstage.dynstage(x, w, reps).numpy().view(np.uint32)
            assert np.array_equal(got, want), reps
            if reps == 1:
                for b in range(nb):
                    o = _exec(oracle, TOOLS / "probe_dynstage.py", np=np, x=xs[b], w=wn,
                              R=ROWS, L=LANES, LOGN=13)
                    assert np.array_equal(o["a"], want[b])
    assert tuple(xs[0].shape) == (ns["R"], ns["L"])


@pytest.mark.parametrize("nb", [1, 3])
def test_probe_dynsub_against_the_tpu_body(nb):
    ns, oracle = _script("probe_dynsub")
    x = probe_dynstage.data(nb, CPU)
    xs = x.numpy().view(np.uint32)
    with jax.enable_x64(False):
        call = jax.jit(pl.pallas_call(ns["body"], interpret=True,
                                      out_shape=jax.ShapeDtypeStruct((ROWS, LANES), U32)))
        for reps in (1, 3):
            want = []
            for b in range(nb):
                a = jnp.asarray(xs[b])
                for _ in range(reps):
                    a = call(a)
                want.append(np.asarray(a))
            want = np.stack(want)
            got = probe_dynsub.dynsub(x, reps).numpy().view(np.uint32)
            assert np.array_equal(got, want), reps
            if reps == 1:
                for b in range(nb):
                    o = _exec(oracle, TOOLS / "probe_dynsub.py", np=np, x=xs[b], R=ROWS, L=LANES)
                    assert np.array_equal(o["a"], want[b])


def test_dyn_inputs_are_the_scripts():
    """nb = 1 draws the scripts' x (default_rng(1)) and w (default_rng(0))."""
    x = np.random.default_rng(1).integers(0, 1 << 20, size=(ROWS, LANES), dtype=np.uint32)
    w = np.random.default_rng(0).integers(1, 97, size=(13, ROWS, LANES), dtype=np.uint32)
    assert np.array_equal(probe_dynstage.data(1, CPU).numpy().view(np.uint32)[0], x)
    assert np.array_equal(probe_dynstage.table(CPU).numpy().view(np.uint32), w)


# ------------------------------------------------------------ arguments
def test_new_probe_wrappers_reject_bad_arguments():
    x, w = probe_mxu.data(1, CPU)
    with pytest.raises(ValueError, match="dtype"):
        probe_mxu.digit_products(x.to(torch.int32), w, 1)
    with pytest.raises(ValueError, match="shape"):
        probe_mxu.digit_products(x[:, :32], w, 1)
    with pytest.raises(ValueError, match="shape"):
        probe_mxu.digit_products(x, w[:4], 1)
    with pytest.raises(ValueError, match="reps"):
        probe_mxu.digit_products(x, w, -1)
    image = probe_mxu.w_image(w)
    with pytest.raises(ValueError, match="card"):
        probe_mxu.launch_rate(x, image, 1)
    with pytest.raises(ValueError, match="shape"):
        probe_mxu.launch_rate(x, image[:-16], 1)
    p = probe_mxu_parts.data(1, CPU)
    with pytest.raises(ValueError, match="variant"):
        probe_mxu_parts.parts(p, "dots", 1)
    with pytest.raises(ValueError, match="dtype"):
        probe_mxu_parts.parts(p.to(torch.int32), "full", 1)
    with pytest.raises(ValueError, match="shape"):
        probe_mxu_parts.parts(p[:, :4096], "mxu", 1)
    with pytest.raises(ValueError, match="reps"):
        probe_mxu_parts.parts(p, "vpu", -1)
    d, t = probe_dynstage.data(1, CPU), probe_dynstage.table(CPU)
    with pytest.raises(ValueError, match="dtype"):
        probe_dynstage.dynstage(d.to(torch.int64), t, 1)
    with pytest.raises(ValueError, match="shape"):
        probe_dynstage.dynstage(d, t[:12], 1)
    with pytest.raises(ValueError, match="reps"):
        probe_dynstage.dynstage(d, t, -1)
    with pytest.raises(ValueError, match="dtype"):
        probe_dynsub.dynsub(d.to(torch.int64), 1)
    with pytest.raises(ValueError, match="shape"):
        probe_dynsub.dynsub(d[:, :32], 1)
    with pytest.raises(ValueError, match="reps"):
        probe_dynsub.dynsub(d, -1)
