"""ops.ntt_pallas (the grid NTT) against the JAX package and the stream wrapper.

- `ntt`/`intt` on CPU tensors (the plain version) equal
  `aloha_tpu.ops.ntt_pallas.ntt/intt(..., interpret=True)`, as
  tests/test_ntt_pallas.py runs the TPU kernel on the CPU, at N = 8192
  under q0 and P; a (2, 3, N) batch and the rings n = 128 and 1024 equal
  `ntt_np`, with inputs at the top of the kernel's windows;
- `transform`'s kernel path, its launch replaced by a stand-in that
  evaluates the tables it is handed, makes one launch of the shapes,
  tables and name csrc/ntt.cu takes and equals `ntt_stream.transform` at
  one modulus; the kernel's index logic is modelled in
  tests/test_torch_ntt_regs.py, and both wrappers are held against each
  other on the card in tests/test_torch_cuda.py.

Every comparison is word-exact.
"""

import numpy as np
import pytest
import torch

from aloha_tpu import ntt_np
from aloha_tpu.config import DEFAULT_CONFIG as CFG
from aloha_tpu.ops import ntt_pallas as jax_ntt_pallas
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch.ops import dispatch, ntt_pallas, ntt_stream

torch.set_num_threads(2)

CPU = torch.device("cpu")
N = CFG.n


def _roots(n: int, m: int):
    q = CFG.moduli[m]
    return q, pow(CFG.psi[m], N // n, q), pow(CFG.ipsi[m], N // n, q)


def _window_inputs(rng, shape, q: int, inverse: bool):
    """Canonical words with the last row lifted to the top of the window:
    < 4q forward, < 2q inverse."""
    x = rng.integers(0, q, size=shape, dtype=np.uint64)
    top = x.reshape(-1, shape[-1])[-1]
    top += np.uint64(q) * rng.integers(1, 2 if inverse else 4, size=shape[-1], dtype=np.uint64)
    return x


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", [0, 2])
def test_equals_the_jax_grid_kernel_in_interpret_mode(m, inverse):
    import jax.numpy as jnp

    q, psi, ipsi = _roots(N, m)
    a = np.random.default_rng(40 + m).integers(0, q, size=(2, N), dtype=np.uint64)
    if inverse:
        got = ntt_pallas.intt(cv.from_u64(a, CPU), q, ipsi)
        want = np.asarray(jax_ntt_pallas.intt(jnp.asarray(a), q, ipsi, interpret=True))
    else:
        got = ntt_pallas.ntt(cv.from_u64(a, CPU), q, psi)
        want = np.asarray(jax_ntt_pallas.ntt(jnp.asarray(a), q, psi, interpret=True))
    assert np.array_equal(cv.to_u64(got), want)


@pytest.mark.parametrize("n", [128, 1024, 8192])
def test_batched_and_small_rings_equal_ntt_np(n):
    """(2, 3, n) batches under q1, forward from < 4q and inverse from < 2q,
    and the round trip."""
    q, psi, ipsi = _roots(n, 1)
    rng = np.random.default_rng(n)
    for inverse in (False, True):
        x = _window_inputs(rng, (2, 3, n), q, inverse)
        red = x % np.uint64(q)
        got = cv.to_u64(ntt_pallas.transform(cv.from_u64(x, CPU), q, ipsi if inverse else psi,
                                             inverse))
        want = ntt_np.intt(red, q, ipsi) if inverse else ntt_np.ntt(red, q, psi)
        assert got.shape == x.shape
        assert np.array_equal(got, want)
    x = rng.integers(0, q, size=(3, n), dtype=np.uint64)
    t = cv.from_u64(x, CPU)
    assert np.array_equal(cv.to_u64(ntt_pallas.intt(ntt_pallas.ntt(t, q, psi), q, ipsi)), x)


def test_rejects_lengths_outside_the_kernel_and_other_devices():
    q, psi = CFG.moduli[0], CFG.psi[0]
    for n in (64, 1000, 16384):
        with pytest.raises(ValueError, match="power of two"):
            ntt_pallas.ntt(torch.zeros((2, n), dtype=torch.int64), q, psi)
    with pytest.raises(ValueError, match="modulus"):
        ntt_pallas.ntt(torch.zeros((2, 128), dtype=torch.int64), 1 << 62, psi)
    with pytest.raises(ValueError):  # no kernel and no quiet fallback off the CPU
        ntt_pallas.ntt(torch.zeros((2, 128), dtype=torch.int64, device="meta"), q, psi)


def test_cpu_path_launches_nothing_and_keeps_empty_batches():
    q, psi = CFG.moduli[0], CFG.psi[0]
    before = ntt_pallas.transform.launches
    out = ntt_pallas.ntt(torch.zeros((0, 3, 256), dtype=torch.int64), q, psi)
    assert out.shape == (0, 3, 256)
    ntt_pallas.intt(torch.ones((1, 256), dtype=torch.int64), q, CFG.ipsi[0])
    assert ntt_pallas.transform.launches == before
    assert ntt_pallas.ntt_plain is not ntt_pallas.ntt


def _table_launch(calls):
    """A stand-in for `ntt_stream._launch` on CPU tensors: it records the
    call and evaluates the compact tables it is handed (the plain stage
    loop fed w[m], ws[m] under qs[m]), as csrc/ntt.cu reads them."""
    def launch(x, w, ws, qs, inverse, name, cluster=0):
        calls.append((tuple(x.shape), tuple(w.shape), name, cluster))
        fn = ntt_torch.intt_with_tables if inverse else ntt_torch.ntt_with_tables
        y = torch.stack([fn(x[m], w[m], ws[m], int(qs[m])) for m in range(x.shape[0])])
        return y, bool(x.shape[1])
    return launch


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [128, 1024, 8192])
def test_equals_the_stream_wrapper_at_one_modulus(monkeypatch, n, inverse):
    """The kernel path of `ntt_pallas.transform` on a (2, 3, n) batch, with
    the launch replaced by a stand-in that evaluates the tables it is
    handed: one launch of shape (1, 6, n) with `ntt_torch.tables`' (1, n)
    tables, the kernel's own cluster choice and the `ntt_grid` name; the
    words of `ntt_stream.transform`'s kernel path at M = 1 and of the plain
    version, under P with the last row at the top of the window (4q - 1
    forward, 2q - 1 inverse).  On the card both launch csrc/ntt.cu
    (tests/test_torch_cuda.py)."""
    q, psi, ipsi = _roots(n, 2)
    root = ipsi if inverse else psi
    x = _window_inputs(np.random.default_rng(50 + n), (2, 3, n), q, inverse)
    x[-1, -1] = (2 if inverse else 4) * q - 1
    t = cv.from_u64(x, CPU)
    calls = []
    monkeypatch.setattr(dispatch, "use_kernel", lambda *a: True)
    monkeypatch.setattr(ntt_stream, "_launch", _table_launch(calls))
    before = ntt_pallas.transform.launches
    got = ntt_pallas.transform(t, q, root, inverse)
    assert ntt_pallas.transform.launches == before + 1
    assert calls == [((1, 6, n), (1, n), "ntt_grid", 0)]
    assert got.shape == t.shape
    want = ntt_stream.transform(t.reshape(1, 6, n), (q,), (root,), inverse).reshape(t.shape)
    assert torch.equal(got, want)
    plain = ntt_pallas.intt_plain if inverse else ntt_pallas.ntt_plain
    assert torch.equal(got, plain(t, q, root))


def test_bench_best_takes_only_bit_exact_forms_with_the_grid_form():
    """With the grid form among the four, `bench.best` still returns the
    fastest bit-exact record and None when no form is bit-exact."""
    from aloha_tpu_torch import bench

    recs = [{"metric": f"ntt8192_throughput_{name}", "value": v, "bitexact": ok}
            for name, v, ok in (("stream", 5.2e6, True), ("grid", 9.9e6, False),
                                ("mxu", 1.6e6, True), ("mxu_chain", 1.7e6, True))]
    assert bench.best(recs)["metric"] == "ntt8192_throughput_stream"
    recs[1]["bitexact"] = True
    assert bench.best(recs)["metric"] == "ntt8192_throughput_grid"
    assert bench.best([dict(r, bitexact=False) for r in recs]) is None
