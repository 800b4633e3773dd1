"""ops.ntt_pallas (the grid NTT) against the JAX package, and a model of its CUDA schedule.

- `ntt`/`intt` on CPU tensors (the plain version) equal
  `aloha_tpu.ops.ntt_pallas.ntt/intt(..., interpret=True)`, as
  tests/test_ntt_pallas.py runs the TPU kernel on the CPU, at N = 8192
  under q0 and P; a (2, 3, N) batch and the rings n = 128 and 1024 equal
  `ntt_np`, with inputs at the top of the kernel's windows;
- `schedule_model` runs csrc/ntt_grid.cu's schedule on Python ints: the
  same owner maps (layout A: thread j owns j + T k; layout B: 16 j + r),
  the same partner rules (registers, then warp shuffles, then registers),
  the same swizzled shared-memory transpose, the same Harvey/Shoup and
  halving butterflies with 64-bit wrap-around.  It is the only CPU check of
  the kernel's index logic; it must equal `ntt_np` at n = 128, 1024, 8192.

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
from aloha_tpu_torch.ops import ntt_pallas

torch.set_num_threads(2)

CPU = torch.device("cpu")
N = CFG.n
M64 = (1 << 64) - 1


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


# ------------------------------------------------------ the kernel's schedule
def _condsub(x, q):
    return np.where(x >= q, x - q, x)


def _shoup(x, w, ws, q):
    """x w mod q in [0, 2q): x w - floor(x ws / 2^64) q, modulo 2^64."""
    return (x * w - ((x * ws) >> 64) * q) & M64


def _halfmod(a, q):
    return (a >> 1) + np.where(a & 1, (q + 1) >> 1, 0)


def _swz(i):
    return i ^ ((i >> 4) & 15)


def _ct(u, v, w, ws, q):
    x = _condsub(u, 2 * q)
    y = _shoup(v, w, ws, q)
    return x + y, x + 2 * q - y


def _gs(u, v, w, ws, q):
    return (_halfmod(_condsub(u + v, q), q),
            _halfmod(_condsub(_shoup(u + q - v, w, ws, q), q), q))


def _transpose(a, n, T, to_b: bool):
    """The shared-memory exchange: write by one owner map, read by the
    other, through the swizzled slots (which must form a permutation)."""
    j = np.arange(T)[:, None]
    col = np.arange(16)[None, :]
    idx_a, idx_b = j + T * col, 16 * j + col
    src, dst = (idx_a, idx_b) if to_b else (idx_b, idx_a)
    sh = np.empty(n, dtype=object)
    slots = _swz(src)
    assert len(set(slots.ravel().tolist())) == n
    sh[slots] = a
    return sh[_swz(dst)]


def schedule_model(x, q: int, root: int, inverse: bool):
    """csrc/ntt_grid.cu on one polynomial x (n,) of Python ints: regs[j, k]
    is register k of thread j."""
    n = len(x)
    logn = n.bit_length() - 1
    logt = logn - 4
    T = 1 << logt
    w64, ws64 = ntt_torch.twiddles_np(n, root, q)
    w = np.array([int(v) for v in w64], dtype=object)
    ws = np.array([int(v) for v in ws64], dtype=object)
    j = np.arange(T)
    x = np.array([int(v) for v in x], dtype=object)
    if not inverse:
        a = x[j[:, None] + T * np.arange(16)[None, :]]  # layout A
        for s in range(4):  # t = T 2^(3-s): registers k, k + (8 >> s)
            d = 8 >> s
            for k in range(16):
                if k & d:
                    continue
                ti = (1 << s) + (k >> (4 - s))
                a[:, k], a[:, k + d] = _ct(a[:, k], a[:, k + d], w[ti], ws[ti], q)
        a = _transpose(a, n, T, to_b=True)
        for s in range(4, logt):  # 16 <= t < T: lanes j, j ^ (t/16)
            m = 1 << (logn - 5 - s)
            assert m < 32  # the partner is inside the warp
            top = (j & m) == 0
            ti = (1 << s) + (j >> (logn - 4 - s))
            tw, tws = w[ti][:, None], ws[ti][:, None]
            send = np.where(top[:, None], _condsub(a, 2 * q), _shoup(a, tw, tws, q))
            got = send[j ^ m]
            a = np.where(top[:, None], send + got, got + 2 * q - send)
        for s in range(max(logt, 4), logn):  # t < 16: registers r, r + t
            d = 1 << (logn - 1 - s)
            for r in range(16):
                if r & d:
                    continue
                ti = (1 << s) + ((16 * j + r) >> (logn - s))
                a[:, r], a[:, r + d] = _ct(a[:, r], a[:, r + d], w[ti], ws[ti], q)
        out = np.empty(n, dtype=object)
        out[(16 * j[:, None] + np.arange(16)[None, :]).ravel()] = \
            _condsub(_condsub(a, 2 * q), q).ravel()
        return out
    a = _condsub(x[16 * j[:, None] + np.arange(16)[None, :]], q)  # layout B
    for s in range(min(logt, 4)):  # t = 2^s < 16: registers
        d = 1 << s
        for r in range(16):
            if r & d:
                continue
            ti = (n >> (s + 1)) + ((16 * j + r) >> (s + 1))
            a[:, r], a[:, r + d] = _gs(a[:, r], a[:, r + d], w[ti], ws[ti], q)
    for s in range(4, logt):  # 16 <= t < T: lanes j, j ^ (t/16)
        m = 1 << (s - 4)
        assert m < 32
        top = (j & m) == 0
        ti = (n >> (s + 1)) + (j >> (s - 3))
        tw, tws = w[ti][:, None], ws[ti][:, None]
        got = a[j ^ m]
        a = np.where(top[:, None], _halfmod(_condsub(a + got, q), q),
                     _halfmod(_condsub(_shoup(got + q - a, tw, tws, q), q), q))
    a = _transpose(a, n, T, to_b=False)
    for s in range(logt, logn):  # t = 2^s >= T: registers k, k + t/T
        d = 1 << (s - logt)
        for k in range(16):
            if k & d:
                continue
            ti = (n >> (s + 1)) + (k >> (s + 1 - logt))
            a[:, k], a[:, k + d] = _gs(a[:, k], a[:, k + d], w[ti], ws[ti], q)
    out = np.empty(n, dtype=object)
    out[(j[:, None] + T * np.arange(16)[None, :]).ravel()] = _condsub(a, q).ravel()
    return out


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [128, 1024, 8192])
def test_schedule_model_equals_ntt_np(n, inverse):
    """The kernel's schedule at the top of its input window, under P (the
    largest modulus: the most headroom used in [0, 4q))."""
    q, psi, ipsi = _roots(n, 2)
    x = _window_inputs(np.random.default_rng(50 + n), (1, n), q, inverse)[0]
    got = schedule_model(x, q, ipsi if inverse else psi, inverse).astype(np.uint64)
    red = x % np.uint64(q)
    want = ntt_np.intt(red, q, ipsi) if inverse else ntt_np.ntt(red, q, psi)
    assert np.array_equal(got, want)


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
