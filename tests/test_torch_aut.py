"""The coefficient-domain automorphism (`ops/aut`, `csrc/aut.cu`) on the CPU.

- a NumPy model of exactly the kernel's index arithmetic (einv = e^-1 mod
  2n, t = d einv mod 2n, src = t mod n, sign = t >= n) against the scatter
  maps of `ntt_torch._aut_maps` and the JAX package's `ntt_np.automorphism`:
  every odd e at n = 128 and 1024, the 12 rotation exponents 3^(2^k) and
  2N - 1 at n = 8192;
- the wrapper on CPU tensors (its plain version) against `ntt_np` and
  `ntt_jax`, with rows of 0 and q (the literal q - x: 0 -> q, q -> 0);
- even exponents and lengths outside 128-8192 raise;
- `he_torch.automorphism` is the wrapper;
- a NumPy model of exactly the kernel's launch (its grid of THREADS-thread
  CTAs, two outputs a thread stored as one 16-byte pair, input rows at a
  stride) at n = 128-8192, nb = 1, 16, 64, 133 and strides n and 2n: every
  output written once, every read inside its own row, the words those of
  `ntt_np` and `ntt_jax`;
- the wrapper's kernel path on CPU tensors, the C entry replaced by that
  model reading and writing the raw pointers it is handed: strided views
  whose rows collapse to one stride go in as they are (no copy), others
  as a contiguous copy, and the words equal the plain version's.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
Exact integer arithmetic: every comparison is word-exact.
"""

import ctypes
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from aloha_tpu import ntt_jax, ntt_np
from aloha_tpu.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch import _build
from aloha_tpu_torch.ops import aut, dispatch

torch.set_num_threads(2)

CPU = torch.device("cpu")
N = CFG.n


def kernel_model(x: np.ndarray, e: int, q: int) -> np.ndarray:
    """csrc/aut.cu's gather on uint64 words: y[d] = t >= n ? q - x[t mod n]
    : x[t mod n] with t = d * einv mod 2n (u64 wrap-around in q - x)."""
    n = x.shape[-1]
    einv = pow(e, -1, 2 * n)
    t = (np.arange(n, dtype=np.int64) * einv) & (2 * n - 1)
    v = x[..., t & (n - 1)]
    with np.errstate(over="ignore"):
        return np.where(t >= n, np.uint64(q) - v, v)


def rotation_exponents(n: int):
    return [pow(3, 1 << k, 2 * n) for k in range(12)] + [2 * n - 1]


@pytest.mark.parametrize("n", [128, 1024])
def test_kernel_index_map_every_odd_exponent(n):
    """The gather form gives _aut_maps' (src, sign) for every odd e."""
    q = CFG.moduli[0]
    x = np.random.default_rng(n).integers(0, q, size=n, dtype=np.uint64)
    for e in range(1, 2 * n, 2):
        einv = pow(e, -1, 2 * n)
        t = (np.arange(n) * einv) % (2 * n)
        src, neg = _aut_maps(n, e)
        assert np.array_equal(t % n, src) and np.array_equal(t >= n, neg), e
        assert np.array_equal(kernel_model(x, e, q), ntt_np.automorphism(x, e, q)), e


def _aut_maps(n, e):
    src, neg = ntt_torch._aut_maps(n, e, CPU)
    return src.numpy(), neg.numpy()


@pytest.mark.parametrize("e", rotation_exponents(N))
def test_kernel_index_map_rotation_exponents_n8192(e):
    q = CFG.moduli[1]
    x = np.random.default_rng(e).integers(0, q, size=(2, N), dtype=np.uint64)
    x[1, ::7] = 0
    x[1, 1::7] = np.uint64(q)
    src, neg = _aut_maps(N, e)
    einv = pow(e, -1, 2 * N)
    t = (np.arange(N) * einv) % (2 * N)
    assert np.array_equal(t % N, src) and np.array_equal(t >= N, neg)
    assert np.array_equal(kernel_model(x, e, q), ntt_np.automorphism(x, e, q))


@pytest.mark.parametrize("m", [0, 1, 2])
def test_wrapper_on_cpu_matches_ntt_np_and_ntt_jax(m):
    """nb = 3 rows under q0, q1 and P; row 1 holds 0 and q (the sign rule's
    literal q - x turns 0 into q and q into 0)."""
    q = CFG.moduli[m]
    e = pow(3, 5, 2 * N)
    x = np.random.default_rng(40 + m).integers(0, q, size=(3, N), dtype=np.uint64)
    x[1, : N // 2] = 0
    x[1, N // 2 :] = np.uint64(q)
    before = aut.automorphism.launches
    got = cv.to_u64(aut.automorphism(cv.from_u64(x, CPU), e, q))
    assert aut.automorphism.launches == before  # the CPU takes the plain version
    assert np.array_equal(got, ntt_np.automorphism(x, e, q))
    assert np.array_equal(got, np.asarray(jax.jit(ntt_jax.automorphism, static_argnums=2)(x, e, q)))
    assert np.array_equal(got, kernel_model(x, e, q))


def test_even_exponent_and_bad_length_raise():
    x = torch.zeros((2, N), dtype=torch.int64)
    with pytest.raises(ValueError, match="even"):
        aut.automorphism(x, 4, CFG.moduli[0])
    with pytest.raises(ValueError, match="even"):
        aut.automorphism(x, 2 * N + 2, CFG.moduli[0])  # taken mod 2N
    for n in (64, 16384, 1000):
        with pytest.raises(ValueError, match="power of two"):
            aut.automorphism(torch.zeros((1, n), dtype=torch.int64), 3, CFG.moduli[0])
    with pytest.raises(ValueError, match="no kernel"):
        aut.automorphism(x.to("meta"), 3, CFG.moduli[0])


def test_he_torch_automorphism_is_the_wrapper():
    q = CFG.moduli[0]
    x = cv.from_u64(np.random.default_rng(5).integers(0, q, size=(2, 2, N), dtype=np.uint64), CPU)
    e = 2 * N - 1
    assert torch.equal(ht.automorphism(x, e, q), aut.automorphism_plain(x, e, q))
    with pytest.raises(ValueError, match="even"):
        ht.automorphism(x, 2, q)


#: threads per CTA of csrc/aut.cu, read from the source the model mirrors
THREADS = int(re.search(
    r"constexpr int THREADS = (\d+);",
    (pathlib.Path(aut.__file__).parent.parent / "csrc" / "aut.cu").read_text()).group(1))


def launch_model(mem: np.ndarray, x_off: int, stride: int, nb: int, logn: int, einv: int, q: int):
    """csrc/aut.cu's launch on a flat uint64 buffer `mem`, input row r at
    mem[x_off + r * stride:]: ceil(nb n / 2 / THREADS) CTAs of THREADS
    threads; thread p = blockIdx.x THREADS + threadIdx.x returns when p >=
    nb n / 2, else owns outputs d, d + 1 (d = 2 (p mod n/2)) of row p / (n/2)
    and gathers them with one read each.  (y (nb, n), writes per output,
    the rows and addresses of the reads)."""
    n = 1 << logn
    pairs = nb << (logn - 1)
    ctas = -(-pairs // THREADS)
    block, thread = np.divmod(np.arange(ctas * THREADS, dtype=np.int64), THREADS)
    p = block * THREADS + thread
    p = p[p < pairs]
    row = p >> (logn - 1)
    d = 2 * (p & (n // 2 - 1))
    t0 = (d * einv) & (2 * n - 1)
    t1 = (t0 + einv) & (2 * n - 1)
    addr = [x_off + row * stride + (t & (n - 1)) for t in (t0, t1)]
    out = row * n + d
    assert not (out % 2).any()  # the 16-byte store's pair is aligned
    y = np.zeros(nb * n, dtype=np.uint64)
    writes = np.zeros(nb * n, dtype=np.int64)
    with np.errstate(over="ignore"):
        for k, (t, a) in enumerate(zip((t0, t1), addr)):
            v = mem[a]
            y[out + k] = np.where(t >= n, np.uint64(q) - v, v)
            np.add.at(writes, out + k, 1)
    return y.reshape(nb, n), writes.reshape(nb, n), row, addr


def _rows_with_zero_and_q(rng, nb, n, q):
    x = rng.integers(0, q, size=(nb, n), dtype=np.uint64)
    x[-1, ::3] = 0
    x[-1, 1::3] = np.uint64(q)
    return x


@pytest.mark.parametrize("stride_rows", [1, 2])
@pytest.mark.parametrize("nb", [1, 16, 64, 133])
@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048, 4096, 8192])
def test_launch_model_writes_each_output_once_reads_its_own_row(n, nb, stride_rows):
    """The launch at row stride n or 2n, rows between them (and after the
    last) filled with a word no row holds: every output written exactly
    once, every read inside its own row, the words equal to `ntt_np` and
    `ntt_jax` on the rows (the last holding 0 and q) under q1 at e = 9 and
    the conjugation 2n - 1."""
    q = CFG.moduli[1]
    rng = np.random.default_rng(n + nb + stride_rows)
    x = _rows_with_zero_and_q(rng, nb, n, q)
    stride, x_off = stride_rows * n, 5
    mem = np.full(x_off + nb * stride + n, np.uint64(2**63 - 1), dtype=np.uint64)
    for r in range(nb):
        mem[x_off + r * stride:x_off + r * stride + n] = x[r]
    jit = jax.jit(ntt_jax.automorphism, static_argnums=2)
    for e in (9, 2 * n - 1):
        y, writes, row, addr = launch_model(mem, x_off, stride, nb, n.bit_length() - 1,
                                            pow(e, -1, 2 * n), q)
        assert (writes == 1).all()
        for a in addr:
            assert ((a >= x_off + row * stride) & (a < x_off + row * stride + n)).all()
        assert np.array_equal(y, ntt_np.automorphism(x, e, q)), e
        assert np.array_equal(y, np.asarray(jit(x, e, q))), e


class ModelLib:
    """A stand-in for the kernel library on CPU tensors: `aloha_aut` checks
    the C entry's preconditions, records its call and runs `launch_model`
    on the memory behind the raw pointers it is handed."""

    def __init__(self):
        self.calls = []

    def aloha_aut(self, device, x, y, q, einv, nb, logn, stride, stream):
        n = 1 << logn
        assert 7 <= logn <= 13 and nb >= 1 and stride >= n and y % 16 == 0
        self.calls.append((x, stride))
        mem = np.ctypeslib.as_array((ctypes.c_uint64 * ((nb - 1) * stride + n)).from_address(x))
        out = np.ctypeslib.as_array((ctypes.c_uint64 * (nb * n)).from_address(y))
        out[:] = launch_model(mem, 0, stride, nb, logn, einv, q)[0].reshape(-1)
        return 0


def _views(n):
    """(name, view, rows' stride when taken without a copy, else None)."""
    base = torch.arange(4 * 3 * 2 * n, dtype=torch.int64).reshape(4, 3, 2, n) % CFG.moduli[0]
    base[-1, -1, :, ::5] = 0
    base[-1, -1, :, 1::5] = CFG.moduli[0]
    flat = base.reshape(12, 2, n)
    return [
        ("contiguous", base[0, 0], n),
        ("pair rows b", flat[:, 0, :], 2 * n),
        ("pair rows a", flat[:, 1, :], 2 * n),
        ("nested pair rows", base[..., 1, :], 2 * n),
        ("one row of a pair", flat[3:4, 1, :], n),
        ("axes swapped", base[:, :, 0, :].transpose(0, 1), None),
        ("broadcast row", base[0, 0, 0].expand(5, n), None),
        ("every other word", base.reshape(-1, 2 * n)[:, ::2], None),
        ("empty", flat[:0, 0, :], None),
    ]


@pytest.mark.parametrize("n", [128, 8192])
def test_wrapper_kernel_path_takes_strided_rows_without_a_copy(monkeypatch, n):
    """The wrapper's kernel path on CPU views, the library replaced by
    `ModelLib`: rows that collapse to one stride >= n are handed over in
    place (the view's own pointer and stride), the rest as a contiguous
    copy at stride n; one launch a call (none for an empty batch); the
    output contiguous and equal to the plain version of the rows made
    contiguous."""
    lib = ModelLib()
    monkeypatch.setattr(dispatch, "use_kernel", lambda *a: True)
    monkeypatch.setattr(dispatch, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    q = CFG.moduli[0]
    for name, x, stride in _views(n):
        for e in (9, 2 * n - 1):
            before, calls = aut.automorphism.launches, len(lib.calls)
            got = aut.automorphism(x, e, q)
            assert got.shape == x.shape and got.is_contiguous(), name
            assert torch.equal(got, aut.automorphism_plain(x.contiguous(), e, q)), (name, e)
            launched = x.numel() > 0
            assert aut.automorphism.launches == before + launched, name
            assert len(lib.calls) == calls + launched, name
            if stride is not None:
                assert lib.calls[-1] == (x.data_ptr(), stride), name
            elif launched:
                assert lib.calls[-1][0] != x.data_ptr() and lib.calls[-1][1] == n, name


@pytest.mark.parametrize("n", [128, 8192])
def test_wrapper_on_strided_cpu_views_equals_plain_on_contiguous_rows(n):
    """On CPU tensors the wrapper takes the plain version, strided or not:
    equal to the same rows made contiguous, word for word, and no launch."""
    for name, x, _ in _views(n):
        before = aut.automorphism.launches
        for m in range(3):
            q = CFG.moduli[m]
            got = aut.automorphism(x % q, 9, q)
            assert torch.equal(got, aut.automorphism_plain((x % q).contiguous(), 9, q)), name
            if x.numel():
                want = ntt_np.automorphism(cv.to_u64((x % q).contiguous()), 9, q)
                assert np.array_equal(cv.to_u64(got), want), name
        assert aut.automorphism.launches == before
