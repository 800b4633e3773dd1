"""4-step NTT as exact int8 digit products: the tensor-core kernel and its plain form.

Replaces the TPU kernels `ntt_mxu._mxu_call` (via `ntt_planes`/`intt_planes`,
aloha_tpu/ops/ntt_mxu.py:653) and `ntt_mxu.ntt_chain_planes` (:860, with its
W-way body :742).  Both become `csrc/ntt_mxu.cu`, one kernel whose k = 1
form is `transform` and whose k > 1 form is the fused `chain`.

With coefficient j at (row r = j // 128, lane l = j % 128) and R = n / 128,
the forward negacyclic transform factors as

    Y = M X      rows: (R x R) product, M[i, r] = eta^(r (2 rev(i) + 1))
    W = D * Y    elementwise twiddle, D[i, l] = psi^((2 rev(i) + 1) l)
    Z = W T      lanes: (128 x 128) product, T[l, c] = omega^(l rev7(c))

with eta = psi^128, omega = psi^(2R), and Z read row-major is the
bit-reversed output (the orders are baked into M, D and T).  The inverse
runs lanes -> D^-1 -> rows with 1/R and 1/128 folded into the matrices.

Exact 60-bit products from int8 ones: a data word is 8 biased bytes
s_k = byte_k - 128; the weight 2^(8k) is folded into the matrix
(A_k = 2^(8k) M mod q) and each A_k split into 8 balanced signed digits, so
accumulator j = sum_k digit_j(A_k) s_k is an integer of magnitude at most
K 2^14 <= 2^24 (K = 8R or 1024, the contraction length).  Then
V = sum_j 2^(8j) (e_j + 2^b) + c, where c repairs the data bias
(128 times the folded row sums) less sum_j 2^(8j+b): the same +2^b as the
TPU's unsigned accumulators, so the constants equal the JAX tables.
The kernel folds V < 2^82 once through 2^59 = -(q - 2^59) (mod q), which
needs q in (2^59, 2^60) with the margin `check_modulus` tests.  The digit
split takes any 64-bit word, so the transform of x is that of x mod q for
every int64 x >= 0.

Tables are rebuilt here in NumPy and Python ints (the JAX module imports
jax): cached per (n, q, root, direction), vectorised where the JAX builder
loops per element.  Shoup companions are u64 bit patterns in int64, as in
`ntt_torch`; the TPU's u32 planes and 16-bit limbs are gone.

The plain version takes the digit products through `torch.matmul` in
float64 (exact: every partial sum is below 2^24 < 2^53; float64 runs on the
CPU and the card alike, and no TF32 setting touches it) and reduces the 8
accumulators with `rns_torch`'s exact limb arithmetic.  Its output is
canonical after every transform; the kernel keeps a lazy window between
the transforms of a chain and folds once at its end.

Bound on the H100 (estimate, see `csrc/ntt_mxu.cu`): L2 traffic of the
int8 tables (4 MiB per transform) and mma.sync issue, not HBM.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from aloha_tpu_torch import _build, ntt_np
from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.ops import dispatch

LANES = 128
NDIG = 8  # base-256 digits of a u64
KERNEL_RINGS = (4096, 8192)  # R a multiple of 32, shared memory within 227 KB

#: One (modulus, direction): row (8, R, 8R) and lane (8, 1024, 128) int8
#: digit matrices, the twiddle tw (R, 128) and its Shoup companion tws
#: (uint64), the bias constants crow (R,) and ccol (128,) (uint64).
Tables = collections.namedtuple("Tables", "row lane tw tws crow ccol")


# ------------------------------------------------------------------ tables
def bias_bits(kdim: int) -> int:
    """Accumulator bias exponent: |e_j| <= K * 128 * 128 = K << 14."""
    return (kdim << 14).bit_length() - 1


def check_modulus(n: int, q: int) -> None:
    """Raise ValueError unless n is a power of two >= 256 and q lies in
    (2^59, 2^60) with the one-step fold's margin (the port of
    `ntt_mxu._check_fold_margin`, aloha_tpu/ops/ntt_mxu.py:619)."""
    if n < 256 or n & (n - 1):
        raise ValueError(f"ring degree {n}: a power of two >= 256 required")
    if not (1 << 59) < q < (1 << 60):
        raise ValueError(f"modulus {q:#x} outside (2^59, 2^60)")
    delta = q - (1 << 59)
    for kdim in (NDIG * (n // LANES), NDIG * LANES):
        b = bias_bits(kdim)
        vmax = sum((1 << (8 * j)) * (1 << (b + 1)) for j in range(NDIG)) + q
        if (vmax >> 59) * delta > 20 * q:
            raise ValueError(f"fold margin violated for q={q:#x}, K={kdim}")
    if not (20 * q + (1 << 59) < (1 << 64) and 22 * delta < q):
        raise ValueError(f"fold margin violated for q={q:#x}")


def _powers(base: int, count: int, q: int) -> np.ndarray:
    """Object array base^e mod q, e in [0, count)."""
    out = np.empty(count, dtype=object)
    v = 1
    for e in range(count):
        out[e] = v
        v = v * base % q
    return out


def _bitrev(bits: int) -> np.ndarray:
    i = np.arange(1 << bits)
    return np.array([ntt_np.bit_reverse(int(v), bits) for v in i], dtype=np.int64)


def _balanced(f: np.ndarray) -> np.ndarray:
    """int64 array of values < 2^62 -> (8, ...) int8 signed base-256 digits
    in [-128, 127]."""
    out = np.empty((NDIG,) + f.shape, dtype=np.int8)
    x = f.copy()
    for j in range(NDIG):
        d = x & 0xFF
        d = np.where(d >= 128, d - 256, d)
        out[j] = d
        x = (x - d) >> 8
    if x.any():
        raise ValueError("value out of signed-digit range")
    return out


def _digitize(mat: np.ndarray, q: int, bias_bits: int):
    """mat (a, b) object ints mod q -> (cat (8, a, 8b) int8, c (a,) uint64).

    cat[j, i, k b + col] = digit_j of (2^(8k) mat[i, col] mod q); c is the
    data-bias repair 128 sum_{k, col} (2^(8k) mat[i, col] mod q) less
    sum_j 2^(8j + bias_bits), mod q."""
    a, b = mat.shape
    cat = np.empty((NDIG, a, NDIG * b), dtype=np.int8)
    bias = np.zeros(a, dtype=object)
    for k in range(NDIG):
        fold = (mat * (1 << (8 * k))) % q
        bias = bias + fold.sum(axis=1)
        cat[:, :, k * b:(k + 1) * b] = _balanced(fold.astype(np.int64))
    off = sum(1 << (8 * j + bias_bits) for j in range(NDIG))
    c = np.array([(128 * int(v) - off) % q for v in bias], dtype=object)
    return cat, c.astype(np.uint64)


def _lane_matrix(t: np.ndarray, q: int):
    """Digitise a (128, 128) lane matrix given as [out-lane, in-lane] and
    lay the digit blocks out as the right operand [k 128 + in-lane, out-lane]."""
    cat, c = _digitize(t, q, bias_bits(NDIG * LANES))
    cat = cat.reshape(NDIG, LANES, NDIG, LANES).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(cat.reshape(NDIG, NDIG * LANES, LANES)), c


@functools.lru_cache(maxsize=None)
def tables_np(n: int, q: int, psi: int, inverse: bool) -> Tables:
    """The digit tables of one (modulus, direction); `psi` is always the
    FORWARD root (the inverse tables derive its inverse), as in
    `ntt_mxu._fwd_tables_np` / `_inv_tables_np` (ntt_mxu.py:167/198)."""
    check_modulus(n, q)
    R = n // LANES
    lr = R.bit_length() - 1
    odd = 2 * _bitrev(lr) + 1  # (R,): 2 rev(i) + 1
    r = np.arange(R)
    lanes = np.arange(LANES)
    rev7 = _bitrev(7)
    eta, omg = pow(psi, LANES, q), pow(psi, 2 * R, q)
    if inverse:
        eta, omg, psi = (pow(v, q - 2, q) for v in (eta, omg, psi))
    pe = _powers(eta, 2 * R, q)  # eta has order 2R
    po = _powers(omg, LANES, q)  # omega has order 128
    D = _powers(psi, 2 * n, q)[(odd[:, None] * lanes[None, :]) % (2 * n)]
    b_row = bias_bits(NDIG * R)
    if inverse:
        iR, iL = pow(R, q - 2, q), pow(LANES, q - 2, q)
        Minv = pe[(r[:, None] * odd[None, :]) % (2 * R)] * iR % q  # [r, i]
        row, crow = _digitize(Minv, q, b_row)
        # Tinv[l, c] = omega^-(rev7(c) l) / 128, digitised as [out l, in c]
        Tinv = po[(lanes[:, None] * rev7[None, :]) % LANES] * iL % q
        lane, ccol = _lane_matrix(Tinv, q)
    else:
        M = pe[(r[None, :] * odd[:, None]) % (2 * R)]  # [i, r]
        row, crow = _digitize(M, q, b_row)
        # T[l, c] = omega^(l rev7(c)), digitised as [out c, in l]
        T = po[(lanes[:, None] * rev7[None, :]) % LANES]
        lane, ccol = _lane_matrix(np.ascontiguousarray(T.T), q)
    tws = (D * (1 << 64)) // q
    return Tables(row, lane, D.astype(np.uint64), tws.astype(np.uint64), crow, ccol)


def _forward_root(q: int, root: int, inverse: bool) -> int:
    """The port's roots are psi (forward) or psi^-1 (inverse), as in
    `ops.ntt_stream.transform`; the tables key off the forward root."""
    return pow(int(root), q - 2, q) if inverse else int(root)


def _i64(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(device)


@functools.lru_cache(maxsize=16)
def plain_tables(n: int, q: int, root: int, inverse: bool, device: torch.device):
    """The plain version's operands on `device`: row and lane digits as
    float64, tw, tws, crow and ccol as int64 bit views."""
    tb = tables_np(n, q, _forward_root(q, root, inverse), inverse)
    f64 = lambda a: torch.from_numpy(a.astype(np.float64)).to(device)  # noqa: E731
    return Tables(f64(tb.row), f64(tb.lane), _i64(tb.tw, device),
                  _i64(tb.tws, device), _i64(tb.crow, device), _i64(tb.ccol, device))


def frag_rows(a: np.ndarray) -> np.ndarray:
    """(8, R, K) row matrices -> the A registers of mma.m16n8k32 s8, per lane:
    [j][R/16][K/32][lane = 4 g + t][reg = 2 s + h][byte] holds
    a[j, 16 mt + 8 h + g, 32 ks + 16 s + 4 t + byte]."""
    nd, R, K = a.shape
    f = a.reshape(nd, R // 16, 2, 8, K // 32, 2, 4, 4)  # j mt h g ks s t byte
    return np.ascontiguousarray(f.transpose(0, 1, 4, 3, 6, 5, 2, 7))


def frag_lanes(t: np.ndarray) -> np.ndarray:
    """(8, K, 128) lane matrices -> the B registers of mma.m16n8k32 s8, per
    lane: [j][128/8][K/32][lane = 4 g + t][reg = s][byte] holds
    t[j, 32 ks + 16 s + 4 t + byte, 8 nt + g]."""
    nd, K, L = t.shape
    f = t.reshape(nd, K // 32, 2, 4, 4, L // 8, 8)  # j ks s t byte nt g
    return np.ascontiguousarray(f.transpose(0, 5, 1, 6, 3, 2, 4))


@functools.lru_cache(maxsize=16)
def kernel_tables(n: int, qs: tuple, roots: tuple, inverse: bool, device: torch.device):
    """Stacked per-modulus kernel operands on `device`: fragment-ordered
    int8 row and lane digits, tw, tws, crow, ccol and q (int64)."""
    per = [tables_np(n, q, _forward_root(q, r, inverse), inverse) for q, r in zip(qs, roots)]

    def stack(f, conv):
        return torch.from_numpy(np.stack([conv(getattr(t, f)) for t in per])).to(device)

    i8 = lambda fn: lambda a: fn(a).reshape(-1)  # noqa: E731
    u64 = lambda a: a.view(np.int64)  # noqa: E731
    return (
        stack("row", i8(frag_rows)), stack("lane", i8(frag_lanes)),
        stack("tw", u64), stack("tws", u64), stack("crow", u64), stack("ccol", u64),
        torch.tensor(qs, dtype=torch.int64, device=device),
    )


# ----------------------------------------------------------- plain version
def _digits(x):
    """int64 (...) -> float64 (8, ...): the biased bytes byte_k - 128."""
    return torch.stack([((x >> (8 * k)) & 0xFF) - 128 for k in range(NDIG)]).to(
        torch.float64
    )


def _reduce(e, b: int, c, q: int):
    """8 exact accumulators (8, ...) float64 -> sum_j 2^(8j) (e_j + 2^b) + c
    mod q, canonical."""
    u = e.to(torch.int64) + (1 << b)  # in [0, 2^(b+1)], below q
    acc = c.expand(u.shape[1:])
    for j in range(NDIG):
        acc = rt.addmod(acc, rt.barrett(u[j], pow(2, 8 * j, q), q), q)
    return acc


def row_products(x, row):
    """(nb, R, 128) -> the 8 exact row-product accumulators (8, nb, R, 128)
    float64, data digits along the contraction k = kk R + r."""
    nb, R, L = x.shape
    s = _digits(x).permute(1, 0, 2, 3).reshape(nb, NDIG * R, L)
    return torch.matmul(row[:, None], s[None])


def lane_products(x, lane):
    """(nb, R, 128) -> the 8 exact lane-product accumulators (8, nb, R, 128)
    float64, data digits along the contraction k = kk 128 + l."""
    nb, R, L = x.shape
    s = _digits(x).permute(1, 2, 0, 3).reshape(nb, R, NDIG * L)
    return torch.matmul(s[None], lane[:, None])


def _row_step(x, tb: Tables, q: int):
    return _reduce(row_products(x, tb.row), bias_bits(NDIG * x.shape[1]), tb.crow[:, None], q)


def _lane_step(x, tb: Tables, q: int):
    return _reduce(lane_products(x, tb.lane), bias_bits(NDIG * LANES), tb.ccol, q)


def _transform1(x, q: int, root: int, inverse: bool):
    nb, n = x.shape
    tb = plain_tables(n, q, int(root), inverse, x.device)
    first, second = (_lane_step, _row_step) if inverse else (_row_step, _lane_step)
    v = rt.mulmod(first(x.reshape(nb, n // LANES, LANES), tb, q), tb.tw, q)
    return second(v, tb, q).reshape(nb, n)


def transform_plain(x, qs, roots, inverse: bool):
    """Plain PyTorch version of `transform`: x (M, nb, n) int64, group m
    under qs[m] with root roots[m] (psi forward, psi^-1 inverse)."""
    return torch.stack(
        [_transform1(x[m], q, r, inverse) for m, (q, r) in enumerate(zip(qs, roots))]
    )


def chain_plain(x, q: int, root: int, k: int, inverse: bool):
    """Plain PyTorch version of `chain`: k canonical single transforms."""
    for _ in range(k):
        x = _transform1(x, q, root, inverse)
    return x


# ------------------------------------------------------------ the wrappers
def _launch(x, qs, roots, inverse: bool, k: int, wrapper):
    """Launch the kernel on x (M, nb, n); count the launch on `wrapper`."""
    M, nb, n = x.shape
    dispatch.check(x, (M, nb, n), "x")
    if n not in KERNEL_RINGS:
        raise ValueError(f"ring degree {n}: the kernel takes n in {KERNEL_RINGS}")
    af, tf, tw, tws, crow, ccol, qt = kernel_tables(n, qs, roots, inverse, x.device)
    y = torch.empty_like(x)
    if nb:
        err = _build.lib().aloha_ntt_mxu(
            x.device.index, x.data_ptr(), y.data_ptr(), af.data_ptr(), tf.data_ptr(),
            tw.data_ptr(), tws.data_ptr(), crow.data_ptr(), ccol.data_ptr(),
            qt.data_ptr(), M, nb, n.bit_length() - 1, k, int(inverse),
            dispatch.stream_of(x),
        )
        _build.check(err, "ntt_mxu")
        wrapper.launches += 1
    return y


def transform(x, qs, roots, inverse: bool):
    """Forward (natural -> bit-reversed) or inverse 4-step NTT of x
    (M, nb, n) int64 >= 0, group m under modulus qs[m] with root roots[m]
    (psi forward, psi^-1 inverse, as `ops.ntt_stream.transform`).  Any
    input word is taken mod q; the output is canonical.  CPU tensors take
    the plain version, CUDA tensors the kernel."""
    qs, roots = tuple(int(q) for q in qs), tuple(int(r) for r in roots)
    M, nb, n = x.shape
    if len(qs) != M or len(roots) != M:
        raise ValueError(f"{M} groups but {len(qs)} moduli, {len(roots)} roots")
    if not dispatch.use_kernel(x):
        return transform_plain(x, qs, roots, inverse)
    return _launch(x, qs, roots, inverse, 1, transform)


def chain(x, q: int, root: int, k: int, inverse: bool):
    """k data-dependent transforms of x (nb, n) int64 >= 0 under modulus q
    in one launch (`ntt_chain_planes`): root is psi for the forward chain
    and psi^-1 for the inverse one.  Output canonical.  CPU tensors take
    the plain version, CUDA tensors the kernel."""
    q, root, k = int(q), int(root), int(k)
    if k < 1:
        raise ValueError(f"chain length {k}: at least 1 required")
    if not dispatch.use_kernel(x):
        return chain_plain(x, q, root, k, inverse)
    return _launch(x[None], (q,), (root,), inverse, k, chain)[0]


transform.launches = 0
chain.launches = 0
