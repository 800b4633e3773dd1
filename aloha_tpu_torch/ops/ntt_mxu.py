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

The kernel takes both products on `wgmma` in the transposed form (M = the
128 lanes) and streams each (modulus, direction)'s tables through a ring
of shared-memory slots by 1-D bulk copies; `table_stream` lays them out
once as the exact bytes of every slot, in the order the kernel reads them.
It takes n = 256 .. 16384 (`KERNEL_RINGS`; `geometry`): below n = 4096 a
CTA holds P = 8192 / n polynomials as n = 8192's 64 rows, its row tables
block-diagonal (`packed_rows`); at n = 16384 each product runs in two
column halves of 64.  Bound on the H100: 8192 R^2 + 1,048,576 R int8 MACs
per transform (R = n / 128), 101.7 ns per polynomial at n = 8192 at the
dense int8 peak; each CTA streams its 1.25 MiB of table once per transform
from L2 (3 MiB at n = 16384).  What holds it back at n = 8192 is inside
the SM, not the L2 stream (`csrc/ntt_mxu.cu`, PERF.md).
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from aloha_tpu_torch import _build, ntt_np
from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.profiling import span

LANES = 128
NDIG = 8  # base-256 digits of a u64
#: The rings the kernel takes: R = n / 128 = 2 .. 128 (the stream NTT's own cap).
KERNEL_RINGS = (256, 512, 1024, 2048, 4096, 8192, 16384)
TILE = 16384  # bytes of one stage of the kernel's table stream (one ring slot)

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


def swizzle128(rows: np.ndarray) -> np.ndarray:
    """(..., r, 128) int8 tile rows -> the layout the kernel's wgmma
    descriptors read (csrc/wgmma_s8.cuh): 16-byte chunk c of row r stored at
    chunk c ^ (r mod 8)."""
    r = rows.shape[-2]
    chunks = rows.reshape(rows.shape[:-1] + (LANES // 16, 16))
    place = np.arange(LANES // 16)[None, :] ^ (np.arange(r) % 8)[:, None]  # an involution
    return np.ascontiguousarray(chunks[..., np.arange(r)[:, None], place, :]).reshape(rows.shape)


def geometry(n: int):
    """(RK, P, N) of csrc/mxu_core.cuh's Ring<R>, R = n / 128: a CTA's words
    are RK rows of 128, P polynomials of R rows (R < 32: 64 rows, P = 64 /
    R); each product step takes its RK output columns in RK / N products of
    N = min(RK, 64) columns."""
    R = n // LANES
    RK = 64 if R < 32 else R
    return RK, RK // R, min(RK, 64)


def packed_rows(row: np.ndarray) -> np.ndarray:
    """(8, R, 8R) row digits -> the (8, RK, 8 RK) ones of a CTA's P
    polynomials: block-diagonal, [j, p R + i, kk RK + p R + r] = row[j, i,
    kk R + r] and zero digits elsewhere, so that the P row products are one
    of n = 8192's shape.  The identity at P = 1."""
    nd, R, _ = row.shape
    RK, P, _ = geometry(R * LANES)
    out = np.zeros((nd, P, R, NDIG, P, R), dtype=row.dtype)
    src = row.reshape(nd, R, NDIG, R)
    for p in range(P):
        out[:, p, :, :, p, :] = src
    return out.reshape(nd, RK, NDIG * RK)


def row_stages(row: np.ndarray) -> np.ndarray:
    """(8, RK, 8 RK) row digits -> (RK / N x 8 RK / 32, 2 N 128) int8, N =
    min(RK, 64): stage (h, j, p) holds the (N x 128-byte) tiles of k-blocks
    2p and 2p + 1 of rows h N .. h N + N - 1 of A_j (row i = row i of A_j,
    bytes 128 kb .. 128 kb + 127), each swizzled."""
    nd, RK, K = row.shape
    N = min(RK, 64)
    tiles = row.reshape(nd, RK // N, N, K // LANES, LANES).transpose(1, 0, 3, 2, 4)
    return swizzle128(tiles).reshape(RK // N * nd * K // (2 * LANES), 2 * N * LANES)


def lane_stages(lane: np.ndarray) -> np.ndarray:
    """(8, 1024, 128) lane digits [j, k, c] -> (64, 16384) int8: stage (j, kk)
    holds the (128 x 128-byte) tile of T_j^T for plane kk (row c = column c
    of T_j, bytes l = 0..127 of k = 128 kk + l), swizzled."""
    nd = lane.shape[0]
    tiles = lane.reshape(nd, NDIG, LANES, LANES).transpose(0, 1, 3, 2)
    return swizzle128(tiles).reshape(nd * NDIG, TILE)


def table_stream(tb: Tables, inverse: bool) -> np.ndarray:
    """(stages, TILE) int8: the kernel's table stream of one (modulus,
    direction), each stage the exact bytes of one shared-memory slot, in the
    order the kernel reads them (rows then lanes forward, lanes then rows
    inverse; each product's stages once per column half, RK / N times).  The
    rows are `packed_rows`; a row stage's 2 N 128 bytes are padded to TILE."""
    rows = row_stages(packed_rows(tb.row))
    rows = np.pad(rows, ((0, 0), (0, TILE - rows.shape[1])))
    RK, _, N = geometry(tb.tw.size)
    lanes = np.concatenate([lane_stages(tb.lane)] * (RK // N))
    return np.concatenate([lanes, rows] if inverse else [rows, lanes])


def kernel_constants(tb: Tables):
    """(tw, tws, crow) as the kernel reads them: (RK 128,), (RK 128,), (RK,)
    uint64, a small ring's repeated over its P polynomials."""
    _, P, _ = geometry(tb.tw.size)
    return np.tile(tb.tw.reshape(-1), P), np.tile(tb.tws.reshape(-1), P), np.tile(tb.crow, P)


@functools.lru_cache(maxsize=16)
@span("aloha.build.mxu_tables")
def kernel_tables(n: int, qs: tuple, roots: tuple, inverse: bool, device: torch.device):
    """Stacked per-modulus kernel operands on `device`: the table stream
    (M, stages x TILE) int8, tw, tws (M, RK 128), crow (M, RK), ccol (M,
    128) and q (int64)."""
    per = [tables_np(n, q, _forward_root(q, r, inverse), inverse) for q, r in zip(qs, roots)]
    stream = np.stack([table_stream(t, inverse).reshape(-1) for t in per])
    tw, tws, crow = zip(*(kernel_constants(t) for t in per))
    return (torch.from_numpy(stream).to(device),
            *(_stack_u64(a, device) for a in (tw, tws, crow, [t.ccol for t in per])),
            torch.tensor(qs, dtype=torch.int64, device=device))


def _stack_u64(arrays, device) -> torch.Tensor:
    return torch.from_numpy(np.stack([a.reshape(-1).view(np.int64) for a in arrays])).to(device)


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
        acc = rt.plain.addmod(acc, rt.barrett(u[j], pow(2, 8 * j, q), q), q)
    return acc


def row_products(x, row):
    """(nb, R, 128) -> the 8 exact row-product accumulators (8, nb, R, 128)
    float64, data digits along the contraction k = kk R + r: one 2-D
    product (8 R x 8R) . (8R x nb 128), no operand repeated over the batch."""
    nb, R, L = x.shape
    s = _digits(x).permute(0, 2, 1, 3).reshape(NDIG * R, nb * L)
    e = torch.matmul(row.reshape(NDIG * R, NDIG * R), s)
    return e.reshape(NDIG, R, nb, L).transpose(1, 2)


def lane_products(x, lane):
    """(nb, R, 128) -> the 8 exact lane-product accumulators (8, nb, R, 128)
    float64, data digits along the contraction k = kk 128 + l: one 2-D
    product (nb R x 1024) . (1024 x 8 128)."""
    nb, R, L = x.shape
    s = _digits(x).permute(1, 2, 0, 3).reshape(nb * R, NDIG * L)
    e = torch.matmul(s, lane.permute(1, 0, 2).reshape(NDIG * L, NDIG * L))
    return e.reshape(nb, R, NDIG, L).permute(2, 0, 1, 3)


def _row_step(x, tb: Tables, q: int):
    return _reduce(row_products(x, tb.row), bias_bits(NDIG * x.shape[1]), tb.crow[:, None], q)


def _lane_step(x, tb: Tables, q: int):
    return _reduce(lane_products(x, tb.lane), bias_bits(NDIG * LANES), tb.ccol, q)


def _transform1(x, q: int, root: int, inverse: bool):
    nb, n = x.shape
    tb = plain_tables(n, q, int(root), inverse, x.device)
    first, second = (_lane_step, _row_step) if inverse else (_row_step, _lane_step)
    v = rt.plain.mulmod(first(x.reshape(nb, n // LANES, LANES), tb, q), tb.tw, q)
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
def _launch(x, qs, roots, inverse: bool, k: int, call):
    """Launch the kernel on x (M, nb, n) by `call`, which counts it."""
    M, nb, n = x.shape
    dispatch.check(x, (M, nb, n), "x")
    if n not in KERNEL_RINGS:
        raise ValueError(f"ring degree {n}: the kernel takes n in {KERNEL_RINGS}")
    stream, tw, tws, crow, ccol, qt = kernel_tables(n, qs, roots, inverse, x.device)
    y = torch.empty_like(x)
    if nb:
        call(
            x.device.index, x.data_ptr(), y.data_ptr(), stream.data_ptr(),
            tw.data_ptr(), tws.data_ptr(), crow.data_ptr(), ccol.data_ptr(),
            qt.data_ptr(), M, nb, n.bit_length() - 1, k, int(inverse),
            dispatch.stream_of(x),
        )
    return y


@span("aloha.kernel.ntt_mxu")
def _launch_transform(*args):
    _build.check(_build.lib().aloha_ntt_mxu(*args), "ntt_mxu")
    transform.launches += 1


@span("aloha.kernel.ntt_mxu_chain")
def _launch_chain(*args):
    _build.check(_build.lib().aloha_ntt_mxu(*args), "ntt_mxu")
    chain.launches += 1


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
    return _launch(x, qs, roots, inverse, 1, _launch_transform)


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
    return _launch(x[None], (q,), (root,), inverse, k, _launch_chain)[0]


transform.launches = 0
chain.launches = 0
