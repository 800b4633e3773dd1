"""A NumPy model of csrc/ntt_regs.cuh, the register-pass schedule of csrc/ntt.cu.

`schedule_model` runs the kernel's schedule on Python ints, one row per
thread: the same geometry (T threads of R words, passes of up to log2 R
stages), the same owner maps (register bit b holds the pass's index bit BOT
+ b, then the top bits; the thread's bits fill the rest in increasing
order), the same swizzled shared-memory slots (written and read back in
place, one barrier per exchange), the same twiddle indices into the compact
tables (the kernel's formula, held against i >> (b + 1)), the same
Harvey/Shoup and halving butterflies with 64-bit wrap-around, and the same
windows.  It is the only CPU check of the kernel's index logic.  It must
equal `ntt_np` on the whole ring's tables at n = 2 to 16384, and
`ntt_torch.ntt_with_tables` / `intt_with_tables` on a shard's tables.
Every exchange must be a permutation of the n slots and, from n = 512 up,
free of bank conflicts on both sides: the 16 lanes of each half-warp access
16 distinct 8-byte bank pairs.

`schedule_model(..., C)` splits the polynomial over a cluster of C = 2 or
4 CTAs of T/C threads, as the kernel does below one wave: each CTA has
its own n/C-word buffer, and the one exchange that moves words between
CTAs (between forward passes 0 and 1) writes them into the owning CTA's
buffer, a second one inverse.  `exchange_plan` checks each exchange per
CTA (a permutation of its n/C slots, free of bank conflicts on both
sides, each warp writing a register to one CTA) and that the cross
exchange is the only one.

Every comparison is word-exact.
"""

import numpy as np
import pytest
import torch

from aloha_tpu import ntt_np
from aloha_tpu.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch.ops import ntt_stream

torch.set_num_threads(2)

CPU = torch.device("cpu")
M64 = (1 << 64) - 1


# ------------------------------------------------ the kernel's geometry
def geometry(logn: int):
    """(LOGT, LOGR, PASSES) of Geometry<LOGN>."""
    logt = max(0, logn - 4, min(5, logn - 1))
    logr = logn - logt
    return logt, logr, (-(-logn // logr) if logr else 1)


def top(logn: int, p: int) -> int:
    return logn - 1 - geometry(logn)[1] * p


def bot(logn: int, p: int) -> int:
    return max(0, top(logn, p) - geometry(logn)[1] + 1)


def regbit(logn: int, p: int, b: int, logc: int = 0) -> int:
    """The index bit of register bit b: the pass's own bits, then a short
    pass's extras, the top index bits below the cluster rank's."""
    u = top(logn, p) - bot(logn, p) + 1
    return bot(logn, p) + b if b < u else logn - 1 - logc - (b - u)


def off(logn: int, p: int, r: int, logc: int = 0) -> int:
    return sum(((r >> b) & 1) << regbit(logn, p, b, logc) for b in range(geometry(logn)[1]))


def base(logn: int, p: int, j, logc: int = 0):
    """The index bits thread J owns: its bits fill the bits the registers
    leave, in increasing order (so its top logc bits, the cluster rank,
    land on the top index bits in every pass but pass 0)."""
    logr = geometry(logn)[1]
    hi, lo = top(logn, p), bot(logn, p)
    mid = max(0, logn - logc - (logr - (hi - lo + 1)) - hi - 1)
    return ((j & ((1 << lo) - 1)) | (((j >> lo) & ((1 << mid) - 1)) << (hi + 1))
            | ((j >> (lo + mid)) << (logn - logc)))


def rankbit(logn: int, p: int, logc: int) -> int:
    """The index bit where the cluster rank (thread bits LOGT - logc and
    up) sits in pass p: below pass 0's register bits, else at the top."""
    return (geometry(logn)[0] if p == 0 else logn) - logc


def local(i, logn: int, rb: int, logc: int):
    """Index i within its CTA's n/C words: the rank's logc bits at rb
    swapped with the top logc bits, which are then dropped (i mod n/C when
    the rank is on top)."""
    m, hi = (1 << logc) - 1, logn - logc
    swapped = (i & ~(m << rb) & ~(m << hi)) | (((i >> rb) & m) << hi) | (((i >> hi) & m) << rb)
    return swapped & ((1 << hi) - 1)


def swz(i):
    return i ^ ((i >> 4) & 15)


# ---------------------------------------------------------- arithmetic
def _condsub(x, q):
    return np.where(x >= q, x - q, x)


def _shoup(x, w, ws, q):
    """x w mod q in [0, 2q): x w - floor(x ws / 2^64) q, modulo 2^64."""
    return (x * w - ((x * ws) >> 64) * q) & M64


def _halfmod(a, q):
    return (a >> 1) + np.where(a & 1, (q + 1) >> 1, 0)


def _ct(u, v, w, ws, q):
    x = _condsub(u, 2 * q)
    y = _shoup(v, w, ws, q)
    return x + y, x + 2 * q - y


def _gs(u, v, w, ws, q):
    return (_halfmod(_condsub(u + v, q), q),
            _halfmod(_condsub(_shoup(u + q - v, w, ws, q), q), q))


def _objects(a):
    return np.array([int(v) for v in np.asarray(a).ravel()], dtype=object).reshape(np.shape(a))


# ------------------------------------------------------- the schedule
def check_banks(slots):
    """slots (threads, R): the 16 lanes of every half-warp hit 16 distinct
    8-byte bank pairs (slot mod 16) in every register's access."""
    for half in slots.reshape(-1, 16, slots.shape[1]):
        for r in range(slots.shape[1]):
            assert len(set((half[:, r] % 16).tolist())) == 16


def check_exchange(slots, words: int):
    """slots (threads, R): the slot of each thread's register at one side of
    an exchange into one buffer of `words` slots.  A permutation of the
    slots and, from 512 words up, free of bank conflicts."""
    assert sorted(slots.ravel().tolist()) == list(range(words))
    if words >= 512:
        check_banks(slots)


def owner_map(logn: int, p: int, C: int):
    """(idx, rank): idx (T, R) the index of each thread's register in pass
    p; rank (T,) each thread's CTA in its cluster of C (its top bits)."""
    logt, logr, _ = geometry(logn)
    logc = C.bit_length() - 1
    J = np.arange(1 << logt)
    idx = base(logn, p, J, logc)[:, None] | np.array(
        [off(logn, p, r, logc) for r in range(1 << logr)])[None, :]
    return idx, J >> (logt - logc)


def exchange_plan(logn: int, C: int, inverse: bool) -> list:
    """The exchanges after each pass but the last, in the direction's order:
    (dest, slots, cross) with dest (T, R) the CTA each register is written
    to and slots (T, R) its slot there, by the next pass's map; cross when
    any word leaves its CTA.  Checks that each CTA's buffer receives a
    permutation of its n/C slots, that the next pass's threads own exactly
    the words their CTA receives and read them free of bank conflicts, that
    the writes are free of bank conflicts and each warp writes a register
    to one CTA, and that a cluster makes one cross exchange, between
    forward passes 0 and 1."""
    passes = geometry(logn)[2]
    logc = C.bit_length() - 1
    words = (1 << logn) // C
    order = list(range(passes - 1, -1, -1)) if inverse else list(range(passes))
    plan = []
    for p, pn in zip(order, order[1:]):
        idx, rank = owner_map(logn, p, C)
        rb = rankbit(logn, pn, logc)
        dest = (idx >> rb) & (C - 1)
        slots = swz(local(idx, logn, rb, logc))
        nidx, nrank = owner_map(logn, pn, C)
        assert ((nidx >> rb) & (C - 1) == nrank[:, None]).all()
        for c in range(C):
            assert sorted(slots[dest == c].tolist()) == list(range(words))
            check_exchange(swz(local(nidx, logn, rb, logc))[nrank == c], words)
        if words >= 512:
            check_banks(slots)
        if C > 1:
            for warp in dest.reshape(-1, 32, dest.shape[1]):
                assert (warp == warp[0]).all()
        plan.append((dest, slots, bool((dest != rank[:, None]).any())))
    assert [c for _, _, c in plan] == [C > 1 and {p, pn} == {0, 1}
                                       for p, pn in zip(order, order[1:])]
    return plan


def schedule_model(x, w, ws, q: int, inverse: bool, C: int = 1):
    """csrc/ntt_regs.cuh on one polynomial x (n,) with compact tables w, ws
    (n,), split over a cluster of C CTAs of T/C threads, each with its own
    n/C-word buffer: a[J, r] is register r of thread J (CTA J >> (LOGT -
    log2 C)).  A local exchange writes and reads back each CTA's own
    buffer; the cross exchange writes into the owning CTA's: its buffer
    `sh` forward (no pass has read it yet), a second buffer `xh` inverse
    (the other CTAs may still read `sh`).  Forward input < 4q, inverse
    < 2q; canonical output."""
    n = len(x)
    logn = n.bit_length() - 1
    logt, logr, passes = geometry(logn)
    logc = C.bit_length() - 1
    T, R = 1 << logt, 1 << logr
    assert T // C >= 32 or C == 1
    x, w, ws = _objects(x), _objects(w), _objects(ws)
    bufs = {"sh": np.full((C, n // C), None, dtype=object),
            "xh": np.full((C, n // C), None, dtype=object)}
    out = np.full(n, None, dtype=object)
    plan = exchange_plan(logn, C, inverse)
    src = None  # the buffer the previous exchange wrote
    for k in range(passes):
        p = passes - 1 - k if inverse else k
        idx, rank = owner_map(logn, p, C)
        bse = base(logn, p, np.arange(T), logc)
        if k == 0:
            a = _condsub(x[idx], q) if inverse else x[idx]
        else:  # each thread reads its words from its own CTA's buffer
            read = swz(local(idx, logn, rankbit(logn, p, logc), logc))
            a = bufs[src][rank[:, None], read]
            assert not any(v is None for v in a.ravel())
        lo_b, hi_b = bot(logn, p), top(logn, p)
        for b in (range(lo_b, hi_b + 1) if inverse else range(hi_b, lo_b - 1, -1)):
            rb = b - lo_b
            stage_base = (n >> (b + 1)) if inverse else 1 << (logn - 1 - b)
            t0 = stage_base + (bse >> (b + 1))
            for hi in range(R >> (rb + 1)):
                t = t0 + (off(logn, p, hi << (rb + 1), logc) >> (b + 1))
                for lo in range(1 << rb):
                    r = (hi << (rb + 1)) | lo
                    assert (idx[:, r] >> b & 1 == 0).all()
                    assert (idx[:, r | 1 << rb] == idx[:, r] + (1 << b)).all()
                    assert (t == stage_base + (idx[:, r] >> (b + 1))).all()
                    bfly = _gs if inverse else _ct
                    a[:, r], a[:, r | 1 << rb] = bfly(a[:, r], a[:, r | 1 << rb], w[t], ws[t], q)
        if k < passes - 1:
            dest, slots, cross = plan[k]
            src = "xh" if cross and inverse else "sh"
            if cross:  # into a buffer no CTA has read yet
                assert all(v is None for v in bufs[src].ravel())
            elif k > 0:  # written back in place: exactly the slots this thread read
                assert (dest == rank[:, None]).all() and (slots == read).all()
            bufs[src][dest, slots] = a
        else:
            out[idx] = a if inverse else _condsub(_condsub(a, 2 * q), q)
    assert not any(v is None for v in out)
    return out.astype(np.uint64)


def _root(n: int, m: int):
    """(q, psi, psi^-1): a primitive 2n-th root of unity under modulus m."""
    q = CFG.moduli[m]
    if n <= CFG.n:
        psi = pow(CFG.psi[m], CFG.n // n, q)
    else:
        psi = next(r for r in (pow(g, (q - 1) // (2 * n), q) for g in range(2, 100))
                   if pow(r, n, q) == q - 1)
    return q, psi, pow(psi, -1, q)


def _window_inputs(rng, n: int, q: int, inverse: bool):
    """Canonical words lifted to the top of the kernel's input window:
    [0, 4q) forward, [0, 2q) inverse, with q - 1 + (window - q) at both ends."""
    x = rng.integers(0, q, size=n, dtype=np.uint64)
    x += np.uint64(q) * rng.integers(0, 2 if inverse else 4, size=n, dtype=np.uint64)
    x[0] = x[-1] = (2 if inverse else 4) * q - 1
    return x


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [2, 16, 128, 1024, 2048, 4096, 8192, 16384])
def test_schedule_model_equals_ntt_np(n, inverse):
    """The whole ring's tables under P (the largest modulus: the most of
    [0, 4q) used; q1 at n = 16384, where 2n does not divide P - 1), inputs
    at the top of the window."""
    q, psi, ipsi = _root(n, 2 if n <= CFG.n else 1)
    root = ipsi if inverse else psi
    x = _window_inputs(np.random.default_rng(70 + n), n, q, inverse)
    w, ws = ntt_torch.twiddles_np(n, root, q)
    got = schedule_model(x, w, ws, q, inverse)
    red = x % np.uint64(q)
    want = ntt_np.intt(red, q, root) if inverse else ntt_np.ntt(red, q, root)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("D", [2, 4])
def test_schedule_model_on_shard_tables(D, inverse):
    """Each shard's compact tables (ntt_torch.shard_tables of the N = 8192
    ring under q0), read as the whole ring's: equal to the plain stage loop
    fed the same tables."""
    n, q = CFG.n, CFG.moduli[0]
    root = (CFG.ipsi if inverse else CFG.psi)[0]
    rng = np.random.default_rng(80 + D)
    for d in range(D):
        w, ws, _ = ntt_torch.shard_tables(n, q, root, D, d, inverse, CPU)
        x = _window_inputs(rng, n // D, q, inverse)
        got = schedule_model(x, cv.to_u64(w), cv.to_u64(ws), q, inverse)
        fn = ntt_torch.intt_with_tables if inverse else ntt_torch.ntt_with_tables
        want = cv.to_u64(fn(cv.from_u64(x[None], CPU), w, ws, q))[0]
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [512, 1024, 2048, 4096, 8192, 16384])
def test_exchanges_are_permutations_free_of_bank_conflicts(n):
    """Every pass's owner map through swz, at every length with 16 words a
    thread: the slots are a permutation and each half-warp's 16 accesses
    hit 16 distinct bank pairs."""
    logn = n.bit_length() - 1
    logt, logr, passes = geometry(logn)
    j = np.arange(1 << logt)
    for p in range(passes):
        idx = base(logn, p, j)[:, None] | np.array([off(logn, p, r) for r in range(1 << logr)])
        check_exchange(swz(idx), n)


def test_geometry_at_the_kernel_lengths():
    """Threads, words a thread, passes and exchanges: 3 exchanges (13 = 4 +
    4 + 4 + 1 stages) at n = 8192, one full warp from n = 64 to 512."""
    want = {1: (1, 1, 1), 2: (1, 2, 1), 4: (2, 2, 2), 16: (8, 2, 4), 64: (32, 2, 6), 128: (32, 4, 4),
            512: (32, 16, 3), 1024: (64, 16, 3), 4096: (256, 16, 3), 8192: (512, 16, 4),
            16384: (1024, 16, 4)}
    for n, (T, R, passes) in want.items():
        logt, logr, got_passes = geometry(n.bit_length() - 1)
        assert (1 << logt, 1 << logr, got_passes) == (T, R, passes)
    logn = 13
    assert [(top(logn, p), bot(logn, p)) for p in range(4)] == [(12, 9), (8, 5), (4, 1), (0, 0)]
    assert [regbit(logn, 3, b) for b in range(4)] == [0, 12, 11, 10]
    # pass 0 reads i = j + T r; the last forward pass owns adjacent pairs
    assert [off(logn, 0, r) for r in range(3)] == [0, 512, 1024]
    assert base(logn, 3, np.arange(3)).tolist() == [0, 2, 4]


#: (n, C, inverse) of the kernel's cluster instances: C = 2, 4 with T/C >=
#: 32, forward from n = 1024 and inverse from n = 4096 (ntt_stream.max_cluster)
CLUSTER_SHAPES = [(n, C, inverse) for n in (1024, 2048, 4096, 8192, 16384) for C in (2, 4)
                  for inverse in (False, True) if C <= ntt_stream.max_cluster(n, inverse)]


@pytest.mark.parametrize("n,C,inverse", CLUSTER_SHAPES)
def test_schedule_model_on_a_cluster_equals_ntt_np(n, C, inverse):
    """One polynomial split over a cluster of C CTAs: the same words as
    `ntt_np`, the whole ring's tables under P (q1 at n = 16384), inputs
    at the top of the window."""
    q, psi, ipsi = _root(n, 2 if n <= CFG.n else 1)
    root = ipsi if inverse else psi
    x = _window_inputs(np.random.default_rng(90 + n + C), n, q, inverse)
    w, ws = ntt_torch.twiddles_np(n, root, q)
    got = schedule_model(x, w, ws, q, inverse, C)
    red = x % np.uint64(q)
    want = ntt_np.intt(red, q, root) if inverse else ntt_np.ntt(red, q, root)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("C", [2, 4])
def test_schedule_model_on_a_cluster_on_shard_tables(C, inverse):
    """Both shards' compact tables at D = 2 (n = 4096 each) on a cluster of
    C CTAs: equal to the plain stage loop fed the same tables."""
    n, q, D = CFG.n, CFG.moduli[0], 2
    root = (CFG.ipsi if inverse else CFG.psi)[0]
    rng = np.random.default_rng(100 + C)
    for d in range(D):
        w, ws, _ = ntt_torch.shard_tables(n, q, root, D, d, inverse, CPU)
        x = _window_inputs(rng, n // D, q, inverse)
        got = schedule_model(x, cv.to_u64(w), cv.to_u64(ws), q, inverse, C)
        fn = ntt_torch.intt_with_tables if inverse else ntt_torch.ntt_with_tables
        want = cv.to_u64(fn(cv.from_u64(x[None], CPU), w, ws, q))[0]
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n,C", sorted({(n, C) for n, C, _ in CLUSTER_SHAPES}))
def test_a_cluster_makes_one_cross_exchange(n, C):
    """Each direction that has the instance: one exchange crosses CTAs,
    the one between forward passes 0 and 1 (after the first forward pass,
    before the last inverse one); every other keeps each word in its CTA at the slot it was read
    from.  The rank sits at thread bits LOGT - log2 C and up, so at index
    bits LOGT - log2 C and up in pass 0 and at the top in every other pass
    (a short last pass's extra register bits go below it)."""
    logn = n.bit_length() - 1
    logt, _, passes = geometry(logn)
    logc = C.bit_length() - 1
    for inverse in (False, True):
        if C > ntt_stream.max_cluster(n, inverse):
            continue
        crosses = [cross for _, _, cross in exchange_plan(logn, C, inverse)]
        assert crosses == ([True] + [False] * (passes - 2) if not inverse
                           else [False] * (passes - 2) + [True])
    for p in range(passes):
        idx, rank = owner_map(logn, p, C)
        rb = rankbit(logn, p, logc)
        assert ((idx >> rb) & (C - 1) == rank[:, None]).all()
        assert rb == (logt if p == 0 else logn) - logc
