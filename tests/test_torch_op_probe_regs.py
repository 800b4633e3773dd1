"""A NumPy model of csrc/probe_ops.cu's kernel (aloha_probe_ops).

`OpsModel` runs the kernel's schedule on uint64 arrays shaped (CTAs, 512
threads, 16 registers): one CTA a polynomial, each word at its place in
`csrc/ntt.cu`'s owner map of forward pass 1 at n = 8192 (register bit b
holds index bit 5 + b, the thread's bits fill index bits 0-4 and 9-12),
loaded once, stepped `reps` times in registers and stored once.  The same
butterflies on register pairs (r, r + 2^J) for v0's runtime distance 2^(5
+ J) and v13/v14's 32, each thread's two twiddles (w[32 + (i >> 8)] by
register bit 3), v9's select on bit sh of the index, v6's roll through
shared memory (word i written to slot roll(i), the thread's own slots read
back), and 64-bit wrap-around.  It is the only CPU check of the kernel's
index logic, and must equal `op_probe.probe_ops_plain` word for word in
every variant.  It also checks the layout: every register of a warp is 32
consecutive words (coalesced loads and stores), a distance-32 pair is two
registers r, r ^ 1 of one thread, a thread takes exactly two twiddle
indices, and v6's writes and reads are free of bank conflicts in every
warp.  The kernel's constants are read from the source.
"""

import re

import numpy as np
import pytest
import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch.probes import common as C
from aloha_tpu_torch.probes import op_probe

torch.set_num_threads(2)

M32 = np.uint64(0xFFFFFFFF)
SOURCE = (_build.CSRC / "probe_ops.cu").read_text()


def constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


# the geometry the kernel names: ntt_regs::Geometry<13>, forward pass P
LOGN = int(re.search(r"ntt_regs::Geometry<(\d+)>", SOURCE).group(1))
PASS, SH = constant("P"), constant("SH")
LOGT = max(0, LOGN - 4, min(5, LOGN - 1))
LOGR = LOGN - LOGT
T, R = 1 << LOGT, 1 << LOGR
TOP, BOT = LOGN - 1 - LOGR * PASS, max(0, LOGN - 1 - LOGR * PASS - LOGR + 1)


def off(r):
    """Index bits of register r: register bit b at index bit BOT + b."""
    return sum(((r >> b) & 1) << (BOT + b) for b in range(LOGR))


def base(j):
    """Index bits thread j owns: its bits below BOT stay, the rest go above TOP."""
    return (j & ((1 << BOT) - 1)) | ((j >> BOT) << (TOP + 1))


# ---------------------------------------------------- 64-bit arithmetic
def mulhi(a, b):
    """The high 64 bits of a * b (uint64 arrays), as __umul64hi."""
    a0, a1, b0, b1 = a & M32, a >> np.uint64(32), b & M32, b >> np.uint64(32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> np.uint64(32)) + (p01 & M32) + (p10 & M32)
    return p11 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) + (mid >> np.uint64(32))


def shoup(x, w, ws, q):
    return x * w - mulhi(x, ws) * q


def shoup_sparse(x, w, ws):
    """shoup_mul_sparse<32, 36, 59>: t q0 as t + t<<32 + t<<36 + t<<59."""
    t = mulhi(x, ws)
    return x * w - (t + (t << np.uint64(32)) + (t << np.uint64(36)) + (t << np.uint64(59)))


def condsub(x, q):
    return np.where(x >= q, x - q, x)


def swap32(x):
    return (x << np.uint64(32)) | (x >> np.uint64(32))


def rolled(r):
    """Register r's word after the roll by 32 in its row (the kernel's `rolled`)."""
    return (r & ~3) | ((r + 1) & 3)


def roll(i):
    """The index word i moves to: +32 inside its 128-word row."""
    return (i & ~127) | ((i + 32) & 127)


def check_banks(slots):
    """slots (threads, R) of one CTA: the 16 lanes of every half-warp hit 16
    distinct 8-byte bank pairs (slot mod 16) in every register's access."""
    for half in slots.reshape(-1, 16, slots.shape[1]):
        for r in range(slots.shape[1]):
            assert len(set((half[:, r] % 16).tolist())) == 16


# ------------------------------------------------------------ the model
class OpsModel:
    """The kernel on nb polynomials: a[cta, thread, register]."""

    def __init__(self, nb: int, tables):
        self.nb = nb
        self.w, self.ws, self.q = tables
        j, r = np.arange(T), np.arange(R)
        self.base = base(j)
        self.index = self.base[:, None] | off(r)[None, :]  # (T, R): a word's index
        # the thread's two twiddles: k and k + 1 by register bit 3
        self.k = 32 + (self.base >> 8)
        self.tw = self.k[:, None] + (r[None, :] >> 3)  # (T, R) twiddle index of a word

    def owner_map(self):
        """(nb, T, R) index of every register's word in the flat (nb N) array."""
        return np.arange(self.nb)[:, None, None] * C.N + self.index[None]

    def load(self, x: np.ndarray):
        where = self.owner_map()
        assert np.array_equal(np.sort(where.reshape(-1)), np.arange(x.size)), "a bijection"
        self.a = x.reshape(-1)[where]

    def store(self) -> np.ndarray:
        y = np.zeros(self.nb * C.N, dtype=np.uint64)
        y[self.owner_map()] = self.a
        return y.reshape(self.nb, C.N)

    def stage(self, J: int, sparse: bool):
        """One CT stage at distance 2^(SH + J): pairs (r, r + 2^J)."""
        D = 1 << J
        q = self.q
        q2 = np.uint64(2) * q
        for r in range(R):
            if r & D:
                continue
            assert (self.index[:, r + D] - self.index[:, r] == 1 << (SH + J)).all()
            w, ws = self.w[self.tw[:, r]], self.ws[self.tw[:, r]]
            u = condsub(self.a[:, :, r], q2)
            v = self.a[:, :, r + D]
            y = shoup_sparse(v, w, ws) if sparse else shoup(v, w, ws, q)
            self.a[:, :, r] = u + y
            self.a[:, :, r + D] = u + q2 - y

    def exchange(self):
        """v6: word i to slot roll(i), barrier, each thread's own slots back."""
        written = self.base[:, None] | off(rolled(np.arange(R)))[None, :]
        assert np.array_equal(written, roll(self.index)), "slot roll(i) takes word i"
        assert np.array_equal(np.sort(written.reshape(-1)), np.arange(C.N)), "a permutation"
        check_banks(written)
        check_banks(self.index)
        sm = np.zeros((self.nb, C.N), dtype=np.uint64)
        sm[:, written] = self.a
        self.a = sm[:, self.index]

    def step(self, v: str, sh: int):
        a, q = self.a, self.q
        w, ws = self.w[self.tw][None], self.ws[self.tw][None]
        lo, hi = a & M32, a >> np.uint64(32)
        if v == "v0":
            assert SH <= sh <= SH + 3, "the register bits 5-8"
            self.stage(sh - SH, sparse=False)
        elif v in ("v13", "v14"):
            self.stage(0, sparse=v == "v13")
        elif v == "v6":
            self.exchange()
        elif v in ("v1", "v11"):
            self.a = shoup(a, w, ws, q)
        elif v in ("v2", "v10"):
            self.a = mulhi(a, ws)
        elif v == "v3":
            self.a = a * w
        elif v == "v4":
            self.a = lo * hi
        elif v == "v5":
            self.a = (((hi + lo) & M32) << np.uint64(32)) | ((lo * hi) & M32)
        elif v == "v7":
            self.a = condsub(a, np.uint64(4) * q)
        elif v == "v8":
            self.a = a + swap32(a)
        elif v == "v9":
            bit = ((self.index >> sh) & 1).astype(bool)[None]
            self.a = np.where(bit, a, swap32(a))
        else:
            assert v == "v12"
            self.a = shoup_sparse(a, w, ws)

    def run(self, x: np.ndarray, v: str, reps: int, sh: int = SH) -> np.ndarray:
        self.load(x)
        for _ in range(reps):
            self.step(v, sh)
        return self.store()


def tables():
    w, ws = C.tables("cpu")
    return w.numpy().view(np.uint64), ws.numpy().view(np.uint64), np.uint64(C.Q)


def plain(x: torch.Tensor, v: str, reps: int):
    return op_probe.probe_ops_plain(x, v, reps).numpy().view(np.uint64)


# ------------------------------------------------------------- tests
def test_the_kernels_layout():
    """The source's geometry is the model's: pass 1 of ntt.cu at n = 8192,
    512 threads of 16 words, register bits at index bits 5-8, the C entry's
    distance 32; its header names the map."""
    assert (LOGN, PASS, SH, T, R, TOP, BOT) == (13, 1, 5, 512, 16, 8, 5)
    assert [off(r) for r in range(R)] == [r << 5 for r in range(R)]
    assert "__launch_bounds__(G::T, min_blocks(V))" in SOURCE
    assert "owner map of forward pass 1" in SOURCE


def test_owner_map():
    """Each word once; each register of a warp is 32 consecutive words
    (one coalesced load and store); a thread's words: lane bits 0-4,
    warp bits 9-12."""
    m = OpsModel(3, tables())
    where = m.owner_map()
    assert np.array_equal(np.sort(where.reshape(-1)), np.arange(3 * C.N))
    warps = m.index.reshape(T // 32, 32, R)
    assert (np.diff(warps, axis=1) == 1).all()
    assert (warps[:, 0, :] % 32 == 0).all()
    assert np.array_equal(m.index & 31, np.broadcast_to((np.arange(T) & 31)[:, None], (T, R)))


def test_pairs_and_twiddles():
    """The distance-32 pairs are registers r, r ^ 1 of one thread (v0's
    distances 64-256: r, r ^ 2^J); a thread takes exactly two twiddle
    indices, k and k + 1, each word's w[32 + (i >> 8)]."""
    m = OpsModel(1, tables())
    for J in range(4):
        for r in range(R):
            partner = r ^ (1 << J)
            assert (np.abs(m.index[:, partner] - m.index[:, r]) == 1 << (SH + J)).all()
    assert np.array_equal(m.tw, 32 + (m.index >> 8))
    per_thread = [sorted(set(row.tolist())) for row in m.tw]
    assert all(len(ks) == 2 and ks[1] == ks[0] + 1 for ks in per_thread)
    assert all(ks[0] == 32 + (b >> 8) for ks, b in zip(per_thread, m.base))


def test_exchange_is_free_of_bank_conflicts():
    """v6's write to slot roll(i) and read of slot i: a permutation of the
    8192 slots, every half-warp on 16 distinct bank pairs on both sides."""
    m = OpsModel(1, tables())
    m.load(C.resident_data(1, "cpu").numpy().view(np.uint64))
    m.exchange()  # asserts the slots and the banks


@pytest.mark.parametrize("variant", op_probe.VARIANTS)
def test_table_bytes_are_what_the_step_reads(variant):
    """`op_probe.TABLE_BYTES`, the table bytes in chip_smoke.py's bound:
    poisoning every entry outside row 5 (w[32 .. 63]) leaves the words as
    they were, and each table counted is one whose row 5 changes them."""
    w, ws, q = tables()
    x = C.resident_data(1, "cpu", seed=5).numpy().view(np.uint64)
    want = OpsModel(1, (w, ws, q)).run(x, variant, 2)
    rng = np.random.default_rng(3)
    row5 = np.zeros(C.N, dtype=bool)
    row5[32:64] = True

    def poisoned(t, where):
        t = t.copy()
        t[where] = rng.integers(0, 2**63, size=int(where.sum()), dtype=np.uint64)
        return t

    outside = (poisoned(w, ~row5), poisoned(ws, ~row5), q)
    assert np.array_equal(OpsModel(1, outside).run(x, variant, 2), want)
    read = sum(not np.array_equal(OpsModel(1, tb).run(x, variant, 2), want)
               for tb in ((poisoned(w, row5), ws, q), (w, poisoned(ws, row5), q)))
    assert op_probe.TABLE_BYTES[variant] == C.table_bytes((5,), read)


@pytest.mark.parametrize("variant", op_probe.VARIANTS)
def test_model_equals_plain(variant):
    """Every variant at nb = 1-3 and 0-3 repetitions, word for word."""
    tb = tables()
    for nb in (1, 2, 3):
        x = C.resident_data(nb, "cpu", seed=17 + nb)
        xs = x.numpy().view(np.uint64)
        for reps in (0, 1, 2, 3):
            got = OpsModel(nb, tb).run(xs, variant, reps)
            assert np.array_equal(got, plain(x, variant, reps)), (nb, reps)


@pytest.mark.parametrize("sh", [5, 6, 7, 8])
def test_runtime_distance_bodies(sh):
    """v0's body for each register bit (sh = 5-8) is the CT stage at
    distance 2^sh with the top word's row-5 twiddle, and v9's select at
    bit sh keeps a word where bit sh of its index is set."""
    w, ws, q = tb = tables()
    x = C.resident_data(2, "cpu", seed=sh)
    xs = x.numpy().view(np.uint64)
    got = OpsModel(2, tb).run(xs, "v0", 2, sh)
    want = xs.copy()
    i = np.arange(C.N)
    top = i[(i >> sh) & 1 == 0]
    k = 32 + (top >> 8)
    for _ in range(2):
        u = condsub(want[:, top], np.uint64(2) * q)
        y = shoup(want[:, top + (1 << sh)], w[k], ws[k], q)
        want[:, top], want[:, top + (1 << sh)] = u + y, u + np.uint64(2) * q - y
    assert np.array_equal(got, want)
    sel = OpsModel(2, tb).run(xs, "v9", 1, sh)
    assert np.array_equal(sel, np.where(((i >> sh) & 1).astype(bool), xs, swap32(xs)))
