"""A NumPy model of csrc/probe_stages.cu's lane kernel (aloha_probe_lane_stages).

`LaneModel` runs the kernel's schedule on uint64 arrays shaped (warps, 32
lanes, 8 registers): the same launch (nb * 64 groups of 128 words, 16
lanes a group, LANE_WARPS warps a CTA, whole warps idle past the last
group), the same owner map (register bits 1 and 2 hold index bits 5 and 6
for good, register bit 0 index bit r0, the lane bits the rest, tracked as
the kernel's `Layout`), the same trades (lanes lane and lane ^ 2^pos(b)
swap half their words, each lane's select by its bit at pos(b)), the same
butterflies on register pairs with the kernel's twiddle indices (one a
group up to table row 6, one a word above) and 64-bit wrap-around.  It is
the only CPU check of the kernel's index logic, and must equal
`stream_prof2.lane_stages_plain` word for word in every mode.  It also
checks that no pair and no shuffle leaves its group (and so its warp), that
every pair is two registers of one lane at the stage's distance, and that a
uniform row's one twiddle is every word's, and it counts the twiddle
indices the schedule needs, which `stream_prof2.needed_ops` charges.  The
kernel's constants are read from the source.
"""

import re

import numpy as np
import pytest
import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch.probes import common as C
from aloha_tpu_torch.probes import stream_prof2 as S

torch.set_num_threads(2)

M32 = np.uint64(0xFFFFFFFF)
GROUP, GROUP_BITS = 128, 7
SOURCE = (_build.CSRC / "probe_stages.cu").read_text()


def constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


LANE_WORDS, LANE_WARPS = constant("LANE_WORDS"), constant("LANE_WARPS")


# ---------------------------------------------------- 64-bit arithmetic
def mulhi(a, b):
    """The high 64 bits of a * b (uint64 arrays), as __umul64hi."""
    a0, a1, b0, b1 = a & M32, a >> np.uint64(32), b & M32, b >> np.uint64(32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> np.uint64(32)) + (p01 & M32) + (p10 & M32)
    return p11 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) + (mid >> np.uint64(32))


def shoup(x, w, ws, q):
    return x * w - mulhi(x, ws) * q


def condsub(x, q):
    return np.where(x >= q, x - q, x)


def add32x2(a, b):
    lo = ((a & M32) + (b & M32)) & M32
    hi = ((a >> np.uint64(32)) + (b >> np.uint64(32))) & M32
    return lo | (hi << np.uint64(32))


# ------------------------------------------------------------ the model
class LaneModel:
    """The lane kernel on nb polynomials."""

    def __init__(self, nb: int):
        self.W = LANE_WORDS
        self.reg_bits = LANE_WORDS.bit_length() - 1
        self.lane_bits = GROUP_BITS - self.reg_bits
        self.G = 1 << self.lane_bits  # lanes a group
        groups = nb * (C.N // GROUP)
        wg = 32 // self.G  # groups a warp
        warps = groups // wg
        assert warps * wg == groups, "whole warps"
        self.ctas = -(-warps // LANE_WARPS)
        # (cta, warp, lane) -> group, as the kernel computes it; the warps of
        # the last CTA past the last group return before any shuffle
        w_id = np.arange(self.ctas * LANE_WARPS)
        lane = np.arange(32)
        grp = w_id[:, None] * wg + lane[None, :] // self.G
        active = grp < groups
        assert (active.all(axis=1) | ~active.any(axis=1)).all(), "a warp is whole or idle"
        self.grp = grp[active.all(axis=1)]  # (warps, 32)
        assert sorted(np.unique(self.grp)) == list(range(groups))
        self.lane = lane
        self.gbase = (self.grp % (C.N // GROUP)) * GROUP
        # Layout: r0 and pos are the same in every lane, lane_i per lane
        self.r0 = self.lane_bits
        self.pos = {b: b for b in range(self.lane_bits)}
        self.lane_i = lane % self.G
        self.trades = []  # (stage bit, lane bit traded) of each trade
        self.pairs = 0  # butterflies (pairs) of every stage run
        self.twiddle_indices = 0  # one a group at a uniform row, one a word above

    def word_index(self, m: int):
        """(32,) index in the group of register m's word, every lane."""
        return (self.lane_i + ((m & 1) << self.r0)
                + ((m >> 1) << (self.lane_bits + 1)))

    def owner_map(self):
        """(warps, 32, W) index of every register's word in the flat (nb N) array."""
        return np.stack([self.grp * GROUP + self.word_index(m)[None, :]
                         for m in range(self.W)], axis=2)

    def load(self, x: np.ndarray):
        flat = x.reshape(-1)
        where = self.owner_map()
        assert np.array_equal(np.sort(where.reshape(-1)), np.arange(flat.size)), "a bijection"
        self.a = flat[where]

    def store(self, nb: int) -> np.ndarray:
        y = np.zeros(nb * C.N, dtype=np.uint64)
        where = self.owner_map()
        assert np.array_equal(np.sort(where.reshape(-1)), np.arange(y.size)), "a bijection"
        y[where] = self.a
        return y.reshape(nb, C.N)

    def trade(self, b: int):
        """Index bit b into register bit 0 (the kernel's `trade`)."""
        p = self.pos[b]
        partner = self.lane ^ (1 << p)
        assert (partner // self.G == self.lane // self.G).all(), "a shuffle stays in its group"
        upper = ((self.lane >> p) & 1).astype(bool)[None, :]
        for m in range(0, self.W, 2):
            send = np.where(upper, self.a[:, :, m], self.a[:, :, m + 1])
            got = send[:, partner]  # __shfl_xor_sync(send, 2^p)
            self.a[:, :, m] = np.where(upper, got, self.a[:, :, m])
            self.a[:, :, m + 1] = np.where(upper, self.a[:, :, m + 1], got)
        self.lane_i = self.lane_i + np.where(upper[0], (1 << self.r0) - (1 << b), 0)
        self.pos[self.r0] = p
        del self.pos[b]
        self.r0 = b
        self.trades.append((b, p))

    def stage(self, b: int, row: int, mode: str, tables):
        """One lane stage at distance 2^b, twiddle row `row` (`lane_stage`)."""
        if b > self.lane_bits:
            J = b - self.lane_bits
        else:
            if self.r0 != b:
                self.trade(b)
            J = 0
        D = 1 << J
        w, ws, q = tables
        q2 = np.uint64(2) * q
        sh = C.LOGN - row
        uniform = sh >= GROUP_BITS
        self.pairs += self.a.size // 2
        if mode in ("full", "statS"):
            self.twiddle_indices += len(np.unique(self.grp)) if uniform else self.a.size
        for m in range(self.W):
            if m & D:
                continue
            i, j = self.word_index(m), self.word_index(m + D)
            assert ((j - i) == (1 << b)).all(), "a pair is two registers at the distance"
            assert (i // GROUP == j // GROUP).all() and (j < GROUP).all()
            u, v = self.a[:, :, m], self.a[:, :, m + D]
            if mode == "nobfly":
                self.a[:, :, m] = self.a[:, :, m + D] = add32x2(u, v)
                continue
            if mode == "statT":
                wi = wj = np.full(u.shape, w[1])
                wsi = wsj = np.full(u.shape, ws[1])
            else:
                ki = (1 << row) + ((self.gbase + i[None, :]) >> sh)
                kj = (1 << row) + ((self.gbase + j[None, :]) >> sh)
                if uniform:  # one twiddle serves the group: every word's
                    k = (1 << row) + (self.gbase >> sh)
                    assert np.array_equal(k, ki) and np.array_equal(k, kj)
                wi, wsi, wj, wsj = w[ki], ws[ki], w[kj], ws[kj]
            x2 = condsub(u, q2)
            self.a[:, :, m] = x2 + shoup(v, wi, wsi, q)
            self.a[:, :, m + D] = x2 + q2 - shoup(v, wj, wsj, q)

    def run(self, x: np.ndarray, mode: str, nstages: int, reps: int, tables) -> np.ndarray:
        self.load(x)
        for _ in range(reps):
            for s in range(nstages):
                b = 4 if mode == "statS" else GROUP_BITS - 1 - s % 7
                self.stage(b, s % C.LOGN, mode, tables)
        return self.store(x.shape[0])


def tables():
    w, ws = C.tables("cpu")
    return w.numpy().view(np.uint64), ws.numpy().view(np.uint64), np.uint64(C.Q)


def model(x: torch.Tensor, mode: str, nstages: int, reps: int):
    xs = x.numpy().view(np.uint64)
    return LaneModel(x.shape[0]).run(xs, mode, nstages, reps, tables())


def plain(x: torch.Tensor, mode: str, nstages: int, reps: int):
    return S.lane_stages_plain(x, mode, nstages, reps).numpy().view(np.uint64)


# ------------------------------------------------------------- tests
def test_the_kernels_layout():
    """The source's layout is the model's; its header names it."""
    assert LANE_WORDS == 8 and LANE_WARPS >= 1
    assert f"{LANE_WORDS} words a lane" in SOURCE


@pytest.mark.parametrize("nstages", [0, 1, 2, 7, 13, 14, 26])
@pytest.mark.parametrize("mode", S.MODES)
def test_model_equals_plain(mode, nstages):
    """Every mode at nb = 1-3 and 0, 1, 3 repetitions, word for word."""
    for nb in (1, 2, 3):
        x = C.resident_data(nb, "cpu", seed=16 + nb)
        for reps in (0, 1, 3):
            assert np.array_equal(model(x, mode, nstages, reps), plain(x, mode, nstages, reps)), (
                nb, reps)


def test_schedule():
    """Which stages trade: never those at a bit a register holds for good
    (64 and 32), nor statS (its bit 16 starts in register bit 0); a bit
    already in register bit 0 stays; every trade's partner lane is in the
    group."""
    x = C.resident_data(1, "cpu")
    m = LaneModel(1)
    m.run(x.numpy().view(np.uint64), "nobfly", 13, 2, tables())
    traded = [b for b, _ in m.trades]
    assert all(b <= m.lane_bits for b in traded)
    fixed = (6, 5)
    expect = []
    r0 = m.lane_bits
    for _ in range(2):
        for s in range(13):
            b = 6 - s % 7
            if b not in fixed and b != r0:
                expect.append(b)
                r0 = b
    assert traded == expect
    assert len(traded) == 17  # 8 trades in the first repetition, 9 after
    s = LaneModel(1)
    s.run(x.numpy().view(np.uint64), "statS", 13, 2, tables())
    assert not s.trades


@pytest.mark.parametrize("nb", [1, 3, 133])
def test_launch_covers_each_word_once(nb):
    """nb * 64 groups over whole warps of LANE_WARPS a CTA; before any stage
    each register's words form 16-word runs (coalesced loads and stores)."""
    m = LaneModel(nb)
    where = m.owner_map()
    assert np.array_equal(np.sort(where.reshape(-1)), np.arange(nb * C.N))
    assert m.ctas == -(-nb * C.N // (32 * LANE_WORDS) // LANE_WARPS)
    runs = where.reshape(where.shape[0], 32 // m.G, m.G, m.W)
    assert (np.diff(runs, axis=2) == 1).all()


@pytest.mark.parametrize("case", S.CASES)
def test_needed_ops_count_the_schedules_work(case):
    """`stream_prof2.needed_ops`, the least work beside the unchanged bound,
    is the model's pairs at NEEDED_PAIR_OPS each plus its twiddle indices
    at C.INDEX each, and never more than `ops`."""
    mode, nstages = S.parse(case)
    m = LaneModel(1)
    m.run(C.resident_data(1, "cpu").numpy().view(np.uint64), mode, nstages, 1, tables())
    assert m.pairs == nstages * C.N // 2
    assert S.needed_ops(mode, nstages) == (m.pairs * S.NEEDED_PAIR_OPS[mode]
                                           + m.twiddle_indices * C.INDEX)
    assert S.needed_ops(mode, nstages) <= S.ops(mode, nstages)
