"""A NumPy model of csrc/probe_stages.cu's stage-modes kernel (aloha_probe_stage_modes).

`StageModesModel` runs the kernel's schedule on uint64 arrays shaped (CTAs,
512 threads, 16 registers): one CTA a polynomial in `csrc/ntt.cu`'s
geometry, each word at its place in an owner map Map<B0, B1, B2, B3>
(register bit k holds index bit B_k, the thread's bits fill the other
index bits in increasing order), loaded once, stepped `reps` times and
stored once.  The maps, rollsonly's stage and exchange sequence and its
stated exchange count are read from the kernel's source; the full mode's
passes are `csrc/ntt_regs.cuh`'s (`test_torch_ntt_regs`'s model of them):

- full: `ntt_regs::run`'s four passes with their twiddle indices (the
  kernel's formula, held against the stage's), one transform after
  another, the last pass's words written to their pass-0 slots and read
  back by the next transform after one barrier;
- rollsonly: the stages' pairs in registers of one thread, the exchanges
  between the maps through the swizzled slots swz(i);
- noroll: the elementwise stages in registers, one (w, ws) load for each
  distinct twiddle of a thread and stage.

`Shared` holds one CTA's 8192 slots and checks every access: a thread
reads a slot another thread wrote, or writes a slot another thread read or
wrote, only across a barrier; every warp access is free of bank conflicts
(the 16 lanes of each half-warp on 16 distinct 8-byte bank pairs).  Global
loads and stores must be coalesced (each warp access covers whole 32-byte
sectors).  The model must equal `stream_prof.stage_modes_plain` and
`stream_prof3.fwd_reps_plain` word for word.  It is the only CPU check of
the kernel's index logic.
"""

import re

import numpy as np
import pytest
import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch.probes import common as C
from aloha_tpu_torch.probes import stream_prof, stream_prof3
from test_torch_ntt_regs import base as pass_base
from test_torch_ntt_regs import bot, check_banks, geometry, regbit, swz, top
from test_torch_ntt_regs import off as pass_off

torch.set_num_threads(2)

M32 = np.uint64(0xFFFFFFFF)
SOURCE = (_build.CSRC / "probe_stages.cu").read_text()
KERNEL = SOURCE[SOURCE.index("// ---------------------------------------------------------- stage modes"):
                SOURCE.index("// ---------------------------------------------------------- lane stages")]

LOGN = int(re.search(r"constexpr int LOGN = (\d+);", SOURCE).group(1))
CLUSTER = int(re.search(r"using G = ntt_regs::Geometry<LOGN, (\d+)>;", KERNEL).group(1))
LOGT, LOGR, PASSES = geometry(LOGN)
T, R = 1 << LOGT, 1 << LOGR
MAPS = {name: tuple(int(b) for b in bits) for name, *bits in
        re.findall(r"using (Map\w+) = Map<(\d+), (\d+), (\d+), (\d+)>;", KERNEL)}
ROLL_EXCHANGES = int(re.search(r"constexpr int ROLL_EXCHANGES = (\d+);", KERNEL).group(1))
_ROLL_BODY = KERNEL[KERNEL.index("MODE == ROLLSONLY"):KERNEL.index("store<MapA>(y, a, ba, false);")]
#: rollsonly's repetition as the kernel writes it: ("stages", map, bits) and
#: ("exchange", from, to), in order
ROLL_SCHEDULE = [("stages", m, tuple(int(b) for b in bits.split(","))) if m else
                 ("exchange", x, y) for m, bits, x, y in re.findall(
                     r"roll_stages<(Map\w+), ([\d, ]+)>\(a\)|exchange<(Map\w+), (Map\w+)>\(",
                     _ROLL_BODY)]
SECTOR_WORDS = 4  # a 32-byte sector of 8-byte words


class Race(AssertionError):
    """A shared-memory access the kernel's barriers do not order."""


# ------------------------------------------------------------ owner maps
class OwnerMap:
    """Register bit k holds index bit bits[k]; thread bits fill the rest of
    the LOGN index bits in increasing order.  idx (T, R): word index of
    register r of thread j."""

    def __init__(self, bits):
        self.bits = tuple(bits)
        assert len(set(self.bits)) == LOGR and all(0 <= b < LOGN for b in self.bits)
        free = [b for b in range(LOGN) if b not in self.bits]
        j, r = np.arange(T), np.arange(R)
        self.base = sum(((j >> t) & 1) << b for t, b in enumerate(free))
        self.off = sum(((r >> k) & 1) << b for k, b in enumerate(self.bits))
        self.idx = self.base[:, None] | self.off[None, :]
        assert np.array_equal(np.sort(self.idx.ravel()), np.arange(1 << LOGN)), "a bijection"
        self.pairs = self.bits[0] == 0

    def regbit(self, b: int) -> int:
        return self.bits.index(b)


def pass_map(p: int) -> OwnerMap:
    """csrc/ntt_regs.cuh's forward pass p at C = 1, checked against its base."""
    m = OwnerMap([regbit(LOGN, p, b) for b in range(LOGR)])
    assert np.array_equal(m.base, pass_base(LOGN, p, np.arange(T)))
    assert [int(o) for o in m.off] == [pass_off(LOGN, p, r) for r in range(R)]
    return m


PASS_MAPS = [pass_map(p) for p in range(PASSES)]
KERNEL_MAPS = {name: OwnerMap(bits) for name, bits in MAPS.items()}


def check_coalesced(m: OwnerMap):
    """Each warp access covers whole 32-byte sectors and nothing else: one
    register a lane, or, where the map holds pairs (i, i + 1), one register
    pair a lane (a 16-byte access when vec, else two 8-byte ones issued
    back to back on the same sectors)."""
    step = 2 if m.pairs else 1
    for warp in m.idx.reshape(-1, 32, R):
        for r in range(0, R, step):
            words = warp[:, r:r + step]
            if step == 2:
                assert (words[:, 1] == words[:, 0] + 1).all()
            words = np.unique(words)
            assert words.size == 32 * step
            sectors = np.unique(words // SECTOR_WORDS)
            assert words.size == SECTOR_WORDS * sectors.size, "a sector partly used"


# ---------------------------------------------------------- arithmetic
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


# ------------------------------------------------------- shared memory
class Shared:
    """One CTA's shared words (every CTA runs the same accesses on its own):
    values (nb, slots), and each slot's last writer and reader with the
    barrier count at the time."""

    def __init__(self, nb: int, words: int):
        self.val = np.zeros((nb, words), dtype=np.uint64)
        self.w_thr, self.r_thr = np.full(words, -1), np.full(words, -1)
        self.w_bar, self.r_bar = np.full(words, -1), np.full(words, -1)
        self.barriers = 0
        self.thr = np.broadcast_to(np.arange(T)[:, None], (T, R))

    def write(self, slots, vals):
        if np.unique(slots).size != slots.size:
            raise Race("two registers written to one slot")
        if ((self.r_bar[slots] == self.barriers) & (self.r_thr[slots] != self.thr)).any():
            raise Race("a store into a slot another thread read since the last barrier")
        if ((self.w_bar[slots] == self.barriers) & (self.w_thr[slots] != self.thr)).any():
            raise Race("a store into a slot another thread wrote since the last barrier")
        check_banks(slots)
        self.val[:, slots] = vals
        self.w_thr[slots], self.w_bar[slots] = self.thr, self.barriers

    def read(self, slots):
        if (self.w_thr[slots] < 0).any():
            raise Race("a read of a slot never written")
        if ((self.w_bar[slots] == self.barriers) & (self.w_thr[slots] != self.thr)).any():
            raise Race("a read of another thread's store before a barrier")
        check_banks(slots)
        self.r_thr[slots], self.r_bar[slots] = self.thr, self.barriers
        return self.val[:, slots]

    def barrier(self):
        self.barriers += 1


# ------------------------------------------------------------ the model
class StageModesModel:
    """The kernel on nb polynomials: a[cta, thread, register]."""

    def __init__(self, nb: int, tables, barriers: bool = True):
        self.nb = nb
        self.w, self.ws, self.q = tables
        self.mem = Shared(nb, 1 << LOGN)
        self.barriers = barriers  # False: the exchanges lose their barrier (to be caught)
        self.loaded = []  # noroll: per stage, the (T, loads) twiddle indices

    def load(self, x, m: OwnerMap):
        check_coalesced(m)
        return x[:, m.idx]

    def store(self, a, m: OwnerMap):
        check_coalesced(m)
        y = np.zeros((self.nb, 1 << LOGN), dtype=np.uint64)
        y[:, m.idx] = a
        return y

    def exchange(self, a, x: OwnerMap, y: OwnerMap):
        """Each word to its slot swz(i), one barrier, each of map y's from its slot."""
        self.mem.write(swz(x.idx), a)
        if self.barriers:
            self.mem.barrier()
        return self.mem.read(swz(y.idx))

    # full: ntt_regs::run, chained
    def transform(self, a, x=None, src="global", dst="regs"):
        q = np.uint64(self.q)
        j = np.arange(T)
        for p in range(PASSES):
            m = PASS_MAPS[p]
            if p == 0 and src == "global":
                a = self.load(x, m)
            elif p > 0 or src == "shared":
                a = self.mem.read(swz(m.idx))
            a = a.copy()
            hi_b, lo_b = top(LOGN, p), bot(LOGN, p)
            for b in range(hi_b, lo_b - 1, -1):
                rb = b - lo_b
                # the kernel's C = 1 index: 2^(LOGN-1-b) + ((j >> BOT) << (TOP - b))
                t0 = (1 << (LOGN - 1 - b)) + ((j >> lo_b) << (hi_b - b))
                for hi in range(R >> (rb + 1)):
                    t = t0 + (int(m.off[hi << (rb + 1)]) >> (b + 1))
                    for lo in range(1 << rb):
                        r = (hi << (rb + 1)) | lo
                        assert (m.idx[:, r | 1 << rb] == m.idx[:, r] + (1 << b)).all()
                        assert (t == (1 << (LOGN - 1 - b)) + (m.idx[:, r] >> (b + 1))).all()
                        u, v = a[:, :, r], a[:, :, r | 1 << rb]
                        y = shoup(v, self.w[t], self.ws[t], q)
                        u = condsub(u, np.uint64(2) * q)
                        a[:, :, r], a[:, :, r | 1 << rb] = u + y, u + np.uint64(2) * q - y
            if p < PASSES - 1:
                self.mem.write(swz(m.idx), a)
                if self.barriers:
                    self.mem.barrier()
            else:
                a = condsub(condsub(a, np.uint64(2) * q), q)
        if dst == "global":
            return self.store(a, PASS_MAPS[-1])
        return a

    def chain(self, a):
        """to_shared<LOGN, 1, LAST, 0>: the last pass's words at their pass-0
        slots, then one barrier."""
        self.mem.write(swz(PASS_MAPS[-1].idx), a)
        if self.barriers:
            self.mem.barrier()

    def full(self, x, reps: int):
        if reps == 0:
            return self.store(self.load(x, KERNEL_MAPS["MapA"]), KERNEL_MAPS["MapA"])
        if reps == 1:
            return self.transform(None, x, "global", "global")
        a = self.transform(None, x, "global", "regs")
        for _ in range(2, reps):
            self.chain(a)
            a = self.transform(a, src="shared", dst="regs")
        self.chain(a)
        return self.transform(a, src="shared", dst="global")

    # rollsonly: ROLL_SCHEDULE in registers and exchanges
    def rollsonly(self, x, reps: int):
        first = KERNEL_MAPS[ROLL_SCHEDULE[0][1]]
        a = self.load(x, first)
        for _ in range(reps):
            for step in ROLL_SCHEDULE:
                if step[0] == "exchange":
                    a = self.exchange(a, KERNEL_MAPS[step[1]], KERNEL_MAPS[step[2]])
                    continue
                m = KERNEL_MAPS[step[1]]
                a = a.copy()
                for b in step[2]:
                    J = m.regbit(b)
                    for r in range(R):
                        if r >> J & 1:
                            continue
                        assert (m.idx[:, r | 1 << J] == m.idx[:, r] + (1 << b)).all()
                        a[:, :, r] = a[:, :, r | 1 << J] = add32x2(a[:, :, r], a[:, :, r | 1 << J])
        return self.store(a, first)

    # noroll: elementwise in registers, one load a distinct twiddle
    def noroll(self, x, reps: int):
        m = KERNEL_MAPS["MapNoroll"]
        q = np.uint64(self.q)
        a = self.load(x, m)
        for _ in range(reps):
            self.loaded = []
            for s in range(LOGN):
                sh = LOGN - s
                mask = sum(1 << k for k, b in enumerate(m.bits) if b >= sh)
                loads = []
                for g in range(R):
                    if g & ~mask:
                        continue
                    t = (1 << s) + (m.base >> sh) + (int(m.off[g]) >> sh)
                    loads.append(t)
                    for r in range(R):
                        if r & mask != g:
                            continue
                        assert (t == (1 << s) + (m.idx[:, r] >> sh)).all()
                        v = a[:, :, r]
                        a[:, :, r] = condsub(v, np.uint64(2) * q) + shoup(v, self.w[t], self.ws[t], q)
                self.loaded.append(np.stack(loads, axis=1))
        return self.store(a, m)

    def run(self, x, mode: str, reps: int):
        return getattr(self, mode)(x, reps)


def tables():
    w, ws = C.tables("cpu")
    return w.numpy().view(np.uint64), ws.numpy().view(np.uint64), C.Q


def plain(x: torch.Tensor, mode: str, reps: int):
    return stream_prof.stage_modes_plain(x, mode, reps).numpy().view(np.uint64)


# ------------------------------------------------------------- tests
def test_the_kernels_geometry():
    """ntt.cu's geometry at n = 8192, one CTA a polynomial at its occupancy
    (two CTAs an SM); maps A, B, C are ntt.cu's forward passes 0, 1, 2;
    full is ntt_regs::run, chained through the last pass's slots."""
    assert (LOGN, CLUSTER, T, R, PASSES) == (13, 1, 512, 16, 4)
    assert "__launch_bounds__(G::THREADS, G::MIN_BLOCKS)" in KERNEL
    assert min(32, max(1, 1024 // T)) == 2  # Geometry<13, 1>::MIN_BLOCKS
    for name, p in (("MapA", 0), ("MapB", 1), ("MapC", 2)):
        assert np.array_equal(KERNEL_MAPS[name].idx, PASS_MAPS[p].idx)
    for entry in ("GLOBAL, GLOBAL>", "GLOBAL, REGS>", "SHARED, REGS>", "SHARED, GLOBAL>"):
        assert f"ntt_regs::run<LOGN, 1, false, 0, {entry}" in KERNEL
    assert KERNEL.count("ntt_regs::to_shared<LOGN, 1, LAST, 0>(sh, G::slot_of(0, G::base(LAST, ") == 2
    assert "constexpr int smem = MODE == NOROLL ? 0 : SMEM;" in KERNEL


@pytest.mark.parametrize("mode", stream_prof.MODES)
def test_loads_and_stores_are_coalesced(mode):
    """Every global access of the mode covers whole 32-byte sectors: a word
    a lane along 32 consecutive words (map A, ntt.cu's pass 0), or pairs
    on adjacent lanes (the last pass, noroll's map: two lanes a sector)."""
    maps = {"full": (PASS_MAPS[0], PASS_MAPS[-1], KERNEL_MAPS["MapA"]),
            "rollsonly": (KERNEL_MAPS["MapA"],), "noroll": (KERNEL_MAPS["MapNoroll"],)}[mode]
    for m in maps:
        check_coalesced(m)


@pytest.mark.parametrize("name", sorted(set(MAPS) - {"MapNoroll"}) + ["pass3"])
def test_exchange_slots_are_free_of_bank_conflicts(name):
    """Every map an exchange writes or reads: the slots swz(i) of a thread's
    words are a permutation of the 8192 slots, every half-warp on 16
    distinct bank pairs in every register."""
    m = PASS_MAPS[-1] if name == "pass3" else KERNEL_MAPS[name]
    slots = swz(m.idx)
    assert np.array_equal(np.sort(slots.ravel()), np.arange(1 << LOGN))
    check_banks(slots)


def test_rollsonly_schedule():
    """The stages' bits are stream_prof.ROLL_SHIFTS in order, each in a
    register of the map it runs in; the repetition makes the stated number
    of exchanges (ROLL_EXCHANGES = 4) and ends in its first map; no
    schedule in maps of 4 index bits makes fewer."""
    stages = [b for kind, _, bits in ROLL_SCHEDULE if kind == "stages" for b in bits]
    assert tuple(stages) == stream_prof.ROLL_SHIFTS
    exchanges = [(x, y) for kind, x, y in ROLL_SCHEDULE if kind == "exchange"]
    assert len(exchanges) == ROLL_EXCHANGES == 4
    maps = [m for kind, m, _ in ROLL_SCHEDULE if kind == "stages"]
    assert exchanges == list(zip(maps, maps[1:] + maps[:1]))
    for kind, m, bits in ROLL_SCHEDULE:
        if kind == "stages":
            assert set(bits) <= set(MAPS[m])

    def segments(seq):  # greedy: the fewest runs of at most LOGR distinct bits
        count, held = 1, set()
        for b in seq:
            if b not in held and len(held) == LOGR:
                count, held = count + 1, set()
            held.add(b)
        return count

    seq = stream_prof.ROLL_SHIFTS
    assert min(segments(seq[k:] + seq[:k]) for k in range(len(seq))) == ROLL_EXCHANGES


def test_noroll_loads_each_twiddle_once():
    """Stage s loads, for each thread, each distinct w[2^s + (i >> (13 - s))]
    of its 16 words once (31 loads a repetition: one pair for s <= 8, then
    2, 4, 8, 8), and no shared memory is touched."""
    m = StageModesModel(1, tables())
    m.noroll(C.resident_data(1, "cpu").numpy().view(np.uint64), 1)
    idx = KERNEL_MAPS["MapNoroll"].idx
    counts = []
    for s, loads in enumerate(m.loaded):
        need = (1 << s) + (idx >> (LOGN - s))
        for j in range(T):
            assert sorted(loads[j].tolist()) == sorted(set(need[j].tolist()))
        counts.append(loads.shape[1])
    assert counts == [1] * 9 + [2, 4, 8, 8] and sum(counts) == 31
    assert m.mem.barriers == 0 and (m.mem.w_thr < 0).all()


def test_full_makes_four_exchanges_a_transform():
    """A repetition of full is 4 passes and 4 barriers: ntt.cu's 3 and the
    one that chains the transforms."""
    for reps, barriers in ((1, 3), (2, 7), (3, 11)):
        m = StageModesModel(1, tables())
        m.full(C.resident_data(1, "cpu").numpy().view(np.uint64), reps)
        assert m.mem.barriers == barriers


@pytest.mark.parametrize("mode", ["full", "rollsonly"])
def test_a_missing_barrier_is_caught(mode):
    """The checker is not blind: the same schedule with its exchanges'
    barriers dropped races."""
    x = C.resident_data(1, "cpu").numpy().view(np.uint64)
    with pytest.raises(Race):
        StageModesModel(1, tables(), barriers=False).run(x, mode, 2)


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("mode", list(stream_prof.MODES) + ["fwd_reps"])
def test_model_equals_plain(mode, nb):
    """Every mode (and stream_prof3.fwd_reps, full's other name) at nb = 1
    and 3 with 0, 1 and 2 repetitions, on random words and on the edge
    words 0, q - 1, 2q and 4q - 1, word for word."""
    tb = tables()
    for x in (C.resident_data(nb, "cpu", seed=11 + nb), stream_prof.edge_data(nb, "cpu", seed=nb)):
        xs = x.numpy().view(np.uint64)
        for reps in (0, 1, 2):
            if mode == "fwd_reps":
                got = StageModesModel(nb, tb).run(xs, "full", reps)
                want = stream_prof3.fwd_reps_plain(x, reps).numpy().view(np.uint64)
            else:
                got = StageModesModel(nb, tb).run(xs, mode, reps)
                want = plain(x, mode, reps)
            assert np.array_equal(got, want), (reps, int(x[0, 1]))
