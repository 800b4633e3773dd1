"""A NumPy model of csrc/probe_dma.cu's stage pipeline (aloha_probe_dma_stages).

`StagesModel` runs the kernel's schedule on uint64 arrays shaped (chunks,
256 threads, 16 registers): each chunk (half a polynomial, 32 rows of 128
words) lands in its slot by the 5-D TMA copy with the 128-byte swizzle,
pass A reads each thread's 16 words (lane l0 + 8m of its row), runs stages
6 .. min(9, 5 + nstages) in registers and writes them back to the slots it
read; then one __syncwarp, and pass B reads its 16 adjacent words (lane
16 l0 + m) as 8 16-byte units, runs stages 10 .. 5 + nstages and writes
them back; a barrier, and the TMA store reads the slot.  The thread and
line layouts, the owner maps' shifts, the box and its strides are read
from the kernel's source.

`Shared` holds a slot's 4096 words and checks every access: a thread reads
or overwrites a slot another thread wrote or read only across a barrier
that orders both (__syncwarp within a warp, the mbarrier wait and
__syncthreads across the CTA); pass A's 8-byte accesses (a half-warp)
fall on 16 distinct 8-byte bank pairs, pass B's 16-byte ones (a
quarter-warp) on 8 distinct 16-byte bank quads.  The model counts every
butterfly and every twiddle load, walks the ring of slots with its
mbarrier parities and read-waits, and must equal `stages_plain` and the
TPU script's body (`tools/dma_bisect_stages.py`, interpret mode) word for
word.  It is the only CPU check of the kernel's index logic.
"""

import re

import jax
import numpy as np
import pytest
import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch.probes import common as C
from aloha_tpu_torch.probes import dma_bisect_stages, stream_prof
from test_torch_ntt_regs import check_banks
from test_torch_probes_dma import HBM, U32, VMEM, _planes, _script, _tpu, _words
from test_torch_stage_modes_regs import condsub, shoup

torch.set_num_threads(2)

CPU = torch.device("cpu")
SOURCE = (_build.CSRC / "probe_dma.cu").read_text()
KERNEL = SOURCE[SOURCE.index("- stages pipeline"):
                SOURCE.index("// The 5-D map of (nb, 64, 128) u64")]


def _const(name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (0x[0-9a-f]+|\d+)", SOURCE).group(1), 0)


def _array(name: str) -> tuple:
    body = re.search(rf"constexpr \w+ {name}\[\d\] = \{{([^}}]*)\}};", SOURCE).group(1)
    return tuple(int(v) for v in body.split(","))


THREADS, ROWS, SLOTS = _const("ST_THREADS"), _const("ST_ROWS"), _const("ST_SLOTS")
CTAS = _const("ST_CTAS")
A_SHIFT, B_SHIFT = _const("ST_A_SHIFT"), _const("ST_B_SHIFT")
L0_BITS, ROW_BITS = _const("ST_L0_BITS"), _const("ST_ROW_BITS")
BOX, STRIDES = _array("ST_BOX"), _array("ST_STRIDES")
R, LANES, WORDS = 16, 128, ROWS * 128  # registers a thread, words a row, words a chunk
FIRST, MAX_STAGES = dma_bisect_stages.FIRST, dma_bisect_stages.MAX_STAGES
SMEM_PER_SM = 228 * 1024  # an H100 SM's shared memory, 1 KiB of it reserved a CTA
NBANKS16 = 8  # 16-byte bank quads


class Race(AssertionError):
    """A shared-memory access the kernel's barriers do not order."""


# ---------------------------------------------------------------- layout
def scatter_bits(v, mask: int):
    out, k = 0, 0
    for b in range(8):
        if mask >> b & 1:
            out = out | (((v >> k) & 1) << b)
            k += 1
    return out


def gather_bits(v, mask: int):
    out, k = 0, 0
    for b in range(8):
        if mask >> b & 1:
            out = out | (((v >> b) & 1) << k)
            k += 1
    return out


def line(r, g):
    return scatter_bits(g, L0_BITS) | scatter_bits(r, ROW_BITS)


def slot(ln, w):
    return 16 * ln + (w ^ ((ln & 7) << 1))


TID = np.arange(THREADS)
ROW, L0 = gather_bits(TID, ROW_BITS), gather_bits(TID, L0_BITS)
M = np.arange(R)


def lane_slot(r, lane):
    return slot(line(r, lane >> 4), lane & 15)


#: pass A: lane of register m, and the kernel's slot ta ^ lane_slot(0, m << A_SHIFT)
LANE_A = L0[:, None] + (M[None, :] << A_SHIFT)
SLOT_A = lane_slot(ROW, L0)[:, None] ^ lane_slot(0, M << A_SHIFT)[None, :]
#: pass B: lane of register m, and the kernel's slot tb ^ lane_slot(0, 2p) of pair p
#: (word 2p + 1 after it)
LANE_B = (L0[:, None] << B_SHIFT) + M[None, :]
SLOT_B = (lane_slot(ROW, L0 << B_SHIFT)[:, None] ^ lane_slot(0, 2 * (M >> 1))[None, :]) | (M & 1)


def tma_image():
    """(4096,) the u64 slot each word r * 128 + lane of a chunk lands in:
    the box's elements in row-major order (dimension 0 fastest) at byte 8e,
    the swizzle moving byte bits 4-6 by bits 7-9 (16-byte unit u of a
    128-byte line L to u ^ (L mod 8)); the word's index from the strides."""
    idx = np.indices(BOX[::-1]).reshape(len(BOX), -1)[::-1]  # (5, elements), dim 0 fastest
    e = np.arange(idx.shape[1])
    byte = 8 * e
    phys = (byte ^ (((byte >> 7) & 7) << 4)) // 8
    word = idx[0] + sum(idx[d] * STRIDES[d - 1] // 8 for d in range(1, len(BOX)))
    out = np.full(WORDS, -1)
    out[word] = phys
    return out


# ------------------------------------------------------- shared memory
class Shared:
    """A slot's words (chunks, 4096) and, per word, its last writer and
    reader with the number of barriers passed at the time; thread -1 is
    the TMA unit.  barriers: their kinds ("warp" or "cta") in order."""

    def __init__(self, nchunks: int):
        self.val = np.zeros((nchunks, WORDS), dtype=np.uint64)
        self.w_thr, self.r_thr = np.full(WORDS, -2), np.full(WORDS, -2)
        self.w_bar, self.r_bar = np.full(WORDS, -1), np.full(WORDS, -1)
        self.barriers = []

    def _ordered(self, thr, bar, by):
        """Whether the accesses (thr, bar) precede thread `by`'s now."""
        ok = (thr == by) | (thr == -2)
        for k, kind in enumerate(self.barriers):
            after = bar <= k
            ok |= after & ((kind == "cta") | ((thr >= 0) & (by >= 0) & (thr // 32 == by // 32)))
        return ok

    def write(self, slots, vals, thr):
        thr = np.broadcast_to(thr, slots.shape)
        if np.unique(slots).size != slots.size:
            raise Race("two words written to one slot")
        if not self._ordered(self.r_thr[slots], self.r_bar[slots], thr).all():
            raise Race("a store into a slot another thread read, with no barrier between")
        if not self._ordered(self.w_thr[slots], self.w_bar[slots], thr).all():
            raise Race("a store into a slot another thread wrote, with no barrier between")
        self.val[:, slots] = vals
        self.w_thr[slots], self.w_bar[slots] = thr, len(self.barriers)

    def read(self, slots, thr):
        thr = np.broadcast_to(thr, slots.shape)
        if (self.w_thr[slots] == -2).any():
            raise Race("a read of a slot never written")
        if not self._ordered(self.w_thr[slots], self.w_bar[slots], thr).all():
            raise Race("a read of another thread's store with no barrier between")
        self.r_thr[slots], self.r_bar[slots] = thr, len(self.barriers)
        return self.val[:, slots]

    def barrier(self, kind: str):
        self.barriers.append(kind)


def check_banks16(units):
    """units (256, 8), the first slot of one 16-byte access a pair: even,
    and each quarter-warp on 8 distinct bank quads."""
    assert (units % 2 == 0).all()
    for quarter in units.reshape(-1, 8, units.shape[1]):
        for p in range(units.shape[1]):
            assert len(set((quarter[:, p] // 2 % NBANKS16).tolist())) == 8, p


# ---------------------------------------------------------- arithmetic
def ct(u, v, w, ws, q):
    """modarith.cuh's ct(): u, v < 4q -> u' + w v, u' + 2q - w v."""
    q2 = np.uint64(2) * q
    x, y = condsub(u, q2), shoup(v, w, ws, q)
    return x + y, x + q2 - y


# ------------------------------------------------------------ the model
class StagesModel:
    """The kernel's step on nb polynomials (2 nb chunks, chunk c half c & 1
    of polynomial c >> 1), every chunk through one slot's accesses."""

    def __init__(self, nb: int, syncwarp: bool = True):
        w, ws = C.tables("cpu")
        self.w, self.ws = cv.to_u64(w), cv.to_u64(ws)
        self.q = np.uint64(C.Q)
        self.nb, self.nchunks = nb, 2 * nb
        self.mem = Shared(self.nchunks)
        self.syncwarp = syncwarp
        self.butterflies = []  # (stage, (chunks, 256, 8) lower word's index in its polynomial)
        self.loads = {"A": [], "B": []}  # per pass: (256, pairs) twiddle indices of chunk 0, 1

    def stage(self, a, s: int, lanes, rows):
        """One stage on a (chunks, 256, 16): the register bit of its
        distance, the kernel's twiddle base and index, each pair once."""
        passb = s >= 10
        K = 12 - s - (0 if passb else A_SHIFT)  # the kernel's register bit
        assert (lanes[:, 1 << K] - lanes[:, 0] == 1 << (12 - s)).all()  # the stage's distance
        i0 = rows * LANES + (L0[None, :] << B_SHIFT if passb else L0[None, :])
        base = (1 << s) + (i0 >> (13 - s))  # the kernel's: register 0's word i0
        nj = R >> (K + 1)
        assert nj == 1 or (base % 2 == 0).all()  # 16-byte loads of consecutive pairs
        loaded = base[..., None] + np.arange(nj)
        self.loads["B" if passb else "A"].append(loaded)
        a = a.copy()
        lower = []
        for m in range(R):
            if m >> K & 1:
                continue
            t = base + (m >> (K + 1))
            i = rows * LANES + lanes[None, :, m]  # (chunks, 256)
            assert (t == (1 << s) + (i >> (13 - s))).all()
            a[:, :, m], a[:, :, m | 1 << K] = ct(a[:, :, m], a[:, :, m | 1 << K], self.w[t],
                                                 self.ws[t], self.q)
            lower.append(i)
        self.butterflies.append((s, np.stack(lower, axis=-1)))
        return a

    def run(self, x, nstages: int):
        """x (nb, 8192) uint64 -> y, as the kernel's chunks."""
        chunks = x.reshape(self.nchunks, WORDS)
        image = tma_image()
        self.mem.write(image, chunks, -1)  # the TMA load
        self.mem.barrier("cta")  # the mbarrier wait
        rows = ((np.arange(self.nchunks) & 1) * ROWS)[:, None] | ROW[None, :]  # (chunks, 256)
        if nstages:
            thr = TID[:, None]
            check_banks(SLOT_A)
            a = self.mem.read(SLOT_A, thr)
            for s in range(FIRST, min(9, FIRST - 1 + nstages) + 1):
                a = self.stage(a, s, LANE_A, rows)
            self.mem.write(SLOT_A, a, thr)
            if nstages > 4:
                if self.syncwarp:
                    self.mem.barrier("warp")
                check_banks16(SLOT_B[:, ::2])
                a = self.mem.read(SLOT_B, thr)
                for s in range(10, FIRST + nstages):
                    a = self.stage(a, s, LANE_B, rows)
                self.mem.write(SLOT_B, a, thr)
        self.mem.barrier("cta")  # fence.proxy.async, __syncthreads
        return self.mem.read(image, -1).reshape(self.nb, C.N)  # the TMA store


def model(x: torch.Tensor, nstages: int, **kw):
    return StagesModel(x.shape[0], **kw).run(cv.to_u64(x), nstages)


def plain(x: torch.Tensor, nstages: int):
    return cv.to_u64(dma_bisect_stages.stages_plain(x, nstages))


# ------------------------------------------------------------------ ring
def ring_walk(nchunks: int, grid: int, slots: int):
    """Each CTA's chunks as the kernel walks them: [(k, chunk, slot,
    parity)], checking that slot k mod slots is refilled only after the
    store that last read it, by the read-wait the kernel issues."""
    out = []
    for b in range(grid):
        n = (nchunks - b + grid - 1) // grid
        s, parity = 0, 0
        stores = []  # chunks whose stores are committed, oldest first
        done = set()  # stores that have read their slot
        walk = [(0, b, 0, 0)] if n else []
        for k in range(n):
            c = b + k * grid
            nxt = 0 if s + 1 == slots else s + 1
            if k + 1 < n:
                # wait_group.read slots - 2: all but the newest slots - 2 stores have read
                done.update(stores[:max(0, len(stores) - (slots - 2))])
                last = k + 1 - slots  # the chunk that last used slot nxt
                assert last < 0 or last in done, (k, last)
                walk.append((k + 1, c + grid, nxt, None))
            assert walk[k][:3] == (k, c, s)
            assert parity == (k // slots) & 1  # the slot's use count's parity
            walk[k] = (k, c, s, parity)
            stores.append(k)
            parity ^= nxt == 0
            s = nxt
        out.append(walk)
    return out


# --------------------------------------------------------------- tests
def test_the_kernels_geometry_and_source():
    """256 threads, 8 a row (one warp's), a chunk of 32 rows; pass A holds
    lane l0 + 8m, pass B lane 16 l0 + m; one instance a stage count; the
    ring's slots at 2 CTAs an SM fit the SM's shared memory; one
    __syncwarp, no shuffle, StagesStep gone."""
    assert (THREADS, ROWS, A_SHIFT, B_SHIFT) == (256, 32, 3, 4)
    assert SLOTS >= 2 and CTAS == 2
    smem = SLOTS * WORDS * 8 + 1024 + SLOTS * 8
    assert CTAS * (smem + 1024) <= SMEM_PER_SM
    assert sorted(zip(ROW.tolist(), L0.tolist())) == [(r, l) for r in range(ROWS) for l in range(8)]
    for r in range(ROWS):
        assert len(set((TID[ROW == r] // 32).tolist())) == 1  # a row is one warp's
    assert "__launch_bounds__(ST_THREADS, ST_CTAS)" in KERNEL
    assert KERNEL.count("__syncwarp()") == 1 and "__shfl" not in KERNEL
    assert "StagesStep" not in SOURCE and "bulk_wait_read<ST_SLOTS - 2>()" in KERNEL
    entry = SOURCE[SOURCE.index('extern "C" int aloha_probe_dma_stages'):]
    assert [int(k) for k in re.findall(r"case (\d): return \(int\)launch_stages<\1>", entry)] == \
        list(range(MAX_STAGES + 1))


def test_tma_image_keeps_the_units_and_is_the_kernels_slot():
    """The box covers a chunk once; each 16-byte unit of the global image
    lands whole and in order; word w of row r's group g sits in slot(line(r,
    g), w), line(r, g) the source's bits; a TMA store of the slot gives the
    chunk back."""
    image = tma_image()
    assert int(np.prod(BOX)) == WORDS and sorted(image.tolist()) == list(range(WORDS))
    assert (image[1::2] == image[0::2] + 1).all() and (image[0::2] % 2 == 0).all()
    r, lane = np.divmod(np.arange(WORDS), LANES)
    assert np.array_equal(image, slot(line(r, lane >> 4), lane & 15))
    x = np.random.default_rng(3).integers(0, 1 << 62, size=WORDS, dtype=np.uint64)
    sh = np.empty_like(x)
    sh[image] = x
    assert np.array_equal(sh[image], x)


@pytest.mark.parametrize("which", ["A", "B"])
def test_owner_maps_read_their_words_free_of_bank_conflicts(which):
    """Each map holds every word of a chunk once; the kernel's XOR-split
    slot equals the swizzled slot of the word; pass A's 8-byte accesses and
    pass B's 16-byte ones are free of bank conflicts; pass A holds lane bits
    3-6 in its registers (its stages' pairs), pass B bits 0-3."""
    lanes, slots = (LANE_A, SLOT_A) if which == "A" else (LANE_B, SLOT_B)
    words = ROW[:, None] * LANES + lanes
    assert sorted(words.ravel().tolist()) == list(range(WORDS))
    assert np.array_equal(slots, tma_image()[words])
    if which == "A":
        check_banks(slots)
        assert ((lanes - L0[:, None]) >> 3 == M[None, :]).all()
    else:
        check_banks16(slots[:, ::2])
        assert (slots[:, 1::2] == slots[:, ::2] + 1).all()
        assert ((lanes & 15) == M[None, :]).all()


def test_each_thread_writes_the_slots_it_read():
    """In place: a pass writes exactly the slots it read, so the exchange
    needs one barrier; pass B's slots of a thread lie in its row's warp."""
    for slots in (SLOT_A, SLOT_B):
        assert all(len(set(s.tolist())) == R for s in slots)
    row_of_slot = np.empty(WORDS, dtype=int)
    row_of_slot[tma_image()] = np.arange(WORDS) // LANES
    for slots in (SLOT_A, SLOT_B):
        assert (row_of_slot[slots] == ROW[:, None]).all()


@pytest.mark.parametrize("nstages", [5, 7])
def test_a_missing_syncwarp_is_caught(nstages):
    """The checker is not blind: pass B reads words pass A's other threads
    wrote, so without the __syncwarp it races."""
    with pytest.raises(Race):
        model(C.resident_data(1, CPU), nstages, syncwarp=False)


@pytest.mark.parametrize("nstages", range(MAX_STAGES + 1))
def test_every_butterfly_once_and_each_twiddle_once_a_pass(nstages):
    """Every pair (i, i + t) of every stage of both halves of a polynomial
    is one butterfly of one thread; each thread loads each distinct (w, ws)
    pair of a pass once (15 in pass A and 14 in pass B at 7 stages), the
    ones its butterflies take."""
    m = StagesModel(2)
    m.run(cv.to_u64(C.resident_data(2, CPU)), nstages)
    assert [s for s, _ in m.butterflies] == list(range(FIRST, FIRST + nstages))
    for s, lower in m.butterflies:
        t = 1 << (12 - s)
        for poly in range(2):
            got = np.sort(lower[2 * poly:2 * poly + 2].ravel())
            want = np.array([i for i in range(C.N) if not i & t])
            assert np.array_equal(got, want), s
    for p, stages in m.loads.items():
        if not stages:
            continue
        per_thread = np.concatenate(stages, axis=-1)  # (chunks, 256, loads)
        for c in range(m.nchunks):
            for j in range(THREADS):
                assert len(set(per_thread[c, j].tolist())) == per_thread.shape[-1]
    counts = {p: sum(st.shape[-1] for st in stages) for p, stages in m.loads.items()}
    a_stages, b_stages = min(nstages, 4), max(0, nstages - 4)
    assert counts["A"] == sum(1 << k for k in range(a_stages))
    assert counts["B"] == sum(1 << k for k in range(1, 1 + b_stages))
    if nstages == MAX_STAGES:
        assert (counts["A"], counts["B"]) == (15, 14)


@pytest.mark.parametrize("slots", [2, 3])
@pytest.mark.parametrize("grid", [132, 133, 264, 395, 396])
def test_ring_walk_covers_every_chunk_once(grid, slots):
    """min(nchunks, grid) persistent CTAs; CTA b takes chunks b + k G; chunk
    k in slot k mod slots with the parity of k // slots; a slot refilled
    only after its last store has read it (wait_group.read slots - 2)."""
    for nchunks in (1, 2, 3, 131, 132, 133, 264, 265, 396, 397, 1000, 2048, 8192):
        g = min(nchunks, grid)
        seen = [c for walk in ring_walk(nchunks, g, slots) for _, c, _, _ in walk]
        assert sorted(seen) == list(range(nchunks)), nchunks


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("nstages", range(MAX_STAGES + 1))
def test_model_equals_plain(nstages, nb):
    """Seeded words and the edge words 0, q - 1, 2q, 4q - 1, word for word."""
    for x in (C.resident_data(nb, CPU, seed=5 + nb), stream_prof.edge_data(nb, CPU, seed=nb)):
        assert np.array_equal(model(x, nstages), plain(x, nstages)), (nstages, nb)


@pytest.mark.parametrize("nstages", range(MAX_STAGES + 1))
def test_model_equals_the_tpu_body(nstages):
    """The script's body in interpret mode at its NB = 32 on seeded planes."""
    ns = _script("dma_bisect_stages", str(nstages))
    lo, hi = _planes(ns["NB"], seed=21 + nstages)
    shape = jax.ShapeDtypeStruct(lo.shape, U32)
    want = _tpu(ns, [VMEM] * 4 + [HBM] * 2, [HBM] * 2, [shape] * 2, *ns["tbls"], lo, hi)
    got = model(cv.from_u64(_words(lo, hi), CPU), nstages)
    assert np.array_equal(got, _words(want[0], want[1]))
