"""A NumPy model of csrc/probe_dyn.cu's two kernels (the runtime-stage probes).

`LaneModel` runs aloha_probe_dynstage's schedule on uint32 arrays shaped
(blocks, threads, registers): thread tid = TPR r + i holds lane TPR j + i
of row r in register j; a stage at t >= TPR moves registers within the
thread (register (j +- t / TPR) mod R, the bit j & (t / TPR)); a stage at
t < TPR takes one shuffle a register among the row's TPR threads, each
sender offering register j - carry by its own carry of i +- t out of
0..TPR-1.  The table image is staged as the kernel stages it, read as the
kernel reads it (16-byte loads of quads), and checked against w; every
4-byte staging store and 16-byte read is checked for bank conflicts.  The
persistent CTAs' walk over the blocks is the kernel's.

`SubModel` runs aloha_probe_dynsub's: thread l holds column l (register r
= row r), each stage's pairs (r, r + t) in registers.

Both carry, beside the words, each register's position in the block, so
every partner is checked to be the TPU roll's (index + t if the bit is
set, else index - t, mod 128 lanes or 64 rows).  Thread counts, words a
thread, stage numbers and the stage bodies of each switch are read from
the kernel's source.  The models must equal `dynstage_plain` /
`dynsub_plain` and the TPU scripts' bodies in interpret mode; they are the
only CPU check of the kernels' index logic.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from aloha_tpu_torch import _build
from aloha_tpu_torch.probes import probe_dynstage, probe_dynsub
from test_torch_probes_mxu import U32, _script

torch.set_num_threads(2)

CPU = torch.device("cpu")
SOURCE = (_build.CSRC / "probe_dyn.cu").read_text()
SMS = 132  # the H100's SMs: the persistent lanes kernel's grid is min(nb, SMs)


def _constants() -> dict:
    """The source's `constexpr int` constants that evaluate from earlier ones."""
    env = {}
    for decl in re.findall(r"constexpr int ([^;(]+);", SOURCE):
        for part in decl.split(","):
            name, expr = (p.strip() for p in part.split("=", 1))
            try:
                env[name] = int(eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(env)))
            except NameError:  # a template's own constant
                pass
    return env


K = _constants()
ROWS, LANES, WORDS = K["ROWS"], K["LANES"], K["WORDS"]
TPR, R, THREADS = K["DS_TPR"], K["DS_R"], K["DS_THREADS"]
FIRST, LAST = K["DS_FIRST"], K["DS_LAST"]
SUB_THREADS, SUB_STAGES = K["SUB_THREADS"], K["SUB_STAGES"]


def _switch(body: str) -> list:
    """[(s, t)] of the `case s: body<t>` lines of the source's switch."""
    return [(int(s), int(t)) for s, t in re.findall(rf"case (\d+): {body}<(\d+)>", SOURCE)]


LANE_STAGES, ROW_STAGES = _switch("lane_stage"), _switch("row_stage")


# ------------------------------------------------------------ banks
def check_banks4(words):
    """words (32,): a warp's 4-byte shared accesses fall on 32 distinct banks."""
    assert len(set((np.asarray(words) % 32).tolist())) == len(words)


def check_banks16(quads):
    """quads (threads,): the 16-byte units of one 16-byte access a thread;
    each quarter-warp's 8 fall on 8 distinct bank quads."""
    for quarter in np.asarray(quads).reshape(-1, 8):
        assert len(set((quarter % 8).tolist())) == 8


# ------------------------------------------------------------ lanes
def walk(nb: int, sms: int = SMS) -> list:
    """The blocks in the order the persistent CTAs take them: CTA c of
    min(nb, sms) takes c, c + grid, ..."""
    grid = min(nb, sms)
    return [b for c in range(grid) for b in range(c, nb, grid)]


class LaneModel:
    """aloha_probe_dynstage at `tpr` threads a row (the source's by default)."""

    def __init__(self, tpr: int = TPR):
        self.tpr, self.R, self.T = tpr, LANES // tpr, ROWS * tpr
        tid = np.arange(self.T)
        self.row, self.i = tid // tpr, tid % tpr
        self.lane = tpr * np.arange(self.R)[None, :] + self.i[:, None]  # (T, R)
        self.pos = self.row[:, None] * LANES + self.lane  # each register's word in the block
        self.shuffles = 0  # per block and repetition, counted by `stage`

    def stage_table(self, w):
        """The kernel's staging: thread tid stores w word g = tid + k' T of
        rows FIRST..LAST to its owner's slot; returns the shared image as
        uint32 words.  `staging_ways` becomes the most stores of one warp's
        store (32 adjacent words) that fall on one bank (1: no conflict)."""
        g = np.arange((LAST - FIRST + 1) * WORDS)
        k, row, l = g // WORDS, g // LANES % ROWS, g % LANES
        j = l // self.tpr
        pos = k * WORDS + ((j // 4) * self.T + row * self.tpr + l % self.tpr) * 4 + j % 4
        assert sorted(pos.tolist()) == list(range(g.size))
        self.staging_ways = max(np.bincount(p % 32).max() for p in pos.reshape(-1, 32))
        image = np.empty(g.size, dtype=np.uint32)
        image[pos] = w.reshape(-1)[FIRST * WORDS:][g]
        return image

    def table_regs(self, image, k: int):
        """(T, R) each thread's table words of stage FIRST + k, by its
        DS_QUADS 16-byte loads; each load checked free of bank conflicts."""
        out = np.empty((self.T, self.R), dtype=np.uint32)
        tid = np.arange(self.T)
        for q in range(self.R // 4):
            quad = k * WORDS // 4 + q * self.T + tid
            check_banks16(quad)
            out[:, 4 * q:4 * q + 4] = image.reshape(-1, 4)[quad]
        return out

    def stage(self, a, tag, t: int, w):
        """One stage at distance t on a (blocks, T, R), tag (T, R) the
        position each value came from; returns the new a, checking each
        partner against the roll's."""
        T, R, tpr = self.T, self.R, self.tpr
        bit = (self.lane & t) != 0  # (T, R)
        want = self.row[:, None] * LANES + np.where(bit, self.lane + t, self.lane - t) % LANES
        if t >= tpr:
            d = t // tpr
            src = np.array([(j + d) % R if j & d else (j - d) % R for j in range(R)])
            assert np.array_equal(bit, np.broadcast_to((np.arange(R) & d) != 0, (T, R)))
            p, p_tag = a[:, :, src], tag[:, src]
        else:
            tbit = (self.i & t) != 0
            ip = np.where(tbit, self.i + t, self.i - t)
            carry = np.where(ip >= tpr, 1, np.where(ip < 0, -1, 0))
            tid = np.arange(T)
            lane32 = tid % 32
            src = tid - lane32 + (lane32 & ~(tpr - 1)) + (ip & (tpr - 1))  # __shfl_sync width tpr
            assert (src // 32 == tid // 32).all() and (src // tpr == tid // tpr).all()
            assert (carry[src] == -carry).all()  # partners' carries mirror each other
            p = np.empty_like(a)
            p_tag = np.empty_like(tag)
            for j in range(R):
                offer = (j - carry) % R  # the register each sender offers
                p[:, :, j] = a[:, tid, offer][:, src]
                p_tag[:, j] = tag[tid, offer][src]
                self.shuffles += T
        assert np.array_equal(p_tag, want), t
        return np.where(bit, p - a * w, a + p * w)

    def run(self, x, w, reps: int, sms: int = SMS):
        """x (nb, 64, 128) uint32, w (13, 64, 128) uint32 -> y, as the
        kernel's persistent CTAs."""
        order = walk(x.shape[0], sms)
        assert sorted(order) == list(range(x.shape[0]))
        image = self.stage_table(w)
        tables = {s: self.table_regs(image, s - FIRST) for s, _ in LANE_STAGES}
        a = x[order][:, self.row[:, None], self.lane]  # (blocks, T, R)
        for s, table in tables.items():
            assert np.array_equal(table, w[s][self.row[:, None], self.lane])
        for _ in range(reps):
            for s, t in LANE_STAGES:
                a = self.stage(a, self.pos, t, tables[s])
        y = np.empty_like(x)
        y[np.array(order)[:, None, None], self.row[None, :, None], self.lane[None]] = a
        return y


# ------------------------------------------------------------- rows
class SubModel:
    """aloha_probe_dynsub: thread l holds column l, register r row r."""

    def stage(self, a, t: int):
        """One row stage at distance t on a (blocks, 128, 64): each pair
        (r, r + t), bit set in r, once; partners checked against the roll."""
        partner = {}
        b = a.copy()
        for r in range(ROWS):
            if r & t:
                r2 = (r + t) % ROWS
                assert r2 not in partner and r not in partner  # each register once
                partner[r], partner[r2] = r2, r
                b[:, :, r], b[:, :, r2] = a[:, :, r2] - a[:, :, r], a[:, :, r2] + a[:, :, r]
        assert partner == {r: (r + t if r & t else r - t) % ROWS for r in range(ROWS)}
        return b

    def run(self, x, reps: int):
        a = x.transpose(0, 2, 1).copy()  # (blocks, 128 threads, 64 registers)
        for _ in range(reps):
            for s in range(SUB_STAGES):
                a = self.stage(a, dict(ROW_STAGES)[s])
        return a.transpose(0, 2, 1).copy()


def u32(t: torch.Tensor):
    return t.numpy().view(np.uint32)


def _tpu(name: str, reps: int, x, w=None):
    """The script's body in interpret mode, `reps` calls chained, per block."""
    ns, _ = _script(name)
    with jax.enable_x64(False):
        call = jax.jit(pl.pallas_call(ns["body"], interpret=True,
                                      out_shape=jax.ShapeDtypeStruct((ROWS, LANES), U32)))
        out = []
        for block in x:
            a = jnp.asarray(block)
            for _ in range(reps):
                a = call(jnp.asarray(w), a) if w is not None else call(a)
            out.append(np.asarray(a))
    return np.stack(out)


# ------------------------------------------------------------- tests
def test_the_kernels_geometry_and_source():
    """8 threads a row of 16 words at 512 threads, rows 6-12's stages in
    the lanes kernel's switch and rows 0-5's in the rows kernel's, each at
    its TPU distance; one thread a column; 224 KiB of table, which fits a
    CTA's 227 KB of dynamic shared memory; the stage loops not unrolled."""
    assert (TPR, R, THREADS) == (8, 16, 512) and R * TPR == LANES
    assert LANE_STAGES == [(s, WORDS >> (s + 1)) for s in range(FIRST, LAST + 1)] and FIRST == 6
    assert ROW_STAGES == [(s, ROWS >> (s + 1)) for s in range(SUB_STAGES)] and SUB_STAGES == 6
    assert SUB_THREADS == LANES
    assert (LAST - FIRST + 1) * WORDS * 4 == probe_dynstage.TABLE_BYTES == 229376 <= 232448
    assert len(re.findall(r"#pragma unroll 1\n\s*for \(int s = ", SOURCE)) == 2
    assert SOURCE.count("switch (s)") == 2
    assert "__launch_bounds__(DS_THREADS, 1)" in SOURCE
    start = SOURCE.index("dynsub_kernel(")
    sub = SOURCE[start:SOURCE.index("}  // namespace", start)]
    assert not re.search(r"__shared__|__syncthreads|__shfl| / |%", sub)


@pytest.mark.parametrize("tpr", [2, 4, 8, 16])
def test_each_word_is_owned_once(tpr):
    """Every (row, lane) of a block sits in one register of one thread,
    and a row's threads lie in one warp."""
    m = LaneModel(tpr)
    assert sorted(m.pos.ravel().tolist()) == list(range(WORDS))
    assert all(len(set((np.flatnonzero(m.row == r) // 32).tolist())) == 1 for r in range(ROWS))


def test_loads_and_stores_fill_whole_sectors():
    """Register j of a warp's 32 threads is 4 rows x 8 adjacent words:
    four whole 32-byte sectors of the block (lanes); a row's 128 bytes
    (columns)."""
    m = LaneModel()
    for warp in range(THREADS // 32):
        for j in range(R):
            byte = 4 * m.pos[32 * warp:32 * warp + 32, j]
            assert len(set((byte // 32).tolist())) == 4 and len(set(byte.tolist())) == 32
    column = np.arange(SUB_THREADS)  # thread l's register r: word r * 128 + l
    for warp in range(SUB_THREADS // 32):
        for r in range(ROWS):
            byte = 4 * (r * LANES + column[32 * warp:32 * warp + 32])
            assert byte.max() - byte.min() == 124 and byte.min() % 128 == 0


@pytest.mark.parametrize("tpr", [4, 8])
def test_table_image_reads_the_stage_rows_free_of_bank_conflicts(tpr):
    """Staged as the kernel stages it, each thread's quads hold its lanes'
    w of each stage row 6-12; every 16-byte read in the stage loop is free
    of bank conflicts (checked inside the model), and so is every staging
    store at the source's 8 threads a row (2-way at 4, once a launch)."""
    m = LaneModel(tpr)
    w = u32(probe_dynstage.table(CPU, seed=tpr))
    image = m.stage_table(w)
    assert m.staging_ways == {8: 1, 4: 2}[tpr]
    for k in range(LAST - FIRST + 1):
        assert np.array_equal(m.table_regs(image, k), w[FIRST + k][m.row[:, None], m.lane])


def test_row_major_image_would_conflict():
    """The row-major table is not conflict-free: with 8 threads a row a
    warp spans 4 rows 128 words apart, all on the same 8 banks."""
    m = LaneModel()
    words = m.pos[:32, 0]
    assert len(set((words % 32).tolist())) == 8
    with pytest.raises(AssertionError):
        check_banks4(words)


@pytest.mark.parametrize("nb", [1, 131, 132, 133, 264, 300])
def test_persistent_walk_covers_every_block_once(nb):
    """min(nb, 132) CTAs; CTA c takes blocks c, c + grid, ...: each once."""
    order = walk(nb)
    assert sorted(order) == list(range(nb))
    grid = min(nb, SMS)
    per_cta = [len(range(c, nb, grid)) for c in range(grid)]
    assert min(per_cta) >= 1 and max(per_cta) == -(-nb // grid)
    assert "for (int blk = blockIdx.x; blk < nb; blk += gridDim.x)" in SOURCE
    assert "const int grid = nb < sms ? nb : sms;" in SOURCE and "<<<grid, DS_THREADS" in SOURCE


@pytest.mark.parametrize("tpr", [4, 8])
def test_shuffle_count_of_the_owner_maps(tpr):
    """The stages below TPR take one shuffle a word: 3 x 8192 a block and
    repetition at 8 threads a row, 2 x 8192 at 4 (16 and 32 words a thread)."""
    m = LaneModel(tpr)
    m.run(u32(probe_dynstage.data(1, CPU)), u32(probe_dynstage.table(CPU)), 1)
    assert m.shuffles == sum(1 for _, t in LANE_STAGES if t < tpr) * WORDS


@pytest.mark.parametrize("reps", [0, 1, 2, 3])
@pytest.mark.parametrize("nb", [1, 3])
def test_lane_model_equals_plain(nb, reps):
    """Seeded words and the edge words 0, 1, 2^31, 2^32 - 1 (with a table
    of them), word for word."""
    for x, w in ((probe_dynstage.data(nb, CPU, seed=nb), probe_dynstage.table(CPU, seed=reps)),
                 (probe_dynstage.edge_data(nb, CPU, seed=nb), probe_dynstage.edge_table(CPU))):
        want = u32(probe_dynstage.dynstage_plain(x, w, reps))
        assert np.array_equal(LaneModel().run(u32(x), u32(w), reps), want)


@pytest.mark.parametrize("tpr", [2, 4, 16])
def test_lane_model_at_other_maps_equals_plain(tpr):
    """The schedule holds at other thread counts a row (the carry's shuffle
    at 2-16 threads a row, register stages from t = tpr up)."""
    x, w = probe_dynstage.edge_data(2, CPU, seed=tpr), probe_dynstage.table(CPU, seed=tpr)
    want = u32(probe_dynstage.dynstage_plain(x, w, 2))
    assert np.array_equal(LaneModel(tpr).run(u32(x), u32(w), 2), want)


@pytest.mark.parametrize("nb", [131, 133])
def test_lane_model_past_one_cta_an_sm_equals_plain(nb):
    """More blocks than SMs: some CTAs take two blocks (a smaller grid
    stands in for the card's 132 SMs to keep the model quick)."""
    x, w = probe_dynstage.data(nb - 128, CPU, seed=nb), probe_dynstage.table(CPU)
    got = LaneModel().run(u32(x), u32(w), 1, sms=nb - 130)
    assert np.array_equal(got, u32(probe_dynstage.dynstage_plain(x, w, 1)))


@pytest.mark.parametrize("reps", [0, 1, 2, 3])
@pytest.mark.parametrize("nb", [1, 3])
def test_sub_model_equals_plain(nb, reps):
    for x in (probe_dynstage.data(nb, CPU, seed=nb), probe_dynstage.edge_data(nb, CPU, seed=nb)):
        want = u32(probe_dynsub.dynsub_plain(x, reps))
        assert np.array_equal(SubModel().run(u32(x), reps), want)


@pytest.mark.parametrize("reps", [0, 1, 2, 3])
def test_lane_model_equals_the_tpu_body(reps):
    """tools/probe_dynstage.py's body in interpret mode, on 2 blocks."""
    x, w = u32(probe_dynstage.data(2, CPU, seed=7)), u32(probe_dynstage.table(CPU))
    assert np.array_equal(LaneModel().run(x, w, reps), _tpu("probe_dynstage", reps, x, w))


@pytest.mark.parametrize("reps", [0, 1, 2, 3])
def test_sub_model_equals_the_tpu_body(reps):
    """tools/probe_dynsub.py's body in interpret mode, on 2 blocks."""
    x = u32(probe_dynstage.edge_data(2, CPU, seed=8))
    assert np.array_equal(SubModel().run(x, reps), _tpu("probe_dynsub", reps, x))
