"""A NumPy model of csrc/ks.cu's fused schedules on csrc/ntt_regs.cuh's register passes.

`transform` runs one transform of `ntt_regs::run` on a (T, R) array of
registers, one row per thread, with the chaining choices of the kernel:
the first pass reads global words, takes the registers as they are, or
reads the shared buffer at its own map; the last pass writes global words
or leaves them in the registers.  `Smem` holds the shared memory of the C
CTAs of a cluster and checks every access for a race: a thread reads a
slot another thread wrote only after a barrier, a thread overwrites a slot
another thread read only after a barrier, a CTA reads words another CTA
wrote into it only after a cluster barrier, a CTA writes into another one
only once every CTA runs and after the cluster barrier that follows that
CTA's last read of the slot; every arrival is followed by one wait.

`head_model` and `tail_model` run csrc/ks.cu's kernels on it:
- ks_head: INTT of b_j from its pairs, the raise in registers and the NTT
  from the registers at e = 1, with no exchange and no barrier between the
  transforms; with the automorphism, the scatter of every word to its
  image's slot (a permutation of the buffer) between two barriers;
- ks_tail: the P-residue inner products at the inverse's input map, the
  INTT from the registers, A = + (P-1)/2 kept at its slots in its own
  region, then per limb the correction's NTT from the registers (a barrier
  between the limbs at one CTA, the two buffers alternating in a cluster)
  and the epilogue at the last pass's pairs.

Both are held word for word against `ks_head_plain` / `ks_tail_plain` at
n = 1024 and 8192, every tail mode, the head at one CTA a polynomial and
the tail at each cluster it has an instance for (`ks_kernel.tail_clusters`:
1, and 4 at n = 8192), and a tail whose limbs lose their barrier (one CTA)
or share one buffer (a cluster) must be caught racing.
"""

import numpy as np
import pytest
import torch

import __graft_entry__
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch.config import DEFAULT_CONFIG
from aloha_tpu_torch.ops import ks_kernel
from test_torch_ntt_regs import (_condsub, _ct, _gs, _objects, base, bot, geometry, local, off,
                                 owner_map, rankbit, swz, top)

torch.set_num_threads(2)

CPU = torch.device("cpu")
SMALL = __graft_entry__._small_cfg(1024)


class Race(AssertionError):
    """A shared-memory access the kernel's barriers do not order."""


class Smem:
    """The shared memory of a cluster of C CTAs, `words` slots each, with
    each slot's last write and read: the thread, the CTA barriers
    (__syncthreads or a cluster barrier) and the cluster barriers passed
    by then.  Every CTA runs the same program, so the counts are those of
    one program point in all of them."""

    def __init__(self, C: int, threads: int, words: int):
        self.C, self.per = C, threads // C
        self.val = np.full((C, words), None, dtype=object)
        shape = (C, words)
        self.w_thr, self.r_thr = np.full(shape, -1), np.full(shape, -1)
        self.w_bar, self.r_bar = np.full(shape, -1), np.full(shape, -1)
        self.w_ep, self.r_ep = np.full(shape, -1), np.full(shape, -1)
        self.bar = self.ep = 0
        self.pending = False

    def _cta(self, thr):
        return thr // self.per

    def write(self, cta, slot, vals, thr):
        cta, thr = np.broadcast_to(cta, slot.shape), np.broadcast_to(thr, slot.shape)
        if len(set(zip(cta.ravel().tolist(), slot.ravel().tolist()))) != slot.size:
            raise Race("two registers written to one slot")
        remote = cta != self._cta(thr)
        read = self.r_thr[cta, slot] >= 0
        if remote.any() and self.ep < 1:
            raise Race("a remote store before every CTA of the cluster runs")
        if (remote & read & (self.r_ep[cta, slot] >= self.ep)).any():
            raise Race("a remote store into a slot its CTA may still read")
        if (~remote & read & (self.r_thr[cta, slot] != thr)
                & (self.r_bar[cta, slot] >= self.bar)).any():
            raise Race("a store into a slot another thread read since the last barrier")
        self.val[cta, slot] = vals
        self.w_thr[cta, slot], self.w_bar[cta, slot], self.w_ep[cta, slot] = thr, self.bar, self.ep

    def read(self, cta, slot, thr):
        cta, thr = np.broadcast_to(cta, slot.shape), np.broadcast_to(thr, slot.shape)
        if (self.w_thr[cta, slot] < 0).any():
            raise Race("a read of a slot never written")
        wcta = self._cta(self.w_thr[cta, slot])
        if ((wcta != cta) & (self.w_ep[cta, slot] >= self.ep)).any():
            raise Race("a read of a remote store before the cluster barrier after it")
        if ((wcta == cta) & (self.w_thr[cta, slot] != thr)
                & (self.w_bar[cta, slot] >= self.bar)).any():
            raise Race("a read of another thread's store before a barrier")
        self.r_thr[cta, slot], self.r_bar[cta, slot], self.r_ep[cta, slot] = thr, self.bar, self.ep
        return self.val[cta, slot]

    def syncthreads(self):
        self.bar += 1

    def arrive(self):
        if self.pending:
            raise Race("a second arrival before the wait")
        self.pending = True

    def wait(self):
        if not self.pending:
            raise Race("a wait with no arrival")
        self.pending = False
        self.ep += 1
        self.bar += 1  # every thread of the cluster meets there


def transform(mem, a, w, ws, q, logn, inverse, C, buf=0, x=None, out=None, first=True,
              src="regs", dst="regs"):
    """ntt_regs::run on registers a (T, R): the first pass reads x
    ("global"), takes a ("regs") or reads buffer `buf` at its own map
    ("shared"); the last writes out ("global") or leaves its words in the
    registers ("regs").  The inverse's cross exchange goes to a second
    buffer, words/C slots above `buf`; `first`: the kernel's first cross
    exchange, which waits for every CTA to start.  Returns the registers
    of the last pass (canonical)."""
    n = 1 << logn
    logt, logr, passes = geometry(logn)
    logc = C.bit_length() - 1
    T, R, words = 1 << logt, 1 << logr, n // C
    J = np.arange(T)
    for k in range(passes):
        p = passes - 1 - k if inverse else k
        idx, rank = owner_map(logn, p, C)
        slots = swz(local(idx, logn, rankbit(logn, p, logc), logc))
        if k == 0 and src == "global":
            a = _condsub(x[idx], q) if inverse else x[idx]
        elif k > 0 or src == "shared":
            at = buf + words if inverse and C > 1 and p == 0 else buf
            a = mem.read(rank[:, None], at + slots, J[:, None])
        assert a.shape == (T, R)
        a = a.copy()
        bse = base(logn, p, J, logc)
        for b in (range(bot(logn, p), top(logn, p) + 1) if inverse
                  else range(top(logn, p), bot(logn, p) - 1, -1)):
            rb = b - bot(logn, p)
            stage = (n >> (b + 1)) if inverse else 1 << (logn - 1 - b)
            for hi in range(R >> (rb + 1)):
                t = stage + (bse >> (b + 1)) + (off(logn, p, hi << (rb + 1), logc) >> (b + 1))
                for lo in range(1 << rb):
                    r = (hi << (rb + 1)) | lo
                    assert (idx[:, r | 1 << rb] == idx[:, r] + (1 << b)).all()
                    bfly = _gs if inverse else _ct
                    a[:, r], a[:, r | 1 << rb] = bfly(a[:, r], a[:, r | 1 << rb], w[t], ws[t], q)
        if k < passes - 1:
            pn = passes - 2 - k if inverse else k + 1
            rb = rankbit(logn, pn, logc)
            dest = (idx >> rb) & (C - 1)
            nslots = swz(local(idx, logn, rb, logc))
            if C > 1 and {p, pn} == {0, 1}:  # the cross exchange
                if first:
                    mem.wait()
                mem.write(dest, (buf + words if inverse else buf) + nslots, a, J[:, None])
                mem.arrive()
                mem.wait()
            else:
                assert (dest == rank[:, None]).all()
                mem.write(dest, buf + nslots, a, J[:, None])
                mem.syncthreads()
    if not inverse:
        a = _condsub(_condsub(a, 2 * q), q)
    if dst == "global":
        out[idx] = a
    return a


def _tables(cfg):
    (fw, fws, q), (iw, iws, _), iq, pinv = ks_kernel._consts(cfg, CPU)
    return tuple(_objects(cv.to_u64(t)) for t in (fw, fws, iw, iws)) + (cfg.moduli,)


def head_model(b, e, cfg):
    """csrc/ks.cu's ks_head (one CTA a polynomial) on b (L, nb, n) uint64
    with Galois exponent e (1: the hoisted head): (L+1, nb, L, n) and the
    barriers between the INTT and the NTT of each CTA."""
    L, n = cfg.n_limbs, cfg.n
    logn = n.bit_length() - 1
    logt = geometry(logn)[0]
    T = 1 << logt
    fw, fws, iw, iws, qs = _tables(cfg)
    out = np.full((L + 1, b.shape[1], L, n), None, dtype=object)
    between = []
    for c in range(b.shape[1]):
        for mm in range(L + 1):
            for j in range(L):
                mem = Smem(1, T, n)
                qj, qm = qs[j], qs[mm]
                a = transform(mem, None, iw[j], iws[j], qj, logn, True, 1, x=_objects(b[j, c]),
                              src="global")
                mark = mem.bar
                if e == 1:
                    a = _condsub(a, qm)
                    transform(mem, a, fw[mm], fws[mm], qm, logn, False, 1, first=False,
                              out=out[mm, c, j], dst="global")
                else:
                    mem.syncthreads()
                    idx = owner_map(logn, 0, 1)[0]
                    jj = (idx * e) % (2 * n)
                    x = np.where(jj >= n, qj - a, a)
                    slots = swz(jj & (n - 1))
                    assert sorted(slots.ravel().tolist()) == list(range(n))
                    mem.write(0, slots, _condsub(x, qm), np.arange(T)[:, None])
                    mem.syncthreads()
                    transform(mem, None, fw[mm], fws[mm], qm, logn, False, 1, out=out[mm, c, j],
                              src="shared", dst="global")
                assert not mem.pending
                between.append(mem.bar - mark)
    return out.astype(np.uint64), between


def tail_model(nd, rider, key, cfg, shared, C, guard=True):
    """csrc/ks.cu's ks_tail with Barrett or Shoup products (the same
    words; key (K, 2L(L+1), n)): (L, nb_out, 2, n).  guard=False drops what
    keeps limb m's exchanges off the slots limb m-1 may still read: the
    barrier at one CTA, the other buffer in a cluster."""
    L, n = cfg.n_limbs, cfg.n
    logn = n.bit_length() - 1
    logt, _, passes = geometry(logn)
    logc = C.bit_length() - 1
    T, words = 1 << logt, n // C
    J = np.arange(T)
    fw, fws, iw, iws, qs = _tables(cfg)
    nb_in = nd.shape[1]
    nb_out, nper = ks_kernel._blocks(nb_in, key.shape[0], shared)
    nd, rider, key = _objects(nd), _objects(rider), _objects(key)
    P, half = qs[L], (qs[L] - 1) // 2
    out = np.full((L, nb_out, 2, n), None, dtype=object)
    last, _ = owner_map(logn, passes - 1, C)  # the inverse's input map: adjacent pairs
    first, rank0 = owner_map(logn, 0, C)
    assert (last[:, 1::2] == last[:, ::2] + 1).all()
    for c in range(nb_out):
        d, kb = c % nb_in, key[c // nper]
        for part in (0, 1):
            mem = Smem(C, T, words * (2 if C == 1 else 3))
            if C > 1:
                mem.arrive()

            def inner(m):  # exact: Shoup and Barrett products give these words
                q = qs[m]
                acc = np.zeros(last.shape, dtype=object)
                for j in range(L):
                    acc = (acc + nd[m, d, j][last] * kb[2 * L * m + 2 * j + part][last]) % q
                return acc

            a = transform(mem, inner(L), iw[L], iws[L], P, logn, True, C)
            a_region = words * (1 if C == 1 else 2)
            sa = swz(local(first, logn, rankbit(logn, 0, logc), logc))
            mem.write(rank0[:, None], a_region + sa, (a + half) % P, J[:, None])
            for m in range(L):
                q = qs[m]
                a = mem.read(rank0[:, None], a_region + sa, J[:, None])
                a = (_condsub(a, q) - half % q) % q
                buf = 0
                if C == 1 and m and guard:
                    mem.syncthreads()
                elif C > 1 and guard and m % 2:
                    buf = words
                a = transform(mem, a, fw[m], fws[m], q, logn, False, C, buf=buf, first=False)
                v = (inner(m) - a) % q * cfg.pinv_mod(m) % q
                if part == 0:
                    v = (rider[m, d][last] % q + v) % q
                out[m, c, part][last] = v
            assert not mem.pending
    return out.astype(np.uint64)


def _data(cfg, nb, seed):
    rng = np.random.default_rng(seed)
    L, n = cfg.n_limbs, cfg.n
    b = np.stack([rng.integers(0, q, size=(nb, n), dtype=np.uint64) for q in cfg.moduli[:L]])
    b[:, 0, :64] = 0  # zero digits become the literal q_j under the automorphism
    return rng, b


def _key(rng, cfg):
    stride = 2 * cfg.n_limbs
    return np.stack([rng.integers(0, cfg.moduli[p // stride], size=cfg.n, dtype=np.uint64)
                     for p in range(stride * (cfg.n_limbs + 1))])


HEAD_CASES = [(cfg, e) for cfg in (SMALL, DEFAULT_CONFIG)
              for e in (1, pow(3, 5, 2 * cfg.n), 2 * cfg.n - 1)]


@pytest.mark.parametrize("cfg,e", HEAD_CASES, ids=[f"n{c.n}-e{e}" for c, e in HEAD_CASES])
def test_head_model_equals_plain(cfg, e):
    """One ciphertext (two at n = 1024): every (mm, j) word-exact; at
    e = 1 the NTT follows the INTT with no barrier between them (its first
    exchange writes the slots the INTT's last pass read, by the same
    thread), with the automorphism two barriers around the scatter."""
    nb = 2 if cfg.n < 8192 else 1
    _, b = _data(cfg, nb, 41)
    got, between = head_model(b, e, cfg)
    want = cv.to_u64(ks_kernel.ks_head_plain(cv.from_u64(b, CPU), None if e == 1 else e, cfg))
    assert np.array_equal(got, want)
    passes = geometry(cfg.n.bit_length() - 1)[2]
    assert set(between) == {passes - 1 + (0 if e == 1 else 2)}


TAIL_CASES = [(cfg, mode, C) for cfg in (SMALL, DEFAULT_CONFIG)
              for mode in ("single-barrett", "single-shoup", "batched", "shared")
              for C in ks_kernel.tail_clusters(cfg.n)]


@pytest.mark.parametrize("cfg,mode,C", TAIL_CASES,
                         ids=[f"n{c.n}-{m}-C{C}" for c, m, C in TAIL_CASES])
def test_tail_model_equals_plain(cfg, mode, C):
    """Single key (Shoup and Barrett products), batched keys (K = 2 blocks
    of one ciphertext) and shared inputs (K = 2 keys over one ciphertext):
    word-exact, and no access races."""
    L = cfg.n_limbs
    nb_in = 2 if mode == "batched" else 1
    rng, _ = _data(cfg, 1, 50 + C)
    nd = np.stack([rng.integers(0, q, size=(nb_in, L, cfg.n), dtype=np.uint64)
                   for q in cfg.moduli])
    rider = np.stack([rng.integers(0, q, size=(nb_in, cfg.n), dtype=np.uint64)
                      for q in cfg.moduli[:L]])
    keys = np.stack([_key(rng, cfg) for _ in range(1 if mode.startswith("single") else 2)])
    got = tail_model(nd, rider, keys, cfg, mode == "shared", C)
    key = cv.from_u64(keys if len(keys) > 1 else keys[0], CPU)
    want = ks_kernel.ks_tail_plain(cv.from_u64(nd, CPU), cv.from_u64(rider, CPU), key, cfg,
                                   shared_inputs=mode == "shared")
    assert np.array_equal(got, cv.to_u64(want))


@pytest.mark.parametrize("C", ks_kernel.tail_clusters(DEFAULT_CONFIG.n))
def test_tail_limbs_without_their_guard_race(C):
    """Without the barrier between the limbs (one CTA), limb 1's first
    exchange overwrites slots other threads may still read in limb 0's
    last pass; in a cluster sharing one buffer, limb 1's cross exchange
    writes into other CTAs' buffer they may still read: the model catches
    both."""
    cfg = DEFAULT_CONFIG
    rng, _ = _data(cfg, 1, 60)
    nd = np.stack([rng.integers(0, q, size=(1, cfg.n_limbs, cfg.n), dtype=np.uint64)
                   for q in cfg.moduli])
    rider = np.stack([rng.integers(0, q, size=(1, cfg.n), dtype=np.uint64)
                      for q in cfg.moduli[:cfg.n_limbs]])
    with pytest.raises(Race, match="another thread read" if C == 1 else "may still read"):
        tail_model(nd, rider, _key(rng, cfg)[None], cfg, False, C, guard=False)
