"""The port's 4-step NTT (`aloha_tpu_torch.ops.ntt_mxu`) against the JAX package.

Inputs are seeded NumPy arrays fed to both packages; every comparison is
word-exact (integer arithmetic, tolerance 0):
- the digit tables equal `aloha_tpu.ops.ntt_mxu._fwd_tables_np` /
  `_inv_tables_np` (planes converted back to u64);
- `transform_plain` and `chain_plain` equal `ntt_np` (n = 1024 - 16384)
  and the JAX MXU kernel run in Pallas interpret mode (n = 256 - 1024), as
  tests/test_ntt_mxu_interpret.py runs it;
- csrc/ntt_mxu.cu's layouts, modelled in NumPy at every ring the kernel
  takes (n = 256 .. 16384): the table stream read back through the wgmma
  descriptors' 128-byte swizzle rebuilds the tables (the small rings' row
  tables block-diagonal over a CTA's P polynomials, n = 16384's stages once
  per column half), each split writes every digit byte once where the
  descriptors read it, the accumulator fragments cover each output once,
  and the whole data flow (P polynomials a CTA with a short last CTA, the
  splits, the stream, the descriptor offsets, the column halves, the
  digit-at-a-time fold) equals the plain version;
- csrc/probe_mxu.cu's parts probe on that model at n = 8192: the XOR
  epilogue equals `probe_mxu_parts`' mxu step, the fake accumulators folded
  a digit at a time with the wide carry its vpu step, the fold with the
  final fold on every repetition `chain_plain`, and its table bytes the
  kernel operands each variant reads;
- inputs >= q, bad moduli and bad ring degrees, on the plain version and
  on the kernel's path (n = 32768 there too);
- the bench refuses to run without CUDA, and names no form that is not
  bit-exact.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from aloha_tpu import ntt_np
from aloha_tpu.config import DEFAULT_CONFIG
from aloha_tpu.ops import ntt_mxu as jax_mxu
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch.ops import ntt_mxu
from aloha_tpu_torch.probes import probe_mxu_parts

pytest.importorskip("jax.experimental.pallas")

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
C1K = __graft_entry__._small_cfg(1024)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ALOHA_STREAM_INTERPRET", "1")
    monkeypatch.setenv("ALOHA_STREAM_BP", "2")


def _u64(lo, hi):
    return np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << np.uint64(32))


def _residues(rng, q, shape):
    a = rng.integers(0, q, size=shape, dtype=np.uint64)
    a.reshape(-1, shape[-1])[0, :3] = (0, q - 1, 1)
    return a


def _root(n, limb, inverse):
    """The limb's root of order 2n, psi or (inverse) psi^-1: psi^(8192 / n)
    of DEFAULT_CONFIG's up to n = 8192, else g^((q - 1) / 2n) for the first
    g that has that order."""
    cfg = DEFAULT_CONFIG
    q = cfg.moduli[limb]
    if n <= cfg.n:
        psi = pow(cfg.psi[limb], cfg.n // n, q)
    else:
        psi = next(r for r in (pow(g, (q - 1) // (2 * n), q) for g in range(2, 100))
                   if pow(r, n, q) == q - 1)
    return pow(psi, -1, q) if inverse else psi


def _planes(a):
    nb, n = a.shape
    return (jnp.asarray((a & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(nb, -1, 128)),
            jnp.asarray((a >> np.uint64(32)).astype(np.uint32).reshape(nb, -1, 128)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n, limb", [(1024, 0), (1024, 2), (256, 0), (16384, 1)])
def test_tables_equal_jax(n, limb, inverse):
    """At n = 256 and 16384 the row bias exponent is bias_bits(8R) = 18 and
    24, which crow carries."""
    q, psi = DEFAULT_CONFIG.moduli[limb], _root(n, limb, False)
    got = ntt_mxu.tables_np(n, q, psi, inverse)
    build = jax_mxu._inv_tables_np if inverse else jax_mxu._fwd_tables_np
    row, lane, dp, ca, cb = build(n, q, psi)
    crow, ccol = (cb, ca) if inverse else (ca, cb)
    assert np.array_equal(got.row, row) and got.row.dtype == np.int8
    assert np.array_equal(got.lane, lane) and got.lane.dtype == np.int8
    assert np.array_equal(got.tw, _u64(dp[0], dp[1]))
    shoup = sum(dp[2 + i].astype(np.uint64) << np.uint64(16 * i) for i in range(4))
    assert np.array_equal(got.tws, shoup)
    assert np.array_equal(got.crow, _u64(*crow)[:, 0])
    assert np.array_equal(got.ccol, _u64(*ccol)[0, :])


@pytest.mark.parametrize("n", [1024, 2048, 8192, 16384])
def test_plain_matches_ntt_np(n):
    """All three moduli in one call (M=3) at n=1024; q0 at the other rings."""
    if n == 1024:
        limbs = range(3)
        qs = tuple(C1K.moduli)
        psis, ipsis = C1K.psi, C1K.ipsi
    else:
        limbs = range(1)
        qs = (DEFAULT_CONFIG.moduli[0],)
        psis, ipsis = (_root(n, 0, False),), (_root(n, 0, True),)
    rng = np.random.default_rng(n)
    a = np.stack([_residues(rng, q, (2, n)) for q in qs])
    x = cv.from_u64(a, CPU)
    fwd = cv.to_u64(ntt_mxu.transform_plain(x, qs, [psis[m] for m in limbs], False))
    inv = cv.to_u64(ntt_mxu.transform_plain(x, qs, [ipsis[m] for m in limbs], True))
    for i, m in enumerate(limbs):
        assert np.array_equal(fwd[i], ntt_np.ntt(a[i], qs[i], psis[m]))
        assert np.array_equal(inv[i], ntt_np.intt(a[i], qs[i], ipsis[m]))


@pytest.mark.parametrize("n", [256, 512, 1024])
def test_plain_matches_jax_interpret(interpret, n):
    """The rings of R = 2, 4 and 8 (roots psi^(1024 / n) of C1K's)."""
    q = C1K.moduli[0]
    psi, ipsi = (pow(r, 1024 // n, q) for r in (C1K.psi[0], C1K.ipsi[0]))
    a = _residues(np.random.default_rng(3), q, (2, n))
    x = cv.from_u64(a[None], CPU)
    fwd = cv.to_u64(ntt_mxu.transform_plain(x, (q,), (psi,), False)[0])
    assert np.array_equal(fwd, np.asarray(jax_mxu.ntt(jnp.asarray(a), q, psi)))
    inv = cv.to_u64(ntt_mxu.transform_plain(x, (q,), (ipsi,), True)[0])
    assert np.array_equal(inv, np.asarray(jax_mxu.intt(jnp.asarray(a), q, ipsi)))


@pytest.mark.parametrize("inverse", [False, True])
def test_chain_plain_matches_jax_chain_and_ntt_np(interpret, inverse):
    """k=3: the root of an inverse chain is psi^-1, as in ntt_chain_planes."""
    q, k = C1K.moduli[0], 3
    root = C1K.ipsi[0] if inverse else C1K.psi[0]
    a = _residues(np.random.default_rng(7), q, (2, 1024))
    want = a
    for _ in range(k):
        want = (ntt_np.intt if inverse else ntt_np.ntt)(want, q, root)
    got = cv.to_u64(ntt_mxu.chain_plain(cv.from_u64(a, CPU), q, root, k, inverse))
    assert np.array_equal(got, want)
    lo, hi = jax_mxu.ntt_chain_planes(*_planes(a), q, root, k, inverse=inverse)
    assert np.array_equal(_u64(lo, hi).reshape(2, 1024), want)


@pytest.mark.parametrize("limb", [0, 2])
def test_inputs_at_or_above_q_give_the_same_words(limb):
    """Any int64 >= 0 is taken mod q: the digit split reads all 64 bits."""
    q, psi = C1K.moduli[limb], C1K.psi[limb]
    rng = np.random.default_rng(11 + limb)
    big = rng.integers(0, (1 << 63) - 1, size=(2, 1024), dtype=np.int64).astype(np.uint64)
    big[0, :4] = (q, 2 * q - 1, (1 << 63) - 1, 16 * q + 5)
    want = ntt_np.ntt(big % np.uint64(q), q, psi)
    got = ntt_mxu.transform_plain(cv.from_u64(big[None], CPU), (q,), (psi,), False)
    assert np.array_equal(cv.to_u64(got[0]), want)
    chained = ntt_mxu.chain_plain(cv.from_u64(big, CPU), q, psi, 2, False)
    assert np.array_equal(cv.to_u64(chained), ntt_np.ntt(want, q, psi))


@pytest.mark.parametrize("n, q, match", [
    (1024, (1 << 59) - 1, "outside"),
    (1024, 1 << 60 | 1, "outside"),
    (1024, (1 << 60) - 1, "fold margin"),
    (128, DEFAULT_CONFIG.moduli[0], "ring degree"),
    (1000, DEFAULT_CONFIG.moduli[0], "ring degree"),
    (32768, DEFAULT_CONFIG.moduli[0], "ring degree"),
])
def test_bad_moduli_and_rings_raise(n, q, match, monkeypatch):
    """The plain version (CPU tensors) raises on each case but n = 32768,
    which it takes as the reference does; the kernel's path (CUDA tensors;
    here CPU ones sent down it, the kernel library a stand-in that fails the
    test if reached) raises on every case before a launch."""
    if n <= 16384:
        with pytest.raises(ValueError, match=match):
            ntt_mxu.check_modulus(n, q)
        with pytest.raises(ValueError, match=match):
            ntt_mxu.transform(torch.zeros((1, 1, n), dtype=torch.int64), (q,), (3,), False)
        with pytest.raises(ValueError, match=match):
            ntt_mxu.chain(torch.zeros((1, n), dtype=torch.int64), q, 3, 2, False)
    else:
        ntt_mxu.check_modulus(n, q)
    monkeypatch.setattr(ntt_mxu.dispatch, "use_kernel", lambda *t: True)
    monkeypatch.setattr(ntt_mxu._build, "lib", lambda: pytest.fail("the kernel was reached"))
    with pytest.raises(ValueError, match=match):
        ntt_mxu.transform(torch.zeros((1, 1, n), dtype=torch.int64), (q,), (3,), False)
    with pytest.raises(ValueError, match=match):
        ntt_mxu.chain(torch.zeros((1, n), dtype=torch.int64), q, 3, 2, False)


def test_cpu_tensors_take_the_plain_version():
    q, psi = C1K.moduli[1], C1K.psi[1]
    x = cv.from_u64(_residues(np.random.default_rng(5), q, (1, 2, 1024)), CPU)
    before = (ntt_mxu.transform.launches, ntt_mxu.chain.launches)
    assert torch.equal(ntt_mxu.transform(x, (q,), (psi,), False),
                       ntt_mxu.transform_plain(x, (q,), (psi,), False))
    assert torch.equal(ntt_mxu.chain(x[0], q, psi, 2, False),
                       ntt_mxu.chain_plain(x[0], q, psi, 2, False))
    assert (ntt_mxu.transform.launches, ntt_mxu.chain.launches) == before
    with pytest.raises(ValueError, match="chain length"):
        ntt_mxu.chain(x[0], q, psi, 0, False)
    with pytest.raises(ValueError, match="groups"):
        ntt_mxu.transform(x, (q, q), (psi, psi), False)


# ------------------------------------------ csrc/ntt_mxu.cu's layouts, modelled
KBLOCK = 128 * 128  # a 128-row k-block of 128 bytes (the rows product's A)
MASK59 = np.uint64((1 << 59) - 1)
M32 = np.uint64(0xFFFFFFFF)


RINGS = ntt_mxu.KERNEL_RINGS


def _ring(n, limb, inverse):
    """(q, root, Tables) at ring degree n under the limb's modulus (`_root`)."""
    q = DEFAULT_CONFIG.moduli[limb]
    root = _root(n, limb, inverse)
    return q, root, ntt_mxu.tables_np(n, q, ntt_mxu._forward_root(q, root, inverse), inverse)


def _sw(start, r, kbyte):
    """The shared-memory byte a wgmma descriptor with the 128-byte swizzle
    (csrc/wgmma_s8.cuh) reads for row r, byte kbyte of a matrix at `start`
    (the buffer 1024-aligned, start mod 128 + kbyte < 128): the address
    start + 1024 (r // 8) + 128 (r mod 8) + kbyte with bits 4-6 XOR bits 7-9."""
    lin = start + 1024 * (r // 8) + 128 * (r % 8) + kbyte
    return lin ^ (((lin >> 7) & 7) << 4)


def _read(buf, start, rows, width=32):
    """(rows, width) int64: the K-major matrix the descriptor at `start` reads."""
    return buf[_sw(start, np.arange(rows)[:, None], np.arange(width)[None, :])].astype(np.int64)


def _digits(words):
    """(R, 128) u64 -> (8, R, 128) int8 biased digits, byte_kk ^ 0x80."""
    return np.stack([(((words >> np.uint64(8 * kk)) & np.uint64(0xFF)) ^ np.uint64(0x80))
                     .astype(np.uint8).view(np.int8) for kk in range(8)])


def _split_rows(words):
    """split_rows_sw: thread item (lane l, rows r0 .. r0 + 15) stores the 16
    digits kk of its rows at k-block (kk R + r0) >> 7, row l, swizzled chunk
    (((kk R + r0) & 127) >> 4) ^ (l & 7).  Returns (planes, addresses)."""
    R = words.shape[0]
    kk, r0, l = np.arange(8)[:, None, None], np.arange(0, R, 16)[None, :, None], np.arange(128)
    k = kk * R + r0
    base = (k >> 7) * KBLOCK + l * 128 + ((((k & 127) >> 4) ^ (l & 7)) << 4)
    addr = base[..., None] + np.arange(16)  # byte i: row r0 + i
    src = _digits(words).reshape(8, R // 16, 16, 128).transpose(0, 1, 3, 2)
    planes = np.zeros(8 * R * 128, dtype=np.int8)
    planes[addr] = src
    return planes, addr


def _split_lanes(words):
    """split_lanes_sw: thread item (row r, lanes l0 .. l0 + 3) stores one u32
    per plane kk at k-block kk (R rows of 128 bytes), row r, byte 16 (((l0 >>
    4) ^ (r & 7))) + (l0 & 15).  Returns (planes, addresses)."""
    R = words.shape[0]
    kk, r, l0 = np.arange(8)[:, None, None], np.arange(R)[None, :, None], np.arange(0, 128, 4)
    base = kk * (R * 128) + r * 128 + (((l0 >> 4) ^ (r & 7)) << 4) + (l0 & 15)
    addr = base[..., None] + np.arange(4)  # byte i: lane l0 + i
    planes = np.zeros(8 * R * 128, dtype=np.int8)
    planes[addr] = _digits(words).reshape(8, R, 32, 4)
    return planes, addr


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", RINGS)
def test_table_stream_rebuilds_the_tables(n, inverse):
    """Read back through the descriptors' swizzle at the kernel's offsets,
    the stream's stages rebuild the row digits of a CTA's P polynomials
    (stage (h, j, p): the N x 128-byte tiles of k-blocks 2p, 2p + 1 of rows
    h N .. h N + N - 1 of A_j, padded to 16 KiB), tables_np(...).row on the
    diagonal blocks and zero digits elsewhere, and, once per column half,
    .lane (stage (j, kk): row c of T_j^T, bytes l of k = 128 kk + l); rows
    first forward and lanes first inverse."""
    _, _, tb = _ring(n, 2 if n <= 8192 else 1, inverse)
    R = n // 128
    RK, P, N = ntt_mxu.geometry(n)
    stream = ntt_mxu.table_stream(tb, inverse)
    nrow, nlane = RK // N * 8 * RK // 32, RK // N * 64
    assert stream.shape == (nrow + nlane, ntt_mxu.TILE) and stream.dtype == np.int8
    rows, lanes = (stream[nlane:], stream[:nlane]) if inverse else (stream[:nrow], stream[nrow:])
    assert not rows[:, 2 * N * 128:].any()
    packed = np.empty((8, RK, 8 * RK), dtype=np.int8)
    for s, tile in enumerate(rows):
        h, jp = divmod(s, 8 * RK // 32)
        j, p = divmod(jp, RK // 32)
        for kb in range(2):
            packed[j, h * N:h * N + N, 128 * (2 * p + kb):128 * (2 * p + kb + 1)] = _read(
                tile, kb * N * 128, N, 128)
    want = np.zeros((8, P, R, 8, P, R), dtype=np.int8)
    for p in range(P):
        want[:, p, :, :, p, :] = tb.row.reshape(8, R, 8, R)
    assert np.array_equal(packed, want.reshape(8, RK, 8 * RK))
    for h in range(RK // N):
        lane = np.empty_like(tb.lane)
        for s, tile in enumerate(lanes[64 * h:64 * h + 64]):
            j, kk = divmod(s, 8)
            lane[j, 128 * kk:128 * (kk + 1), :] = _read(tile, 0, 128, 128).T
        assert np.array_equal(lane, tb.lane)


@pytest.mark.parametrize("n", RINGS)
def test_splits_put_every_digit_at_one_swizzled_place(n):
    """Each split of a CTA's RK rows of words writes every byte of its
    planes exactly once, and the descriptors read back the operands the
    products need: the rows' A (lane l, k = kk RK + r) by k-block, the
    lanes' B (row r, k = kk 128 + l)."""
    RK = ntt_mxu.geometry(n)[0]
    words = np.random.default_rng(n).integers(0, 1 << 64, size=(RK, 128), dtype=np.uint64)
    words[0, :3] = (0, (1 << 63) - 1, (1 << 64) - 1)
    dig = _digits(words)
    planes, addr = _split_rows(words)
    assert np.array_equal(np.sort(addr.reshape(-1)), np.arange(planes.size))
    sT = dig.transpose(2, 0, 1).reshape(128, 8 * RK)  # S^T[l, kk RK + r]
    for kb in range(8 * RK // 128):
        assert np.array_equal(_read(planes, kb * KBLOCK, 128, 128), sT[:, 128 * kb:128 * kb + 128])
    planes, addr = _split_lanes(words)
    assert np.array_equal(np.sort(addr.reshape(-1)), np.arange(planes.size))
    for kk in range(8):
        assert np.array_equal(_read(planes, kk * RK * 128, RK, 128), dig[kk])


@pytest.mark.parametrize("n", RINGS)
def test_accumulator_fragments_cover_each_output_once(n):
    """The epilogue's word of d[4 blk + 2h + e] (lane 4 gq + t of warp w in
    warpgroup wg) in column half hf: lane m = 64 wg + 16 w + gq + 8h, row i
    = hf N + 8 blk + 2t + e; the 256 threads cover a CTA's (128 x RK)
    outputs once."""
    RK, _, N = ntt_mxu.geometry(n)
    seen = set()
    for hf in range(RK // N):
        for tid in range(256):
            wg, w, lane = tid // 128, (tid >> 5) & 3, tid & 31
            for o in range(N // 2):
                m = 64 * wg + 16 * w + (lane >> 2) + 8 * ((o >> 1) & 1)
                i = hf * N + 8 * (o >> 2) + 2 * (lane & 3) + (o & 1)
                assert (m, i) not in seen
                seen.add((m, i))
    assert len(seen) == 128 * RK


def _tail(lo, hi, c, q):
    """fold59's tail (csrc/mxu_core.cuh): W from the digit sums (lo, hi) and c."""
    qq, delta = np.uint64(q), np.uint64(q - (1 << 59))
    v1 = lo + (hi << np.uint64(40))
    v2 = v1 + c
    vhi = (hi >> np.uint64(24)) + (v1 < lo) + (v2 < v1)
    return (v2 & MASK59) + np.uint64(20) * qq - ((vhi << np.uint64(5)) | (v2 >> np.uint64(59))) * delta


def _finish(w, tw, tws, mid, fin, q):
    """finish<MID>: the Shoup twiddle (tw, tws at w's words), or the final fold when fin."""
    if mid:
        wo, two, tso = (a.astype(object) for a in (w, tw, tws))
        return ((wo * two - ((wo * tso) >> 64) * q) % (1 << 64)).astype(np.uint64)
    if fin:
        qq, delta = np.uint64(q), np.uint64(q - (1 << 59))
        w = (w & MASK59) + qq - (w >> np.uint64(59)) * delta
        w = np.where(w >= qq, w - qq, w)
    return w


def _kernel_step(words, tb, stream, s, rows, mid, fin, q, epi="fold"):
    """One product step as the kernel runs it on a CTA's (RK, 128) words: the
    split, then per column half h the wgmma k32 steps through the
    descriptors at the kernel's offsets (rows: A the planes' k-block p KB +
    kb, B the slot's k-block kb of N rows; lanes: A the slot, B the planes'
    k-block p from row h N), then the epilogue into rows h N .. h N + N - 1:
    "fold", fold59 a digit at a time into (lo, hi), its tail with the row
    bias of tables_np's ring, then finish on kernel_constants' tw, tws and
    crow; "xor", the parts probe's, x ^= e_j as each digit completes and
    u32(x) | u32(x + 1 or x ^ 3) << 32.  Returns (words, next stage)."""
    RK = words.shape[0]
    N = min(RK, 64)
    parts, kbs = (RK // 32, 2) if rows else (8, 1)
    b = ntt_mxu.bias_bits(8 * tb.tw.shape[0] if rows else 1024)
    tw, tws, crow = (a.reshape(RK, -1) for a in ntt_mxu.kernel_constants(tb))
    planes = (_split_rows if rows else _split_lanes)(words)[0]
    out = np.empty_like(words)
    for h in range(RK // N):
        lo = np.zeros((128, N), dtype=np.uint64)
        hi = np.zeros((128, N), dtype=np.uint64)
        x = np.zeros((128, N), dtype=np.uint64)
        for j in range(8):
            acc = np.zeros((128, N), dtype=np.int64)
            for p in range(parts):
                tile = stream[s % len(stream)]  # the stages repeat per transform
                s += 1
                for kb in range(kbs):
                    for kc in range(4):
                        if rows:
                            a = _read(planes, (p * kbs + kb) * KBLOCK + 32 * kc, 128)
                            bt = _read(tile, kb * N * 128 + 32 * kc, N)
                        else:
                            a = _read(tile, 32 * kc, 128)
                            bt = _read(planes, p * RK * 128 + h * N * 128 + 32 * kc, N)
                        acc += a @ bt.T
            if epi == "xor":
                x ^= (acc & 0xFFFFFFFF).astype(np.uint64)
                continue
            u = (acc + (1 << b)).astype(np.uint64)
            if j < 5:
                lo += u << np.uint64(8 * j)
            else:
                hi += u << np.uint64(8 * (j - 5))
        half = slice(h * N, h * N + N)
        if epi == "xor":
            top = (x + np.uint64(1)) & M32 if rows else x ^ np.uint64(3)
            out[half] = (x | (top << np.uint64(32))).T
            continue
        c = (crow[half, 0][None, :] if rows else tb.ccol[:, None]).astype(np.uint64)
        w = _tail(lo, hi, c, q).T  # word (h N + i) 128 + m
        out[half] = _finish(w, tw[half], tws[half], mid, fin, q)
    return out, s


def _kernel_model(words, tb, stream, q, k, inverse):
    """The kernel's k transforms of one CTA's words (RK, 128) u64."""
    s = 0
    for it in range(k):
        fin = it == k - 1
        for rows, mid in (((False, True), (True, False)) if inverse
                          else ((True, True), (False, False))):
            words, s = _kernel_step(words, tb, stream, s, rows, mid, fin, q)
    assert s == k * stream.shape[0]
    return words


def _launch_model(x, tb, stream, q, k, inverse):
    """The kernel's launch on x (nb, n) u64: CTA c takes polynomials c P ..
    c P + P - 1 as its RK rows of words; the last CTA's missing ones are
    zeros, and are not stored."""
    nb, n = x.shape
    RK, P, _ = ntt_mxu.geometry(n)
    y = np.empty_like(x)
    for c in range(0, nb, P):
        cta = np.zeros((P, n), dtype=np.uint64)
        cta[:nb - c] = x[c:c + P]
        y[c:c + P] = _kernel_model(cta.reshape(RK, 128), tb, stream, q, k,
                                   inverse).reshape(P, n)[:nb - c]
    return y


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", RINGS)
def test_kernel_model_equals_plain(n, inverse):
    """A NumPy model of csrc/ntt_mxu.cu's launch (P polynomials a CTA, the
    splits, table stream, descriptor offsets, column halves, the
    digit-at-a-time fold59, finish) gives the plain version's words for k =
    1 and 2 on 2P - 1 polynomials (the last CTA one short; one at P = 1),
    on the fold's range ends (0, q - 1, 2^63 - 1, 2^64 - 1) and random
    words."""
    q, root, tb = _ring(n, 0, inverse)
    P = ntt_mxu.geometry(n)[1]
    nb = 2 * P - 1
    stream = ntt_mxu.table_stream(tb, inverse)
    words = np.random.default_rng(n + inverse).integers(0, 1 << 63, size=(nb, n),
                                                        dtype=np.uint64)
    words[0, :4] = (0, q - 1, (1 << 63) - 1, (1 << 64) - 1)
    x = torch.from_numpy(words.view(np.int64))
    for k in (1, 2):
        got = _launch_model(words, tb, stream, q, k, inverse)
        want = ntt_mxu.chain_plain(x, q, root, k, inverse)
        assert np.array_equal(got, cv.to_u64(want)), k


# ------------------------- csrc/probe_mxu.cu's parts probe on the same model
def _parts_model(words, tb, stream, q, reps, epi):
    """The parts kernel's full ("fold") or mxu ("xor") variant on one
    polynomial (R, 128) u64: each repetition the rows with the twiddle, then
    the lanes, the final fold on every repetition, the stream's stage g
    running on across repetitions."""
    s = 0
    for _ in range(reps):
        for rows, mid in ((True, True), (False, False)):
            words, s = _kernel_step(words, tb, stream, s, rows, mid, True, q, epi)
    assert s == reps * stream.shape[0]
    return words


def _parts_input(q):
    """(64, 128) u64: random words below 2^63 and the fold's range ends."""
    words = np.random.default_rng(18).integers(0, 1 << 63, size=(64, 128), dtype=np.uint64)
    words[0, :4] = (0, q - 1, (1 << 63) - 1, (1 << 64) - 1)
    return words


def _port(words):
    return torch.from_numpy(words.reshape(1, -1).view(np.int64))


@pytest.mark.parametrize("reps", [1, 2])
def test_parts_fold_every_repetition_equals_chain_plain(reps):
    """full: the transform with fin on every repetition is canonical each
    time, so its words are chain_plain's."""
    q, root, tb = _ring(8192, 0, False)
    words = _parts_input(q)
    got = _parts_model(words, tb, ntt_mxu.table_stream(tb, False), q, reps, "fold")
    want = ntt_mxu.chain_plain(_port(words), q, root, reps, False)
    assert np.array_equal(got.reshape(1, -1), cv.to_u64(want))
    assert int(got.max()) < q


@pytest.mark.parametrize("reps", [1, 2])
def test_parts_xor_epilogue_equals_the_mxu_step(reps):
    """mxu: the XOR epilogue, a digit at a time through the rows then the
    lanes, gives probe_mxu_parts' mxu words (its _mxu_step, reps times)."""
    q, _, tb = _ring(8192, 0, False)
    words = _parts_input(q)
    got = _parts_model(words, tb, ntt_mxu.table_stream(tb, False), q, reps, "xor")
    want = probe_mxu_parts.parts_plain(_port(words), "mxu", reps)
    assert np.array_equal(got.reshape(1, -1), cv.to_u64(want))


def _places():
    """(256, 32): the word of accumulator o of thread tid at R = 64
    (csrc/mxu_core.cuh's Places), a permutation of the 8192 words."""
    tid, o = np.arange(256)[:, None], np.arange(32)[None, :]
    wg, w, lane = tid // 128, (tid >> 5) & 3, tid & 31
    m = 64 * wg + 16 * w + (lane >> 2) + 8 * ((o >> 1) & 1)
    i = 8 * (o >> 2) + 2 * (lane & 3) + (o & 1)
    return i * 128 + m


def _vpu_epilogue(words, tb, q, rows):
    """vpu_step: each thread's 32 words at its places, e_j = v ^ j (v =
    lo32(x), or lo32(x) ^ hi32(x) for the lanes) folded a digit at a time,
    lo's carry past 2^64 at j = 4 put into hi as 2^24, fold59's tail with
    crow[i] or ccol[m], then the Shoup twiddle (rows) or the final fold.
    Returns (words, the number of words that carried)."""
    idx = _places()
    x = words.reshape(-1)[idx]
    v = x & M32 if rows else (x ^ (x >> np.uint64(32))) & M32
    b = ntt_mxu.bias_bits(8 * 64 if rows else 1024)
    lo, hi = np.zeros_like(x), np.zeros_like(x)
    for j in range(8):
        u = ((v ^ np.uint64(j)) + np.uint64(1 << b)) & M32
        if j < 4:
            lo += u << np.uint64(8 * j)
        elif j == 4:
            t = lo + (u << np.uint64(32))
            carry = t < lo
            hi = carry.astype(np.uint64) << np.uint64(24)
            lo = t
        else:
            hi += u << np.uint64(8 * (j - 5))
    c = tb.crow[idx // 128] if rows else tb.ccol[idx % 128]
    w = _finish(_tail(lo, hi, c, q), tb.tw.reshape(-1)[idx], tb.tws.reshape(-1)[idx], rows,
                True, q)
    out = words.reshape(-1).copy()
    out[idx] = w
    return out.reshape(words.shape), int(carry.sum())


@pytest.mark.parametrize("reps", [1, 2])
def test_parts_fake_accumulators_equal_the_vpu_step(reps):
    """vpu: the digit-at-a-time fold with the wide carry gives
    probe_mxu_parts' vpu words (its _vpu_step, reps times), on words whose
    lo4 + (u_4 << 32) carries out of 64 bits in the row epilogue (lo32 =
    2^32 - 2^23 - 8: u_j = 2^32 - 8 + j) and random words, which carry in
    the lane epilogue too."""
    q, _, tb = _ring(8192, 0, False)
    assert sorted(_places().reshape(-1)) == list(range(8192))
    words = _parts_input(q)
    words[1, :] = (words[1, :] & ~M32) | np.uint64((1 << 32) - (1 << 23) - 8)
    got, carried = words, []
    for _ in range(reps):
        for rows in (True, False):
            got, n = _vpu_epilogue(got, tb, q, rows)
            carried.append(n)
    assert carried[0] >= 128 and all(carried), carried
    want = probe_mxu_parts.parts_plain(_port(words), "vpu", reps)
    assert np.array_equal(got.reshape(1, -1), cv.to_u64(want))


@pytest.mark.parametrize("variant", probe_mxu_parts.VARIANTS)
def test_parts_table_bytes_are_the_kernel_operands(variant):
    """TABLE_BYTES: the bytes of kernel_tables' forward stream of q0 (80
    stages of 16 KiB, a row stage filling its slot at R = 64) and of the
    constants each variant reads."""
    q, psi = DEFAULT_CONFIG.moduli[0], DEFAULT_CONFIG.psi[0]
    stream, tw, tws, crow, ccol, _ = ntt_mxu.kernel_tables(8192, (q,), (psi,), False, CPU)
    assert stream.numel() == 80 * ntt_mxu.TILE
    reads = {"full": (stream, tw, tws, crow, ccol), "mxu": (stream,),
             "vpu": (tw, tws, crow, ccol)}[variant]
    assert probe_mxu_parts.TABLE_BYTES[variant] == sum(t.numel() * t.element_size()
                                                       for t in reads)


def test_bench_without_cuda_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", "aloha_tpu_torch.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    for line in res.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        assert "metric" not in rec


def test_bench_best_takes_only_bit_exact_forms():
    from aloha_tpu_torch import bench

    recs = [{"metric": "a", "value": 3.0, "bitexact": False},
            {"metric": "b", "value": 2.0, "bitexact": True},
            {"metric": "c", "value": 1.0, "bitexact": True}]
    assert bench.best(recs)["metric"] == "b"
    assert bench.best([dict(r, bitexact=False) for r in recs]) is None
