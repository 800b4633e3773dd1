"""The op bench on one NVIDIA GPU (the port of tools/bench_opsuite.py and tools/bench_ops.py).

    python -m aloha_tpu_torch.opbench [--batch 64] [--chain 16] [--ops rotate,encode]
                                      [--trials 4] [--out FILE]
    python -m aloha_tpu_torch.opbench --device cpu --batch 2 --chain 2 --trials 1

Each row is a K-link, data-dependent chain of one link function on a batch
of B ciphertexts at N = 8192, L = 2 (`config.DEFAULT_CONFIG`); the links
are the JAX tool's, written in `he_torch`:

  hom_add         hom_add(ct, ct2)                           8K links
  mul_plain       mul_plain(ct, pt)                          8K
  ct_mul_like     hom_add(mul_plain(ct, pt), mul_plain(ct2, pt))  4K
  rotate          rotate(ct, 2, ksk)                         K
  matvec_step     hom_add(mul_plain(rotate(ct, 2, ksk), pt), ct2)  K
  encode_post     (encode_post(ct[0]), ct[1])                4K
  rotate_hoisted  rotate_hoisted(ct, 1..KH, ksks), chained on its step-1
                  output, beside the plain rotations of the same steps  K
  matvec_bsgs     matvec_bsgs(ct, diags, kb, kg, g=4) at D = 16  max(K, 4)
  multiply        relinearize(*ct_mul(ct, ct2), rlk)         K
  encode          he_torch.encode of B cleartexts (two batches taken in
                  turn: the links are independent calls on one stream)  4K
  isa_oplist      `runtime.host.HostRunner` through the case3 op-list of
                  chip_smoke.py's isa phase (encode one plaintext; per
                  ciphertext load, mul_plain, rotate by 2 and by 4,
                  hom_add, store) on min(B, 16) ciphertexts, link j
                  reading DRAM region j mod 2 and storing to the other  max(2, K/8)
  end_to_end      one request of B vectors: host encoding, encryption on
                  the card, matvec_bsgs (D = 16, g = 4), rescale,
                  decryption back on the host (decoding, for the error
                  check, is not timed)                       max(2, K/4)

Inputs are the JAX tool's: uniform words below each modulus from
np.random.default_rng(0), drawn in its order (a1, b1, a2, b2, pt, its
epoch sample, the D diagonals), then this bench's cleartexts and slot
vectors from the same stream; keys from `keys` under a seeded
torch.Generator, or a caller's `keyset` (the tests carry the JAX
package's keys across by `convert`).

Protocol.  Eager: the card synchronised before and after, host clock, best
of `trials` after one warm-up; recorded = B K / t at the full chain,
marginal = the K-slope between K/2 and K links, marginal_reliable when the
half/full delta exceeds 5 ms (the JAX tool's rule), and the chain doubles
(up to 10 times) until it does.  Graph: the same chain captured in one
CUDA graph and replayed (graph_recorded, graph_marginal over its own
graph_chain, doubled by the same rule, and graph_bitexact: the replay's
words against the eager chain's); the ISA and end-to-end rows do host work
by design and are eager only.  null_ms is an empty synchronised
call.  bitexact: batch element 0 of the card's chain against the port's
plain path on CPU tensors, link by link (the CPU tests hold that path
against `he_np`), for `bitexact_links` links: at least 2, the whole chain
where that takes under `replay_s`; the ISA row compares the card's DRAM
with a CPU HostRunner's; the end-to-end row replays each request's vector
of largest slot error, worst first (`client`).  It also carries that
error (decrypt_error, beside the one-vector envelope 0.15) and the largest
error in noise standard deviations (noise_ratio) against the level a
correct answer of all its slots keeps (noise_bound, `client.noise_bound`).
launches: kernel launches per link from the
wrappers' `.launches` counters; device_busy: the busy share of one eager
chain (at most 8 links; one for the ISA and end-to-end rows) in a
torch.profiler trace.  With `device="cpu"` every row runs on the plain
path, untimed by graphs and with no bitexact replay (bitexact None).

A row that raises is recorded with its error and the run goes on; main()
then exits nonzero, as for a row with bitexact or graph_bitexact false or
an end-to-end noise_ratio at or over its noise_bound.  The decrypt error
over 0.15 (within_envelope false) is recorded, not a failure: the error is
the rescale's noise, whose tail grows with the slots checked, not with
D.  It prints one JSON line per row and writes a file only where --out
names one.  `--device cuda`
without a card raises (no CPU fallback).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from aloha_tpu_torch import bench, client, encoder, keys, profiling
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch.config import DEFAULT_CONFIG, NUM_LANES, HEConfig
from aloha_tpu_torch.ops import aut, ks_kernel, ntt_pallas, ntt_stream, rns_kernel

ROWS = ("hom_add", "mul_plain", "ct_mul_like", "rotate", "matvec_step", "encode_post",
        "rotate_hoisted", "matvec_bsgs", "multiply", "encode", "isa_oplist", "end_to_end")
#: rows built only of he_torch calls: each is also captured in a CUDA graph
GRAPH_ROWS = ROWS[:10]
HOISTED_K = 12  # steps of the hoisted rotation (the JAX tool's OPBENCH_HOISTED_K)
MATVEC_D, MATVEC_G = 16, 4  # diagonals and baby steps of matvec_bsgs
ISA_BATCH = 16  # ciphertexts of the ISA op-list (chip_smoke.py's isa phase)
RELIABLE_S = 0.005  # half/full delta a marginal needs (tools/bench_opsuite.py:237-239)
MAX_DOUBLINGS = 10
REPLAY_S = 30.0  # budget of the CPU replay behind `bitexact`
PROFILE_LINKS = 8
ENVELOPE = 0.15  # decrypt error bound of examples/encrypted_matvec.py
SEED = 0
#: the wrappers whose `.launches` count kernel launches
COUNTERS = {"ntt": ntt_stream.transform, "ntt_grid": ntt_pallas.transform,
            "ks_head": ks_kernel.ks_head, "ks_tail": ks_kernel.ks_tail,
            "aut": aut.automorphism, "rns": rns_kernel.elementwise}
UNITS = {
    "hom_add": "ops/s/card", "mul_plain": "ops/s/card", "ct_mul_like": "ops/s/card",
    "rotate": "rotations/s/card", "matvec_step": "ops/s/card", "encode_post": "ops/s/card",
    "rotate_hoisted": "rotations/s/card",
    "matvec_bsgs": f"matvec{MATVEC_D}/s/card (D={MATVEC_D} diagonals, g={MATVEC_G})",
    "multiply": "products/s/card (ct_mul + relinearize)", "encode": "encodings/s/card",
    "isa_oplist": "op-list links/s/card (load, mul_plain, rotate 2, rotate 4, hom_add, store)",
    "end_to_end": "vectors/s/card (host encoding, encryption, matvec16, rescale, decryption)",
}


def links(name: str, K: int) -> int:
    """Links of row `name`'s chain at --chain K (at least 2, so the half
    chain has one)."""
    mult = {"hom_add": 8 * K, "mul_plain": 8 * K, "ct_mul_like": 4 * K, "encode_post": 4 * K,
            "encode": 4 * K, "matvec_bsgs": max(K, 4), "isa_oplist": K // 8,
            "end_to_end": K // 4}
    return max(2, mult.get(name, K))


# ---------------------------------------------------------------- material
@dataclasses.dataclass
class Material:
    """A row's inputs on one device."""

    cfg: HEConfig
    ct1: tuple  # (a, b), each (B, L, N) int64: uniform words below each modulus
    ct2: tuple
    pt: torch.Tensor  # (B, L, N)
    diags: list  # MATVEC_D uniform (L, N) plaintexts (the matvec_bsgs row)
    sk: keys.SecretKey
    rot: dict  # rotation step -> key (2L(L+1), N)
    rlk: torch.Tensor
    clear: torch.Tensor  # (2, B, N) float64 cleartexts (the encode row)
    isa_flat: np.ndarray  # (min(B, ISA_BATCH), 4N) uint64: ct1 in the ISA's layout
    isa_clear: np.ndarray  # (N,) float64: the op-list's encoded cleartext
    dvecs: list  # MATVEC_D real slot vectors: the end-to-end row's matrix
    ddiags: list  # their encodings (L, N)
    zs: np.ndarray  # (2, B, N/2) complex slot vectors: the end-to-end requests

    @property
    def batch(self) -> int:
        return self.ct1[0].shape[0]

    @property
    def hsteps(self) -> list:
        return list(range(1, HOISTED_K + 1))

    @property
    def baby(self) -> list:
        return [self.rot[j] for j in range(1, MATVEC_G)]

    @property
    def giant(self) -> list:
        return [self.rot[MATVEC_G * i] for i in range(1, -(-MATVEC_D // MATVEC_G))]

    def element0(self, device) -> "Material":
        """Batch element 0 of every batched input, and the keys, on `device`."""
        def to(x):
            return x[:1].to(device)

        return dataclasses.replace(
            self, ct1=tuple(to(x) for x in self.ct1), ct2=tuple(to(x) for x in self.ct2),
            pt=to(self.pt), diags=[d.to(device) for d in self.diags],
            sk=keys.SecretKey(coeff=self.sk.coeff.to(device), ntt=self.sk.ntt.to(device)),
            rot={s: k.to(device) for s, k in self.rot.items()}, rlk=self.rlk.to(device),
            clear=self.clear[:, :1].to(device), isa_flat=self.isa_flat[:1],
            ddiags=[d.to(device) for d in self.ddiags], zs=self.zs[:, :1])


def key_steps() -> list:
    """Rotation steps whose keys the rows read: the hoisted steps, the
    matvec's baby and giant steps, and the ISA's 2 and 4."""
    bg = -(-MATVEC_D // MATVEC_G)
    return sorted(set(range(1, HOISTED_K + 1)) | set(range(1, MATVEC_G))
                  | {MATVEC_G * i for i in range(1, bg)} | {2, 4})


def material(cfg: HEConfig, device, batch: int, keyset: dict | None = None) -> Material:
    """The rows' inputs for a batch of `batch` on `device`.  keyset:
    {"sk": keys.SecretKey, "rot": {step: key}, "rlk": key} (None: drawn
    from keys under a torch.Generator seeded SEED + 1)."""
    dev = torch.device(device)
    L, n, S = cfg.n_limbs, cfg.n, cfg.n // 2
    rng = np.random.default_rng(SEED)
    lim = np.asarray(cfg.moduli[:L], dtype=np.uint64)[:, None]

    def rand_u64(shape):
        return rng.integers(0, 1 << 63, size=shape + (L, n), dtype=np.uint64) % lim

    def slots(shape=()):
        return rng.uniform(-1, 1, shape + (S,)) + 1j * rng.uniform(-1, 1, shape + (S,))

    a1, b1, a2, b2, ptv = (rand_u64((batch,)) for _ in range(5))
    rand_u64((batch,))  # the JAX tool's epoch sample, drawn to keep its stream
    diags = [rand_u64(()) for _ in range(MATVEC_D)]
    clear = np.stack([[encoder.cleartext_from_slots(z) for z in slots((batch,))]
                      for _ in range(2)])
    isa_clear = encoder.cleartext_from_slots(slots())
    dvecs = [rng.uniform(-1, 1, S) for _ in range(MATVEC_D)]
    zs = slots((2, batch))
    steps = key_steps()
    if keyset is None:
        gen = torch.Generator().manual_seed(SEED + 1)
        sk = keys.gen_secret(cfg, gen, dev)
        rot = {s: keys.gen_rotation_key(sk, s, cfg, gen) for s in steps}
        rlk = keys.gen_relin_key(sk, cfg, gen)
    else:
        sk = keys.SecretKey(coeff=keyset["sk"].coeff.to(dev), ntt=keyset["sk"].ntt.to(dev))
        rot = {s: keyset["rot"][s].to(dev) for s in steps}
        rlk = keyset["rlk"].to(dev)
    dcoeff = np.stack([encoder.encode(encoder.cleartext_from_slots(d + 0j), cfg) for d in dvecs])
    nb_isa = min(batch, ISA_BATCH)
    return Material(
        cfg=cfg, ct1=(cv.from_u64(a1, dev), cv.from_u64(b1, dev)),
        ct2=(cv.from_u64(a2, dev), cv.from_u64(b2, dev)), pt=cv.from_u64(ptv, dev),
        diags=[cv.from_u64(d, dev) for d in diags], sk=sk, rot=rot, rlk=rlk,
        clear=torch.from_numpy(clear).to(dev),
        isa_flat=np.concatenate([a1[:nb_isa].reshape(nb_isa, -1),
                                 b1[:nb_isa].reshape(nb_isa, -1)], axis=1),
        isa_clear=isa_clear, dvecs=dvecs,
        ddiags=list(ht.encode_post(cv.from_u64(dcoeff, dev), cfg)), zs=zs)


# -------------------------------------------------------------------- links
LINKS = {
    "hom_add": lambda m, s, j: ht.hom_add(s, m.ct2, m.cfg),
    "mul_plain": lambda m, s, j: ht.mul_plain(s, m.pt, m.cfg),
    "ct_mul_like": lambda m, s, j: ht.hom_add(ht.mul_plain(s, m.pt, m.cfg),
                                              ht.mul_plain(m.ct2, m.pt, m.cfg), m.cfg),
    "rotate": lambda m, s, j: ht.rotate(s, 2, m.rot[2], m.cfg),
    "matvec_step": lambda m, s, j: ht.hom_add(
        ht.mul_plain(ht.rotate(s, 2, m.rot[2], m.cfg), m.pt, m.cfg), m.ct2, m.cfg),
    "encode_post": lambda m, s, j: (ht.encode_post(s[0], m.cfg), s[1]),
    "rotate_hoisted": lambda m, s, j: ht.rotate_hoisted(
        s[0], m.hsteps, [m.rot[t] for t in m.hsteps], m.cfg),
    "matvec_bsgs": lambda m, s, j: ht.matvec_bsgs(s, m.diags, m.baby, m.giant, m.cfg,
                                                  g=MATVEC_G),
    "multiply": lambda m, s, j: ht.relinearize(*ht.ct_mul(s, m.ct2, m.cfg), m.rlk, m.cfg),
    "encode": lambda m, s, j: ht.encode(m.clear[j % 2], m.cfg),
}


def _plain_hoisted(m, s, j):
    """The link of rotate_hoisted's yardstick: the plain rotations of the same steps."""
    return [ht.rotate(s[0], t, m.rot[t], m.cfg) for t in m.hsteps]


def _first(x):
    """Batch element 0 of a state on the CPU."""
    if isinstance(x, (tuple, list)):
        return type(x)(_first(v) for v in x)
    return x[:1].cpu() if isinstance(x, torch.Tensor) else x[:1]


def isa_oplist(cfg: HEConfig, nb: int, j: int) -> str:
    """Link j of the ISA row's op-list in the reference's case3 line format
    (runtime.host): the encode of the plaintext first at j = 0, then per
    ciphertext i load from DRAM region j mod 2, mul_plain, rotate by 2 and
    by 4, hom_add, store to the other region (chip_smoke.py's isa phase
    with one region a link)."""
    ct = 4 * (cfg.n // NUM_LANES)  # SPM rows of a ciphertext
    CT, PT, R1, R2, R3, R4 = (i * ct for i in range(6))
    ct_bytes = 4 * cfg.n * 8

    def line(op, spm, b, c):
        return f"{(op << 28) | spm:08x},{b:08x},{c:08x}"

    text = [line(3, PT, 0, 0)] if j == 0 else []
    for i in range(nb):
        src = ((j % 2) * nb + i) * ct_bytes
        dst = (((j + 1) % 2) * nb + i) * ct_bytes
        text += [line(1, CT, 0, src), line(5, R1, CT, PT), line(7, R2, 2, R1),
                 line(7, R3, 4, R1), line(6, R4, R2, R3), line(2, R4, 0, dst)]
    return "\n".join(text)


class _IsaChain:
    """The ISA row's state: an AlohaDevice with the full SPM and KSK memory
    on m's device, rotation keys 2 and 4 in their slots, and a HostRunner
    whose DRAM holds the ciphertexts in region 0 and the op-list's cleartext."""

    def __init__(self, m: Material):
        from aloha_tpu_torch.runtime import host
        from aloha_tpu_torch.runtime.device import AlohaDevice

        cfg, dev = m.cfg, m.ct1[0].device
        self.cfg, self.host = cfg, host
        self.flat = m.isa_flat
        self.nb = self.flat.shape[0]
        self.ct_bytes = 4 * cfg.n * 8
        device = AlohaDevice(cfg, device=dev)
        for c in (2, 4):
            device.dma_load_ksk(m.rot[c], row=device.rotation_ksk_ptr(c))
        words = host.DRAM_VP_BASE // 8 + 2 * self.nb * 4 * cfg.n
        self.runner = host.HostRunner(device, cfg, dram_words=max(1 << 23, words),
                                      encoder=functools.partial(encoder.encode, cfg=cfg))
        self.runner.load_dram(host.DRAM_ENCODER_BASE, m.isa_clear.view(np.uint64))
        self._ops = {}

    def ops(self, j: int) -> list:
        """Link j's parsed ops."""
        key = (j == 0, j % 2)  # link j's ops depend on these alone
        if key not in self._ops:
            self._ops[key] = self.host.parse_op_list(isa_oplist(self.cfg, self.nb, j))
        return self._ops[key]

    def start(self):
        self.runner.trace.clear()
        self.runner.load_dram(self.host.DRAM_VP_BASE, self.flat)
        return 0  # links run so far

    def link(self, done: int, j: int) -> int:
        self.runner.run(self.ops(j))
        return done + 1

    def output(self, done: int) -> np.ndarray:
        """The stored ciphertexts after `done` links, (nb, 4N) uint64."""
        base = self.host.DRAM_VP_BASE + (done % 2) * self.nb * self.ct_bytes
        return self.runner.read_dram(base, self.nb * self.ct_bytes // 8).reshape(self.nb, -1)


def _request(m: Material, j: int):
    """End-to-end request j of B vectors: host encoding, encryption on m's
    device (draws from a generator seeded by j), matvec_bsgs, rescale,
    decryption; (input ciphertext, output ciphertext, the signed limb-0
    coefficients on the host)."""
    cfg = m.cfg
    ct = client.encrypt_slots(m.zs[j % 2], m.sk, cfg, torch.Generator().manual_seed(SEED + 2 + j))
    out = ht.rescale(ht.matvec_bsgs(ct, m.ddiags, m.baby, m.giant, cfg, g=MATVEC_G), cfg)
    return ct, out, keys.decrypt(out, m.sk, cfg).cpu().numpy()


def _errors(m: Material, j: int, dec: np.ndarray):
    """Request j's largest slot error of each vector against the cleartext
    product; its largest error in noise standard deviations, their mean square."""
    want = np.stack([client.matvec_clear(m.dvecs, z) for z in m.zs[j % 2]])
    return client.slot_errors(client.decode_rescaled(dec, m.cfg), want,
                              client.noise_sigma(dec, m.sk, m.cfg))


@dataclasses.dataclass
class _Spec:
    """A chain: its start, its link j, and its result (the ISA's: the DRAM
    words of the ciphertexts, read back once the links have run)."""

    start: Callable[[], object]
    link: Callable[[object, int], object]
    finish: Callable[[object], object] = lambda s: s


def _spec(name: str, m: Material, link=None) -> _Spec:
    if name == "isa_oplist":
        isa = _IsaChain(m)
        return _Spec(isa.start, isa.link, isa.output)
    if name == "end_to_end":
        return _Spec(lambda: None, lambda s, j: _request(m, j))
    link = link or LINKS[name]
    start = {"rotate_hoisted": lambda: [m.ct1], "encode": lambda: None}.get(name, lambda: m.ct1)
    return _Spec(start, lambda s, j: link(m, s, j))


def _chain(spec: _Spec):
    def chain(k: int):
        s = spec.start()
        for j in range(k):
            s = spec.link(s, j)
        return spec.finish(s)
    return chain


# ------------------------------------------------------------------- timing
def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best(fn, trials: int, dev: torch.device):
    """(best host seconds of `trials` calls of fn, the card synchronised
    before and after each; the last call's result)."""
    best, out = math.inf, None
    for _ in range(trials):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, out


def _rates(work: int, k: int, t_hi: float, t_lo: float, prefix: str = "") -> dict:
    """recorded, marginal and its reliability of a k-link chain timed t_hi
    beside its k // 2 links timed t_lo; `work` units a link."""
    delta = t_hi - t_lo
    return {f"{prefix}recorded": work * k / t_hi,
            f"{prefix}marginal": work * (k - k // 2) / delta if delta > 0 else None,
            f"{prefix}marginal_reliable": bool(delta > RELIABLE_S),
            f"{prefix}t_full_ms": t_hi * 1e3, f"{prefix}t_half_ms": t_lo * 1e3}


def _doubling(timed, k: int):
    """timed(k) -> (seconds, output) of a k-link chain, taken at k and k // 2
    with k doubling until their delta exceeds RELIABLE_S: (k, t_full,
    t_half, the full chain's output)."""
    for attempt in range(MAX_DOUBLINGS + 1):
        t_hi, out = timed(k)
        t_lo, _ = timed(k // 2)
        if t_hi - t_lo > RELIABLE_S or attempt == MAX_DOUBLINGS:
            return k, t_hi, t_lo, out
        k *= 2


def _graph(chain, k: int, trials: int, dev: torch.device):
    """chain(k) captured in one CUDA graph: (best replay seconds, the
    captured output after the last replay)."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = chain(k)
    g.replay()
    t, _ = _best(g.replay, trials, dev)
    del g
    return t, out


def _equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def _host(x):
    """A state as uint64 arrays on the host."""
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    return cv.to_u64(x) if isinstance(x, torch.Tensor) else x


def _counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def _trace_busy(fn, dev: torch.device):
    """(device busy seconds, host seconds) of fn() under torch.profiler."""
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.Profiler(trace_dir=tmp).device_trace("chain"):
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            wall = time.perf_counter() - t0
        _, busy_us = profiling.trace_device_events(os.path.join(tmp, "chain.json"))
    return busy_us / 1e6, wall


# ---------------------------------------------------------------- replays
def _replay(spec: _Spec, plain: _Spec, k: int, budget_s: float):
    """Batch element 0 of spec's chain against plain's chain on CPU
    tensors, link by link: (equal, links compared).  At least 2 links, all
    k while the CPU's links fit `budget_s`."""
    s, c = spec.start(), plain.start()
    t0 = time.perf_counter()
    for j in range(k):
        s, c = spec.link(s, j), plain.link(c, j)
        if not _equal(_first(spec.finish(s)), _first(plain.finish(c))):
            return False, j + 1
        spent = time.perf_counter() - t0
        if j + 1 >= 2 and spent * (j + 2) / (j + 1) > budget_s:
            return True, j + 1
    return True, k


def _replay_e2e(m: Material, m0: Material | None, k: int, budget_s: float) -> dict:
    """k requests on m's device, then each request's vector of largest slot
    error, worst first, through matvec_bsgs and rescale on the plain path
    (m0, CPU tensors) from the card's encryption: at least 2 (or all k),
    all while they fit budget_s; none without m0.  The end-to-end row's
    bitexact, bitexact_links (requests compared), decrypt_error and
    decrypt_error_at ([request, vector]), noise_ratio, noise_bound and
    noise_mean_square."""
    worst, ratio, square = [], 0.0, 0.0
    for j in range(k):
        ct, out, dec = _request(m, j)
        err, r, sq = _errors(m, j, dec)
        i = int(err.argmax())
        ratio, square = max(ratio, r), square + sq / k
        worst.append((float(err[i]), j, i, tuple(x[i:i + 1].cpu() for x in ct),
                      tuple(x[i:i + 1].cpu() for x in out)))
    worst.sort(key=lambda w: -w[0])
    ok, n, t0 = None, 0, time.perf_counter()
    if m0 is not None:
        ok = True
        for _, _, _, ct_i, out_i in worst:
            ref = ht.rescale(ht.matvec_bsgs(ct_i, m0.ddiags, m0.baby, m0.giant, m0.cfg,
                                            g=MATVEC_G), m0.cfg)
            n += 1
            if not _equal(out_i, ref):
                ok = False
                break
            spent = time.perf_counter() - t0
            if n >= 2 and spent * (n + 1) / n > budget_s:
                break
    return {"bitexact": ok, "bitexact_links": n, "decrypt_error": worst[0][0],
            "decrypt_error_at": list(worst[0][1:3]), "noise_ratio": ratio,
            "noise_bound": client.noise_bound(k * m.batch * m.cfg.n // 2),
            "noise_mean_square": square}


# -------------------------------------------------------------------- rows
def _row(name: str, m: Material, m0: Material | None, K: int, trials: int,
         dev: torch.device, replay_s: float, outputs: dict | None) -> dict:
    spec = _spec(name, m)
    chain = _chain(spec)
    k = links(name, K)
    nb = m.isa_flat.shape[0] if name == "isa_oplist" else m.batch
    work = nb * (HOISTED_K if name == "rotate_hoisted" else 1)
    before = _counts()
    chain(k)  # warm-up: key preparation, tables, the caching allocator
    _sync(dev)
    launches = {c: (v - before[c]) / k for c, v in _counts().items() if v != before[c]}
    k, t_hi, t_lo, out = _doubling(lambda kk: _best(lambda: chain(kk), trials, dev), k)
    row = {"unit": UNITS[name], "batch": nb, "chain": k, **_rates(work, k, t_hi, t_lo),
           "launches": launches}
    if outputs is not None:
        outputs[name] = _host(out if name in ("isa_oplist", "end_to_end") else _first(out))
    if name == "end_to_end":
        e2e = _replay_e2e(m, m0, k, replay_s)
        row.update(e2e, envelope=ENVELOPE, within_envelope=e2e["decrypt_error"] < ENVELOPE,
                   within_noise_bound=e2e["noise_ratio"] < e2e["noise_bound"],
                   request_latency_ms=t_hi / k * 1e3)
    elif m0 is None:
        row.update(bitexact=None, bitexact_links=0)
    else:
        ok, nl = _replay(spec, _spec(name, m0), k, replay_s)
        row.update(bitexact=ok, bitexact_links=nl)
    if name == "isa_oplist":
        n_ops = sum(len(isa_oplist(m.cfg, nb, j).splitlines()) for j in range(k))
        row.update(ops=n_ops, ops_per_s=n_ops / t_hi)
    if name == "matvec_bsgs":
        bg = -(-MATVEC_D // MATVEC_G)
        row["rotations_equivalent_per_s"] = nb * (MATVEC_G - 1 + bg - 1) * k / t_hi
    if dev.type != "cuda":
        row.update(device_busy=None, graph_recorded=None, graph_marginal=None,
                   graph="none: no CUDA graph on the CPU")
        return row
    kp = 1 if name in ("isa_oplist", "end_to_end") else min(k, PROFILE_LINKS)
    busy, wall = _trace_busy(lambda: chain(kp), dev)
    row.update(device_busy=busy / wall, device_busy_links=kp, device_busy_ms=busy * 1e3,
               device_busy_of_unprofiled=busy / (t_hi * kp / k))
    if name not in GRAPH_ROWS:
        row.update(graph_recorded=None, graph_marginal=None,
                   graph="eager only: the row does host work by design")
        return row
    gk, g_hi, g_lo, g_out = _doubling(lambda kk: _graph(chain, kk, trials, dev), k)
    row.update(graph_chain=gk, **_rates(work, gk, g_hi, g_lo, "graph_"),
               graph_bitexact=_equal(g_out, out if gk == k else chain(gk)))
    if name == "rotate_hoisted":
        pchain = _chain(_spec(name, m, _plain_hoisted))
        pchain(k)
        p_hi, pout = _best(lambda: pchain(k), trials, dev)
        p_lo, _ = _best(lambda: pchain(k // 2), trials, dev)
        pg_hi, pg_out = _graph(pchain, k, trials, dev)
        pg_lo, _ = _graph(pchain, k // 2, trials, dev)
        row.update({"plain_" + key: v for key, v in _rates(work, k, p_hi, p_lo).items()})
        row.update({"plain_" + key: v for key, v in _rates(work, k, pg_hi, pg_lo,
                                                          "graph_").items()})
        row["plain_graph_bitexact"] = _equal(pg_out, pout)
        per = {p: 1e6 / row[p + "marginal"] if row[p + "marginal"] else None
               for p in ("", "plain_", "graph_", "plain_graph_")}
        row.update(us_per_rotation=per[""], plain_us_per_rotation=per["plain_"],
                   graph_us_per_rotation=per["graph_"],
                   plain_graph_us_per_rotation=per["plain_graph_"])
        if per[""] and per["plain_"]:
            row["speedup_vs_plain"] = per["plain_"] / per[""]
        if per["graph_"] and per["plain_graph_"]:
            row["graph_speedup_vs_plain"] = per["plain_graph_"] / per["graph_"]
    return row


def run(cfg: HEConfig = DEFAULT_CONFIG, device="cuda", batch: int = 64, chain_k: int = 16,
        ops=None, trials: int = 4, *, keyset: dict | None = None, replay_s: float = REPLAY_S,
        outputs: dict | None = None, on_row=None) -> dict:
    """Run the rows `ops` (None: all of ROWS) on `device`: {"card", "device",
    "protocol", "null_ms", "rows": {name: row}}.  A row that raises holds
    {"error": ...}.  outputs: filled with each row's final state, batch
    element 0 (the ISA row: every ciphertext's DRAM words; the end-to-end
    row: the last request's input, output and decryptions), as arrays.
    on_row(name, row) is called as each row ends."""
    names = list(ROWS) if ops is None else list(ops)
    unknown = [x for x in names if x not in ROWS]
    if unknown:
        raise ValueError(f"unknown rows {unknown}; the rows are {', '.join(ROWS)}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the op bench on cuda needs a CUDA device (a GPU); "
                               "device='cpu' runs the plain path")
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                           else dev.index)
    m = material(cfg, dev, batch, keyset=keyset)
    m0 = m.element0(torch.device("cpu")) if dev.type == "cuda" else None
    null_s, _ = _best(lambda: None, trials, dev)
    result = {"card": bench.card() if dev.type == "cuda" else "cpu", "device": str(dev),
              "protocol": f"K-link chains, eager (host clock, synchronised) and in one CUDA "
                          f"graph, best of {trials}", "null_ms": null_s * 1e3, "rows": {}}
    for name in names:
        t0 = time.perf_counter()
        try:
            row = _row(name, m, m0, chain_k, trials, dev, replay_s, outputs)
        except Exception as e:  # the run goes on; main() exits nonzero
            row = {"error": f"{type(e).__name__}: {e}"[:300]}
        row.update(card=result["card"], seconds=time.perf_counter() - t0)
        result["rows"][name] = row
        if on_row is not None:
            on_row(name, row)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return result


def failures(result: dict) -> list:
    """Names of the rows that raised or differ from the plain path (eager,
    or the graph's words from the eager chain's), or whose decryptions lie
    beyond the noise bound."""
    return [name for name, row in result["rows"].items()
            if "error" in row or row.get("bitexact") is False
            or row.get("graph_bitexact") is False or row.get("plain_graph_bitexact") is False
            or row.get("within_noise_bound") is False]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--chain", type=int, default=16, help="K: the links of a chain (see links())")
    ap.add_argument("--ops", default=None, help="a comma subset of " + ",".join(ROWS))
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--out", default=None, help="write the whole result here as JSON")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("aloha_tpu_torch.opbench: no CUDA device; the card's rows run only on a GPU "
              "(--device cpu runs the plain path)", file=sys.stderr)
        return 1
    result = run(DEFAULT_CONFIG, args.device, args.batch, args.chain,
                 args.ops.split(",") if args.ops else None, args.trials,
                 on_row=lambda name, row: print(json.dumps({"row": name, **row}), flush=True))
    bad = failures(result)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"opbench": args.out, "card": result["card"], "null_ms": result["null_ms"],
                      "rows": len(result["rows"]), "failed": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
