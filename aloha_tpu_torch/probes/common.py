"""Resident test data, tables, 64-bit helpers and the marginal-timing protocol.

A probe launches one CTA per polynomial (or block of rows) with its words
in shared memory for the whole launch, and repeats a step REPS times on
them.  Two are exceptions that hold the words in registers: the
building-block probe (`op_probe`), in `csrc/ntt.cu`'s owner map of forward
pass 1 (16 words a thread, 512 threads a polynomial; only its roll, v6,
goes through shared memory), and the lane-stage probe (`stream_prof2`),
where 16 lanes of a warp hold each 128-word group and trade words by
shuffles.  Where a TPU script chained K separate calls, the port repeats inside
one launch instead: a call of this port's wrappers costs 20-100 µs of host
time (the Python checks, `torch.empty_like`, `dispatch.stream_of`, ctypes
and the launch; PERF.md §6-7), so a chain of launches of a few µs of device
work each would time the host.  Its cost per repetition is a marginal:
t(REPS_hi) and t(REPS_lo) are each the least, over ITERS tries, of the mean
time of BURST launches enqueued back to back between two CUDA events, and
(t_hi - t_lo) / ((REPS_hi - REPS_lo) NB_TIME) is the time per polynomial
per repetition.  The launch's own cost and the loads and stores are the
same at both REPS and drop out of the difference; the burst keeps the
host's enqueue gap out of the events (a single launch between two events
counts it, and its spread swamped the difference of the cheapest probes).
A copy pipeline has no repetition to difference: its marginal is over the
batch instead (`batch_marginal`, t(nb_hi) - t(nb_lo) over nb_hi - nb_lo),
which cancels the launch's cost the same way.

The plain versions' 64-bit products go through `rns_torch`'s 30-bit limbs
(`mul_lo64`, `mul_hi64`, `plain.mulmod_shoup`, whose operands stay below 4q
here); a conditional subtract is `rns_torch.plain.lazy_reduce` (aten code
on the card, not `csrc/rns.cu`); adds, subtracts
and shifts wrap mod 2^64 as the kernels' u64 arithmetic does.
"""

from __future__ import annotations

import functools
import subprocess
import sys

import numpy as np
import torch

from aloha_tpu_torch import _build, ntt_torch
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch.ops import dispatch

N, LOGN = CFG.n, CFG.logn
#: the TPU scripts' modulus and root (CFG.moduli[0], CFG.psi[0])
Q, PSI = CFG.moduli[0], CFG.psi[0]
#: polynomials of the timed launches: the batch of PERF.md's row 1 (the bench's)
NB_TIME = 256
SMALL = (8, 3)  # nb, reps of one timed call (chip_smoke.py times every probe at it)
ITERS = 5
BURST = 4
GRAPH_CALLS = 16  # calls captured in one graph by `graph_ms`
M32 = 0xFFFFFFFF
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3 (the copy pipelines' bound)

# INT32 instructions of the kernels' arithmetic, counted from the code as
# chip_smoke.py's CT_OPS are: a 64-bit add, subtract, compare or select is 2,
# a 64-bit shift 2, a 64x64-bit low product 4, __umul64hi 8.
ADD64 = 2
MUL64LO = 4
MULHI64 = 8
SHOUP = MULHI64 + 2 * MUL64LO + ADD64  # t = hi(x ws); x w - t q
CONDSUB = 3 * ADD64
INDEX = 6  # a butterfly's pair and twiddle index from the loop counter
CT_BUTTERFLY = CONDSUB + SHOUP + ADD64 + 2 * ADD64 + INDEX  # = chip_smoke's CT_OPS


def resident_data(nb: int, device, seed: int = 0) -> torch.Tensor:
    """(nb, N) int64 words hi << 32 | lo with lo < 2^31, hi < 2^27: the
    TPU scripts' random planes, every word below 2^59 < q0."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 31, size=(nb, N), dtype=np.uint64)
    hi = rng.integers(0, 1 << 27, size=(nb, N), dtype=np.uint64)
    return torch.from_numpy((lo | (hi << np.uint64(32))).view(np.int64)).to(device)


def tables(device):
    """(w, ws) int64 (N,): q0's compact forward tables, psi^bitrev(i) and
    floor(w 2^64 / q) from the port's ntt_np (ntt_torch.tables)."""
    w, ws, _ = ntt_torch.tables(N, (Q,), (PSI,), torch.device(device))
    return w[0], ws[0]


@functools.lru_cache(maxsize=64)
def twiddle_row(s: int, device):
    """Row s of the per-element forward tables: element i takes
    w[2^s + (i >> (LOGN - s))] (the TPU's ntt_pallas._tables_np row s)."""
    w, ws = tables(device)
    idx = (1 << s) + (torch.arange(N, device=w.device) >> (LOGN - s))
    return w[idx], ws[idx]


def table_bytes(rows, tables: int = 2) -> int:
    """Bytes of `tables` of the compact (w, wshoup) tables a launch reads at
    the given twiddle rows: row s holds the 2^s entries w[2^s .. 2^(s+1) - 1]
    (`twiddle_row`)."""
    return tables * 8 * sum(1 << s for s in set(rows))


def check_reps(reps: int, name: str = "reps") -> None:
    if not 0 <= reps < 1 << 31:
        raise ValueError(f"{name} = {reps}: a count in [0, 2^31) required")


def check_operand(t: torch.Tensor, dtype, shape, name: str) -> None:
    """Raise ValueError unless t has the dtype and shape and is contiguous."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(entry: str, x: torch.Tensor, *ints: int) -> torch.Tensor:
    """One launch of the C entry `entry(device, x, y, w, ws, q, *ints,
    stream)` on x (nb, N) int64 with q0's tables: the new (nb, N) y."""
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (nb >= 1, {N})")
    dispatch.check(x, (x.shape[0], N), "x")
    w, ws = tables(x.device)
    y = torch.empty_like(x)
    err = getattr(_build.lib(), entry)(
        x.device.index, x.data_ptr(), y.data_ptr(), w.data_ptr(), ws.data_ptr(), Q, *ints,
        dispatch.stream_of(x),
    )
    _build.check(err, entry)
    return y


# ------------------------------------------------- plain 64-bit helpers
def swap32(x):
    """The two 32-bit halves exchanged."""
    return ((x >> 32) & M32) | (x << 32)


def add32x2(a, b):
    """The 32-bit halves of a and b added separately, each mod 2^32."""
    lo = ((a & M32) + (b & M32)) & M32
    hi = (((a >> 32) & M32) + ((b >> 32) & M32)) & M32
    return lo | (hi << 32)


def pairs(x, sh: int):
    """x (nb, N) as (u, v) views of the pairs (i, i + 2^sh), bit sh of i clear."""
    v = x.reshape(x.shape[0], N >> (sh + 1), 2, 1 << sh)
    return v[:, :, 0], v[:, :, 1]


def join(top, bottom):
    """The inverse of `pairs`: (nb, N) from the two halves of every pair."""
    return torch.stack([top, bottom], dim=2).reshape(top.shape[0], N)


# --------------------------------------------------------------- timing
def bursts_ms(fn) -> list:
    """The ITERS tries of one call of fn, each the mean of BURST calls
    enqueued back to back between two CUDA events, after one warm-up call."""
    fn()
    tries = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BURST):
            fn()
        end.record()
        end.synchronize()
        tries.append(start.elapsed_time(end) / BURST)
    return tries


def time_ms(fn) -> float:
    """The time of one call of fn: the least of `bursts_ms`."""
    return min(bursts_ms(fn))


def graph_ms(fn) -> float:
    """Mean time of one call of fn in a burst of GRAPH_CALLS captured in one
    CUDA graph and replayed (no host enqueue between them): the least of
    ITERS replays.  Beside `time_ms` of the same calls, the difference is
    the host's share of a call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / GRAPH_CALLS)
    return best


def measure_small(run, names, device) -> list:
    """[(name, eager ms, graph ms)] of one call run(x, name, reps) a name
    on x = SMALL[0] resident polynomials, reps = SMALL[1]: `time_ms` and
    `graph_ms` of the same call."""
    x = resident_data(SMALL[0], device)
    rows = []
    for name in names:
        call = lambda name=name: run(x, name, SMALL[1])  # noqa: E731
        rows.append((name, time_ms(call), graph_ms(call)))
    return rows


def _two_points(run, points: tuple, units: int):
    """(ns per unit, t_lo ms, t_hi ms, spread ms) of run(p) at p = points[0]
    and points[1], `units` units per step of p; the spread is the larger of
    the two tries' ranges (most - least), the noise the difference t_hi -
    t_lo has to exceed."""
    lo, hi = points
    b_lo, b_hi = bursts_ms(lambda: run(lo)), bursts_ms(lambda: run(hi))
    t_lo, t_hi = min(b_lo), min(b_hi)
    spread = max(max(b_lo) - t_lo, max(b_hi) - t_hi)
    return (t_hi - t_lo) * 1e6 / ((hi - lo) * units), t_lo, t_hi, spread


def marginal(run, reps: tuple):
    """(ns per polynomial per repetition, t_lo ms, t_hi ms, spread ms) of
    run(r), one launch of r repetitions on NB_TIME polynomials, at r =
    reps[0] and reps[1]."""
    return _two_points(run, reps, NB_TIME)


def batch_marginal(run, nbs: tuple):
    """(ns per block or polynomial, t_lo ms, t_hi ms, spread ms) of run(nb),
    one launch on nb blocks (or polynomials), at nb = nbs[0] and nbs[1]:
    the marginal over the batch, for a step with no repetition to difference
    (a copy pipeline).  The launch's own cost drops out as in `marginal`."""
    return _two_points(run, nbs, 1)


def marginal_ns(run, reps: tuple):
    """`marginal` without the spread."""
    return marginal(run, reps)[:3]


def small_call(name: str, run, plain, args, card: str) -> None:
    """Hold run(*args, SMALL[1]) equal to plain(*args, SMALL[1]) (exit on
    a difference), then print the call's `time_ms` and `graph_ms`, and its
    `graph_ms` at 0 repetitions (the launch's fixed part)."""
    if not torch.equal(run(*args, SMALL[1]), plain(*args, SMALL[1])):
        raise SystemExit(f"{name}: the kernel differs from its plain version")
    call = lambda: run(*args, SMALL[1])  # noqa: E731
    eager, graph, fixed = time_ms(call), graph_ms(call), graph_ms(lambda: run(*args, 0))
    print(f"nb={args[0].shape[0]} reps={SMALL[1]}: eager {eager * 1e3:.2f} us, graph "
          f"{graph * 1e3:.2f} us per call (reps=0: graph {fixed * 1e3:.2f} us) on {card}",
          flush=True)


def print_marginal(m, reps: tuple, what: str, bounds: dict, card: str) -> None:
    """Print `marginal`'s m (ns, t_lo, t_hi, spread) at NB_TIME and REPS
    `reps`, beside `bounds` (ns by name; the first is the bound)."""
    ns, t_lo, t_hi, spread = m
    print(f"nb={NB_TIME}: {ns:.3f} ns per block per repetition ({what}) "
          f"t({reps[0]})={t_lo:.4f} ms t({reps[1]})={t_hi:.4f} ms spread={spread:.4f} ms "
          f"bound_ns={next(iter(bounds.values())):.3f} ("
          + ", ".join(f"{k} {v:.3f}" for k, v in bounds.items()) + f") on {card}", flush=True)


def card() -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit` gives it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def int32_peak() -> float:
    """The integer issue peak, INT32 instructions per second: 132 SMs x 128
    lanes x the card's clocks.max.sm (chip_smoke.py's INT32 peak)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return 132 * 128 * float(smi.stdout.strip().splitlines()[0]) * 1e6


def require_card() -> str:
    """The card's name and power limit; exits 1 without CUDA (the probes
    measure the card and have no CPU fallback)."""
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU: the probes measure the card and have no CPU fallback",
              file=sys.stderr)
        raise SystemExit(1)
    return card()


def names(argv, choices) -> list:
    """The variants or modes named on the command line (all when none)."""
    chosen = list(argv) or list(choices)
    unknown = [c for c in chosen if c not in choices]
    if unknown:
        raise SystemExit(f"unknown {unknown}; choose from {list(choices)}")
    return chosen
