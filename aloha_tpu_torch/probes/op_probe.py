"""Marginal cost of the NTT's building blocks on the card (the port of tools/op_probe.py).

    python -m aloha_tpu_torch.probes.op_probe [v0 v1 ...]

Replaces the TPU kernel of tools/op_probe.py:263 (`make(fn, reps)` ->
`body`) with `csrc/probe_ops.cu`: REPS data-dependent repetitions of one of
15 building blocks on nb resident polynomials under q0, at REPS 50 and 450
as the TPU script, nb = 256.  Each variant runs the u64 operation it
stands for (the table in csrc/probe_ops.cu); v2, v4 and v10 - v14 measured
the TPU's u32 plane split, which the port drops, and keep their names.

The kernel holds each polynomial in `csrc/ntt.cu`'s register owner map of
forward pass 1, 16 words a thread, loaded once and stored once; a
repetition is the step on a thread's words in registers, as in a stage of
`ntt.cu`.  Only v6 (the roll) goes through shared memory, as one of
`ntt.cu`'s exchanges.  So the differences of the variants split the cost
of a register-resident stage: v1 - v7 the Shoup product, v14 a CT stage
with its twiddles, v0 - v14 a stage distance known only at run time, v6
an exchange.

Each variant is timed at nb = 256 (the marginal) and in one call at nb,
reps = common.SMALL (chip_smoke.py's timed case) eager and in a CUDA-graph
burst (`common.measure_small`).  Beyond the wrapper, `main` reads only
`common`, the plain helpers and the C entry from the package, so run as a
file (`python aloha_tpu_torch/probes/op_probe.py`) with an older tree
first on PYTHONPATH it times that tree's kernel against this file's OPS;
a tree whose `probes/common.py` lacks `measure_small` takes this tree's
copy of that file.

Bound on the H100: integer issue, `OPS[v]` INT32 instructions per
polynomial per repetition over the card's integer issue rate; nothing
moves over HBM per repetition.
"""

from __future__ import annotations

import sys

import torch

from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.probes import common as C

VARIANTS = tuple(f"v{k}" for k in range(15))
REPS = (50, 450)
_STAGES = ("v0", "v13", "v14")  # one CT stage at distance 32
# a CT butterfly on two registers of one thread with its twiddle in
# registers: no pair or twiddle index
_CT_REGS = C.CT_BUTTERFLY - C.INDEX
# v12's t*q as shift-adds: q0's three set bits above bit 0 (csrc/probe_ops.cu)
_Q0_SHIFTS = (32, 36, 59)
# shifts by 32 and more touch only the high word; a shift and an add fuse
_SPARSE_MUL = 3

#: INT32 instructions of one repetition on one polynomial (see common.ADD64)
OPS = {
    "v0": C.N // 2 * _CT_REGS,
    "v1": C.N * C.SHOUP,
    "v2": C.N * C.MULHI64,
    "v3": C.N * C.MUL64LO,
    "v4": C.N * 2,  # one 32x32 -> 64-bit product
    "v5": C.N * 2,  # one 32-bit product, one 32-bit add
    "v6": C.N * 4,  # the source index: and, sub, and, or
    "v7": C.N * C.CONDSUB,
    "v8": C.N * C.ADD64,  # the swap is a register renaming
    "v9": C.N * (2 + C.ADD64),  # lane bit test, 64-bit select
    "v10": C.N * C.MULHI64,
    "v11": C.N * C.SHOUP,
    "v12": C.N * (C.SHOUP - C.MUL64LO + _SPARSE_MUL),
    "v13": C.N // 2 * (_CT_REGS - C.MUL64LO + _SPARSE_MUL),
    "v14": C.N // 2 * _CT_REGS,
}

#: bytes of the tables one launch reads: row 5 of w and wshoup where the
#: step takes both, of one where it takes one (v2, v10: wshoup; v3: w)
TABLE_BYTES = {v: C.table_bytes((5,), 2 if v in _STAGES + ("v1", "v11", "v12") else
                                1 if v in ("v2", "v3", "v10") else 0) for v in VARIANTS}


def _stage_plain(x, sparse: bool):
    """One Harvey CT stage on the pairs (i, i + 32), twiddles of row 5."""
    w, ws = C.twiddle_row(5, x.device)
    u, v = C.pairs(x, 5)
    tw, tws = C.pairs(w[None], 5)[0], C.pairs(ws[None], 5)[0]
    up = rt.plain.lazy_reduce(u, 2 * C.Q)
    y = _sparse_shoup(v, tw, tws) if sparse else rt.plain.mulmod_shoup(v, tw, tws, C.Q)
    return C.join(up + y, up + 2 * C.Q - y)


def _sparse_shoup(x, w, ws):
    t = rt.mul_hi64(x, ws)
    tq = t
    for s in _Q0_SHIFTS:
        tq = tq + (t << s)
    return rt.mul_lo64(x, w) - tq


def _step_plain(x, variant: str):
    if variant in _STAGES:
        return _stage_plain(x, sparse=variant == "v13")
    w, ws = C.twiddle_row(5, x.device)
    if variant in ("v1", "v11"):
        return rt.plain.mulmod_shoup(x, w, ws, C.Q)
    if variant in ("v2", "v10"):
        return rt.mul_hi64(x, ws)
    if variant == "v3":
        return rt.mul_lo64(x, w)
    lo, hi = x & C.M32, (x >> 32) & C.M32
    if variant == "v4":
        return rt.mul_lo64(lo, hi)
    if variant == "v5":
        return (((hi + lo) & C.M32) << 32) | (rt.mul_lo64(lo, hi) & C.M32)
    if variant == "v6":
        return x.reshape(-1, C.N // 128, 128).roll(32, dims=-1).reshape(x.shape)
    if variant == "v7":
        return rt.plain.lazy_reduce(x, 4 * C.Q)
    if variant == "v8":
        return x + C.swap32(x)
    if variant == "v9":
        lane32 = (torch.arange(C.N, device=x.device) & 32) != 0
        return torch.where(lane32, x, C.swap32(x))
    if variant == "v12":
        return _sparse_shoup(x, w, ws)
    raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")


def probe_ops_plain(x, variant: str, reps: int):
    """Plain PyTorch version: `reps` repetitions of the variant's step on
    x (nb, N) int64 under q0."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")
    for _ in range(reps):
        x = _step_plain(x, variant)
    return x


def probe_ops(x, variant: str, reps: int):
    """`reps` repetitions of the variant's step on x (nb, N) int64 under
    q0.  CPU tensors take the plain version, CUDA tensors the kernel."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")
    C.check_reps(reps)
    if not dispatch.use_kernel(x):
        return probe_ops_plain(x, variant, reps)
    y = C.launch("aloha_probe_ops", x, VARIANTS.index(variant), x.shape[0], reps)
    probe_ops.launches += 1
    return y


probe_ops.launches = 0


def measure(variants, device):
    """[(variant, ns per polynomial per repetition, t_lo ms, t_hi ms)] of
    the kernel on C.NB_TIME resident polynomials at REPS."""
    x = C.resident_data(C.NB_TIME, device)
    return [(v, *C.marginal_ns(lambda r: probe_ops(x, v, r), REPS)) for v in variants]


def main(argv=None):
    chosen = C.names(sys.argv[1:] if argv is None else argv, VARIANTS)
    card = C.require_card()
    dev = torch.device("cuda", 0)
    for v, ns, t_lo, t_hi in measure(chosen, dev):
        print(f"{v}: {ns:.3f} ns/poly/rep (x13 = {ns * 13 / 1e3:.4f} us) "
              f"t({REPS[0]})={t_lo:.4f} ms t({REPS[1]})={t_hi:.4f} ms nb={C.NB_TIME} "
              f"ops/poly/rep={OPS[v]} on {card}", flush=True)
    for v, eager_ms, graph_ms in C.measure_small(probe_ops, chosen, dev):
        print(f"{v} nb={C.SMALL[0]} reps={C.SMALL[1]}: eager {eager_ms * 1e3:.2f} us, "
              f"graph {graph_ms * 1e3:.2f} us per call on {card}", flush=True)


if __name__ == "__main__":
    main()
