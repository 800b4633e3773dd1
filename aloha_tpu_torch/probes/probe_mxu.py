"""The int8 tensor-core rate of the 4-step core on the card (the port of tools/probe_mxu.py).

    python -m aloha_tpu_torch.probes.probe_mxu

Replaces the TPU kernel of tools/probe_mxu.py:58 (`kernel` :30-49) with
`aloha_probe_mxu_rate` of `csrc/probe_mxu.cu`.  x is (8, M, 128) int8
digit planes, M = BP * 64; w is (8, 128, 128) int8.  One repetition
computes all 64 digit-pair products acc_j = sum_k x_k @ w_j (j, k = 0..7,
int32), combines s = acc_0 + sum_{j>=1} acc_j << (j mod 4) (int32,
wrapping) and makes the next x: x_0 = int8(s), x_k = int8(s >> k) with an
arithmetic shift.  The products are `wgmma.mma_async` m64n128k32 s8 with
both operands in shared memory (csrc/wgmma_s8.cuh), so the rate is the one
a `wgmma` transform can reach; an `mma.sync.m16n8k32` product loop
reached 467.8-470.9 T-MAC/s on the same products on the H100 (PERF.md).
(Adding the x_k first would give the same acc_j with an eighth of the
MACs: the kernel does not.)  The kernel reads w as
`w_image(w)`, laid out once per w: `digit_products` lays it out on every
call, `launch_rate` takes it laid out (the timed launches).

The TPU script chained K separate calls; the port repeats REPS times in
one launch (probes/common.py says why).  The marginal over REPS 8 and 48
(the script's K and 6K) at BP = 256 (M = 16384, 1.72e10 MACs per
repetition, 128 tiles of 128 rows for 132 SMs) is the time of one
repetition.

Bound on the H100: 2 MACs operations per repetition over the dense int8
peak of 1,979 TOP/s, 17.4 µs at BP = 256.  One `torch._int_mm` of X =
[x_0 ... x_7] (M, 1024) and Wcat (1024, 1024) computes the same products
(`int_mm_operands`; `measure_launch` and chip_smoke.py time it, the port
does not call it).

The plain version takes the products through `torch.matmul` in float64
(exact: every sum is below 2^24) and combines in int64 with explicit 32-
and 8-bit wrapping.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch.ops import dispatch
from aloha_tpu_torch.probes import common as C

NDIG = 8  # data and matrix digit planes
LANES = 128
ROWS_PER_BP = 64  # rows of x per polynomial of the TPU script
BP_CHECK = 32  # the script's default BP
REPS = (8, 48)
#: int8 MACs of one repetition per polynomial (per BP)
MACS = NDIG * NDIG * ROWS_PER_BP * LANES * LANES
#: INT32 instructions of one repetition per polynomial: per output word the
#: combine (7 shifts, 7 adds) and the next x (7 shifts, 8 byte placements)
OPS = ROWS_PER_BP * LANES * (7 + 7 + 7 + 8)


def data(bp: int, device, seed: int = 0):
    """(x (8, 64 bp, 128), w (8, 128, 128)) int8 drawn as tools/probe_mxu.py
    draws them (x, then w, from one generator)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(NDIG, bp * ROWS_PER_BP, LANES), dtype=np.int8)
    w = rng.integers(-128, 128, size=(NDIG, LANES, LANES), dtype=np.int8)
    return torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)


def _check(x, reps: int) -> None:
    C.check_reps(reps)
    if x.dim() != 3 or x.shape[1] < 1 or x.shape[1] % ROWS_PER_BP:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (8, M, 128) with M a positive "
                         f"multiple of {ROWS_PER_BP}")
    C.check_operand(x, torch.int8, (NDIG, x.shape[1], LANES), "x")


def accumulators_plain(x, w):
    """acc_j = sum_k x_k @ w_j as (8, M, 128) int64: float64 products, each
    of the 64 taken on its own."""
    wf = w.to(torch.float64)
    acc = sum(torch.matmul(x[k].to(torch.float64), wf) for k in range(NDIG))
    return acc.to(torch.int64)


def combine_plain(acc):
    """The next x (8, M, 128) int8 from the 8 accumulators."""
    s = acc[0] + sum(acc[j] << (j % 4) for j in range(1, NDIG))
    s = ((s + (1 << 31)) & C.M32) - (1 << 31)  # int32, wrapping
    return torch.stack([(((s >> k) + 128) & 0xFF) - 128 for k in range(NDIG)]).to(torch.int8)


def digit_products_plain(x, w, reps: int):
    """Plain PyTorch version: `reps` repetitions on x (8, M, 128) int8."""
    for _ in range(reps):
        x = combine_plain(accumulators_plain(x, w))
    return x


def w_image(w):
    """w (8, 128, 128) int8 -> the rate kernel's image of w, flat int8 on
    w's device: per j, w_j^T (row n holds column n of w_j, K-major), its
    16-byte chunk c of row n stored at chunk c ^ (n mod 8), the 128-byte
    swizzle the kernel's wgmma descriptors read (csrc/wgmma_s8.cuh)."""
    n = torch.arange(LANES, device=w.device)
    chunk = torch.arange(LANES // 16, device=w.device)[None, :] ^ (n[:, None] % 8)
    rows = w.transpose(1, 2).reshape(NDIG, LANES, LANES // 16, 16)  # j n c byte
    return rows[:, n[:, None], chunk].contiguous().reshape(-1)


def launch_rate(x, image, reps: int):
    """The rate kernel on x (8, M, 128) int8 on the card with w laid out as
    `w_image(w)`: the last x after `reps` repetitions."""
    _check(x, reps)
    C.check_operand(image, torch.int8, (NDIG * LANES * LANES,), "image")
    if not dispatch.use_kernel(x, image):
        raise ValueError("launch_rate runs the kernel: x and the image must lie on the card")
    y = torch.empty_like(x)
    err = _build.lib().aloha_probe_mxu_rate(x.device.index, x.data_ptr(), y.data_ptr(),
                                            image.data_ptr(), x.shape[1], reps,
                                            dispatch.stream_of(x))
    _build.check(err, "aloha_probe_mxu_rate")
    digit_products.launches += 1
    return y


def digit_products(x, w, reps: int):
    """`reps` repetitions of the 64 digit-pair products and the combine on
    x (8, M, 128) int8, M a multiple of 64, with w (8, 128, 128) int8: the
    last x.  CPU tensors take the plain version, CUDA tensors the kernel."""
    _check(x, reps)
    C.check_operand(w, torch.int8, (NDIG, LANES, LANES), "w")
    if not dispatch.use_kernel(x, w):
        return digit_products_plain(x, w, reps)
    return launch_rate(x, w_image(w), reps)


digit_products.launches = 0


def int_mm_operands(x, w):
    """(X, Wcat) of one `torch._int_mm` that computes the 64 products: X =
    [x_0 ... x_7] (M, 1024), Wcat (1024, 1024) with Wcat[k 128 + a, j 128 + b]
    = w_j[a, b], column-major (K contiguous, the layout int8 GEMMs take: 4.8x
    faster than row-major on the H100, PERF.md).  acc_j is in columns j 128
    .. j 128 + 127 of the product.  Laid out once, as `w_image` is."""
    M = x.shape[1]
    X = x.permute(1, 0, 2).reshape(M, NDIG * LANES).contiguous()
    Wcat = w.permute(1, 0, 2).reshape(LANES, NDIG * LANES).repeat(NDIG, 1)
    return X, Wcat.t().contiguous().t()


def measure_launch(device):
    """{"kernel": (eager ms, graph ms), "torch._int_mm": (eager ms, graph
    ms)}: one launch of one repetition at BP = C.NB_TIME with w laid out once, and
    the yardstick, one `torch._int_mm` of the same products (the port never
    calls it), each timed eagerly (`common.time_ms`) and in a CUDA-graph
    burst (`common.graph_ms`)."""
    x, w = data(C.NB_TIME, device)
    image = w_image(w)
    X, Wcat = int_mm_operands(x, w)
    fns = {"kernel": lambda: launch_rate(x, image, 1),
           "torch._int_mm": lambda: torch._int_mm(X, Wcat)}
    return {name: (C.time_ms(fn), C.graph_ms(fn)) for name, fn in fns.items()}


def measure(device):
    """(ns per polynomial per repetition, t_lo ms, t_hi ms, spread ms) of
    the kernel at BP = C.NB_TIME and REPS."""
    x, w = data(C.NB_TIME, device)
    image = w_image(w)
    return C.marginal(lambda r: launch_rate(x, image, r), REPS)


def main(argv=None):
    C.names(sys.argv[1:] if argv is None else argv, ())
    card = C.require_card()
    ns, t_lo, t_hi, spread = measure(torch.device("cuda", 0))
    per_rep_s = ns * 1e-9 * C.NB_TIME
    print(f"BP={C.NB_TIME}: marginal per repetition {per_rep_s * 1e6:.3f} us "
          f"({MACS * C.NB_TIME / per_rep_s / 1e12:.2f} T-MACs/s, {ns / 1e3:.4f} us/poly for "
          f"{NDIG * NDIG} pair-matmuls) t({REPS[0]})={t_lo:.4f} ms t({REPS[1]})={t_hi:.4f} ms "
          f"spread={spread:.4f} ms on {card}", flush=True)
    for name, (eager, graph) in measure_launch(torch.device("cuda", 0)).items():
        print(f"BP={C.NB_TIME} reps=1 {name}: eager {eager * 1e3:.2f} us, graph "
              f"{graph * 1e3:.2f} us per call on {card}", flush=True)


if __name__ == "__main__":
    main()
