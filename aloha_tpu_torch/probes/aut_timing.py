"""The automorphism (csrc/aut.cu) at the main paths' shapes, eager and in a CUDA graph.

    python -m aloha_tpu_torch.probes.aut_timing

Times `ops.aut.automorphism` under q0, e = 9, n = 8192 on the shapes the
paths launch: nb = 1 (the ISA replay's `vaut`), nb = 16 contiguous and at
row stride 2n (the multiply path's `rotate_per_transform`, which hands in
every other row of its (b, a) pairs), and nb = 64 and 256.  Each case is
held against its plain version (torch.equal), then timed eager
(`common.time_ms`: calls enqueued back to back) and in a CUDA-graph burst
(`common.graph_ms`: device time, no host between the calls), beside its
bound (the bytes in and out, chip_smoke.py's `aut_work`, over the HBM
rate).  Beside them:
- the card's launch floor: `zero_` of a one-element tensor, eager and in a
  graph burst;
- a gather yardstick on its own line: `index_select` of the same rows at
  the same source index.  It lacks the sign rule, so it is not the same
  function and no library time of the kernel;
- the wrapper's host µs per call at nb = 1 and nb = 16 at stride 2n, and
  its parts (`host_us`).
One line each, with the card; it exits 1 without CUDA.  Beyond the
wrapper's public calls it reads only the C entry's signature from the
tree, so it also times an older tree of the package put first on
PYTHONPATH.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from aloha_tpu_torch import _build
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch.ops import aut, dispatch
from aloha_tpu_torch.probes import common as C

E = 9  # 3^2: the ISA's rotation by 2, chip_smoke.py's AUT_MAIN
SEED = 15
HOST_CALLS = 2000


def cases(dev) -> list:
    """[(label, x)]: q0 words, the last row holding 0 and q; x is a view at
    row stride 2n for the strided case."""
    rng = np.random.default_rng(SEED)
    n, q = CFG.n, CFG.moduli[0]

    def rand(*shape):
        x = rng.integers(0, q, size=shape, dtype=np.uint64)
        x[-1, ..., ::3] = 0
        x[-1, ..., 1::3] = np.uint64(q)
        return cv.from_u64(x, dev)

    return [("nb=1", rand(1, n)), ("nb=16", rand(16, n)),
            ("nb=16 stride=2n", rand(16, 2, n)[:, 0, :]),
            ("nb=64", rand(64, n)), ("nb=256", rand(256, n))]


def host_us(x) -> dict:
    """Host µs per call, on the host clock, of the wrapper at x's shape and
    of its parts: the stream handle as `dispatch.stream_of` reads it and as
    a `torch.cuda.Stream` object gives it, the output's allocation, the
    rows' view (where the tree has `aut.rows`) and the C entry alone on
    contiguous rows (ctypes, cudaSetDevice, the launch)."""
    n, q = x.shape[-1], CFG.moduli[0]
    lib, xc = _build.lib(), x.contiguous()
    y = torch.empty_like(xc)
    entry = [x.device.index, xc.data_ptr(), y.data_ptr(), q, pow(E, -1, 2 * n), xc.numel() // n,
             n.bit_length() - 1]
    if len(lib.aloha_aut.argtypes) == 9:  # this tree's entry takes the rows' stride
        entry.append(n)
    stream = dispatch.stream_of(x)
    parts = {
        "wrapper": lambda: aut.automorphism(x, E, q),
        "dispatch.stream_of": lambda: dispatch.stream_of(x),
        "Stream object": lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "torch.empty": lambda: torch.empty(x.shape, dtype=torch.int64, device=x.device),
        "C entry": lambda: lib.aloha_aut(*entry, stream),
    }
    if hasattr(aut, "rows"):
        parts["aut.rows"] = lambda: aut.rows(x)
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        out[name] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
    return out


def main():
    card = C.require_card()
    dev = torch.device("cuda", 0)
    n, q = CFG.n, CFG.moduli[0]
    one = torch.zeros(1, dtype=torch.int64, device=dev)
    print(f"aut timing launch floor (zero_ of one element): eager_us="
          f"{C.time_ms(one.zero_) * 1e3:.2f} graph_us={C.graph_ms(one.zero_) * 1e3:.2f} on {card}",
          flush=True)
    src = torch.from_numpy((np.arange(n) * pow(E, -1, 2 * n)) % (2 * n) % n).to(dev)
    for label, x in cases(dev):
        run = lambda: aut.automorphism(x, E, q)  # noqa: E731
        if not torch.equal(run(), aut.automorphism_plain(x, E, q)):
            raise SystemExit(f"aut {label}: kernel differs from plain")
        bound_us = 2 * x.numel() * 8 / C.HBM_BYTES_PER_S * 1e6
        print(f"aut timing q0 e={E} {label}: eager_us={C.time_ms(run) * 1e3:.2f} "
              f"graph_us={C.graph_ms(run) * 1e3:.2f} bound_us={bound_us:.2f} (bytes) on {card}",
              flush=True)
        gather = lambda: x.index_select(-1, src)  # noqa: E731
        print(f"aut timing gather yardstick index_select {label}: eager_us="
              f"{C.time_ms(gather) * 1e3:.2f} graph_us={C.graph_ms(gather) * 1e3:.2f} on {card}",
              flush=True)
    for label, x in cases(dev):
        if label not in ("nb=1", "nb=16 stride=2n"):
            continue
        parts = ", ".join(f"{k} {v:.2f}" for k, v in host_us(x).items())
        print(f"aut timing host us per call {label}: {parts} on {card}", flush=True)


if __name__ == "__main__":
    main()
