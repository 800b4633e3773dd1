"""Dry run of the coefficient-sharded NTT on several devices.

    torchrun --nproc-per-node D -m aloha_tpu_torch.parallel.dryrun [--device cpu]

The port of the NTT blocks of the JAX package's multi-chip dry run
(__graft_entry__.py:163-184, :242-271).  Each rank takes its block of a
seeded batch of N=8192 polynomials (rows over the `dp` axis, coefficients
over the `coeff` axis of `multihost.pod_mesh`), runs `ntt_sharded` and
`intt_sharded`, and checks that its block of the forward transform equals
the NumPy oracle `ntt_np.ntt` and that the round trip gives its input back.
It prints one line per check with the D it ran at and exits nonzero when a
check fails.  Ranks run on `cuda:LOCAL_RANK` with NCCL by default, on the
CPU with gloo under `--device cpu`.  Without torchrun it runs as a world of
one (D = 1).  `spawn` starts the ranks of a local job from
`torch.multiprocessing`, as torchrun would.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import ntt_np
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch.ops import ntt_stream
from aloha_tpu_torch.parallel import multihost
from aloha_tpu_torch.parallel.ntt_sharded import intt_sharded, ntt_sharded

SEED = 2  # of the seeded batch every rank draws in full and takes its block of


def roots(n: int):
    """(q0, psi, psi^-1) of a ring of n <= N coefficients: psi^(N/n) is a
    primitive 2n-th root when psi is one of order 2N."""
    q, k = CFG.moduli[0], CFG.n // n
    return q, pow(CFG.psi[0], k, q), pow(CFG.ipsi[0], k, q)


def run(device: torch.device, n: int = CFG.n, batch: int = 4, dp: int = 1,
        check_rows: int | None = None) -> dict:
    """One rank's part of the dry run in an initialised process group.

    Returns the rank's layout, its blocks (x, forward y, round trip back)
    as uint64 arrays, the checks (forward against `ntt_np.ntt` on the
    first `check_rows` rows of the block, None: all; round trip on all)
    and the launches of `transform_with_tables` it made."""
    mesh = multihost.pod_mesh(("dp", "coeff"), dp, device.type)
    group = mesh.get_group("coeff")
    D, d, i = mesh.size(1), mesh.get_local_rank("coeff"), mesh.get_local_rank("dp")
    if batch % dp or n % D:
        raise ValueError(f"batch {batch} over dp={dp}, ring {n} over D={D}: not divisible")
    q, psi, ipsi = roots(n)
    nbl, C = batch // dp, n // D
    rows, cols = slice(i * nbl, (i + 1) * nbl), slice(d * C, (d + 1) * C)
    x = np.random.default_rng(SEED).integers(0, q, size=(batch, n), dtype=np.uint64)
    block = cv.from_u64(x[rows, cols], device)
    before = ntt_stream.transform_with_tables.launches
    y = ntt_sharded(block, q, psi, group)
    back = intt_sharded(y, q, ipsi, group)
    y, back = cv.to_u64(y), cv.to_u64(back)
    k = nbl if check_rows is None else min(check_rows, nbl)
    return {
        "D": D, "d": d, "dp": dp, "dp_index": i, "n": n, "rows": (rows.start, rows.stop),
        "cols": (cols.start, cols.stop), "x": x[rows, cols], "y": y, "back": back,
        "forward_ok": bool(np.array_equal(y[:k], ntt_np.ntt(x[rows][:k], q, psi)[:, cols])),
        "checked_rows": k,
        "roundtrip_ok": bool(np.array_equal(back, x[rows, cols])),
        "launches": ntt_stream.transform_with_tables.launches - before,
    }


def init_world_of_one(device: torch.device) -> None:
    """A process group of one rank on `device`, from an in-memory store (no
    rendezvous)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        multihost.backend_for(device.type), store=dist.HashStore(), rank=0,
        world_size=1, timeout=multihost.TIMEOUT,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=CFG.n, help="ring degree (<= 8192)")
    ap.add_argument("--batch", type=int, default=4, help="polynomials in the batch")
    ap.add_argument("--dp", type=int, default=1, help="size of the batch-parallel axis")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="directory for each rank's blocks (rank<r>.npz)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device (pass --device cpu for gloo CPU ranks)", file=sys.stderr)
        return 1
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device("cuda", local) if args.device == "cuda" else torch.device("cpu")
    multihost.initialize(args.device)
    if not dist.is_initialized():
        init_world_of_one(device)
    try:
        res = run(device, args.n, args.batch, args.dp)
        rank, world = dist.get_rank(), dist.get_world_size()
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            np.savez(args.out / f"rank{rank}.npz", **res)
        tag = (f"dryrun rank {rank}/{world}: D={res['D']} dp={res['dp']} n={res['n']} "
               f"rows {res['rows']} cols {res['cols']} on {device}")
        print(f"{tag}: forward equals ntt_np.ntt: {res['forward_ok']}", flush=True)
        print(f"{tag}: round trip exact: {res['roundtrip_ok']}", flush=True)
        return 0 if res["forward_ok"] and res["roundtrip_ok"] else 1
    finally:
        dist.destroy_process_group()


def _rank(local_rank: int, world: int, port: int, argv) -> None:
    """One rank of `spawn`: torchrun's environment for a single-host job on
    127.0.0.1:port, then `main(argv)`; SystemExit with its code on failure."""
    os.environ.update(
        RANK=str(local_rank), LOCAL_RANK=str(local_rank), WORLD_SIZE=str(world),
        LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
    )
    code = main(list(argv))
    if code:
        raise SystemExit(code)


def spawn(world: int, argv, timeout_s: float) -> None:
    """Run `main(argv)` on `world` local ranks started by
    `torch.multiprocessing` at a free port.  Raises when a rank fails or
    when the ranks have not finished within timeout_s, and kills every
    rank still running."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(_rank, args=(world, port, list(argv)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks did not finish in {timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()


if __name__ == "__main__":
    sys.exit(main())
