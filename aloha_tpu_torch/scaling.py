"""Scaling bench of the coefficient-sharded rotation, and its collective census.

    python -m aloha_tpu_torch.scaling [--batch-per-device 8] [--iters 10] [--step 2]
        [--device cuda|cpu] [--n 8192] [--census] [--dp 0] [--out DIR]
    torchrun --nproc-per-node R -m aloha_tpu_torch.scaling ...

The port of tools/bench_scaling.py and of tools/scaling_report.py sections
1-4.  Every process of the job lays the world out as the (dp, coeff) mesh
of `multihost.pod_mesh` (--dp 0: one dp group per host) and rotates its
block of a batch of B = batch-per-device x dp ciphertexts (rows over dp,
coefficients over coeff) with `parallel.coeff_sharded.rotate`, drawn as
bench_scaling.py:67-77 draws them (default_rng(0), words below q0, the
default moduli scaled to the ring --n).

Rate: the best of 3 trials of --iters chained rotations, the device
synchronised at the end, as B / seconds a rotation.  Each process prints
one JSON line with the reference's keys (`metric` rotate_throughput,
`devices` = the world, `hosts`, `value`, `per_device`, `unit`), and `dp`,
`coeff`, `rank`, the fused single-card yardstick `fused_value` (rank 0:
`he_torch.rotate`, the ks_head/ks_tail pair, on the whole batch on its
device, timed the same way; null elsewhere), `exact` and the kernel
launches of the run; on CUDA also `card`, the card's name and power limit
as `nvidia-smi` gives them.  Every rank checks its block of the warm-up
output word for word against the plain `he_torch.rotate` of its rows on
CPU tensors; a difference exits nonzero.

Census (--census), counted at the collectives' call sites
(`multihost.collectives`), each held to its formula, else exit nonzero:
one `ntt_sharded` of the rank's rows (log2(D) exchanges of nb C 8 bytes,
D the coeff axis); one `keyswitch_sharded.rotate_sharded` on a (world/L,
L) digit mesh (one all_reduce of 2(L+1) nb n 8 bytes; not run where L does
not divide the world); one coefficient-sharded rotation ((3L+2) log2(D)
exchanges of (L^2+6L+2) nb C 8 log2(D) bytes in all, and one all-to-all
of 2L nb C 8 bytes).  Each rank prints its block shapes and its
own seconds of that rotation: the balance section.

Without torchrun it runs as a world of one; `spawned` runs it on local
ranks through `dryrun.spawn` (the 1- and 2-process runs of the same
program, scaling_report.py section 4).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch.bench import card
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch.ops import ks_kernel, ntt_stream
from aloha_tpu_torch.parallel import coeff_sharded, dryrun, multihost
from aloha_tpu_torch.parallel.keyswitch_sharded import rotate_sharded
from aloha_tpu_torch.parallel.ntt_sharded import ntt_sharded

TRIALS = 3
SEED = 0  # bench_scaling.py:65

#: the wrappers whose launches a run reports (rows 3-5 of the kernel table)
WRAPPERS = {"ntt_with_tables": ntt_stream.transform_with_tables,
            "ks_head": ks_kernel.ks_head, "ks_tail": ks_kernel.ks_tail}


def inputs(cfg, batch: int):
    """(a, b, ksk) of the bench, uint64 (batch, L, n), (batch, L, n),
    (2L(L+1), n), words below q0, drawn in bench_scaling.py's order."""
    rng = np.random.default_rng(SEED)
    L, n, q0 = cfg.n_limbs, cfg.n, cfg.moduli[0]
    a = rng.integers(0, q0, size=(batch, L, n), dtype=np.uint64)
    b = rng.integers(0, q0, size=(batch, L, n), dtype=np.uint64)
    return a, b, rng.integers(0, q0, size=(2 * L * (L + 1), n), dtype=np.uint64)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_rate(step, x0, iters: int, batch: int, device: torch.device,
              line_up=dist.barrier) -> float:
    """The best of TRIALS rates batch / seconds a step over `iters` chained
    steps from x0, the ranks lined up by `line_up` before each trial and
    the device synchronised at its end."""
    best = 0.0
    for _ in range(TRIALS):
        x = x0
        line_up()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            x = step(x)
        _sync(device)
        best = max(best, batch * iters / (time.perf_counter() - t0))
    return best


def _held(counted: dict, calls: dict, nbytes: dict | None = None) -> dict:
    """A census entry: what was counted beside the formula's calls (and
    bytes, where the formula fixes them), and whether they agree."""
    ok = ({k: v[0] for k, v in counted.items()} == calls
          and (nbytes is None or {k: v[1] for k, v in counted.items()} == nbytes))
    return {"counted": {k: list(v) for k, v in counted.items()}, "calls": calls,
            "bytes": nbytes, "ok": ok}


def census(device, cfg, block, key, rows_np, ksk_np, step: int, coeff_group) -> dict:
    """The collectives of one sharded NTT, one digit-sharded rotation and
    one coefficient-sharded rotation of this rank's block, each held to its
    formula; the block shapes and the seconds of the rotation."""
    L, n = cfg.n_limbs, cfg.n
    nb, C = block[0].shape[0], block[0].shape[-1]
    logD = (n // C).bit_length() - 1
    world = dist.get_world_size()
    res = {}
    with multihost.collectives() as got:
        ntt_sharded(block[0][:, 0].contiguous(), cfg.moduli[0], cfg.psi[0], coeff_group)
    res["ntt_sharded"] = (_held(got, {"exchange": logD}, {"exchange": logD * nb * C * 8})
                          if logD else _held(got, {}, {}))
    if world % L == 0:
        mesh = multihost.pod_mesh(("dp", "digit"), world // L, device.type)
        j = mesh.get_local_rank("digit")
        limb = tuple(cv.from_u64(x[:, j:j + 1], device) for x in rows_np)
        with multihost.collectives() as got:
            rotate_sharded(limb, step, cv.from_u64(ksk_np, device), cfg, mesh.get_group("digit"))
        res["rotate_sharded"] = _held(got, {"all_reduce": 1},
                                      {"all_reduce": 2 * (L + 1) * nb * n * 8})
    else:
        res["rotate_sharded"] = {"counted": None, "ok": None,
                                 "note": f"not run: a digit group takes L = {L} ranks, "
                                         f"the world has {world}"}
    with multihost.collectives() as got:
        _sync(device)
        t0 = time.perf_counter()
        coeff_sharded.rotate(block, step, key, cfg, coeff_group)
        _sync(device)
        seconds = time.perf_counter() - t0
    # the 3L + 2 transforms exchange blocks of L (2 nb) + L (L + 1) nb + L nb
    # + 2 nb + L (2 nb) rows in all; the all-to-all moves the 2L nb rows once
    calls, nbytes = {"all_to_all": 1}, {"all_to_all": 2 * L * nb * C * 8}
    if logD:
        calls["exchange"] = (3 * L + 2) * logD
        nbytes["exchange"] = (L * L + 6 * L + 2) * nb * C * 8 * logD
    res["coeff_sharded.rotate"] = _held(got, calls, nbytes)
    res["balance"] = {"a_block": list(block[0].shape), "key_block": list(key.shape),
                      "seconds": seconds}
    return res


def run(device: torch.device, n: int = CFG.n, batch_per_device: int = 8, iters: int = 10,
        step: int = 2, dp: int = 0, with_census: bool = False) -> dict:
    """One process's part of the bench in an initialised process group: its
    JSON record (see the module's docstring)."""
    before = {k: w.launches for k, w in WRAPPERS.items()}
    mesh = multihost.pod_mesh(("dp", "coeff"), dp, device.type)
    dp, D = mesh.size(0), mesh.size(1)
    i, d = mesh.get_local_rank("dp"), mesh.get_local_rank("coeff")
    rank, world = dist.get_rank(), dist.get_world_size()
    group = mesh.get_group("coeff")
    cfg = dryrun.ring(n)
    B = batch_per_device * dp
    a, b, ksk = inputs(cfg, B)
    C = n // D
    rows = slice(i * batch_per_device, (i + 1) * batch_per_device)
    cols = slice(d * C, (d + 1) * C)
    block = (cv.from_u64(a[rows, :, cols], device), cv.from_u64(b[rows, :, cols], device))
    key = cv.from_u64(ksk[:, cols], device)

    def sharded(x):
        return coeff_sharded.rotate(x, step, key, cfg, group)

    warm = sharded(block)
    cpu = torch.device("cpu")
    want = ht.rotate((cv.from_u64(a[rows], cpu), cv.from_u64(b[rows], cpu)), step,
                     cv.from_u64(ksk, cpu), cfg)
    exact = all(np.array_equal(cv.to_u64(g), cv.to_u64(w)[..., cols]) for g, w in zip(warm, want))
    rate = best_rate(sharded, block, iters, B, device)

    fused = None
    if rank == 0:
        whole = (cv.from_u64(a, device), cv.from_u64(b, device))
        whole_key = cv.from_u64(ksk, device)

        def fused_step(x):
            return ht.rotate(x, step, whole_key, cfg)

        fused_step(whole)
        fused = best_rate(fused_step, whole, iters, B, device, line_up=lambda: None)
    dist.barrier()

    rec = {"metric": "rotate_throughput", "devices": world,
           "hosts": max(1, world // int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))),
           "value": rate, "per_device": rate / world, "unit": "rotations/s",
           "dp": dp, "coeff": D, "rank": rank, "n": n, "batch": B, "fused_value": fused,
           "exact": exact}
    if device.type == "cuda":
        rec["card"] = card()
    if with_census:
        rec["census"] = census(device, cfg, block, key, (a[rows], b[rows]), ksk, step, group)
    rec["launches"] = {k: w.launches - before[k] for k, w in WRAPPERS.items()}
    return rec


def _print_census(rank: int, world: int, res: dict) -> None:
    for name in ("ntt_sharded", "rotate_sharded", "coeff_sharded.rotate"):
        c = res[name]
        detail = c.get("note") or (f"counted (calls, bytes) {c['counted']}; formula calls "
                                   f"{c['calls']}, bytes {c['bytes']}: ok {c['ok']}")
        print(f"census rank {rank}/{world}: {name}: {detail}", flush=True)
    bal = res["balance"]
    print(f"census rank {rank}/{world}: balance: a block {bal['a_block']}, key block "
          f"{bal['key_block']}, {bal['seconds']:.4f} s a coefficient-sharded rotation",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-per-device", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--step", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=CFG.n, help="ring degree (<= 8192)")
    ap.add_argument("--census", action="store_true",
                    help="count the sharded paths' collectives against their formulas")
    ap.add_argument("--dp", type=int, default=0,
                    help="size of the batch-parallel axis (0: one group per host)")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="directory for each process's record, rank<r>_scaling.json")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scaling: no CUDA device (pass --device cpu for gloo CPU ranks)", file=sys.stderr)
        return 1
    device = multihost.local_device(args.device)
    multihost.initialize(args.device)
    if not dist.is_initialized():
        dryrun.init_world_of_one(device)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        rec = run(device, args.n, args.batch_per_device, args.iters, args.step, args.dp,
                  args.census)
        ok = rec["exact"]
        if not ok:
            print(f"scaling rank {rank}/{world}: the warm-up block differs from the plain "
                  "he_torch.rotate", file=sys.stderr, flush=True)
        if args.census:
            _print_census(rank, world, rec["census"])
            ok = ok and all(v.get("ok") is not False for v in rec["census"].values())
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            (args.out / f"rank{rank}_scaling.json").write_text(json.dumps(rec))
        print(json.dumps(rec), flush=True)
        return 0 if ok else 1
    finally:
        dist.destroy_process_group()


def spawned(world: int, argv, timeout_s: float) -> list:
    """`main(argv)` on `world` local ranks (`dryrun.spawn`): each rank's
    record, by rank."""
    with tempfile.TemporaryDirectory() as tmp:
        dryrun.spawn(world, list(argv) + ["--out", tmp], timeout_s, target=main)
        return [json.loads((pathlib.Path(tmp) / f"rank{r}_scaling.json").read_text())
                for r in range(world)]


if __name__ == "__main__":
    sys.exit(main())
