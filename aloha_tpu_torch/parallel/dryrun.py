"""Dry run of the port's multi-device paths.

    torchrun --nproc-per-node R -m aloha_tpu_torch.parallel.dryrun [--device cpu]
        [--workload {ntt,keyswitch,hoisted,bsgs,smoke}]...

The port of the JAX package's multi-chip dry run (__graft_entry__.py:
49-145, 163-218 and `_dryrun_workloads`, :221-end).  Each workload draws its
inputs from a seed, runs on this rank's share and checks it, one printed
line per check; the run exits nonzero when a check fails.

  ntt        (the default) the coefficient-sharded NTT: each rank takes its
             block of a batch of polynomials (rows over the `dp` axis,
             coefficients over the `coeff` axis of `multihost.pod_mesh`),
             runs `ntt_sharded` and `intt_sharded`, and checks its block of
             the forward transform against `ntt_np.ntt` and the round trip;
  keyswitch  the digit-sharded rotation `keyswitch_sharded.rotate_sharded`
             on a (dp, digit) mesh of R = dp L ranks: rank (i, j) holds limb
             j of the batch, rotates block i, and checks its limb against
             the plain `he_torch.rotate` on CPU tensors, word for word;
  hoisted    `he_torch.rotate_hoisted` (steps 1 and 2, one shared head) on
             each rank's block of the batch (dp = R), and
  bsgs       `he_torch.matvec_bsgs` (D = 4 diagonals, g = 2) likewise: the
             first and last row of each block word-exact against the plain
             path on CPU tensors;
  smoke      the coefficient-sharded rotation `coeff_sharded.rotate` (the
             JAX package's GSPMD smoke tier, __graft_entry__.py:87-145) on
             the (dp, coeff) mesh of `multihost.pod_mesh`, at the ring
             max(256, 8 coeff) (or --n) with batch 2 dp (or --batch): rank
             (i, d) rotates rows block i, coefficients block d, by step 2
             and checks it against the plain `he_torch.rotate` of the whole
             batch on CPU tensors, word for word.

The key-switch workloads run on the ring `ring(--n, --moduli, --psi)`: the
default moduli (L = 2) scaled to n, or the given ones (L = len - 1).  Ranks
run on `multihost.local_device` with NCCL by default, over gloo when
ranks share a card, and on the CPU with gloo under `--device cpu`.  Without
torchrun it runs as a world of one.  `spawn` starts the ranks of a local job
from `torch.multiprocessing`, as torchrun would.
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
from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch import keys, ntt_np
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
from aloha_tpu_torch.config import HEConfig
from aloha_tpu_torch.ops import aut, ntt_stream
from aloha_tpu_torch.parallel import coeff_sharded, multihost
from aloha_tpu_torch.parallel.keyswitch_sharded import rotate_sharded
from aloha_tpu_torch.parallel.ntt_sharded import intt_sharded, ntt_sharded

SEED = 2  # of the seeded batch every rank draws in full and takes its block of
WORKLOADS = ("ntt", "keyswitch", "hoisted", "bsgs", "smoke")
KS_STEP = 2  # the sharded rotations' step (__graft_entry__.py:128, :206)
SMOKE_SEED = 1  # of the smoke workload's draws (__graft_entry__.py:108)
BATCH = 4  # the default batch of every workload but smoke
HOISTED_STEPS = (1, 2)
BSGS_D, BSGS_G = 4, 2


def ring(n: int, moduli=None, psi=None) -> HEConfig:
    """The ring of degree n <= N: the default moduli with their roots
    raised to the power N/n (psi^(N/n) is a primitive 2n-th root when psi
    is one of order 2N), or `moduli` with `psi` (2n-th primitive roots, one
    per modulus; the last modulus is P)."""
    if moduli is None:
        k = CFG.n // n
        return HEConfig(n=n, moduli=CFG.moduli,
                        psi=tuple(pow(p, k, q) for p, q in zip(CFG.psi, CFG.moduli)),
                        ipsi=tuple(pow(p, k, q) for p, q in zip(CFG.ipsi, CFG.moduli)))
    return HEConfig(n=n, moduli=tuple(moduli), psi=tuple(psi),
                    ipsi=tuple(pow(p, -1, q) for p, q in zip(psi, moduli)))


def roots(n: int):
    """(q0, psi, psi^-1) of the NTT workload's ring of degree n."""
    cfg = ring(n)
    return cfg.moduli[0], cfg.psi[0], cfg.ipsi[0]


def run(device: torch.device, n: int = CFG.n, batch: int = 4, dp: int = 1,
        check_rows: int | None = None) -> dict:
    """One rank's part of the NTT workload in an initialised process group.

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


def ciphertexts(cfg: HEConfig, batch: int):
    """The seeded batch (a, b) of the key-switch workloads: uint64 (batch,
    L, n), words below q0 (__graft_entry__.py:200-201)."""
    rng = np.random.default_rng(SEED)
    shape = (batch, cfg.n_limbs, cfg.n)
    return tuple(rng.integers(0, cfg.moduli[0], size=shape, dtype=np.uint64) for _ in "ab")


def random_key(cfg: HEConfig) -> np.ndarray:
    """The keyswitch workload's key: random words below q0 in the KSK
    layout, (2L(L+1), n) uint64 (__graft_entry__.py:202)."""
    L = cfg.n_limbs
    return np.random.default_rng(SEED + 1).integers(
        0, cfg.moduli[0], size=(2 * L * (L + 1), cfg.n), dtype=np.uint64)


def serving_keys(cfg: HEConfig, device) -> dict:
    """The port's rotation keys of the hoisted and bsgs workloads, by step
    (1 and 2), made from seeded `torch.Generator`s on the host."""
    sk = keys.gen_secret(cfg, torch.Generator().manual_seed(SEED + 2), device)
    return {s: keys.gen_rotation_key(sk, s, cfg, torch.Generator().manual_seed(SEED + 3 + s))
            for s in (1, 2)}


def diagonals(cfg: HEConfig) -> np.ndarray:
    """The bsgs workload's D encoded diagonals: random words below q0,
    uint64 (D, L, n) (__graft_entry__.py:366-369)."""
    return np.random.default_rng(SEED + 4).integers(
        0, cfg.moduli[0], size=(BSGS_D, cfg.n_limbs, cfg.n), dtype=np.uint64)


def _launch_counts() -> dict:
    return {"ntt": ntt_stream.transform.launches, "aut": aut.automorphism.launches}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device: torch.device) -> float:
    """Host seconds of one call of fn, the device synchronised before and after."""
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def run_keyswitch(device: torch.device, cfg: HEConfig, batch: int = 4, dp: int = 1) -> dict:
    """One rank's part of the keyswitch workload: limb j of the batch on a
    (dp, digit) mesh, block i rotated by `rotate_sharded` twice (the second
    call timed on the host clock, the device synchronised before and
    after), its limb checked against the plain `he_torch.rotate`.  Beside
    the rotation's seconds, two yardsticks timed the same way: one
    all_reduce of the rotation's 2(L+1) nb N words over the digit group,
    and the whole-ciphertext `he_torch.rotate` of the block on the rank's
    device (after one warm-up call)."""
    L, n = cfg.n_limbs, cfg.n
    world = dist.get_world_size()
    if world != dp * L or batch % dp:
        raise ValueError(f"{world} ranks for dp={dp} x L={L}, batch {batch}: no such mesh")
    mesh = multihost.pod_mesh(("dp", "digit"), dp, device.type)
    i, j = mesh.get_local_rank("dp"), mesh.get_local_rank("digit")
    a, b = ciphertexts(cfg, batch)
    ksk = random_key(cfg)
    ct = (cv.from_u64(a[:, j:j + 1], device), cv.from_u64(b[:, j:j + 1], device))
    key = cv.from_u64(ksk, device)
    before = _launch_counts()

    def rotate():
        return rotate_sharded(ct, KS_STEP, key, cfg, mesh.get_group("digit"),
                              mesh.get_group("dp"))

    rotate()
    out = []
    seconds = _timed(lambda: out.extend(rotate()), device)
    launches = {k: v - before[k] for k, v in _launch_counts().items()}
    nbl = batch // dp
    rows = slice(i * nbl, (i + 1) * nbl)
    shares = torch.zeros((2 * (L + 1), nbl, n), dtype=torch.int64, device=device)
    allreduce_seconds = _timed(lambda: dist.all_reduce(shares, group=mesh.get_group("digit")),
                               device)
    whole = (cv.from_u64(a[rows], device), cv.from_u64(b[rows], device))
    ht.rotate(whole, KS_STEP, key, cfg)
    fused_seconds = _timed(lambda: ht.rotate(whole, KS_STEP, key, cfg), device)
    cpu = torch.device("cpu")
    want = ht.rotate((cv.from_u64(a[rows], cpu), cv.from_u64(b[rows], cpu)), KS_STEP,
                     cv.from_u64(ksk, cpu), cfg)
    got = tuple(cv.to_u64(x) for x in out)
    exact = all(np.array_equal(g[:, 0], cv.to_u64(w)[:, j]) for g, w in zip(got, want))
    return {"dp": dp, "dp_index": i, "digit": j, "L": L, "n": n, "rows": (rows.start, rows.stop),
            "a": got[0], "b": got[1], "exact": exact, "seconds": seconds,
            "allreduce_seconds": allreduce_seconds, "fused_seconds": fused_seconds,
            "backend": dist.get_backend(),
            "launches_ntt": launches["ntt"], "launches_aut": launches["aut"]}


def _block(cfg: HEConfig, batch: int, device):
    """This rank's rows of the seeded batch (dp = the world), on `device`
    and on the CPU."""
    world, r = dist.get_world_size(), dist.get_rank()
    if batch % world:
        raise ValueError(f"batch {batch} over {world} ranks: not divisible")
    nbl = batch // world
    rows = slice(r * nbl, (r + 1) * nbl)
    a, b = (x[rows] for x in ciphertexts(cfg, batch))
    cpu = torch.device("cpu")
    return rows, (cv.from_u64(a, device), cv.from_u64(b, device)), (cv.from_u64(a, cpu),
                                                                       cv.from_u64(b, cpu))


def _ends_exact(got, want) -> bool:
    """The first and last row of each part of got equal want's."""
    return all(np.array_equal(cv.to_u64(g[k]), cv.to_u64(w[k]))
               for g, w in zip(got, want) for k in (0, -1))


def run_hoisted(device: torch.device, cfg: HEConfig, batch: int = 4) -> dict:
    """One rank's part of the hoisted workload: its block of the batch
    rotated by steps 1 and 2 through one shared head."""
    rows, ct, ct_cpu = _block(cfg, batch, device)
    ksk = serving_keys(cfg, device)
    steps = list(HOISTED_STEPS)
    outs = ht.rotate_hoisted(ct, steps, [ksk[s] for s in steps], cfg)
    want = ht.rotate_hoisted(ct_cpu, steps, [ksk[s].cpu() for s in steps], cfg)
    res = {"rows": (rows.start, rows.stop),
           "exact": all(_ends_exact(o, w) for o, w in zip(outs, want))}
    for s, (oa, ob) in zip(steps, outs):
        res[f"a{s}"], res[f"b{s}"] = cv.to_u64(oa), cv.to_u64(ob)
    return res


def run_bsgs(device: torch.device, cfg: HEConfig, batch: int = 4) -> dict:
    """One rank's part of the bsgs workload: its block of the batch through
    `matvec_bsgs` with D = 4 diagonals, g = 2."""
    rows, ct, ct_cpu = _block(cfg, batch, device)
    ksk = serving_keys(cfg, device)
    diags = diagonals(cfg)
    cpu = torch.device("cpu")

    def matvec(ct, dev, keyed):
        return ht.matvec_bsgs(ct, [cv.from_u64(d, dev) for d in diags], [keyed(ksk[1])],
                              [keyed(ksk[BSGS_G])], cfg, g=BSGS_G)

    out = matvec(ct, device, lambda k: k)
    want = matvec(ct_cpu, cpu, lambda k: k.cpu())
    return {"rows": (rows.start, rows.stop), "exact": _ends_exact(out, want),
            "a": cv.to_u64(out[0]), "b": cv.to_u64(out[1])}


def smoke_ring(coeff: int) -> int:
    """The smoke workload's ring degree on a coefficient axis of `coeff`
    ranks (__graft_entry__.py:107)."""
    return max(256, 8 * coeff)


def smoke_inputs(cfg: HEConfig, batch: int):
    """The smoke workload's (a, b, ksk), drawn as __graft_entry__.py:108-111
    draws them: uint64 (batch, L, n), (batch, L, n) and (2L(L+1), n), words
    below q0 (the smallest modulus, so canonical under every modulus)."""
    rng = np.random.default_rng(SMOKE_SEED)
    L, n, q0 = cfg.n_limbs, cfg.n, cfg.moduli[0]
    a = rng.integers(0, q0, size=(batch, L, n), dtype=np.uint64)
    b = rng.integers(0, q0, size=(batch, L, n), dtype=np.uint64)
    return a, b, rng.integers(0, q0, size=(2 * L * (L + 1), n), dtype=np.uint64)


def run_smoke(device: torch.device, n: int | None = None, batch: int | None = None,
              dp: int = 1) -> dict:
    """One rank's part of the smoke workload: its block of the batch
    (rows over dp, coefficients over coeff) rotated by
    `coeff_sharded.rotate`, checked word for word against the plain
    `he_torch.rotate` of the whole batch on CPU tensors.  The rotation's
    seconds are timed on the host clock, the device synchronised before and
    after; the launches are `transform_with_tables`'."""
    mesh = multihost.pod_mesh(("dp", "coeff"), dp, device.type)
    D, d, i = mesh.size(1), mesh.get_local_rank("coeff"), mesh.get_local_rank("dp")
    n = n or smoke_ring(D)
    batch = batch or 2 * dp
    if batch % dp:
        raise ValueError(f"batch {batch} over dp={dp}: not divisible")
    cfg = ring(n)
    a, b, ksk = smoke_inputs(cfg, batch)
    nbl, C = batch // dp, n // D
    rows, cols = slice(i * nbl, (i + 1) * nbl), slice(d * C, (d + 1) * C)
    block = (cv.from_u64(a[rows, :, cols], device), cv.from_u64(b[rows, :, cols], device))
    key = cv.from_u64(ksk[:, cols], device)
    before = ntt_stream.transform_with_tables.launches
    out = []
    seconds = _timed(lambda: out.extend(
        coeff_sharded.rotate(block, KS_STEP, key, cfg, mesh.get_group("coeff"))), device)
    launches = ntt_stream.transform_with_tables.launches - before
    cpu = torch.device("cpu")
    want = ht.rotate((cv.from_u64(a, cpu), cv.from_u64(b, cpu)), KS_STEP,
                     cv.from_u64(ksk, cpu), cfg)
    got = tuple(cv.to_u64(x) for x in out)
    exact = all(np.array_equal(g, cv.to_u64(w)[rows, :, cols]) for g, w in zip(got, want))
    return {"dp": dp, "coeff": D, "dp_index": i, "d": d, "n": n, "batch": batch,
            "rows": (rows.start, rows.stop), "cols": (cols.start, cols.stop),
            "a": got[0], "b": got[1], "exact": exact, "seconds": seconds,
            "backend": dist.get_backend(), "launches": launches}


def init_world_of_one(device: torch.device) -> None:
    """A process group of one rank on `device`, from an in-memory store (no
    rendezvous)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        multihost.backend_for(device.type), store=dist.HashStore(), rank=0,
        world_size=1, timeout=multihost.TIMEOUT,
    )


def _ints(text: str):
    return tuple(int(v) for v in text.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--workload", choices=WORKLOADS, action="append",
                    help="repeatable; default: ntt")
    ap.add_argument("--n", type=int, default=None,
                    help=f"ring degree (<= 8192; default {CFG.n}, smoke: max(256, 8 coeff))")
    ap.add_argument("--batch", type=int, default=None,
                    help=f"polynomials (ciphertexts) in the batch (default {BATCH}, smoke: 2 dp)")
    ap.add_argument("--dp", type=int, default=1,
                    help="size of the batch-parallel axis (ntt, keyswitch, smoke)")
    ap.add_argument("--moduli", type=_ints, default=None,
                    help="the key-switch ring's moduli q_0,...,q_{L-1},P (default: CFG's)")
    ap.add_argument("--psi", type=_ints, default=None,
                    help="their primitive 2n-th roots, comma-separated (with --moduli)")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="directory for each rank's results: rank<r>.npz (ntt), "
                         "rank<r>_<workload>.npz (the others)")
    args = ap.parse_args(argv)
    if (args.moduli is None) != (args.psi is None):
        ap.error("--moduli and --psi go together")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device (pass --device cpu for gloo CPU ranks)", file=sys.stderr)
        return 1
    workloads = args.workload or ["ntt"]
    device = multihost.local_device(args.device)
    multihost.initialize(args.device)
    if not dist.is_initialized():
        init_world_of_one(device)
    ok = True
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        n, batch = args.n or CFG.n, args.batch or BATCH
        cfg = ring(n, args.moduli, args.psi)
        for workload in workloads:
            ok_line = None
            if workload == "ntt":
                res = run(device, n, batch, args.dp)
                tag = (f"dryrun rank {rank}/{world}: D={res['D']} dp={res['dp']} n={res['n']} "
                       f"rows {res['rows']} cols {res['cols']} on {device}")
                checks = {"forward equals ntt_np.ntt": res["forward_ok"],
                          "round trip exact": res["roundtrip_ok"]}
            elif workload == "keyswitch":
                res = run_keyswitch(device, cfg, batch, args.dp)
                tag = (f"dryrun keyswitch rank {rank}/{world}: dp={res['dp']} x digit={res['L']}"
                       f" n={res['n']} limb {res['digit']} rows {res['rows']} on {device} "
                       f"({res['backend']}), {res['seconds']:.4f} s a rotation (one "
                       f"all_reduce of its words {res['allreduce_seconds']:.4f} s, he_torch."
                       f"rotate of the block {res['fused_seconds']:.4f} s)")
                checks = {"limb equals the plain he_torch.rotate": res["exact"]}
            elif workload == "smoke":
                res = run_smoke(device, args.n, args.batch, args.dp)
                tag = (f"dryrun smoke rank {rank}/{world}: dp={res['dp']} x coeff={res['coeff']} "
                       f"n={res['n']} rows {res['rows']} cols {res['cols']} on {device} "
                       f"({res['backend']}), {res['seconds']:.4f} s a rotation")
                checks = {"block equals the plain he_torch.rotate": res["exact"]}
                ok_line = (f"dryrun_multichip smoke OK (coefficient-sharded rotate): mesh "
                           f"dp={res['dp']} x coeff={res['coeff']}, ring n={res['n']}, "
                           f"batch={res['batch']}")
            else:
                res = (run_hoisted if workload == "hoisted" else run_bsgs)(device, cfg, batch)
                tag = (f"dryrun {workload} rank {rank}/{world}: dp={world} n={cfg.n} "
                       f"L={cfg.n_limbs} rows {res['rows']} on {device}")
                checks = {"first and last row equal the plain path": res["exact"]}
            if args.out is not None:
                args.out.mkdir(parents=True, exist_ok=True)
                name = f"rank{rank}.npz" if workload == "ntt" else f"rank{rank}_{workload}.npz"
                np.savez(args.out / name, **res)
            for what, good in checks.items():
                print(f"{tag}: {what}: {good}", flush=True)
                ok = ok and bool(good)
            if ok_line and all(checks.values()):
                print(ok_line, flush=True)
        return 0 if ok else 1
    finally:
        dist.destroy_process_group()


def _rank(local_rank: int, world: int, port: int, argv, target) -> None:
    """One rank of `spawn`: torchrun's environment for a single-host job on
    127.0.0.1:port, then `target(argv)`; SystemExit with its code on failure."""
    os.environ.update(
        RANK=str(local_rank), LOCAL_RANK=str(local_rank), WORLD_SIZE=str(world),
        LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
    )
    code = target(list(argv))
    if code:
        raise SystemExit(code)


def spawn(world: int, argv, timeout_s: float, target=None) -> None:
    """Run `target(argv)` (default: this module's `main`), a module-level
    function returning an exit code, on `world` local ranks started by
    `torch.multiprocessing` at a free port.  Raises when a rank fails or
    when the ranks have not finished within timeout_s, and kills every
    rank still running."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(_rank, args=(world, port, list(argv), target or main),
                             nprocs=world, join=False, start_method="spawn")
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
