"""One run of one cell: set-up, the measured window or the traced requests,
then the check of the answers against the reference.

The cell is named in BENCHMARK.json at the checkout's root.  Its
configuration file gives the deployment (ring, moduli, evaluation keys, the
request kind's parameters); its traffic file under `workloads/` gives the
request kind, the batch, the pool of request batches, how many requests a
trace holds, which answers are kept, and the limit of each number compared.

A request takes one batch of B ciphertexts held in pinned host memory (a
server's receive buffer), copies it to the card, runs the kind's chain of
`aloha_tpu_torch.he_torch` calls, copies the result back to pinned host
memory and synchronises.  One client sends them back to back (a closed
loop), cycling the pool.  The window keeps the answers of a few requests
drawn from the seed (by the time at which they start) and of the last ones;
the traced run keeps those of its traced requests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import json
import math
import os
import pathlib
import tempfile
import time

import numpy as np
import torch

from portbench import check, draws as dr, roofline, trace as tr
from portbench.reference import ckks

PACKAGE = pathlib.Path(__file__).resolve().parent
#: where BENCHMARK.json lies: the checkout's root
ROOT = PACKAGE.parent
#: the data directories, relative to the root
DATA = pathlib.PurePosixPath(PACKAGE.name)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: dict  # {metric: unit} this cell reports with --trace 0
    per_layer: dict  # and with --trace 1
    root: pathlib.Path

    @property
    def ring(self) -> ckks.Ring:
        r = self.config["ring"]
        return ckks.Ring(n=r["n"], moduli=tuple(r["moduli"]), psi=tuple(r["psi"]))

    @property
    def kind(self) -> str:
        return self.traffic["request"]

    def reference(self):
        return importlib.import_module(f"portbench.reference.{self.kind}")

    def program(self):
        return importlib.import_module(f"portbench.requests.{self.kind}")

    def counts(self):
        return importlib.import_module(f"portbench.counts.{self.kind}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root=ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json, its configuration and its
    traffic read from their files."""
    root = pathlib.Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / DATA / "workloads" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                end_to_end={m["name"]: m["unit"] for m in bench["end_to_end"] if _applies(m, name)},
                per_layer={m["name"]: m["unit"] for m in bench["per_layer"] if _applies(m, name)},
                root=root)


def reader(metric: str):
    return importlib.import_module(f"portbench.metrics.{metric}").read


def _cpu() -> int:
    """The CPU this process last ran on (/proc/self/stat, field 39)."""
    with open("/proc/self/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[36])


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ------------------------------------------------------------- the system
class Program:
    """The system's side of a run: its keys and encryptions derived from the
    draws by `aloha_tpu_torch`, the pool of request batches in host memory,
    and the request chain."""

    def __init__(self, cell: Cell, draws: dr.Draws, device: torch.device):
        from aloha_tpu_torch import client, keys as pk
        from aloha_tpu_torch.config import HEConfig

        ring, config = cell.ring, cell.config
        self.dev, self.kind = device, cell.program()
        self.cfg = cfg = HEConfig(n=ring.n, moduli=ring.moduli, psi=ring.psi,
                                  ipsi=tuple(pow(p, -1, q) for p, q in zip(ring.psi, ring.moduli)))
        sk = pk.secret_key(draws.secret.to(device), cfg)
        keys = {}
        for name in dr.key_names(config):
            chunks, noise = (x.to(device) for x in draws.keys[name])
            src = (pk.relin_secret(sk, cfg) if name == "relin"
                   else pk.galois_secret(sk, pow(3, int(name[3:]), 2 * ring.n), cfg))
            keys[name] = pk.ksk_from_draws(src, sk, chunks, noise, cfg)
        P, k, B = draws.slots.shape[:3]
        self.pool = torch.empty((P, k, 2, B, ring.L, ring.n), dtype=torch.int64,
                                pin_memory=device.type == "cuda")
        for p in range(P):
            for c in range(k):
                m = torch.from_numpy(client.encode_signed(draws.slots[p, c], cfg)).to(device)
                ct = pk.encrypt_with(m, sk, draws.noise[p, c].to(device), draws.b[p, c].to(device),
                                     cfg)
                self.pool[p, c, 0].copy_(ct[0])
                self.pool[p, c, 1].copy_(ct[1])
        self.prepared = self.kind.prepare(cfg, config, keys, draws.extra, device)

    def serve(self, cts: list) -> tuple:
        return self.kind.serve(self.cfg, self.prepared, cts)


class Requests:
    """Requests of one client: pool batch p in, the answer into a host buffer."""

    def __init__(self, pool: torch.Tensor, serve, device: torch.device):
        self.pool, self.serve, self.dev = pool, serve, device

    def __call__(self, p: int, buf: torch.Tensor) -> None:
        x = self.pool[p].to(self.dev, non_blocking=True)
        out = self.serve([(x[c, 0], x[c, 1]) for c in range(x.shape[0])])
        buf[0].copy_(out[0], non_blocking=True)
        buf[1].copy_(out[1], non_blocking=True)
        sync(self.dev)

    def buffer(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.int64, pin_memory=self.dev.type == "cuda")


@dataclasses.dataclass
class Window:
    """What the end-to-end readers read."""

    latencies: list  # seconds, every request of the window
    seconds: float  # first request's start to last request's end
    vectors: int  # batch elements answered
    setup_s: float


def measure(req: Requests, pool: int, batch: int, out_shape, seconds: float, keep: dict,
            seed: int):
    """Requests back to back while fewer than `seconds` have passed: (Window
    without set-up, kept answers).  keep["sampled"] answers are kept from
    the first requests to start after fractions of the window drawn from
    the seed, and the last keep["last"]."""
    fractions = sorted(np.random.default_rng(seed).uniform(0.0, 1.0, keep["sampled"]))
    sampled = [req.buffer(out_shape) for _ in fractions]
    ring = [req.buffer(out_shape) for _ in range(keep["last"])]
    kept, last, lat = [], [None] * len(ring), []
    start = time.perf_counter()
    end = start
    i = 0
    while i == 0 or end - start < seconds:
        t0 = time.perf_counter()
        p = i % pool
        if len(kept) < len(fractions) and t0 - start >= fractions[len(kept)] * seconds:
            buf = sampled[len(kept)]
            kept.append(check.Kept(buf, i, p))
        else:
            buf = ring[i % len(ring)]
            last[i % len(ring)] = check.Kept(buf, i, p)
        req(p, buf)
        end = time.perf_counter()
        lat.append(end - t0)
        i += 1
    window = Window(latencies=lat, seconds=end - start, vectors=i * batch, setup_s=0.0)
    return window, kept + [k for k in last if k is not None]


# ------------------------------------------------------------- tracing
#: program functions that a traced run wraps in spans named after them
SPANS = {
    "aloha_tpu_torch.he_torch": ("hom_add", "mul_plain", "rotate", "rotate_hoisted",
                                 "rotate_batch", "pt_rotate", "matvec_bsgs", "ct_mul",
                                 "relinearize", "rescale"),
    "aloha_tpu_torch.ops.ks_kernel": ("rotate_planes", "rotate_planes_hoisted",
                                      "rotate_planes_batch", "prepare_ksk"),
    "aloha_tpu_torch.ops.ntt_stream": ("transform_limbs",),
}


@contextlib.contextmanager
def spans():
    """Wrap the calls into each layer in `record_function` spans."""
    saved = []
    for module_name, names in SPANS.items():
        module = importlib.import_module(module_name)
        label = module_name.rsplit(".", 1)[-1]
        for name in names:
            fn = getattr(module, name)

            def wrapped(*a, __fn=fn, __label=f"{label}.{name}", **kw):
                with torch.profiler.record_function(__label):
                    return __fn(*a, **kw)

            saved.append((module, name, fn))
            setattr(module, name, functools.wraps(fn)(wrapped))
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def traced(req: Requests, pool: int, out_shape, requests: int, path) -> list:
    """Profile `requests` requests (CPU and CUDA activities) into a Chrome
    trace at `path`; their answers kept."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if req.dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    kept = [check.Kept(req.buffer(out_shape), i, i % pool) for i in range(requests)]
    with spans(), profile(activities=activities) as prof:
        for k in kept:
            with record_function(tr.REQUEST_SPAN):
                req(k.pool, k.out)
    prof.export_chrome_trace(str(path))
    return kept


# ------------------------------------------------------------- a run
def card(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, started: float,
        control: bool = False, log=print) -> dict:
    """One run; `started` is the process's start on the perf_counter clock.
    control: the reference, with its products in float64, in the system's
    place.  A traced run's Chrome trace goes to a temporary directory
    (under TMPDIR) and is removed once read."""
    dev = torch.device(device)
    ring, traffic = cell.ring, cell.traffic
    if traffic["clients"] != 1 or traffic["loop"] != "closed":
        raise ValueError(f"{cell.name}: only one client in a closed loop is implemented")
    ref = cell.reference()
    t = [time.perf_counter()]
    draws = dr.draw(ring, cell.config, traffic, ref, seed, dev)
    t.append(time.perf_counter())
    program = Program(cell, draws, dev)
    t.append(time.perf_counter())
    serve = program.serve
    if control:
        serve = check.Judge(ring, cell.config, ref, draws, dev, exact=False).serve
    req = Requests(program.pool, serve, dev)
    P, B = traffic["pool"], traffic["batch"]
    x = program.pool[0].to(dev)
    out_shape = (2,) + tuple(serve([(x[c, 0], x[c, 1]) for c in range(x.shape[0])])[0].shape)
    del x
    probe = req.buffer(out_shape)
    for p in range(P):  # warm-up: every pool batch through a whole request
        req(p, probe)
    del probe
    t.append(time.perf_counter())
    setup_s = t[-1] - started
    log(f"set-up: {setup_s} s, of which imports and start {t[0] - started}, draws {t[1] - t[0]}, "
        f"keys and pool {t[2] - t[1]}, warm-up {t[3] - t[2]}")
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}, "device": card(dev)}
    if trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "trace.json"
            kept = traced(req, P, out_shape, traffic["trace_requests"], path)
            ctx = tr.load(path, tr.families(cell.root / DATA / "kernels"),
                          cell.counts().work(ring, cell.config, traffic), roofline.peaks())
        names, attempted = cell.per_layer, len(kept)
        result["device"].update(busy_s=ctx.busy_us * 1e-6, window_s=ctx.window_us * 1e-6)
    else:
        window, kept = measure(req, P, B, out_shape, seconds, traffic["keep"], seed)
        window.setup_s = setup_s
        ctx, names, attempted = window, cell.end_to_end, len(window.latencies)
        lat = np.array(window.latencies) * 1e3
        log(f"latency: median {np.median(lat)} ms, p95 {np.percentile(lat, 95)} ms over "
            f"{len(lat)} requests in {window.seconds} s; set-up {setup_s} s; on cpu "
            f"{_cpu()} of {sorted(os.sched_getaffinity(0))}")
    if dev.type == "cuda":
        result["device"]["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    for name, unit in names.items():
        value = reader(name)(ctx)
        if value is not None:
            result["metrics"][name] = {"value": value, "unit": unit}
    if trace:
        result["breakdown"] = ctx.breakdown()
    # the system's state goes before the reference runs
    del program, req, serve
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, per = check.Judge(ring, cell.config, ref, draws, dev).numbers(kept)
    log(f"reference and check: {time.perf_counter() - t} s")
    limits = traffic["limits"]
    failed = sum(1 for bad, err in per if bad > limits["mismatched_words"]
                 or not err <= limits["max_slot_error"])
    result.update(attempted=attempted, failed=failed,
                  correct=bool(kept) and all(numbers[k] <= limits[k] for k in numbers)
                  and all(math.isfinite(v) for v in numbers.values()))
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    log(f"checked {len(kept)} answer batches of {B} (requests "
        f"{[k.request for k in kept]}): {failed} wrong")
    return result
