"""Launch profiling: per-launch time and device profiler traces.

The port of `aloha_tpu/profiling.py:18-78`.  The reference's observability
is simulation artifacts — FSDB waves, cycle counters in the testbenches,
per-op latency fields in the shadow pipeline (reference:
sim/vp/*/run_verdi.sh, vp_top_tb.sv:107-108,285-292).  Here: host-clock
timers around launches, each bracketed by a synchronisation of the card so
that a record is the launch's time and not its enqueue time, and
`torch.profiler` (CPU + CUDA activities) in place of `jax.profiler`, with
a Chrome trace exported to `trace_dir`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class LaunchRecord:
    name: str
    seconds: float


def _sync() -> None:
    """Wait for the card's queued work, when this process has used it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Profiler:
    """Collects per-launch times; optionally wraps torch.profiler."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.records: List[LaunchRecord] = []
        self.trace_dir = trace_dir

    @contextlib.contextmanager
    def launch(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.records.append(
                LaunchRecord(name=name, seconds=time.perf_counter() - t0)
            )

    @contextlib.contextmanager
    def device_trace(self, name: str = "trace"):
        """Profile a region with torch.profiler (CPU and, where there is a
        card, CUDA activities); yields the profile (None without a
        trace_dir) and exports `<trace_dir>/<name>.json` on exit."""
        if self.trace_dir is None:
            yield None
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield prof
            _sync()
        prof.export_chrome_trace(os.path.join(self.trace_dir, f"{name}.json"))

    def summary(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for r in self.records:
            s = out.setdefault(
                r.name, {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            s["count"] += 1
            s["total_s"] += r.seconds
            s["max_s"] = max(s["max_s"], r.seconds)
        for s in out.values():
            s["mean_s"] = s["total_s"] / s["count"]
        return out


def trace_device_events(path):
    """(device events, busy µs) of a Chrome trace that `device_trace`
    exported: the kernels, copies and fills the card ran (one stream, so
    their intervals add)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return len(dev), sum(float(e.get("dur", 0)) for e in dev)


def profile_device(device, profiler: Profiler):
    """Wrap an AlohaDevice so every run_vp launch is timed."""
    orig = device.run_vp

    def run_vp(pc, src0, src1, rslt, step=0, ksk_ptr=0):
        with profiler.launch(f"run_vp[pc={pc}]"):
            return orig(pc, src0, src1, rslt, step, ksk_ptr)

    device.run_vp = run_vp
    return device
