"""Launch profiling: per-launch time, device profiler traces and the program's spans.

The port of `aloha_tpu/profiling.py:18-78`.  The reference's observability
is simulation artifacts — FSDB waves, cycle counters in the testbenches,
per-op latency fields in the shadow pipeline (reference:
sim/vp/*/run_verdi.sh, vp_top_tb.sv:107-108,285-292).  Here: host-clock
timers around launches, each bracketed by a synchronisation of the card so
that a record is the launch's time and not its enqueue time, and
`torch.profiler` (CPU + CUDA activities) in place of `jax.profiler`, with
a Chrome trace exported to `trace_dir`.

Spans.  The library marks its own layers with `span(name)`: while a
profiler records, each span is a `user_annotation` range on the calling
thread, on the same clock as the kernels and copies it enqueued, so an idle
gap of the card can be put down to what the host was doing.  With no
profiler recording a span costs one check of a flag.  To record them:

    prof = Profiler(trace_dir)
    with prof.device_trace("request"):
        out = he_torch.matvec_bsgs(ct, diags, baby, giant, cfg)

and open `<trace_dir>/request.json` in Perfetto or chrome://tracing.  The
families (a span nests in the span it was opened in, on one thread):

- `aloha.he.<op>`: a public `he_torch` op (`rotate` nests a `galois`);
- `aloha.rns.<fn>`: an `rns_torch` ALU entry point called from outside
  `rns_torch` (lazy_reduce, addmod, submod, mulmod, modred, mulmod_shoup,
  halfmod), or its `rns_torch.plain` form (the references' aten code):
  the host dispatch of the limb arithmetic (on the card the entry point's
  one `aloha.kernel.rns` launch inside it);
- `aloha.pack.<what>`: a layout copy (the limbs stacked back on the CPU, a
  key-switch's packed operands, stacked keys);
- `aloha.gather.ntt_domain_aut`: an NTT-domain automorphism gather;
- `aloha.kernel.<wrapper>`: a wrapper call that reaches a hand kernel, one
  a launch its `.launches` counts (ks_head, ks_tail, ntt, ntt_with_tables,
  ntt_grid, ntt_mxu, ntt_mxu_chain, aut, rns);
- `aloha.build.<what>`: a cache filled (twiddle and kernel tables, gather
  maps, a prepared key, the kernel library): none in a steady state.

A request has no span of its own: the caller's enclosing span identifies it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


#: open and close a `user_annotation` range as `record_function` does, by
#: the binding `torch.profiler` itself uses: no Python object around it and
#: no dispatcher op.  On an H100 machine's host while a profiler records:
#: 6.2-7.0 µs a range, against 14.9-17.4 µs by a `record_function` object
#: and 30.4-31.8 µs by the dispatcher's enter and exit ops.
_enter_range = torch.autograd._record_function_with_args_enter
_exit_range = torch.autograd._record_function_with_args_exit


class span:
    """A named range of the program in a profiler's trace, as a decorator
    (`@span(name)`, names and signatures kept) or a context manager (`with
    span(name):`, one object a `with`: it holds the open range).

    While no profiler records (`torch.autograd.profiler`'s
    `_is_profiler_enabled`, which `torch.profiler.profile` and `emit_nvtx`
    set), the decorated function is called after one check of that flag:
    no range is opened and nothing is allocated.  While one records, the
    call runs inside a range named `name`, as under `record_function`."""

    __slots__ = ("name", "_handle")

    def __init__(self, name: str):
        self.name = name
        self._handle = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._handle = _enter_range(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        handle, self._handle = self._handle, None
        if handle is not None:
            _exit_range(handle)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            handle = _enter_range(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _exit_range(handle)

        return spanned


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
    exported: the kernels, copies and fills the card ran, and the time in
    which at least one of them ran (the union of their intervals: events
    that overlap, on several streams or as a copy beside a kernel, count
    once)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, reached = 0.0, float("-inf")
    for start, end in sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                             for e in dev):
        if end > reached:
            busy += end - max(start, reached)
            reached = end
    return len(dev), busy


def profile_device(device, profiler: Profiler):
    """Wrap an AlohaDevice so every run_vp launch is timed."""
    orig = device.run_vp

    def run_vp(pc, src0, src1, rslt, step=0, ksk_ptr=0):
        with profiler.launch(f"run_vp[pc={pc}]"):
            return orig(pc, src0, src1, rslt, step, ksk_ptr)

    device.run_vp = run_vp
    return device
