"""Reading a `torch.profiler` Chrome trace of the traced requests.

The traced window runs from the start of the first "portbench.request" span
to the end of the last.  Device time is the union of the intervals of the
kernels, copies and fills the card ran in it (not their sum: intervals that
overlap count once).  Kernels fall into families by the name patterns of
`kernels/<family>.json`; a kernel no file claims is elementwise.  Idle gaps
are labelled by the spans and the operator the host was in at the gap's
middle.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

REQUEST_SPAN = "portbench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
DEFAULT_FAMILY = "elementwise"
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160


def families(kernels_dir) -> dict:
    """{family: [name patterns]} from kernels/<family>.json."""
    return {p.stem: json.loads(p.read_text())["patterns"]
            for p in sorted(pathlib.Path(kernels_dir).glob("*.json"))}


def family_of(name: str, fams: dict) -> str:
    for fam, patterns in fams.items():
        if any(p in name for p in patterns):
            return fam
    return DEFAULT_FAMILY


def union(intervals) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(intervals, lo: float, hi: float) -> list:
    return [[max(s, lo), min(e, hi)] for s, e in intervals if e > lo and s < hi]


@dataclasses.dataclass
class Trace:
    """What the metric readers read; times in µs."""

    requests: int
    window: tuple  # (start, end)
    kernels: list  # (name, start, dur) of the kernels in the window
    copies: list  # (name, start, dur) of the memcpys in the window
    fills: list  # (name, start, dur) of the memsets in the window
    busy: list  # union of the device intervals, clipped to the window
    host: list  # (start, end, name, cat) of the request thread's spans and operators
    fams: dict  # kernel families
    work: dict  # {family: (bytes, INT32 instructions)} of one request
    peaks: dict

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy)

    def family_us(self, family: str) -> float:
        return sum(d for name, _, d in self.kernels if family_of(name, self.fams) == family)

    def gaps(self) -> list:
        """[start, end) of the idle intervals inside the window."""
        out, t = [], self.window[0]
        for s, e in self.busy:
            if s > t:
                out.append([t, s])
            t = max(t, e)
        if self.window[1] > t:
            out.append([t, self.window[1]])
        return out

    def host_labels(self, times) -> list:
        """For each of the sorted times, the innermost span and the innermost
        operator open on the request thread then (spans and operators of one
        thread nest, so the open ones form a stack)."""
        out, stack, i, host = [], [], 0, self.host
        for t in times:
            while i < len(host) and host[i][0] <= t:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            span = next((h[2] for h in reversed(stack)
                         if h[3] == "user_annotation" and h[2] != REQUEST_SPAN), None)
            op = next((h[2] for h in reversed(stack) if h[3] == "cpu_op"), None)
            out.append("/".join(x for x in (span, op) if x) or "harness")
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing: at most ten of each, in seconds."""
        ops = {}
        for name, _, d in self.kernels + self.copies + self.fills:
            key = name[:NAME_CHARS]
            ops[key] = ops.get(key, 0.0) + d
        idle, gaps = {}, self.gaps()
        for (s, e), label in zip(gaps, self.host_labels([(s + e) / 2 for s, e in gaps])):
            idle[label] = idle.get(label, 0.0) + (e - s)
        top = lambda d: [[k, v * 1e-6] for k, v in  # noqa: E731
                         sorted(d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def load(path, fams: dict, work: dict, peaks: dict) -> Trace:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == REQUEST_SPAN]
    if not spans:
        raise ValueError(f"{path}: no {REQUEST_SPAN} span")
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    tid = spans[0]["tid"]

    def inside(cat):
        return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
                if e.get("cat") == cat and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]

    dev = {cat: inside(cat) for cat in DEVICE_CATS}
    busy = clip(union((s, s + d) for c in DEVICE_CATS for _, s, d in dev[c]), lo, hi)
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e["cat"])
                   for e in events if e.get("cat") in HOST_CATS and e.get("tid") == tid),
                  key=lambda h: (h[0], -h[1]))
    return Trace(requests=len(spans), window=(lo, hi), kernels=dev["kernel"],
                 copies=dev["gpu_memcpy"], fills=dev["gpu_memset"], busy=busy, host=host,
                 fams=fams, work=work, peaks=peaks)
