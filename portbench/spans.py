"""The program's own spans in a traced run.

`aloha_tpu_torch.profiling.span` marks the program's layers with ranges
named `aloha.<layer>.<what>` (category `user_annotation` on the request
thread, beside the harness's own `he_torch.*` and `ks_kernel.*` labels).
The readers here take them from `trace.Trace.host`, clipped to the traced
window.  A trace with no `aloha.` span in its window (a program without
spans) gives None: the metric is left out rather than read as zero.
"""

from __future__ import annotations

from portbench import trace as tr

PREFIX = "aloha."
RNS = "aloha.rns."
BUILD = "aloha.build."


def spans(t, prefix: str = PREFIX) -> list:
    """[start, end) of the request thread's spans whose name starts with
    `prefix`, clipped to the traced window."""
    lo, hi = t.window
    return tr.clip([[s, e] for s, e, name, cat in t.host
                    if cat == "user_annotation" and name.startswith(prefix)], lo, hi)


def overlap_us(a: list, b: list) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def covered_ms(t, prefix: str = PREFIX):
    """Host ms a request in the union of the spans named prefix*; None
    without any `aloha.` span."""
    if not spans(t):
        return None
    return sum(e - s for s, e in tr.union(spans(t, prefix))) * 1e-3 / t.requests


def idle_covered_ms(t):
    """Device-idle ms a request (the trace's gaps) inside the union of the
    `aloha.` spans; None without any."""
    covered = tr.union(spans(t))
    if not covered:
        return None
    return overlap_us(t.gaps(), covered) * 1e-3 / t.requests


def count_per_request(t, prefix: str):
    """Spans named prefix* a request; None without any `aloha.` span."""
    if not spans(t):
        return None
    return len(spans(t, prefix)) / t.requests
