"""The readers of the program's spans (`portbench/spans.py`) on a synthetic
trace: two requests in [100, 300) µs, the card busy in [100, 110),
[115, 145), [220, 282) and [285, 295), and on the request thread the
harness's labels, aten operators and the program's `aloha.*` spans."""

from __future__ import annotations

import pathlib

import pytest

from portbench import harness, spans, trace
from portbench.tests.conftest import small_root

DATA = pathlib.Path(__file__).resolve().parent / "data" / "small_trace.json"
SPAN_METRICS = ("dispatch_ms", "dispatch_idle_ms", "rns_dispatch_ms", "rebuilds_per_request")

HOST = [
    (100, 200, trace.REQUEST_SPAN, "user_annotation"),
    (200, 300, trace.REQUEST_SPAN, "user_annotation"),
    (50, 90, "aloha.build.library", "user_annotation"),  # before the window
    (105, 150, "he_torch.mul_plain", "user_annotation"),  # the harness's label
    (106, 150, "aloha.he.mul_plain", "user_annotation"),
    (108, 120, "aloha.rns.mulmod", "user_annotation"),
    (110, 112, "aten::mul", "cpu_op"),
    (125, 140, "aloha.rns.mulmod", "user_annotation"),
    (141, 150, "aloha.pack.per_limb", "user_annotation"),
    (210, 260, "aloha.he.rotate", "user_annotation"),
    (212, 215, "aloha.build.tables", "user_annotation"),
    (290, 310, "aloha.he.rescale", "user_annotation"),  # cut at the window's end
]


def synthetic(host) -> trace.Trace:
    return trace.Trace(requests=2, window=(100.0, 300.0), kernels=[], copies=[], fills=[],
                       busy=[[100, 110], [115, 145], [220, 282], [285, 295]], host=host,
                       fams={}, work={}, peaks={})


def read(name, t):
    return harness.reader(name)(t)


def test_readers_with_spans():
    """The union of the aloha spans is [106, 150), [210, 260), [290, 300):
    104 µs; the gaps inside it [110, 115), [145, 150), [210, 220),
    [295, 300): 25 µs; the rns spans 27 µs; one build in the window."""
    t = synthetic(HOST)
    assert read("dispatch_ms", t) == pytest.approx(104e-3 / 2)
    assert read("dispatch_idle_ms", t) == pytest.approx(25e-3 / 2)
    assert read("rns_dispatch_ms", t) == pytest.approx(27e-3 / 2)
    assert read("rebuilds_per_request", t) == 0.5


def test_readers_without_builds_or_rns():
    t = synthetic([h for h in HOST if not h[2].startswith(("aloha.build.", "aloha.rns."))])
    assert read("rebuilds_per_request", t) == 0.0
    assert read("rns_dispatch_ms", t) == 0.0
    assert read("dispatch_ms", t) == pytest.approx(104e-3 / 2)


@pytest.mark.parametrize("host", [[h for h in HOST if not h[2].startswith("aloha.")],
                                  [h for h in HOST if h[2] == "aloha.build.library"]],
                         ids=["no_aloha_span", "only_outside_the_window"])
def test_silent_without_the_programs_spans(host):
    t = synthetic(host)
    assert [read(m, t) for m in SPAN_METRICS] == [None] * 4


def test_silent_on_a_trace_of_a_program_without_spans():
    """The hand-made trace in torch.profiler's format has the harness's
    spans only, as a program without its own would give."""
    t = trace.load(DATA, trace.families(harness.ROOT / harness.DATA / "kernels"), {}, {})
    assert [read(m, t) for m in SPAN_METRICS] == [None] * 4


def test_overlap():
    assert spans.overlap_us([[0, 3], [5, 8]], [[2, 6], [7, 20]]) == 1 + 1 + 1
    assert spans.overlap_us([], [[0, 1]]) == 0


def test_traced_run_reports_the_span_metrics(tmp_path):
    """A traced run of the program on the CPU (n = 1024, B = 4): every
    span metric read, and no cache built again after the warm-up."""
    root = small_root(tmp_path)
    r = harness.run(harness.load_cell("rotsum.b256", root), 2 ** 33 + 5, 0.5, True, "cpu", 0.0,
                    log=lambda m: None)
    assert r["correct"], r
    got = {m: r["metrics"][m]["value"] for m in SPAN_METRICS}
    assert got["rebuilds_per_request"] == 0
    assert 0 < got["rns_dispatch_ms"] < got["dispatch_ms"]
    assert 0 < got["dispatch_idle_ms"] <= got["dispatch_ms"]
