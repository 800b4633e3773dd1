"""The trace readers on a small trace in torch.profiler's Chrome format
(data/small_trace.json): two requests in [100, 300) µs, the device busy in
[100, 110), [115, 145) (two kernels that overlap by 5), [220, 282) and
[285, 295)."""

from __future__ import annotations

import pathlib

import pytest

from portbench import harness, roofline, trace

DATA = pathlib.Path(__file__).resolve().parent / "data" / "small_trace.json"
PEAKS = {"hbm_bytes_per_s": 1e12, "int32_ops_per_s": 1e12}
#: bound per request: ks 5 µs (bytes), ntt 2 µs (operations), elementwise 7 µs
WORK = {"ks": (5e6, 1e6), "ntt": (1e6, 2e6), "elementwise": (7e6, 0)}


@pytest.fixture
def t():
    fams = trace.families(harness.ROOT / harness.DATA / "kernels")
    return trace.load(DATA, fams, WORK, PEAKS)


def read(name, t):
    return harness.reader(name)(t)


def test_union():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 8), (9, 9.5)]) == [[0, 3], [5, 8], [9, 9.5]]
    assert trace.clip([[0, 3], [5, 8]], 2, 6) == [[2, 3], [5, 6]]


def test_window_and_busy(t):
    assert t.requests == 2
    assert t.window == (100.0, 300.0)
    assert t.busy == [[100, 110], [115, 145], [220, 282], [285, 295]]
    assert t.busy_us == 112.0
    assert read("device_idle", t) == pytest.approx(44.0)


def test_counts(t):
    assert read("launches_per_request", t) == 2.5  # the kernel outside the window left out
    assert read("transfer_ms", t) == pytest.approx(0.01)


def test_families_and_rooflines(t):
    assert t.family_us("ks") == 50 and t.family_us("ntt") == 10
    assert t.family_us("elementwise") == 35
    assert read("ks_roofline", t) == pytest.approx(20.0)
    assert read("ntt_roofline", t) == pytest.approx(40.0)
    assert read("elementwise_roofline", t) == pytest.approx(40.0)


def test_silent_without_work_or_kernels(t):
    t.work = {"ks": WORK["ks"]}
    assert read("ntt_roofline", t) is None
    t.kernels = [k for k in t.kernels if "ks_" not in k[0]]
    assert read("ks_roofline", t) is None


def test_breakdown(t):
    b = t.breakdown()
    ops = dict(b["device_ops"])
    assert ops["void (anonymous namespace)::ks_tail_kernel<13, 1>(unsigned long const*)"] == \
        pytest.approx(30e-6)
    assert len(ops) == 8
    assert b["idle_gaps"] == [["harness", pytest.approx(83e-6)],
                              ["he_torch.mul_plain/aten::mul", pytest.approx(5e-6)]]


def test_bound_arithmetic():
    """chip_smoke.py's counts: a forward 8192-point transform is
    4096 x 13 x 36 + 8192 x 12 instructions."""
    assert roofline.transform_ops(8192, False) == 4096 * 13 * 36 + 8192 * 12
    assert roofline.transform_ops(8192, True) == 4096 * 13 * 56 + 8192 * 6
    assert roofline.bound_s((3.35e12, 0), roofline.peaks()) == pytest.approx(1.0)


RECORDED = DATA.parent / "dotprod_b4_trace.json.gz"


def test_recorded_trace(tmp_path):
    """A trace recorded on the H100: one dotprod request at B = 4 (the
    profiler's events of the kinds the readers use, names cut to 96
    characters, times from the first event; gzip)."""
    import gzip

    path = tmp_path / "trace.json"
    path.write_bytes(gzip.decompress(RECORDED.read_bytes()))
    cell = harness.load_cell("dotprod.b256")
    cell.traffic = dict(cell.traffic, batch=4)
    t = trace.load(path, trace.families(harness.ROOT / harness.DATA / "kernels"),
                   cell.counts().work(cell.ring, cell.config, cell.traffic), roofline.peaks())
    assert t.requests == 1
    assert read("launches_per_request", t) == 2644
    assert 0 < t.busy_us <= sum(d for _, _, d in t.kernels + t.copies + t.fills) + 1e-6
    assert t.busy_us < t.window_us
    assert 0 < read("transfer_ms", t) < 1
    for fam in ("ks", "ntt", "elementwise"):
        assert 0 < read(f"{fam}_roofline", t) < 100
    assert read("device_idle", t) == pytest.approx(100 * (1 - t.busy_us / t.window_us))
    b = t.breakdown()
    assert len(b["device_ops"]) == len(b["idle_gaps"]) == 10
    assert any("ks_tail_kernel" in name for name, _ in b["device_ops"])
