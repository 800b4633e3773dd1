"""One reader a metric, found by the metric's name in BENCHMARK.json.

`read(ctx)` returns the metric's value, or None where it finds nothing to
read (the harness then leaves the metric out).  An end-to-end metric's
reader gets the measured window (`harness.Window`); a per-layer metric's
reader gets the traced requests (`trace.Trace`)."""
