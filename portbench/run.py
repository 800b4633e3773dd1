"""Run one cell of the benchmark once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root, on a machine with the cards the cell asks for;
without them it exits nonzero and prints no result.  The last line of
standard output is one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer metrics),
device, with --trace 1 the breakdown, the card's limits, and last the
numbers compared with their limits, which also end standard error.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

#: top-level modules that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "aloha_tpu")


def forbidden_modules(modules=None) -> list:
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def card_limits() -> dict:
    """The card's name, power limit and clocks as nvidia-smi reads them."""
    q = "name,power.limit,clocks.max.sm,clocks.sm"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    first = (out.stdout.strip().splitlines() or [""])[0]
    return dict(zip(q.split(","), (v.strip() for v in first.split(","))))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    imported = time.perf_counter()
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        return 2
    log(f"interpreter and imports: {imported - STARTED} s")
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED,
                         log=log)
    limits = card_limits()
    log(f"card: {limits}")
    bad = forbidden_modules()
    if bad:
        log(f"modules that no run may load were loaded: {bad}")
        return 3
    checks = result.pop("checks")
    result["card"] = limits
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
