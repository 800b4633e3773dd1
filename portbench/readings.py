"""The readings that each compared number's limit is set from, on the card.

    python -m portbench.readings --workload <cell> --seeds 11 12 ... [--control] [--seconds 3]

Runs the cell once a seed in one process (set-up, a short window at the
cell's own load that keeps as many answers as a run does, the check) and
prints each seed's numbers as a JSON line, then their largest (sound runs:
the lower reading) or, with --control, their smallest (the reference with
its products in float64 in the system's place: the upper reading).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seen = []
    for seed in args.seeds:
        r = harness.run(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                        control=args.control, log=lambda m: print(m, file=sys.stderr))
        numbers = {k: c["value"] for k, c in r["checks"].items()}
        seen.append(numbers)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": args.control,
                          "correct": r["correct"], "requests": r["attempted"],
                          "numbers": numbers}), flush=True)
    pick = min if args.control else max
    print(json.dumps({"workload": cell.name, "control": args.control, "seeds": len(seen),
                      ("upper" if args.control else "lower"):
                      {k: pick(s[k] for s in seen) for k in seen[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
