#!/usr/bin/env python3
"""The readings the limits of `correct` are set from: for each seed, one
run of a cell with a short window, the numbers `check.judge` compares for
the program, and the same numbers for the lower-precision control (the
reference computed in float32 put in the program's place: `check.judge`
with `control`). One JSON line a seed; all seeds in one process.

    python3 gjbench/control.py --workload vrp-tw-n1000.ts-sweep \\
        --seeds 11 12 13 --seconds 3
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root, cell, seed, seconds, device):
    """{"program": {number: value}, "control": {number: value}}."""
    from gjbench import check, harness

    st = harness.execute(root, cell, seed, seconds, False, device,
                         time.perf_counter())
    args = (harness.family(st), st["capture"], st["final_row"],
            st["final_score"], st["workload"], st["device"])
    prog = check.judge(*args)
    ctl = check.judge(*args, control=harness.family(st, "float32"))
    return {"program": {k: v["value"] for k, v in prog.items()},
            "control": {k: v["value"] for k, v in ctl.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    for seed in args.seeds:
        out = readings(ROOT, args.workload, seed, args.seconds, "cuda:0")
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)


if __name__ == "__main__":
    main()
