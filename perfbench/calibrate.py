#!/usr/bin/env python3
"""The readings that a cell's check limit is set from (not run by the
benchmark's own runs).

    python3 perfbench/calibrate.py --workload lampshade.beamphoton --seconds 12 \
        --seeds 12 --control-seeds 3

For each seed, in one process, one run of the cell as `run.py` makes it
(`run.execute`), with a window of ``--seconds``: its compared number is
the program's reading (the lower one: the largest over the seeds). For
the first ``--control-seeds`` seeds the run also computes the control, the
plain reference in bfloat16 (the precision below the float32 that the
renderer states) in the program's place on the same answers, read against
the same reference (the upper one: the smallest over the seeds). One JSON
line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, device: str = "cuda", overrides: dict | None = None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = p.parse_args(argv)
    if CHECKOUT not in sys.path:
        sys.path.insert(0, CHECKOUT)
    from perfbench import run

    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        code, result = run.execute(["--workload", args.workload, "--seed", str(seed),
                                    "--seconds", str(args.seconds), "--trace", "0"],
                                   device, overrides, readings=True,
                                   control=i < args.control_seeds)
        row = {"seed": seed, "code": code}
        if result is not None:
            row.update(correct=result["correct"], attempted=result["attempted"],
                       failed=result["failed"],
                       program=result["check"]["mismatch_share"]["value"],
                       **{k: v["value"] for k, v in result["metrics"].items()})
            row.update(result["readings"])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
