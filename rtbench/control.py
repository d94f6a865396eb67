"""Readings for the limits of a cell's comparison, many seeds in one
process: for each seed a short run of the cell at its own size, the
program's compared numbers and the control's (the plain reference in
bfloat16 put in the program's place, one precision below the float32 the
configurations state).

    python3 rtbench/control.py --workload terrain1m-split.orbit \\
        --seeds 11,12,13 --seconds 6

Prints one JSON line per seed, then the largest program reading and the
smallest control reading of each number. ``--fault NAME`` plants one of
``faults.py``'s faults in the program first, so that the program's
readings are the fault's. Needs a CUDA card; the benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--no-control", action="store_true", help="the program's readings only")
    p.add_argument("--fault", help="a fault of rtbench/faults.py to plant in the program")
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from rtbench import faults, harness

    if args.fault:
        faults.install(args.fault, setattr)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    lows: dict = {}
    highs: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        with contextlib.redirect_stdout(sys.stderr):
            r = harness.run_cell(args.workload, seed, args.seconds, False, device="cuda",
                                 control_dtype=None if args.no_control else torch.bfloat16)
        rd = r["_readings"]
        print(json.dumps(dict(seed=seed, correct=r["correct"], program=rd["program"],
                              control=rd["control"], frames=rd["frames"])), flush=True)
        for k, v in rd["program"].items():
            lows[k] = max(lows.get(k, v), v)
        for k, v in (rd["control"] or {}).items():
            highs[k] = min(highs.get(k, v), v)
    print(json.dumps(dict(workload=args.workload, fault=args.fault, program_max=lows,
                          control_min=highs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
