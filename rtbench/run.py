"""Run one benchmark cell of the PyTorch and CUDA ray tracer on the card.

    python3 rtbench/run.py --workload terrain1m-split.orbit --seed 7 \\
        --seconds 20 --trace 0

Prints, as its last line on standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit, which also end standard error. Exits non-zero
without a result where there is no CUDA card, fewer cards than the cell
asks for, no program beside the benchmark, or where the JAX package or
JAX was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PROGRAM = "tpu_raytracing_torch"


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not (REPO / PROGRAM / "__init__.py").is_file():
        print(f"rtbench: no {PROGRAM} package beside the benchmark", file=sys.stderr)
        return 2
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    # nvcc's scratch files: the given TMPDIR, else a fixed directory here
    if not os.environ.get("TMPDIR"):
        tmp = REPO / "rtbench" / ".tmp"
        tmp.mkdir(exist_ok=True)
        os.environ["TMPDIR"] = str(tmp)

    import torch

    from rtbench import harness

    chips = harness.resolve(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rtbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    with contextlib.redirect_stdout(sys.stderr):
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  device="cuda", t_process=T_PROCESS)
    readings = result.pop("_readings")
    if readings["forbidden"]:
        print(f"rtbench: the run loaded {', '.join(readings['forbidden'])}", file=sys.stderr)
        return 4
    print(f"rtbench: set-up {readings['setup_s']:.2f} s, window {readings['window_s']:.2f} s "
          f"({readings['frames']} frames), comparison {readings['judge_s']:.2f} s",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
