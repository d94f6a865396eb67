"""CLI argument parsing (reference: src/Arguments.cpp:42-63).

Port of ``tpu_raytracing/app/args.py``: the flags of the scalar, split and lane paths
(``--type sah|bottom-up``, ``--pairs``, ``--splits``), with
the reference's defaults and confirmation printout, plus ``--device``. The
reference's other flags are accepted only to be refused: each is recorded
in ``args.unported``, and ``app/main.py`` raises "not yet ported" for them
and for the ``--type`` and ``--tracer`` values the port does not have.
"""

from __future__ import annotations

import argparse

from tpu_raytracing_torch.trace.modes import BuildType

# Reference flags whose paths are not ported yet, with the number of values
# each takes.
UNPORTED_FLAGS = {
    "--render-mode": 1, "--cycle-modes": 0, "--animate": 0, "--refit": 0,
    "--refit-bound": 1, "--refit-interval": 1, "--grid-scale": 1, "--profile-build": 0,
    "--interactive": 0,
}


class _Unported(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        namespace.unported = namespace.unported + [option_string]


def parse_cmd(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu_raytracing_torch",
        description="Ray tracer on PyTorch and CUDA (port of tpu_raytracing)",
    )
    p.add_argument("filename", nargs="?", default=None,
                   help="OBJ scene file (or use --scene)")
    p.add_argument("--type", dest="build_type", default="sah",
                   choices=[b.value for b in BuildType],
                   help="acceleration-structure build pipeline (the port has: sah, bottom-up)")
    p.add_argument("--pairs", action="store_true", help="enable triangle pairing")
    p.add_argument("--splits", action="store_true",
                   help="enable bounded spatial splits (SAH builds only)")
    p.add_argument("--scene", default=None,
                   help="procedural scene: cornell | sphere[:subdiv] | soup:N | terrain:N")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--orbit", action="store_true",
                   help="orbit the camera around the scene across frames")
    p.add_argument("--bounces", type=int, default=0,
                   help="path-trace with N bounces (the port needs N >= 1)")
    p.add_argument("--output", default="out", help="PNG output directory")
    p.add_argument("--tracer", default="wide",
                   choices=["scalar", "packet", "wide", "split", "grid", "lane"],
                   help="traversal kernel (the port has: scalar, split, lane)")
    p.add_argument("--debug-checks", action="store_true",
                   help="run the build invariants on the host and raise on violation")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, or cpu for the plain "
                        "PyTorch kernels)")
    p.set_defaults(unported=[])
    for flag, nargs in UNPORTED_FLAGS.items():
        p.add_argument(flag, action=_Unported, nargs=nargs, help="not yet ported")
    args = p.parse_args(argv)
    args.build_type = BuildType(args.build_type)

    print("Build options")
    print(f"  type:    {args.build_type.value}")
    print(f"  pairs:   {'true' if args.pairs else 'false'}")
    print(f"  splits:  {'true' if args.splits else 'false'}")
    return args
