"""CLI argument parsing (reference: src/Arguments.cpp:42-63).

Port of ``tpu_raytracing/app/args.py``: every flag of the reference, with
its defaults and confirmation printout, plus ``--device``.
"""

from __future__ import annotations

import argparse

from tpu_raytracing_torch.trace.modes import BuildType, RenderType


def parse_cmd(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu_raytracing_torch",
        description="Ray tracer on PyTorch and CUDA (port of tpu_raytracing)",
    )
    p.add_argument("filename", nargs="?", default=None,
                   help="OBJ scene file (or use --scene)")
    p.add_argument("--type", dest="build_type", default="sah",
                   choices=[b.value for b in BuildType],
                   help="acceleration-structure build pipeline")
    p.add_argument("--pairs", action="store_true", help="enable triangle pairing")
    p.add_argument("--splits", action="store_true",
                   help="enable bounded spatial splits (SAH builds only)")
    p.add_argument("--scene", default=None,
                   help="procedural scene: cornell | sphere[:subdiv] | soup:N | terrain:N")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--render-mode", type=int, default=int(RenderType.DEPTH),
                   help="0..8 (reference 'm'-key cycle order)")
    p.add_argument("--cycle-modes", action="store_true",
                   help="render every mode once (the 'm' key loop)")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--orbit", action="store_true",
                   help="orbit the camera around the scene across frames")
    p.add_argument("--animate", action="store_true",
                   help="animate the geometry and rebuild the BVH every frame")
    p.add_argument("--refit", action="store_true",
                   help="with --animate --tracer split: the quality-guarded refit "
                        "schedule: refit the tree's boxes in place every frame, and "
                        "rebuild only when the entry-area monitor or --refit-interval "
                        "trips (bvh/refit_schedule.py)")
    p.add_argument("--refit-bound", type=float, default=1.3,
                   help="with --refit: rebuild when the total entry surface area exceeds "
                        "this ratio of its value at the last rebuild (0 turns it off)")
    p.add_argument("--refit-interval", type=int, default=0,
                   help="with --refit: rebuild at least every N frames (0: no cap)")
    p.add_argument("--bounces", type=int, default=0,
                   help="path-trace with N bounces instead of the render modes")
    p.add_argument("--instances", type=int, default=0,
                   help="with --tracer split and --bounces N: path-trace N instances of the "
                        "scene, each under its own affine transform (the app's scatter, "
                        "app/main.py:scatter_transforms), over one split tree built once; "
                        "with --animate the instances move and only the instance level is "
                        "rebuilt each frame")
    p.add_argument("--output", default="out", help="PNG output directory")
    p.add_argument("--tracer", default="wide",
                   choices=["scalar", "packet", "wide", "split", "grid", "lane"],
                   help="traversal kernel: scalar (the reference's exact order), packet "
                        "(one stack per 8x8 tile), wide (K6 over fat 8-wide rows), split "
                        "(K1 over the split BVH), grid (uniform-grid DDA) or lane (K5 over "
                        "treelets)")
    p.add_argument("--grid-scale", type=float, default=1.0,
                   help="with --tracer grid: cell-size scale (< 1: finer cells; the "
                        "footprint tiers widen with it, bvh/grid.py:tier_params)")
    p.add_argument("--profile-build", action="store_true",
                   help="time each build stage separately (the run() report)")
    p.add_argument("--debug-checks", action="store_true",
                   help="run the build invariants on the host and raise on violation")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, or cpu for the plain "
                        "PyTorch kernels)")
    p.add_argument("--interactive", action="store_true",
                   help="live frames in the terminal: WASD/QE and arrows move the camera, 'm' "
                        "cycles the mode, 'p' saves a PNG, 'x' quits (app/interactive.py)")
    args = p.parse_args(argv)
    args.build_type = BuildType(args.build_type)
    args.render_type = RenderType(args.render_mode)

    print("Build options")
    print(f"  type:    {args.build_type.value}")
    print(f"  pairs:   {'true' if args.pairs else 'false'}")
    print(f"  splits:  {'true' if args.splits else 'false'}")
    return args
