"""App shell: scene -> BVH build -> frames (render modes or path-traced)
-> PNG output.

Port of ``tpu_raytracing/app/main.py`` (``load_scene``, ``build_accel``,
``orbit_camera``, ``main``) for ``--tracer scalar``, ``wide``, ``split`` or
``lane``, ``--type sah|bottom-up``, ``--pairs``, ``--splits``,
``--render-mode``, ``--cycle-modes``, ``--bounces N`` and a positional OBJ
file (``scene/objio.py:load_obj``). Flags the port cannot honour yet raise
"not yet ported"; nothing falls back to another path.

    python -m tpu_raytracing_torch.app.main      # the reference's defaults:
        # cornell, --type sah, --tracer wide, --bounces 0, --render-mode 0,
        # 1024x768, out/frame0000_mode0.png
    python -m tpu_raytracing_torch.app.main --scene terrain:1000000 \\
        --type sah --pairs --tracer split --bounces 1 \\
        --width 1024 --height 1024 --frames 2 --output out

As in the reference, frame 0 builds the ``--type`` tree (the binned-SAH
tree, ``bvh/sah.py:build_sah_auto``, or the Karras LBVH) for every tracer,
timed by ``StageTimer``, and prints its "Hierarchy stats" and any
``verify_hierarchy`` error (src/main.cu:248-259). ``--tracer wide`` (the
default) collapses that tree to fat 8-wide rows (``bvh/wide.py:
build_wide_fat``, after ``ops/fat_traverse.py:check_stack_depth``) and
traces them with K6's counting instantiation over 8 x 8 screen tiles
(``trace/wide_fat.py:make_tiled_fat_tracer``). ``--tracer scalar`` traces
that tree with ``trace_rays``. ``--tracer split`` traces its own build
with K1: with ``--type sah`` the SAH tree in the split format
(``bvh/split_convert.py:build_sah_split_auto``), with ``--type bottom-up``
the bucket build. ``--tracer lane`` traces a treelet BVH over the bucket
front (``bvh/treelet.py:build_treelet_auto``) with the per-ray treelet
tracer (K5, wave driver), whatever the ``--type``, as the reference does.
With ``--bounces 0`` each frame renders ``--render-mode`` (every mode with
``--cycle-modes``) through ``trace/render.py:render_frame`` and the
tracer's closest-hit form, and prints the first frame's "Total number of
box tests"; with ``--bounces N`` it path-traces (``trace/pathtrace.py``).
The wide and scalar tracers need 8-divisible frames: otherwise the app
warns and traces with ``scalar``, as the reference does. ``--splits``
reaches both SAH builds; with ``--debug-checks`` every build runs its
invariants on the host.
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np
import torch

from tpu_raytracing_torch.app.args import parse_cmd
from tpu_raytracing_torch.bvh import bucket, lbvh, sah, split_convert, wide
from tpu_raytracing_torch.bvh.treelet import build_treelet_auto
from tpu_raytracing_torch.bvh.verify import count_nodes, verify_hierarchy
from tpu_raytracing_torch.ops.fat_traverse import check_stack_depth
from tpu_raytracing_torch.scene import camera as cam
from tpu_raytracing_torch.scene import procedural
from tpu_raytracing_torch.scene.objio import load_obj
from tpu_raytracing_torch.scene.types import scene_to_device
from tpu_raytracing_torch.trace.lane_trace import make_lane_tracer
from tpu_raytracing_torch.trace.modes import BuildType, RenderType
from tpu_raytracing_torch.trace.pathtrace import path_trace
from tpu_raytracing_torch.trace.render import render_frame
from tpu_raytracing_torch.trace.split_trace import LEAFW, make_frame_tracers
from tpu_raytracing_torch.trace.traverse import pack_bvh, pack_pairs, trace_rays
from tpu_raytracing_torch.trace.wide_fat import make_tiled_fat_tracer
from tpu_raytracing_torch.utils.png import write_png
from tpu_raytracing_torch.utils.timing import FPSCounter, StageTimer


def load_scene(args):
    if args.filename:
        return load_obj(args.filename)
    spec = args.scene or "cornell"
    if spec == "cornell":
        return procedural.cornell_box()
    if spec.startswith("sphere"):
        sub = int(spec.split(":")[1]) if ":" in spec else 4
        return procedural.sphere_scene(sub)
    if spec.startswith("soup"):
        n = int(spec.split(":")[1]) if ":" in spec else 100000
        return procedural.random_triangle_soup(n)
    if spec.startswith("terrain"):
        n = int(spec.split(":")[1]) if ":" in spec else 1_000_000
        return procedural.terrain(n)
    raise SystemExit(f"unknown scene '{spec}'")


PORTED_TRACERS = ("scalar", "wide", "split", "lane")


def _require_ported(args) -> None:
    """Raise for every flag whose path the port does not have yet."""
    missing = list(args.unported)
    if args.tracer not in PORTED_TRACERS:
        missing.append(f"--tracer {args.tracer}")
    if args.build_type not in (BuildType.SAH, BuildType.BOTTOM_UP):
        missing.append(f"--type {args.build_type.value}")
    if missing:
        raise NotImplementedError(f"not yet ported: {', '.join(missing)}")


def orbit_camera(camera, scene, frame, num_frames):
    camera.yaw = math.pi / 2 + 2 * math.pi * frame / max(num_frames, 1)
    return cam.update_camera(camera)


def build_accel(triangles, args, timer: StageTimer):
    """The frame-0 ``--type`` build, stage-timed as the reference's run()
    report, and its hierarchy validation (src/main.cu:248-259). Returns
    (BVH, TrianglePairs)."""
    if args.build_type == BuildType.SAH:
        bvh, pairs = timer.run("SharedTaskBuild     ", sah.build_sah_auto, triangles,
                               args.pairs, args.splits, debug=args.debug_checks)
    else:
        bvh, pairs = timer.run("BottomUpBuild       ", lbvh.build_lbvh, triangles, args.pairs)
    stats = count_nodes(bvh)
    print("Hierarchy stats")
    print(f"  num nodes:      {stats.num_nodes}")
    print(f"  num tree nodes: {stats.num_tree_nodes}")
    print(f"  num leaf nodes: {stats.num_leaf_nodes}")
    for e in verify_hierarchy(bvh):
        print(f"Error: Invalid hierarchy; aabb inclusion check failed on index {e}",
              file=sys.stderr)
    return bvh, pairs


def build_trav(args, triangles, bvh=None, pairs=None, timer: StageTimer = None):
    """The traversal structure for ``args.tracer`` and the tracers that
    serve it: (trav, packed, ``path_trace`` keyword arguments; ``tracer``
    is the closest-hit tracer the render modes use). The scalar and wide
    tracers take the frame-0 tree (``bvh``, ``pairs``); ``timer`` times
    the wide tracer's collapse."""
    if args.tracer == "scalar":
        return pack_bvh(bvh), pack_pairs(pairs), dict(tracer=trace_rays)
    if args.tracer == "wide":
        check_stack_depth(bvh)
        packed = pack_pairs(pairs)
        timer = timer or StageTimer()
        fat = timer.run("WideFatCollapse     ", wide.build_wide_fat, bvh, packed.rows)
        print("Fat wide BVH")
        print(f"  wide rows:      {int(fat.num_nodes)}")
        # wide=None: the fat rows ride in the trav argument, as in the reference
        return fat, packed, dict(tracer=make_tiled_fat_tracer(None, args.width, args.height,
                                                              8, 8))
    if args.tracer == "lane":
        tb, packed = build_treelet_auto(bucket.split_front(triangles, args.pairs))
        print("Treelet BVH")
        print(f"  treelets:       {int(tb.num_treelets)} (capacity {tb.tables.shape[0]})")
        print(f"  leaf pairs:     {int(tb.num_leaves)}")
        # as the reference app: one closest-hit tracer serves every pass
        return tb, packed, dict(tracer=make_lane_tracer())
    if args.build_type == BuildType.SAH:
        split, packed = split_convert.build_sah_split_auto(
            triangles, args.pairs, LEAFW, args.splits, debug=args.debug_checks)
        split_convert.check_sah_split_capacity(split)
        views, packed, split = split_convert.sah_split_views(split, packed)
    else:
        views, packed, split = bucket.emit_split_views(
            bucket.split_front(triangles, args.pairs), leaf_width=LEAFW,
            debug=args.debug_checks)
        bucket.check_split_capacity(split, triangles.shape[0])
    print("Split BVH")
    print(f"  inner rows:     {int(split.num_inner)}")
    print(f"  leaf pairs:     {int(split.num_leaves)}")
    if args.debug_checks:
        print("debug checks: build invariants OK")
    return views, packed, make_frame_tracers(args.width, args.height)


def main(argv=None) -> dict:
    """Runs the app. Returns what it timed, ``stages`` (StageTimer's (name,
    ms) list) and ``frames`` ((frame, mode or None, ms, file) for every
    image: the render or path trace and its read-back to the host, the
    PNG write excluded), and what it rendered with: ``bvh`` (the frame-0
    tree), ``trav``, ``packed``, ``scene`` (the device scene), ``camera``
    (the last frame's) and ``tracer`` (the closest-hit tracer)."""
    args = parse_cmd(argv)
    _require_ported(args)
    device = torch.device(args.device)
    scene = load_scene(args)
    print("Geometry")
    print(f"  faces:        {scene.num_triangles}")

    dev_scene = scene_to_device(scene, device)
    camera = cam.initialise_camera(scene.aabb_min, scene.aabb_max)
    os.makedirs(args.output, exist_ok=True)
    triangles = torch.as_tensor(scene.triangles, device=device)
    timer = StageTimer(should_print=True)
    fps = FPSCounter()

    bvh, pairs = build_accel(triangles, args, timer)
    # The split and lane tracers pad any resolution to their tiles; the wide
    # (and the reference's packet) tracer needs 8-divisible frames.
    if (args.width % 8 or args.height % 8) and args.tracer not in ("split", "lane"):
        if args.tracer != "scalar":
            print(f"WARNING: {args.width}x{args.height} is not 8-divisible; "
                  f"downgrading --tracer {args.tracer} -> scalar (slow path). "
                  f"Use 8-divisible dimensions for the fast tracers.", file=sys.stderr)
        args.tracer = "scalar"
    trav, packed, tracers = build_trav(args, triangles, bvh, pairs, timer)

    modes = list(RenderType)[:-1] if args.cycle_modes else [args.render_type]
    generator = torch.Generator(device=device).manual_seed(0)
    frames, cam_dev = [], None
    for frame in range(args.frames):
        if args.orbit:
            camera = orbit_camera(camera, scene, frame, args.frames)
        cam_dev = cam.camera_to_device(camera, device)
        for mode in modes:
            t0 = time.perf_counter()
            if args.bounces > 0:
                img, rays_traced = path_trace(
                    trav, packed, dev_scene, cam_dev, args.width, args.height,
                    num_bounces=args.bounces, generator=generator, **tracers)
                img = (img * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
                tests = int(rays_traced)
                name = f"frame{frame:04d}_pt.png"
            else:
                img_dev, tests_dev = render_frame(
                    trav, packed, dev_scene, cam_dev, args.width, args.height, mode,
                    tracer=tracers["tracer"])
                img = img_dev.cpu().numpy()
                tests = int(tests_dev)
                name = f"frame{frame:04d}_mode{int(mode)}.png"
            frame_ms = (time.perf_counter() - t0) * 1000.0
            path = os.path.join(args.output, name)
            write_png(path, img)
            frames.append((frame, None if args.bounces > 0 else int(mode), frame_ms, path))
            if frame == 0:
                # src/main.cu:180-183 (a path-traced frame counts its rays).
                print(f"Total number of box tests: {tests}")
            print(f"frame {frame} {name}: {frame_ms:.1f} ms on {device}")
        rate = fps.tick()
        if rate is not None:
            print(f"fps: {rate:.1f}")
    print(f"Wrote {args.frames * len(modes)} frame(s) to {args.output}/")
    return dict(stages=list(timer.stages), frames=frames, bvh=bvh, trav=trav, packed=packed,
                scene=dev_scene, camera=cam_dev, tracer=tracers["tracer"])


if __name__ == "__main__":
    main()
