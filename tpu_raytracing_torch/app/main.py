"""App shell: scene -> BVH build -> path-traced frames -> PNG output.

Port of the scalar, split and lane paths of ``tpu_raytracing/app/main.py``
(``load_scene``, ``orbit_camera``, ``main`` with ``--tracer scalar``,
``split`` or ``lane``, ``--type sah|bottom-up``, ``--pairs``, ``--splits``,
``--bounces N``). Flags the port cannot honour yet raise "not yet ported";
nothing falls back to another path.

    python -m tpu_raytracing_torch.app.main --scene terrain:1000000 \\
        --type sah --pairs --tracer split --bounces 1 \\
        --width 1024 --height 1024 --frames 2 --output out

As in the reference, frame 0 builds the ``--type`` tree (the binned-SAH
tree, ``bvh/sah.py:build_sah_auto``, or the Karras LBVH) for every tracer
and prints its "Hierarchy stats" and any ``verify_hierarchy`` error
(src/main.cu:248-259). ``--tracer scalar`` traces that tree with
``trace_rays`` on every pass. ``--tracer split`` traces its own build with
K1: with ``--type sah`` the SAH tree in the split format
(``bvh/split_convert.py:build_sah_split_auto``), with ``--type bottom-up``
the bucket build. ``--tracer lane`` traces a treelet BVH over the bucket
front (``bvh/treelet.py:build_treelet_auto``) with the per-ray treelet
tracer (K5, wave driver) on every pass, the NEE passes included, whatever
the ``--type``, as the reference does. ``--splits`` reaches both SAH
builds; with ``--debug-checks`` every build runs its invariants on the
host.
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np
import torch

from tpu_raytracing_torch.app.args import parse_cmd
from tpu_raytracing_torch.bvh import bucket, lbvh, sah, split_convert
from tpu_raytracing_torch.bvh.treelet import build_treelet_auto
from tpu_raytracing_torch.bvh.verify import count_nodes, verify_hierarchy
from tpu_raytracing_torch.scene import camera as cam
from tpu_raytracing_torch.scene import procedural
from tpu_raytracing_torch.scene.types import scene_to_device
from tpu_raytracing_torch.trace.lane_trace import make_lane_tracer
from tpu_raytracing_torch.trace.modes import BuildType
from tpu_raytracing_torch.trace.pathtrace import path_trace
from tpu_raytracing_torch.trace.split_trace import LEAFW, make_frame_tracers
from tpu_raytracing_torch.trace.traverse import pack_bvh, pack_pairs, trace_rays
from tpu_raytracing_torch.utils.png import write_png


def load_scene(args):
    if args.filename:
        raise NotImplementedError("OBJ scenes are not yet ported (scene/objio.py)")
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


PORTED_TRACERS = ("scalar", "split", "lane")


def _require_ported(args) -> None:
    """Raise for every flag whose path the port does not have yet."""
    missing = list(args.unported)
    if args.tracer not in PORTED_TRACERS:
        missing.append(f"--tracer {args.tracer}")
    if args.build_type not in (BuildType.SAH, BuildType.BOTTOM_UP):
        missing.append(f"--type {args.build_type.value}")
    if args.bounces < 1:
        missing.append("--bounces 0 (the render modes)")
    if missing:
        raise NotImplementedError(f"not yet ported: {', '.join(missing)}")


def orbit_camera(camera, scene, frame, num_frames):
    camera.yaw = math.pi / 2 + 2 * math.pi * frame / max(num_frames, 1)
    return cam.update_camera(camera)


def build_accel(triangles, args):
    """The frame-0 ``--type`` build and its hierarchy validation
    (src/main.cu:248-259). Returns (BVH, TrianglePairs)."""
    if args.build_type == BuildType.SAH:
        bvh, pairs = sah.build_sah_auto(triangles, args.pairs, args.splits,
                                        debug=args.debug_checks)
    else:
        bvh, pairs = lbvh.build_lbvh(triangles, args.pairs)
    stats = count_nodes(bvh)
    print("Hierarchy stats")
    print(f"  num nodes:      {stats.num_nodes}")
    print(f"  num tree nodes: {stats.num_tree_nodes}")
    print(f"  num leaf nodes: {stats.num_leaf_nodes}")
    for e in verify_hierarchy(bvh):
        print(f"Error: Invalid hierarchy; aabb inclusion check failed on index {e}",
              file=sys.stderr)
    return bvh, pairs


def build_trav(args, triangles, bvh=None, pairs=None):
    """The traversal structure for ``args.tracer`` and the tracers that
    serve it: (trav, packed, ``path_trace`` keyword arguments). The scalar
    tracer takes the frame-0 tree (``bvh``, ``pairs``)."""
    if args.tracer == "scalar":
        return pack_bvh(bvh), pack_pairs(pairs), dict(tracer=trace_rays)
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


def main(argv=None):
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

    bvh, pairs = build_accel(triangles, args)
    trav, packed, tracers = build_trav(args, triangles, bvh, pairs)
    generator = torch.Generator(device=device).manual_seed(0)
    for frame in range(args.frames):
        if args.orbit:
            camera = orbit_camera(camera, scene, frame, args.frames)
        t0 = time.perf_counter()
        img, rays_traced = path_trace(
            trav, packed, dev_scene, cam.camera_to_device(camera, device),
            args.width, args.height, num_bounces=args.bounces, generator=generator,
            **tracers)
        img = (img * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
        frame_ms = (time.perf_counter() - t0) * 1000.0
        write_png(os.path.join(args.output, f"frame{frame:04d}_pt.png"), np.asarray(img))
        if frame == 0:
            print(f"Total number of rays traced: {int(rays_traced)}")
        print(f"frame {frame}: {frame_ms:.1f} ms on {device}")
    print(f"Wrote {args.frames} frame(s) to {args.output}/")


if __name__ == "__main__":
    main()
