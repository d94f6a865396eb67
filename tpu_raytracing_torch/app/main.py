"""App shell: scene -> BVH build -> path-traced frames -> PNG output.

Port of the split and lane paths of ``tpu_raytracing/app/main.py``
(``load_scene``, ``orbit_camera``, ``main`` with ``--tracer split`` or
``--tracer lane``, ``--type bottom-up --bounces N``). Flags the port cannot
honour yet raise "not yet ported"; nothing falls back to another path.

    python -m tpu_raytracing_torch.app.main --scene terrain:1000000 \\
        --type bottom-up --pairs --tracer split --bounces 1 \\
        --width 1024 --height 1024 --frames 2 --output out

``--tracer lane`` builds a treelet BVH over the split front
(``bvh/treelet.py:build_treelet_auto``) and traces every pass, the NEE
passes included, with the per-ray treelet tracer (K5, wave driver).

The reference's ``--type bottom-up`` builds a Karras tree only for frame-0
validation and then traces its own bucket build; the port builds only the
bucket tree (with ``--debug-checks`` its invariants run on the host).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from tpu_raytracing_torch.app.args import parse_cmd
from tpu_raytracing_torch.bvh import bucket
from tpu_raytracing_torch.bvh.treelet import build_treelet_auto
from tpu_raytracing_torch.scene import camera as cam
from tpu_raytracing_torch.scene import procedural
from tpu_raytracing_torch.scene.types import scene_to_device
from tpu_raytracing_torch.trace.lane_trace import make_lane_tracer
from tpu_raytracing_torch.trace.modes import BuildType
from tpu_raytracing_torch.trace.pathtrace import path_trace
from tpu_raytracing_torch.trace.split_trace import LEAFW, make_frame_tracers
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


PORTED_TRACERS = ("split", "lane")


def _require_ported(args) -> None:
    """Raise for every flag whose path the port does not have yet."""
    missing = list(args.unported)
    if args.tracer not in PORTED_TRACERS:
        missing.append(f"--tracer {args.tracer}")
    if args.build_type != BuildType.BOTTOM_UP:
        missing.append(f"--type {args.build_type.value}")
    if args.bounces < 1:
        missing.append("--bounces 0 (the render modes)")
    if missing:
        raise NotImplementedError(f"not yet ported: {', '.join(missing)}")


def orbit_camera(camera, scene, frame, num_frames):
    camera.yaw = math.pi / 2 + 2 * math.pi * frame / max(num_frames, 1)
    return cam.update_camera(camera)


def build_trav(args, triangles):
    """The traversal structure for ``args.tracer`` and the tracers that
    serve it: (trav, packed, ``path_trace`` keyword arguments)."""
    front = bucket.split_front(triangles, args.pairs)
    if args.tracer == "lane":
        tb, packed = build_treelet_auto(front)
        print("Hierarchy stats")
        print(f"  treelets:       {int(tb.num_treelets)} (capacity {tb.tables.shape[0]})")
        print(f"  leaf pairs:     {int(tb.num_leaves)}")
        # as the reference app: one closest-hit tracer serves every pass
        return tb, packed, dict(tracer=make_lane_tracer())
    views, packed, split = bucket.emit_split_views(front, leaf_width=LEAFW,
                                                   debug=args.debug_checks)
    bucket.check_split_capacity(split, triangles.shape[0])
    print("Hierarchy stats")
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

    trav, packed, tracers = build_trav(args, triangles)
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
