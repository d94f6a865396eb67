"""One tracer signature across the port: ``(trav, pairs, rays, active=None)
-> (HitRecord, TraceStats)``.

Every tracer the app's ``build_trav`` can hand to ``path_trace`` or
``render_frame`` (the scalar ``trace_rays``, the tiled packet tracer, the
grid tracer, the lane tracer, ``make_frame_tracers``' four,
``make_fat_frame_tracers``' four and ``make_tiled_fat_tracer``), and the
BFS and wide-packet tracers, is called on cornell's camera rays with
``active`` as the fourth positional argument and every third ray dead: the
dead rays miss, and some live ones hit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing_torch.app import main as app  # noqa: E402
from tpu_raytracing_torch.app.args import parse_cmd  # noqa: E402
from tpu_raytracing_torch.bvh import bucket, build, grid, wide  # noqa: E402
from tpu_raytracing_torch.bvh.build import BuildType  # noqa: E402
from tpu_raytracing_torch.scene import camera as cam  # noqa: E402
from tpu_raytracing_torch.scene import procedural  # noqa: E402
from tpu_raytracing_torch.trace import wavefront_bfs, wide_packet  # noqa: E402
from tpu_raytracing_torch.trace.brute import HitRecord  # noqa: E402
from tpu_raytracing_torch.trace.ray import generate_primary_rays  # noqa: E402
from tpu_raytracing_torch.trace.traverse import TraceStats, pack_pairs  # noqa: E402
from tpu_raytracing_torch.utils.timing import StageTimer  # noqa: E402

torch.set_num_threads(2)
W, H = 32, 16
FRAME_KEYS = ("tracer", "shadow_tracer", "bounce_tracer", "shadow_tracer_bounce")
CASES = (["scalar", "packet", "grid", "lane"]
         + [f"split.{k}" for k in FRAME_KEYS] + [f"wide.{k}" for k in FRAME_KEYS]
         + ["wide-tiled", "bfs", "wide-packet"])


@pytest.fixture(scope="module")
def scene():
    s = procedural.cornell_box()
    c = cam.camera_to_device(cam.update_camera(cam.initialise_camera(s.aabb_min, s.aabb_max)),
                             torch.device("cpu"))
    return dict(scene=s, tris=torch.from_numpy(s.triangles),
                rays=generate_primary_rays(c, W, H), structs={})


def _app_tracers(scene, tracer: str, bounces: int):
    """(trav, packed, tracers) from the app's ``build_trav``, once a
    configuration."""
    key = (tracer, bounces)
    if key not in scene["structs"]:
        args = parse_cmd(["--scene", "cornell", "--width", str(W), "--height", str(H),
                          "--tracer", tracer, "--bounces", str(bounces), "--type",
                          "bottom-up", "--pairs", "--device", "cpu"])
        s = scene["scene"]
        args.grid_res = grid.auto_res3(s.aabb_max - s.aabb_min, s.num_triangles,
                                       scale=args.grid_scale)  # as the app's main sets it
        bvh, pairs = app.build_accel(scene["tris"], args, StageTimer())
        scene["structs"][key] = app.build_trav(args, scene["tris"], bvh, pairs, StageTimer())
    return scene["structs"][key]


def _tracer(scene, case: str):
    """(trav, pairs, tracer) for one case."""
    if case in ("scalar", "packet", "grid", "lane"):
        trav, packed, tracers = _app_tracers(scene, case, 0)
        return trav, packed, tracers["tracer"]
    if case.startswith("split."):
        trav, packed, tracers = _app_tracers(scene, "split", 1)
        return trav, packed, tracers[case.split(".")[1]]
    if case.startswith("wide."):
        trav, packed, tracers = _app_tracers(scene, "wide", 1)
        return trav, packed, tracers[case.split(".")[1]]
    if case == "wide-tiled":
        trav, packed, tracers = _app_tracers(scene, "wide", 0)
        return trav, packed, tracers["tracer"]
    if case == "bfs":
        split, packed = bucket.build_bucket_split(scene["tris"], True, 16)
        views = wavefront_bfs.prep_bfs_views(split, packed)
        return views, packed, wavefront_bfs.make_bfs_tracer()
    bvh, pairs = build.build(scene["tris"], BuildType.BOTTOM_UP, True)
    return None, pack_pairs(pairs), wide_packet.make_tiled_wide_tracer(wide.build_wide(bvh),
                                                                       W, H)


@pytest.mark.parametrize("case", CASES)
def test_active_is_the_fourth_argument(scene, case):
    trav, pairs, tracer = _tracer(scene, case)
    active = torch.arange(W * H) % 3 != 0
    rec, stats = tracer(trav, pairs, scene["rays"], active)
    assert isinstance(rec, HitRecord) and isinstance(stats, TraceStats)
    assert {f.name: getattr(rec, f.name).shape for f in dataclasses.fields(rec)} == {
        f.name: (W * H,) for f in dataclasses.fields(rec)}
    hit = rec.hit.numpy()
    live = active.numpy()
    assert not hit[~live].any()
    assert hit[live].sum() > W * H // 4
