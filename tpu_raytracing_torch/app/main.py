"""App shell: scene -> BVH build -> frames (render modes or path-traced)
-> PNG output.

Port of ``tpu_raytracing/app/main.py`` (``load_scene``, ``build_accel``,
``_profile_split_stages``, ``orbit_camera``, ``main``) with every flag:
``--tracer scalar``, ``packet``, ``wide``, ``split``, ``grid`` or ``lane``,
every ``--type``, ``--pairs``, ``--splits``, ``--grid-scale``,
``--render-mode``, ``--cycle-modes``, ``--bounces N``, ``--animate`` with
``--refit``, ``--profile-build``, ``--interactive`` and a positional OBJ
file (``scene/objio.py:load_obj``).

    python -m tpu_raytracing_torch.app.main      # the reference's defaults:
        # cornell, --type sah, --tracer wide, --bounces 0, --render-mode 0,
        # 1024x768, out/frame0000_mode0.png
    python -m tpu_raytracing_torch.app.main --scene terrain:1000000 \\
        --type sah --pairs --tracer split --bounces 1 \\
        --width 1024 --height 1024 --frames 2 --output out
    python -m tpu_raytracing_torch.app.main --scene terrain:1000000 \\
        --type bottom-up --pairs --tracer split --bounces 1 --animate \\
        --refit --refit-interval 3 --frames 6 --output out

As in the reference, frame 0 builds the ``--type`` tree (``bvh/build.py``:
the binned-SAH tree, the Karras LBVH or the hybrid of the two) for every
tracer, timed by ``StageTimer``, and prints its "Hierarchy stats" and any
``verify_hierarchy`` error (src/main.cu:248-259). ``--tracer wide`` (the
default) collapses that tree to fat 8-wide rows (``bvh/wide.py:
collapse_fat``: ``build_wide_fat`` after ``ops/fat_traverse.py:
check_stack_depth``, on the card ``csrc/wide_collapse.cu``; the span
``build.wide_collapse``) and traces them with K6's counting instantiation
over 8 x 8 screen tiles (``trace/wide_fat.py:make_tiled_fat_tracer``); a
path-traced frame (``--bounces N``) takes ``make_fat_frame_tracers``
instead: K6's any-hit instantiation for both shadow passes, and the bounce
rays traced in the order the compaction leaves them. ``--tracer scalar`` traces
that tree with ``trace_rays``, ``--tracer packet`` with one stack per 8 x 8
screen tile (``trace/packet.py:make_tiled_packet_tracer``). ``--tracer
grid`` builds a uniform grid (``bvh/grid.py:build_grid``) over the
``--type`` build's pair rows, with ``auto_res3`` over the scene's box and
``tier_params(--grid-scale)``, checks its capacity, and traces it with the
DDA tracer (``trace/grid_trace.py``) on every pass. ``--tracer split``
traces its own build with K1: with ``--type sah`` the SAH tree in the split format
(``bvh/split_convert.py:build_sah_split``), otherwise the bucket
build (``bvh/bucket.py:build_bucket_split``). ``--tracer lane`` traces a
treelet BVH over the bucket front (``bvh/treelet.py:build_treelet_auto``)
with the per-ray treelet tracer (K5, ``wave`` rounds), whatever the ``--type``,
as the reference does. With ``--bounces 0`` each frame renders
``--render-mode`` (every mode with ``--cycle-modes``) through
``trace/render.py:render_frame`` and the tracer's closest-hit form, and
prints the first frame's "Total number of box tests"; with ``--bounces N``
it path-traces (``trace/pathtrace.py``). The wide, packet and scalar
tracers need 8-divisible frames: otherwise the app warns and traces with
``scalar``, as the reference does; the split, lane and grid tracers take
any frame. ``--splits`` reaches both SAH builds; with
``--debug-checks`` every build runs its invariants on the host.

``--animate`` moves the geometry every frame after frame 0 by the
reference's wobble at t = 0.1 * frame (``scene/procedural.py:
animate_triangles``, on the device) and rebuilds what the tracer traces:
the ``--type`` tree and its collapse for ``wide``, ``packet`` and
``scalar``, the treelets for ``lane``, the split tree for ``split``, and
for ``grid`` only the grid, from the moved triangles
(``build_grid_from_triangles``, at frame 0's resolution). ``--tracer split
--refit`` runs the quality-guarded refit schedule
(``bvh/refit_schedule.py``) instead, seeded by frame 0's tree: the last
rebuild's pair rows, in their sorted order and at rest (``rest_rows``),
are deformed (``deform_rows``) and the tree refitted, and a full rebuild
runs when the entry-area monitor (``--refit-bound``) or
``--refit-interval`` trips. Each animated frame's build stages are timed
(synchronised) and returned.
``--profile-build`` times the build's stages before the build
(``_profile_build_stages``) and, for the split tracer's bucket build, its
six stages (``_profile_split_stages``). ``--interactive`` renders frames
live in the terminal (``app/interactive.py``) on the app's device.

``--instances N`` (with ``--tracer split`` and ``--bounces N``) path-traces
N instances of the scene, each under its own affine transform
(``scatter_transforms``: a grid with a random turn and scale a copy),
without ever making the instances' world triangles: the scene's split tree
and pair rows are built once (``instance_blas``), the instance level (the
instances' world boxes, inverse transforms and normal matrices,
``instance_level``) on frame 0 and, with ``--animate``, on every frame from
the moved transforms, and every pass runs the instanced tracers
(``make_instanced_tracers``: the candidate sweep over the instances' boxes
and one object-space K1 pass, ``trace/instanced_split.py``).
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from tpu_raytracing_torch.app.args import parse_cmd
from tpu_raytracing_torch.bvh import bucket, build, grid, lbvh, sah, split_convert, wide
from tpu_raytracing_torch.bvh.pairing import pair_vertices
from tpu_raytracing_torch.bvh.refit_schedule import GuardedRefit
from tpu_raytracing_torch.bvh.treelet import build_treelet_auto
from tpu_raytracing_torch.bvh.verify import count_nodes, verify_hierarchy
from tpu_raytracing_torch.scene import camera as cam
from tpu_raytracing_torch.scene import procedural
from tpu_raytracing_torch.scene.objio import load_obj
from tpu_raytracing_torch.scene.types import scene_to_device
from tpu_raytracing_torch.trace import instanced_split
from tpu_raytracing_torch.trace.instanced_split import make_instanced_tracers
from tpu_raytracing_torch.trace.grid_trace import make_grid_tracer
from tpu_raytracing_torch.trace.lane_trace import make_lane_tracer
from tpu_raytracing_torch.trace.modes import BuildType, RenderType
from tpu_raytracing_torch.trace.packet import make_tiled_packet_tracer
from tpu_raytracing_torch.trace.pathtrace import path_trace
from tpu_raytracing_torch.trace.render import render_frame
from tpu_raytracing_torch.trace.split_trace import LEAFW, make_frame_tracers
from tpu_raytracing_torch.trace.traverse import (
    PackedPairs,
    f2i,
    i2f,
    pack_bvh,
    pack_pairs,
    trace_rays,
)
from tpu_raytracing_torch.trace.wide_fat import make_fat_frame_tracers, make_tiled_fat_tracer
from tpu_raytracing_torch.utils import timing
from tpu_raytracing_torch.utils.png import write_png
from tpu_raytracing_torch.utils.timing import FPSCounter, StageTimer, block_until_ready

# The reference's run() stage names of the three build pipelines.
BUILD_STAGES = {BuildType.SAH: "SharedTaskBuild     ",
                BuildType.BOTTOM_UP: "BottomUpBuild       ",
                BuildType.HYBRID: "HybridBuild         "}
# The split, lane and grid tracers' builds of their own structures.
REBUILD_STAGES = {"split": "SplitBuild          ", "lane": "TreeletBuild        ",
                  "grid": "GridBuild           "}
# Seconds of animation a frame (the reference's frame * 0.1).
ANIMATE_DT = 0.1
# --instances: the scatter's spacing in object extents, its scale range, its
# bob in object extents and its turn in rad per second of animation
INSTANCE_SPACING = 1.6
INSTANCE_SCALE = (0.75, 1.25)
INSTANCE_BOB = 0.5
INSTANCE_TURN = 0.2
# --instances: the camera's pitch down over the instances (instances_camera)
INSTANCE_PITCH = 0.6


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


def orbit_camera(camera, scene, frame, num_frames):
    camera.yaw = math.pi / 2 + 2 * math.pi * frame / max(num_frames, 1)
    return cam.update_camera(camera)


def deform_rows(rows: torch.Tensor, t: float) -> torch.Tensor:
    """Pair rows [P, 16] int32 with their four vertices (words 0-11) moved
    by ``procedural.animate_triangles``. The wobble is a function of a
    vertex's own position, so it deforms a tree's sorted rows as it
    deforms the triangles they came from, and a zeroed sentinel row's four
    equal vertices move alike and stay degenerate."""
    v = procedural.animate_triangles(i2f(rows[:, :12]).reshape(-1, 4, 3), t)
    return torch.cat([f2i(v.reshape(-1, 12)), rows[:, 12:]], dim=1)


def rest_rows(rows: torch.Tensor, triangles: torch.Tensor, num_leaves) -> torch.Tensor:
    """Sorted pair rows with their vertices taken again from ``triangles``
    (the rest pose) by each row's primitive ids and rotations: the rows a
    refit deforms, whatever time the tree was built at. Rows past
    ``num_leaves`` stay zero."""
    v = pair_vertices(triangles, *rows[:, 12:16].unbind(dim=1))
    live = torch.arange(rows.shape[0], device=rows.device) < num_leaves
    return torch.where(live[:, None], torch.cat([f2i(v.reshape(-1, 12)), rows[:, 12:]], dim=1),
                       0)


def _profile_build_stages(triangles, args, timer: StageTimer) -> None:
    """The ``--type`` build's front stages, each on its own
    (``--profile-build``, the reference's run() report): pairing (or the
    spatial splits) and the grid partition of the SAH build; the scene box,
    the Morton codes and their sort of the bottom-up build. The hybrid
    build has none."""
    if args.build_type == BuildType.SAH:
        if args.splits:
            from tpu_raytracing_torch.bvh.splits import setup_split_leaves

            leaves, _ = timer.run("setup+splits        ", setup_split_leaves, triangles,
                                  args.pairs)
        else:
            leaves, _ = timer.run("triangle pairing    ", sah.setup_leaves, triangles,
                                  args.pairs)
        timer.run("grid partition      ", sah.grid_partition, leaves)
    elif args.build_type == BuildType.BOTTOM_UP:
        aabb = timer.run("SceneAabb           ", lbvh.scene_aabb, triangles)
        codes = timer.run("GenerateMortonCodes ", lbvh.generate_morton_codes, triangles, *aabb)
        timer.run("RadixSort           ", lbvh.sort_codes, *codes)


def build_accel(triangles, args, timer: StageTimer):
    """The ``--type`` build through ``bvh/build.py:build``, stage-timed as
    the reference's run() report (with ``--profile-build``, its front stages
    first). Returns (BVH, TrianglePairs)."""
    if args.profile_build:
        _profile_build_stages(triangles, args, timer)
    return timer.run(BUILD_STAGES[args.build_type], build.build, triangles, args.build_type,
                     args.pairs, args.splits, debug=args.debug_checks)


def report_hierarchy(bvh) -> None:
    """Frame 0's hierarchy validation (src/main.cu:248-259)."""
    stats = count_nodes(bvh)
    print("Hierarchy stats")
    print(f"  num nodes:      {stats.num_nodes}")
    print(f"  num tree nodes: {stats.num_tree_nodes}")
    print(f"  num leaf nodes: {stats.num_leaf_nodes}")
    for e in verify_hierarchy(bvh):
        print(f"Error: Invalid hierarchy; aabb inclusion check failed on index {e}",
              file=sys.stderr)


def _profile_split_stages(triangles, enable_pairs: bool, leaf_width: int, iters: int = 2):
    """Stage times of the split tracer's bucket build (``--profile-build``
    with ``--tracer split``): the reference's six stages and names.

    As in the reference, stage k's time is the difference between two
    cumulative times, of stages 1..k and of stages 1..k-1, each the mean of
    ``iters`` synchronised runs after a warm one. Eager PyTorch could time
    each stage alone, but ``emit_split`` recomputes the tables,
    classification and range-min table, so only the differences give its
    scatter alone the reference's meaning.
    """
    dev = triangles.device
    lw = leaf_width

    def cum(fn):
        block_until_ready(fn(triangles))
        t0 = time.perf_counter()
        for _ in range(iters):
            block_until_ready(fn(triangles))
        return (time.perf_counter() - t0) / iters * 1000.0

    def front(t):
        return bucket.split_front(t, enable_pairs)

    def tables(t):
        fr = front(t)
        return fr, bucket.leaf_major_tables(fr[0], fr[5], fr[0].shape[0], 8)

    def classify(t):
        fr, (heads, starts, _nxts, counts) = tables(t)
        n = fr[0].shape[0]
        live = torch.arange(n, device=dev) < fr[5]
        return fr, bucket.classify_split(heads, starts, counts, live, fr[5], n, lw)

    def aabb_table(t):
        fr, cls = classify(t)
        return fr, cls, bucket._range_min_table(fr[2], fr[3])

    def emit(t):
        return bucket.emit_split(front(t), leaf_width=lw)

    def views(t):
        return bucket.split_views(*emit(t))

    stages = [("MortonSortFront     ", front), ("BucketTables        ", tables),
              ("Classification      ", classify), ("RangeMinAabbTable   ", aabb_table),
              ("EmitScatter         ", emit), ("KernelViewPrep      ", views)]
    print(f"Split-build stage profile (cumulative-delta, {iters} warm iters)")
    prev = 0.0
    for name, fn in stages:
        ms = cum(fn)
        print(f"{name} time elapsed: {max(ms - prev, 0.0):f}ms")
        prev = ms
    print(f"SplitBuildTotal      time elapsed: {prev:f}ms")


def split_tree(args, triangles):
    """The split tracer's tree over ``triangles`` and its sorted pair rows,
    capacity-checked: the SAH tree in the split format with ``--type sah``,
    else the bucket build. Both carry ``e_ranges`` for ``refit_split``."""
    if args.build_type == BuildType.SAH:
        split, packed = split_convert.build_sah_split(
            triangles, args.pairs, LEAFW, args.splits, debug=args.debug_checks)
        split_convert.check_sah_split_capacity(split)
    else:
        split, packed = bucket.build_bucket_split(triangles, args.pairs, LEAFW,
                                                  debug=args.debug_checks)
        bucket.check_split_capacity(split, triangles.shape[0])
    return split, packed


def split_tree_views(args, split, packed):
    """K1's views of a tree from ``split_tree``, with the tree's stack
    bound."""
    if args.build_type == BuildType.SAH:
        return split_convert.sah_split_views(split, packed)[0]
    return bucket.split_views(split, packed)


def build_trav(args, triangles, bvh=None, pairs=None, timer: StageTimer = None,
               sched: GuardedRefit = None):
    """The traversal structure for ``args.tracer`` and the tracers that
    serve it: (trav, packed, ``path_trace`` keyword arguments; ``tracer``
    is the closest-hit tracer the render modes use). The scalar, packet and
    wide tracers take the ``--type`` tree (``bvh``, ``pairs``), the grid
    tracer its pair rows (``grid_trav``); the split and lane tracers build
    their own. ``timer`` times the wide tracer's collapse and the split,
    lane and grid builds, and a quiet one keeps the structure's printout
    quiet too. ``sched`` is seeded with the split tracer's tree."""
    say = print if timer is None or timer.should_print else (lambda *a, **k: None)
    timer = timer or StageTimer()
    if args.tracer == "scalar":
        return pack_bvh(bvh), pack_pairs(pairs), dict(tracer=trace_rays)
    if args.tracer == "packet":
        return pack_bvh(bvh), pack_pairs(pairs), dict(
            tracer=make_tiled_packet_tracer(args.width, args.height, 8, 8))
    if args.tracer == "grid":
        return grid_trav(args, triangles, pairs, timer, say)
    if args.tracer == "wide":
        packed = pack_pairs(pairs)

        def collapse():
            with timing.span("build.wide_collapse"):
                return wide.collapse_fat(bvh, packed.rows)

        fat = timer.run("WideFatCollapse     ", collapse)
        say("Fat wide BVH")
        say(f"  wide rows:      {fat.live_rows}")
        # wide=None: the fat rows ride in the trav argument, as in the reference
        if args.bounces > 0:
            return fat, packed, make_fat_frame_tracers(args.width, args.height)
        return fat, packed, dict(tracer=make_tiled_fat_tracer(None, args.width, args.height,
                                                              8, 8))
    if args.tracer == "lane":
        tb, packed = timer.run(REBUILD_STAGES["lane"], lambda: build_treelet_auto(
            bucket.split_front(triangles, args.pairs)))
        say("Treelet BVH")
        say(f"  treelets:       {int(tb.num_treelets)} (capacity {tb.tables.shape[0]})")
        say(f"  leaf pairs:     {int(tb.num_leaves)}")
        # as the reference app: one closest-hit tracer serves every pass
        return tb, packed, dict(tracer=make_lane_tracer())
    split, packed = timer.run(REBUILD_STAGES["split"], split_tree, args, triangles)
    views = split_tree_views(args, split, packed)
    if sched is not None:
        # frame 0's tree seeds the schedule: the first animated frame refits
        sched.seed(split, packed)
    say("Split BVH")
    say(f"  inner rows:     {int(split.num_inner)}")
    say(f"  leaf pairs:     {int(split.num_leaves)}")
    if args.debug_checks:
        say("debug checks: build invariants OK")
    return views, packed, make_frame_tracers(args.width, args.height)


def grid_trav(args, triangles, pairs, timer: StageTimer, say=print):
    """The grid tracer's structure: a uniform grid over the ``--type``
    build's pair rows (``pairs``, all rows taken as live, as the reference
    app does) on frame 0, or from ``triangles`` alone
    (``build_grid_from_triangles``) on an animated frame (``pairs`` None),
    at ``args.grid_res`` with ``tier_params(args.grid_scale)``; its capacity
    checked. Returns (grid, packed, ``path_trace`` keyword arguments): one
    closest-hit tracer serves every pass, as in the reference app."""
    tiers = grid.tier_params(args.grid_scale)

    def build_it():
        if pairs is None:
            return grid.build_grid_from_triangles(triangles, args.pairs, res=args.grid_res,
                                                  **tiers)
        packed = pack_pairs(pairs)
        return grid.build_grid(packed.rows, packed.rows.shape[0], res=args.grid_res,
                               **tiers), packed

    ugrid, packed = timer.run(REBUILD_STAGES["grid"], build_it)
    grid.check_grid_capacity(ugrid)
    say("Uniform grid")
    say(f"  resolution:     {ugrid.res[0]}x{ugrid.res[1]}x{ugrid.res[2]}")
    say(f"  refs:           {ugrid.refs.shape[0]}")
    say(f"  big-list rows:  {int(ugrid.num_big)}")
    return ugrid, packed, dict(tracer=make_grid_tracer())


class InstanceBLAS(NamedTuple):
    """What every instance shares: the object's split-tree views (K1's),
    its pair rows and its box."""

    views: tuple
    packed: PackedPairs
    lo: torch.Tensor  # [3]
    hi: torch.Tensor  # [3]


def instance_blas(args, triangles, timer: StageTimer = None) -> InstanceBLAS:
    """The shared object of ``--instances``: the split tracer's tree over
    ``triangles`` (object space, [T, 3, 3]) and its pair rows, built once
    (timed as ``SplitBuild``), and the triangles' box."""
    timer = timer or StageTimer()
    split, packed = timer.run(REBUILD_STAGES["split"], split_tree, args, triangles)
    flat = triangles.reshape(-1, 3)
    return InstanceBLAS(split_tree_views(args, split, packed), packed, flat.amin(dim=0),
                        flat.amax(dim=0))


def instance_level(blas: InstanceBLAS, transforms: torch.Tensor):
    """A frame's instance level from its transforms ([I, 3, 4] float32,
    world <- object, on the device): the instances' world boxes, inverse
    transforms and normal matrices over the shared ``blas``
    (``instanced_split.build_instanced_split``), what the instanced tracers
    and ``path_trace`` take as ``trav``."""
    return instanced_split.build_instanced_split(blas.views, blas.packed, blas.lo, blas.hi,
                                                 transforms)


def instances_camera(lo, hi) -> cam.Camera:
    """The ``--instances`` camera over the instances' world box (``lo``,
    ``hi``): ``initialise_camera``'s depth and step, from above the box's
    near edge, looking along +z and ``INSTANCE_PITCH`` down (the box's
    centre, where ``initialise_camera`` puts it, would look along a row of
    instances)."""
    camera = cam.initialise_camera(lo, hi)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    camera.position = np.array([(lo[0] + hi[0]) / 2, hi[1] + 0.35 * (hi[2] - lo[2]), lo[2]],
                               np.float32)
    camera.yaw, camera.pitch = 0.0, INSTANCE_PITCH
    return cam.update_camera(camera)


def scatter_transforms(count: int, lo, hi, t: float, seed: int = 0) -> np.ndarray:
    """[count, 3, 4] float32 (world <- object): the app's ``--instances``
    scatter of an object with box (``lo``, ``hi``) at animation time ``t``.
    Copies sit on a square grid in x and z, ``INSTANCE_SPACING`` object
    extents apart, each turned about y by a random angle and scaled by a
    random factor in ``INSTANCE_SCALE`` (drawn from ``seed``); with time
    each bobs by ``INSTANCE_BOB`` extents at its own phase and turns by
    ``INSTANCE_TURN`` rad a second."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    extent = float(np.max(hi - lo)) or 1.0
    side = max(int(math.ceil(math.sqrt(count))), 1)
    k = np.arange(count)
    grid = (np.stack([k % side, k // side], 1) - (side - 1) / 2.0) * INSTANCE_SPACING * extent
    yaw = rng.uniform(0.0, 2.0 * math.pi, count) + INSTANCE_TURN * t
    scale = rng.uniform(*INSTANCE_SCALE, count)
    phase = rng.uniform(0.0, 2.0 * math.pi, count)
    c, s = np.cos(yaw) * scale, np.sin(yaw) * scale
    out = np.zeros((count, 3, 4), np.float64)
    out[:, 0, 0], out[:, 0, 2], out[:, 2, 0], out[:, 2, 2] = c, s, -s, c
    out[:, 1, 1] = scale
    centre = (lo + hi) / 2.0
    out[:, :, 3] = -np.einsum("iab,b->ia", out[:, :, :3], centre)
    out[:, 0, 3] += grid[:, 0]
    out[:, 1, 3] += INSTANCE_BOB * extent * np.sin(t + phase)
    out[:, 2, 3] += grid[:, 1]
    return out.astype(np.float32)


def animated_trees(args, triangles0, t: float, views, sched: GuardedRefit, rest: dict):
    """The structures an animated frame traces at time ``t``: the geometry
    ``triangles0`` moved by ``procedural.animate_triangles``, then the
    ``--refit`` schedule's step (``sched``, None without ``--refit``) on
    ``views``' tree, or a full rebuild of what the tracer traces. Returns
    (trav, packed, bvh or None, record), the record holding the frame's
    kind (``refit`` or ``rebuild``), its synchronised stage times and, for
    a refit, its surface-area ratio as a device scalar (read by nobody
    here: the schedule reads it one frame later).

    A refit deforms the rest pose of the last rebuild's rows
    (``rest_rows``, kept in ``rest`` from one rebuild to the next), so a
    refitted frame's geometry is the rebuilt frame's at the same t. (The
    reference deforms the rebuild's rows themselves, which after a rebuild
    at t > 0 moves each vertex twice.)"""
    timer = StageTimer()
    triangles = timer.run("Animate             ", procedural.animate_triangles, triangles0, t)
    record = dict(t=t, kind="rebuild", stages=timer.stages, sa_ratio=None)
    bvh = None
    if sched is not None:
        with timer.stage("DeformRows          ") as out:
            if rest.get("rebuild") != sched.rebuild_count:
                rest.update(rebuild=sched.rebuild_count,
                            rows=rest_rows(sched.rows0, triangles0, sched.split0.num_leaves))
            rows_t = out["value"] = deform_rows(rest["rows"], t)
        with timer.stage("RefitSchedule       ") as out:
            split, packed, rebuilt = sched.step(triangles, rows_t)
            if rebuilt:
                print(f"refit schedule: full rebuild at t={t:.2f} (#{sched.rebuild_count})")
                trav = split_tree_views(args, split, packed)
            else:
                # a refit keeps the topology, so the tree keeps the stack
                # bound of its last rebuild
                trav = bucket.split_views(split, packed, views[2])
                record.update(kind="refit", sa_ratio=sched.pending_sa / max(sched.sa0, 1e-30))
            out["value"] = trav
    elif args.tracer in ("split", "lane", "grid"):
        trav, packed, _ = build_trav(args, triangles, timer=timer)
    else:
        bvh, pairs = build_accel(triangles, args, timer)
        trav, packed, _ = build_trav(args, triangles, bvh, pairs, timer)
    return trav, packed, bvh, record


def _interactive(args, camera, trav, packed, dev_scene, tracers, device):
    from tpu_raytracing_torch.app.interactive import interactive_loop

    def render_one(host_cam, mode):
        cd = cam.camera_to_device(host_cam, device)
        if args.bounces > 0:
            img, _ = path_trace(trav, packed, dev_scene, cd, args.width, args.height,
                                num_bounces=args.bounces,
                                generator=torch.Generator(device=device).manual_seed(0),
                                **tracers)
            return (img * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
        img_dev, _ = render_frame(trav, packed, dev_scene, cd, args.width, args.height, mode,
                                  tracer=tracers["tracer"])
        return img_dev.cpu().numpy()

    return interactive_loop(args, camera, render_one)


def main(argv=None) -> dict:
    """Runs the app. Returns what it timed, ``stages`` (StageTimer's (name,
    ms) list of frame 0's builds), ``frames`` ((frame, mode or None, ms,
    file) for every image: the render or path trace and its read-back to
    the host, the PNG write excluded) and ``animated`` (for each animated
    frame, ``animated_trees``' record, or with ``--instances`` the instance
    level's, and its ``frame``), and what it rendered with: ``bvh`` (the
    last ``--type`` tree built), ``trav``, ``packed``, ``scene`` (the device
    scene), ``camera`` (the last frame's), ``tracer`` (the closest-hit
    tracer) and ``sched`` (``--refit``'s schedule, or None)."""
    args = parse_cmd(argv)
    if args.instances and (args.tracer != "split" or args.bounces < 1):
        raise SystemExit("--instances needs --tracer split and --bounces N >= 1")
    device = torch.device(args.device)
    scene = load_scene(args)
    # the grid's resolution, from the scene's box on frame 0 (animated
    # frames keep it)
    args.grid_res = grid.auto_res3(scene.aabb_max - scene.aabb_min, scene.num_triangles,
                                   scale=args.grid_scale)
    print("Geometry")
    print(f"  faces:        {scene.num_triangles}")

    dev_scene = scene_to_device(scene, device)
    camera = cam.initialise_camera(scene.aabb_min, scene.aabb_max)
    os.makedirs(args.output, exist_ok=True)
    triangles = torch.as_tensor(scene.triangles, device=device)
    timer = StageTimer(should_print=True)
    fps = FPSCounter()

    bvh, pairs = build_accel(triangles, args, timer)
    report_hierarchy(bvh)
    # The split and lane tracers pad any resolution to their tiles and the
    # grid tracer takes any order; the wide and packet tracers need
    # 8-divisible frames.
    if (args.width % 8 or args.height % 8) and args.tracer not in ("grid", "split", "lane"):
        if args.tracer != "scalar":
            print(f"WARNING: {args.width}x{args.height} is not 8-divisible; "
                  f"downgrading --tracer {args.tracer} -> scalar (slow path). "
                  f"Use 8-divisible dimensions for the fast tracers.", file=sys.stderr)
        args.tracer = "scalar"
    if args.refit and args.tracer != "split":
        print("WARNING: --refit needs --tracer split; animated frames "
              "will run the full rebuild path.", file=sys.stderr)
    if args.profile_build and args.tracer == "split" and args.build_type != BuildType.SAH:
        _profile_split_stages(triangles, args.pairs, LEAFW)
    sched = None
    if args.refit and args.tracer == "split":
        sched = GuardedRefit(rebuild=lambda tris: split_tree(args, tris),
                             quality_bound=args.refit_bound, max_interval=args.refit_interval)
    if args.instances:
        blas = instance_blas(args, triangles, timer)

        def instances_at(t):
            tf = scatter_transforms(args.instances, scene.aabb_min, scene.aabb_max, t)
            return timer.run("InstanceLevel       ", instance_level, blas,
                             torch.as_tensor(tf, device=device))

        trav, packed, tracers = instances_at(0.0), blas.packed, make_instanced_tracers()
        print(f"Instances: {args.instances} of {scene.num_triangles} triangles")
        camera = instances_camera(trav.wmin.amin(dim=0).cpu().numpy(),
                                  trav.wmax.amax(dim=0).cpu().numpy())
    else:
        trav, packed, tracers = build_trav(args, triangles, bvh, pairs, timer, sched)
    result = dict(stages=list(timer.stages), frames=[], animated=[], bvh=bvh, trav=trav,
                  packed=packed, scene=dev_scene, camera=None,
                  tracer=tracers["tracer"], sched=sched)
    if args.interactive:
        result["camera"] = _interactive(args, camera, trav, packed, dev_scene, tracers, device)
        return result

    modes = list(RenderType)[:-1] if args.cycle_modes else [args.render_type]
    generator = torch.Generator(device=device).manual_seed(0)
    frames, cam_dev, rest = result["frames"], None, {}
    for frame in range(args.frames):
        if args.orbit:
            camera = orbit_camera(camera, scene, frame, args.frames)
        built = ""
        if args.animate and frame > 0 and args.instances:
            n_stages = len(timer.stages)
            trav = instances_at(frame * ANIMATE_DT)
            record = dict(t=frame * ANIMATE_DT, kind="instances",
                          stages=timer.stages[n_stages:])
            result["animated"].append(dict(frame=frame, **record))
            built = f", instance level {record['stages'][0][1]:.1f} ms"
        elif args.animate and frame > 0:
            trav, packed, new_bvh, record = animated_trees(
                args, triangles, frame * ANIMATE_DT, trav, sched, rest)
            bvh = new_bvh if new_bvh is not None else bvh
            result["animated"].append(dict(frame=frame, **record))
            built = (f", {record['kind']} " + " + ".join(f"{name.strip()} {ms:.1f}"
                                                         for name, ms in record["stages"])
                     + " ms")
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
            print(f"frame {frame} {name}: {frame_ms:.1f} ms on {device}{built}")
        rate = fps.tick()
        if rate is not None:
            print(f"fps: {rate:.1f}")
    print(f"Wrote {args.frames * len(modes)} frame(s) to {args.output}/")
    result.update(bvh=bvh, trav=trav, packed=packed, camera=cam_dev)
    return result


if __name__ == "__main__":
    main()
