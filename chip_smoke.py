#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, render.

    python3 chip_smoke.py

Drives ``tpu_raytracing_torch`` only (no JAX, no ``tpu_raytracing``) and
exits non-zero if any phase fails:

1. Device: requires CUDA; prints the card, the device count and
   ``nvidia-smi``'s name and power limit.
2. Build: compiles ``csrc/split_trace.cu`` (K1) and ``csrc/lane_trace.cu``
   (K5) with nvcc, in parallel, into ``tpu_raytracing_torch/build/`` and
   prints the ptxas register and spill lines.
3. Split path: the frame ``bench.py`` times — ``terrain(1_000_000)``,
   aerial camera, per-frame split-BVH rebuild + capacity check,
   fixed-topology refit, the ``tid`` bounce sort from ``build_pair_tid``,
   then a 1024x1024 path-traced frame with 1 bounce: one warm frame and 2
   timed ones. K1's launch count is set to 0 before these frames and read
   after them; every frame must launch K1 at least 4 times, no ray may
   overflow its stack, and the image must be finite with a nonzero mean.
   Two frames with the ``leaf`` sort are timed after, for comparison.
4. K1 against its plain PyTorch version on the card: hit, tri and per-ray
   pop counts must agree on >= 99.99% of rays and t within rtol 1e-5, in
   closest-hit and any-hit, on the sphere and soup(2000) fixtures (camera,
   axis-aligned, random and half-dead ray sets) and on 65,536 live rays
   sampled evenly from each of the 1M frame's four passes, each sample
   with at least one hit. Then both are timed on the 1M bounce pass.
5. Treelet build at 1M: ``build_treelet_auto`` on the phase-3 front (one
   warm build, 2 timed), its capacity check, and ``pair_tid`` equal to
   ``build_pair_tid`` on every pair.
6. Lane path: the app's ``--tracer lane`` path (``app/main.py:build_trav``)
   at 1M, 1024x1024, 1 bounce, wave driver, with phase 3's camera and
   generator seeds: one warm frame and 2 timed. K5's launch count is set
   to 0 before and read after; it must grow on every one of the 4 passes
   of every frame, no ray may be left unfinished, and the image must be
   finite and within 40 dB PSNR of phase 3's split frame.
7. K5 against its plain version on the card, bit for bit on all 8 out rows
   and the whole state, in closest-hit and any-hit and in three launch
   modes (unbudgeted, budget 48, no_switch): on the sphere and soup(2000)
   fixtures with ecap 128 and with ecap 16 (8-pair windows: portals and
   the multi-round cut), and on 65,536 live rays sampled evenly from each
   lane-frame pass. The lane tracer's hits on 4,096 bounce rays are held to
   brute force over the 1M triangles. Then K5 and the plain version are
   timed as one unbudgeted launch on the 1M bounce pass (on the 65,536-ray
   sample instead if the plain version would take over 120 s).

The last two lines of standard output are a JSON summary of the kernels
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

T_PROCESS0 = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_raytracing_torch.app.args import parse_cmd  # noqa: E402
from tpu_raytracing_torch.app.main import build_trav  # noqa: E402
from tpu_raytracing_torch.bvh import bucket, treelet  # noqa: E402
from tpu_raytracing_torch.ops import _cuda_build  # noqa: E402
from tpu_raytracing_torch.scene import camera as cam  # noqa: E402
from tpu_raytracing_torch.scene import procedural  # noqa: E402
from tpu_raytracing_torch.scene.types import scene_to_device  # noqa: E402
from tpu_raytracing_torch.trace import lane_trace, split_trace  # noqa: E402
from tpu_raytracing_torch.trace.brute import brute_force_trace  # noqa: E402
from tpu_raytracing_torch.trace.pathtrace import path_trace  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays, generate_primary_rays  # noqa: E402
from tpu_raytracing_torch.trace.traverse import PackedPairs, f2i, i2f  # noqa: E402

NUM_TRIS = 1_000_000
RES = 1024
BOUNCES = 1
ITERS = 2
SLICE = 65_536
BRUTE_RAYS = 4096
T_RTOL = 1e-5
MIN_AGREE = 0.9999
# Brute force tests each source triangle; the tracers test a pair's second
# triangle as (v2, v1, v3), so a ray at an edge may hit or miss by float32
# rounding, and neighbours sharing an edge tie on t.
BRUTE_AGREE = 0.995
MIN_PSNR = 40.0
PLAIN_LIMIT_S = 120.0
PASSES = ("primary", "primary shadow", "bounce", "bounce shadow")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def aerial_camera(scene, device) -> dict:
    """bench.py:85-91: look down at ~40 degrees from above the terrain."""
    host = cam.initialise_camera(scene.aabb_min, scene.aabb_max)
    host.position = (scene.aabb_max * 0.0).astype("float32")
    host.position[1] = float(scene.aabb_max[1]) * 1.5 + 20.0
    host.position[2] = float(scene.aabb_min[2]) * 0.7
    host.yaw = 0.0
    host.pitch = 0.7
    return cam.camera_to_device(cam.update_camera(host), device)


def sync_ms(t0: float) -> float:
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0


def psnr(a, b) -> float:
    mse = float(((a.clamp(0, 1) - b.clamp(0, 1)) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * float(np.log10(1.0 / mse))


class Capture:
    """Wraps a tracer and keeps the (rays, active) of its last call."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.rays = self.active = None

    def __call__(self, views, packed, rays, active=None):
        self.rays, self.active = rays, active
        return self.tracer(views, packed, rays, active=active)


class PassRecorder:
    """Wraps the lane tracer: for every call, the K5 launches it made, its
    unfinished-ray flag and its (rays, active)."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.calls = []

    def __call__(self, trav, packed, rays, active=None):
        before = lane_trace.launch_count
        rec, stats = self.tracer(trav, packed, rays, active=active)
        self.calls.append(dict(launches=lane_trace.launch_count - before,
                               overflow=stats.overflow, rays=rays, active=active))
        return rec, stats


def frame_fn(trav, packed, dev_scene, camera, device, **tracers):
    """One 1024x1024 path-traced frame with a given seed and camera jitter."""
    def frame(seed, jitter, pair_loc=None, sort_kind=None):
        cam_j = dict(camera)
        cam_j["position"] = camera["position"] + jitter
        return path_trace(trav, packed, dev_scene, cam_j, RES, RES, num_bounces=BOUNCES,
                          generator=torch.Generator(device=device).manual_seed(seed),
                          pair_loc=pair_loc, sort_kind=sort_kind, **tracers)
    return frame


def timed_frames(frame, **kw):
    """ITERS frames with seeds 1.. after the caller's warm frame: (last
    image, ms per frame, rays traced)."""
    total_rays = 0
    t0 = time.perf_counter()
    for i in range(ITERS):
        img, rays_traced = frame(i + 1, (i + 1) * 1e-4, **kw)
        total_rays += int(rays_traced)
    elapsed_ms = sync_ms(t0)
    return img, elapsed_ms / ITERS, total_rays


def split_path(device, card: str, scene, dev_scene, camera, triangles) -> dict:
    """Phase 3: the bench frame end to end."""
    torch.cuda.reset_peak_memory_stats()

    def build(tris):
        return bucket.emit_split_views(bucket.split_front(tris, True),
                                       leaf_width=split_trace.LEAFW)

    front = bucket.split_front(triangles, True)
    views, packed, split = bucket.emit_split_views(front, leaf_width=split_trace.LEAFW)
    bucket.check_split_capacity(split, scene.num_triangles)
    require(split.leaf_width == split_trace.LEAFW, "build/trace leaf width mismatch")
    build(triangles)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ITERS):
        build(triangles + (i + 1) * 1e-5)
    rebuild_ms = sync_ms(t0) / ITERS

    def deform_refit(s, rows, d):
        v = i2f(rows[:, :12]) + d
        return bucket.refit_split(s, PackedPairs(rows=torch.cat([f2i(v), rows[:, 12:]], dim=1)))

    deform_refit(split, packed.rows, 0.0)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ITERS):
        deform_refit(split, packed.rows, (i + 1) * 1e-4)
    refit_ms = sync_ms(t0) / ITERS

    # the bucket tree's tid bounce sort (bench.py:361-378)
    treelet.build_pair_tid(front)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        pair_loc = treelet.build_pair_tid(front)
    pair_tid_ms = sync_ms(t0) / ITERS

    tracers = split_trace.make_frame_tracers(RES, RES)
    captured = {k: Capture(v) for k, v in tracers.items()}
    split_trace.launch_count = 0
    frame = frame_fn(views, packed, dev_scene, camera, device, **captured)
    frame(0, 0.0, pair_loc=pair_loc)
    torch.cuda.synchronize()
    ttff_s = time.perf_counter() - T_PROCESS0
    img, frame_ms, total_rays = timed_frames(frame, pair_loc=pair_loc)
    launches = split_trace.launch_count
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    require(launches >= 4 * (ITERS + 1),
            f"K1 launched {launches} times in {ITERS + 1} frames (< 4 per frame)")
    require(bool(torch.isfinite(img).all()), "frame has non-finite pixels")
    mean = float(img.mean())
    require(mean > 0.0, f"frame mean {mean} is not positive")
    _, leaf_ms, _ = timed_frames(frame_fn(views, packed, dev_scene, camera, device, **tracers),
                                 sort_kind="leaf")
    out = dict(rebuild_ms=rebuild_ms, refit_ms=refit_ms, pair_tid_ms=pair_tid_ms,
               frame_ms=frame_ms, mrays_per_s=total_rays / (frame_ms * ITERS) / 1000.0,
               time_to_first_frame_s=ttff_s, peak_mem_mib=peak_mib,
               leaf_sort_frame_ms=leaf_ms)
    print(f"phase 3: {scene.num_triangles} tris, {int(split.num_inner)} inner rows, "
          f"{RES}x{RES}, {BOUNCES} bounce, tid bounce sort, image mean {mean:.6f}, "
          f"{total_rays} rays in {ITERS} frames")
    for key, val in out.items():
        print(f"  {key} = {val!r}  [{card}]")
    print(f"  K1 launches in {ITERS + 1} main-path frames = {launches}")
    return dict(front=front, views=views, captured=captured, launches=launches, img=img, **out)


class Agreement:
    """Running K1-vs-plain comparison totals."""

    def __init__(self):
        self.max_abs_err = 0.0

    def check(self, label, views, rays, active, any_hit) -> int:
        inner, pairs = views
        ops = split_trace.kernel_operands(rays, active)
        kw = dict(leafw=split_trace.LEAFW, any_hit=any_hit,
                  stack_cap=split_trace._stack_cap(inner.shape[1], pairs.shape[0]))
        kt, ktri, kip, klp, kov = split_trace.split_traverse(inner, pairs, *ops, **kw)
        pt, ptri, pip, plp, pov = split_trace.trace_split_plain(inner, pairs, *ops, **kw)
        torch.cuda.synchronize()
        num = kt.shape[0]
        bad = {
            "hit": int(((ktri >= 0) != (ptri >= 0)).sum()),
            "tri": int((ktri != ptri).sum()),
            "inner_pops": int((kip != pip).sum()),
            "leaf_pops": int((klp != plp).sum()),
        }
        err = (kt - pt).abs()
        bad["t"] = int((err > T_RTOL * pt.abs()).sum())
        self.max_abs_err = max(self.max_abs_err, float(err.max()) if num else 0.0)
        hits = int((ktri >= 0).sum())
        print(f"  {label:<34} any_hit={int(any_hit)} rays={num:>7} hits={hits:>7} "
              f"mismatches={bad} overflow={int(kov)}/{int(pov)}")
        for key, count in bad.items():
            require(count <= (1.0 - MIN_AGREE) * num,
                    f"{label}: K1 and plain disagree on {key} for {count} of {num} rays")
        require(int(kov) == int(pov) == 0, f"{label}: stack overflow")
        return hits


def fixture_rays(scene, device, rng) -> dict:
    """Camera, axis-aligned, random and half-dead ray sets for a fixture."""
    lo, hi = scene.aabb_min.astype(np.float64), scene.aabb_max.astype(np.float64)
    camera = cam.camera_to_device(
        cam.update_camera(cam.initialise_camera(scene.aabb_min, scene.aabb_max)), device)
    primary = generate_primary_rays(camera, 64, 64)
    n = 16
    gx, gz = np.meshgrid(np.linspace(lo[0] + 1e-3, hi[0] - 1e-3, n),
                         np.linspace(lo[2] + 1e-3, hi[2] - 1e-3, n))
    down_o = np.stack([gx.ravel(), np.full(n * n, hi[1] + 1.0), gz.ravel()], 1)
    gy, gz2 = np.meshgrid(np.linspace(lo[1] + 1e-3, hi[1] - 1e-3, n),
                          np.linspace(lo[2] + 1e-3, hi[2] - 1e-3, n))
    side_o = np.stack([np.full(n * n, lo[0] - 1.0), gy.ravel(), gz2.ravel()], 1)
    axis_o = np.concatenate([down_o, side_o])
    axis_d = np.concatenate([np.tile([0.0, -1.0, 0.0], (n * n, 1)),
                             np.tile([1.0, 0.0, 0.0], (n * n, 1))])
    m = 4096
    rand_o = lo + (hi - lo) * rng.random((m, 3))
    rand_d = rng.normal(size=(m, 3))
    rand_d /= np.linalg.norm(rand_d, axis=1, keepdims=True)

    def rays(o, d):
        k = o.shape[0]
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        return Rays(f(o), f(d), f(np.zeros(k)), f(np.full(k, 1e6)))

    half_dead = torch.as_tensor(rng.random(64 * 64) < 0.5, device=device)
    return {"camera": (primary, None), "axis-aligned": (rays(axis_o, axis_d), None),
            "random": (rays(rand_o, rand_d), None), "half-dead": (primary, half_dead)}


def live_sample(rays: Rays, active, size: int = SLICE):
    """Up to ``size`` live rays of a pass, evenly spaced over the live ones
    in the pass's own order; returns (rays, number of live rays)."""
    num = rays.origin.shape[0]
    live = (torch.arange(num, device=rays.origin.device) if active is None
            else torch.nonzero(active).reshape(-1))
    n_live = live.shape[0]
    pick = live if n_live <= size else live[
        torch.linspace(0, n_live - 1, size, device=live.device).round().long()]
    return rays.take(pick), n_live


def event_ms(fn, reps, warm: bool = True):
    """Mean CUDA-event time of ``reps`` calls (after one warm call)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def time_bounce_pass(views, rays: Rays, active, card: str) -> dict:
    """K1 against the plain version on the 1M frame's bounce closest-hit
    pass, timed with CUDA events (K1: mean of 5 launches after a warm-up;
    plain: one run)."""
    inner, pairs = views
    ops = split_trace.kernel_operands(rays, active)
    kw = dict(leafw=split_trace.LEAFW, any_hit=False,
              stack_cap=split_trace._stack_cap(inner.shape[1], pairs.shape[0]))
    ms, kout = event_ms(lambda: split_trace.split_traverse(inner, pairs, *ops, **kw), 5)
    plain_ms, pout = event_ms(lambda: split_trace.trace_split_plain(inner, pairs, *ops, **kw), 1)
    tri_bad = int((kout[1] != pout[1]).sum())
    print(f"  1M bounce pass: {ops[0].shape[0]} rays ({int(active.sum())} live); "
          f"K1 {ms!r} ms, plain {plain_ms!r} ms, tri mismatches {tri_bad}  [{card}]")
    require(tri_bad <= (1.0 - MIN_AGREE) * ops[0].shape[0], "1M bounce pass: K1 != plain")
    return dict(ms=ms, plain_ms=plain_ms)


def k1_checks(device, card: str, split: dict) -> dict:
    """Phase 4."""
    print("phase 4: K1 against its plain version on the card")
    agree = Agreement()
    rng = np.random.default_rng(0)
    for name, scene in (("sphere", procedural.sphere_scene(3)),
                        ("soup2000", procedural.random_triangle_soup(2000, seed=1))):
        tris = torch.as_tensor(scene.triangles, device=device)
        for pairs in (False, True):
            views, _, _ = bucket.emit_split_views(bucket.split_front(tris, pairs),
                                                  leaf_width=split_trace.LEAFW)
            for set_name, (rays, active) in fixture_rays(scene, device, rng).items():
                for any_hit in (False, True):
                    agree.check(f"{name} pairs={int(pairs)} {set_name}", views, rays, active,
                                any_hit)
    cap = split["captured"]
    for key, any_hit in (("tracer", False), ("shadow_tracer", True),
                         ("bounce_tracer", False), ("shadow_tracer_bounce", True)):
        rays, n_live = live_sample(cap[key].rays, cap[key].active)
        print(f"  terrain1M {key}: {rays.origin.shape[0]} of {n_live} live rays")
        hits = agree.check(f"terrain1M {key}", split["views"], rays, None, any_hit)
        require(hits > 0, f"terrain1M {key}: no ray of the sample hits, so it checks nothing")
    timing = time_bounce_pass(split["views"], cap["bounce_tracer"].rays,
                              cap["bounce_tracer"].active, card)
    print(f"  K1 launch count after the comparisons = {split_trace.launch_count} "
          f"(main path: {split['launches']})")
    return dict(max_abs_err=agree.max_abs_err, **timing)


def treelet_build(card: str, front) -> dict:
    """Phase 5."""
    tb, packed = treelet.build_treelet_auto(front)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        tb, packed = treelet.build_treelet_auto(front)
    build_ms = sync_ms(t0) / ITERS
    treelet.check_treelet_capacity(tb)
    pair_tid = treelet.build_pair_tid(front)
    bad = int((tb.pair_tid != pair_tid).sum())
    tcap, wh, ecap = tb.tables.shape
    table_mib = tb.tables.numel() * 4 / 2**20
    print(f"phase 5: treelet build at 1M: {int(tb.num_treelets)} treelets, tcap {tcap}, "
          f"tables [{tcap}, {wh}, {ecap}] = {table_mib:.1f} MiB, root tid {int(tb.root_tid)}, "
          f"max col {int(tb.max_col)}; check_treelet_capacity passed")
    print(f"  treelet_build_ms = {build_ms!r}  [{card}]")
    print(f"  pair_tid vs build_pair_tid: {bad} of {pair_tid.shape[0]} pairs differ")
    require(bad == 0, "TreeletBVH.pair_tid != build_pair_tid")
    return dict(build_ms=build_ms)


def lane_path(device, card: str, dev_scene, camera, triangles, split_img) -> dict:
    """Phase 6: the app's --tracer lane path at full size."""
    args = parse_cmd(["--scene", f"terrain:{NUM_TRIS}", "--type", "bottom-up", "--pairs",
                      "--tracer", "lane", "--bounces", str(BOUNCES), "--width", str(RES),
                      "--height", str(RES)])
    torch.cuda.reset_peak_memory_stats()
    tb, packed, tracers = build_trav(args, triangles)
    recorder = PassRecorder(tracers["tracer"])
    lane_trace.launch_count = 0
    frame = frame_fn(tb, packed, dev_scene, camera, device, tracer=recorder)
    frame(0, 0.0)
    img, frame_ms, total_rays = timed_frames(frame)
    launches = lane_trace.launch_count
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    calls = recorder.calls
    per_call = [c["launches"] for c in calls]
    unfinished = int(sum(int(c["overflow"].sum()) for c in calls))
    print(f"phase 6: lane path ({int(tb.num_treelets)} treelets), {RES}x{RES}, {BOUNCES} "
          f"bounce, wave driver, {total_rays} rays in {ITERS} frames")
    require(len(calls) == 4 * (ITERS + 1), f"{len(calls)} tracer calls in {ITERS + 1} frames")
    require(all(n > 0 for n in per_call), f"a pass launched no K5: {per_call}")
    require(unfinished == 0, f"{unfinished} passes left rays unfinished")
    require(bool(torch.isfinite(img).all()), "lane frame has non-finite pixels")
    db = psnr(img, split_img)
    out = dict(frame_ms=frame_ms, mrays_per_s=total_rays / (frame_ms * ITERS) / 1000.0,
               peak_mem_mib=peak_mib, psnr_vs_split_db=db)
    for key, val in out.items():
        print(f"  {key} = {val!r}  [{card}]")
    print(f"  K5 launches per pass = {per_call} (total {launches})")
    require(db >= MIN_PSNR, f"lane frame {db:.2f} dB against the split frame (< {MIN_PSNR})")
    return dict(tb=tb, packed=packed, passes=calls[-4:], launches=launches, **out)


def lane_operands(tb, rays: Rays, active):
    """(rays8, fresh state), padded to a multiple of 128 with dead rays."""
    rays, active = lane_trace.pad_to_packets(rays, active)
    return (lane_trace.rays8_of(rays, active),
            lane_trace.init_state(int(tb.root_tid), rays.tmax, active))


class LaneAgreement:
    """K5 against its plain version, bit for bit, in the launch modes
    unbudgeted, budget48 and no_switch."""

    MODES = {"unbudgeted": dict(budget=0), "budget48": dict(budget=48),
             "no_switch": dict(no_switch=True)}

    def __init__(self):
        self.max_abs_err = 0.0

    def check(self, label, tb, rays, active) -> int:
        """Six launches (2 hit kinds x 3 modes); one line with, per launch,
        the rays with a hit and the rays stopped unfinished."""
        r8, state = lane_operands(tb, rays, active)
        root = int(tb.root_tid)
        counts = []
        for any_hit in (False, True):
            for mode, kw in self.MODES.items():
                ko, ks = lane_trace.lane_traverse(tb.tables, r8, state, root, lw=tb.leaf_width,
                                                  any_hit=any_hit, **kw)
                po, ps = lane_trace.trace_lane_plain(tb.tables, r8, state, root,
                                                     lw=tb.leaf_width, any_hit=any_hit, **kw)
                torch.cuda.synchronize()
                rows = (ko.view(torch.int32) != po.view(torch.int32)).sum(dim=(0, 2)).tolist()
                st_bad = int((ks != ps).sum())
                self.max_abs_err = max(self.max_abs_err, float((ko[:, 0] - po[:, 0]).abs().max()))
                require(sum(rows) == 0 and st_bad == 0,
                        f"{label} {mode} any_hit={any_hit}: K5 != plain on out rows {rows} "
                        f"and {st_bad} state words")
                counts.append(f"{int((f2i(ko[:, 1]) >= 0).sum())}/{int((ko[:, 7] > 0).sum())}")
        print(f"  {label:<36} rays={r8.shape[0] * 128:>6} hit/stopped "
              f"closest {' '.join(counts[:3])} any {' '.join(counts[3:])}: bit-equal")
        return int(counts[0].split("/")[0])


def lane_checks(device, card: str, lane: dict, triangles) -> dict:
    """Phase 7."""
    print("phase 7: K5 against its plain version on the card")
    agree = LaneAgreement()
    rng = np.random.default_rng(0)
    for name, scene in (("sphere", procedural.sphere_scene(3)),
                        ("soup2000", procedural.random_triangle_soup(2000, seed=1))):
        front = bucket.split_front(torch.as_tensor(scene.triangles, device=device), True)
        for lw, ecap in ((16, 128), (8, 16)):
            tcap = treelet.treelet_capacity(front, lw, ecap) + 8
            tb, _ = treelet.build_treelet(front, tcap, leaf_width=lw, ecap=ecap)
            treelet.check_treelet_capacity(tb)
            for set_name, (rays, active) in fixture_rays(scene, device, rng).items():
                agree.check(f"{name} ecap={ecap} T={int(tb.num_treelets)} {set_name}", tb, rays,
                            active)
    tb, packed = lane["tb"], lane["packed"]
    samples = {}
    for name, call in zip(PASSES, lane["passes"]):
        rays, n_live = live_sample(call["rays"], call["active"])
        samples[name] = rays
        print(f"  terrain1M {name}: {rays.origin.shape[0]} of {n_live} live rays")
        hits = agree.check(f"terrain1M {name}", tb, rays, None)
        require(hits > 0, f"terrain1M {name}: no ray of the sample hits, so it checks nothing")

    # the lane tracer's hits against brute force over the 1M triangles
    n_sample = samples["bounce"].origin.shape[0]
    rays = samples["bounce"].take(
        torch.linspace(0, n_sample - 1, min(BRUTE_RAYS, n_sample), device=device).round().long())
    rec, stats = lane_trace.make_lane_tracer()(tb, packed, rays)
    ref = brute_force_trace(triangles, rays, chunk=64)
    both = rec.hit & ref.hit
    bad_hit = int((rec.hit != ref.hit).sum())
    bad_t = int((both & ((rec.t - ref.t).abs() > T_RTOL * ref.t.abs())).sum())
    bad_prim = int((both & (rec.prim_id != ref.prim_id)).sum())
    print(f"  brute force, {rays.origin.shape[0]} bounce rays over {triangles.shape[0]} tris: "
          f"{int(ref.hit.sum())} hits, mismatches hit={bad_hit} t={bad_t} prim={bad_prim}, "
          f"unfinished={int(stats.overflow)}")
    for key, count in (("hit", bad_hit), ("t", bad_t), ("prim", bad_prim)):
        require(count <= (1.0 - BRUTE_AGREE) * rays.origin.shape[0],
                f"lane tracer and brute force disagree on {key} for {count} rays")
    require(int(stats.overflow) == 0, "brute-force sample left rays unfinished")

    timing = time_lane_bounce(tb, lane["passes"][2], samples["bounce"], card)
    time_drivers(tb, packed, lane["passes"][2], card)
    print(f"  K5 launch count after the comparisons = {lane_trace.launch_count} "
          f"(lane path: {lane['launches']})")
    return dict(max_abs_err=agree.max_abs_err, **timing)


def time_lane_bounce(tb, bounce_call, sample: Rays, card: str) -> dict:
    """K5 and its plain version, each as one unbudgeted closest-hit launch
    on the 1M bounce pass, by CUDA events (K5: mean of 5 after a warm-up;
    plain: one run). The plain version is first timed on the sample; if
    the full pass would take it over PLAIN_LIMIT_S, both are timed on the
    sample."""
    kw = dict(lw=tb.leaf_width, any_hit=False)
    root = int(tb.root_tid)
    r8s, sts = lane_operands(tb, sample, None)
    sample_ms, _ = event_ms(lambda: lane_trace.trace_lane_plain(tb.tables, r8s, sts, root, **kw),
                            1, warm=False)
    rays, active = bounce_call["rays"], bounce_call["active"]
    num = rays.origin.shape[0]
    estimate_s = sample_ms / 1000.0 * num / sample.origin.shape[0]
    where = "1M bounce pass"
    r8, st = lane_operands(tb, rays, active)
    if estimate_s > PLAIN_LIMIT_S:
        where = f"{sample.origin.shape[0]}-ray bounce sample (plain estimated {estimate_s:.0f} s)"
        r8, st, num = r8s, sts, sample.origin.shape[0]
    ms, kout = event_ms(lambda: lane_trace.lane_traverse(tb.tables, r8, st, root, **kw), 5)
    # the sample run warmed the plain version up
    plain_ms, pout = event_ms(lambda: lane_trace.trace_lane_plain(tb.tables, r8, st, root, **kw),
                              1, warm=False)
    bad = int((kout[0].view(torch.int32) != pout[0].view(torch.int32)).sum())
    live = num if where != "1M bounce pass" else int(active.sum())
    print(f"  {where}: {num} rays ({live} live); K5 {ms!r} ms, plain {plain_ms!r} ms, "
          f"out mismatches {bad}  [{card}]")
    require(bad == 0, f"{where}: K5 != plain")
    return dict(ms=ms, plain_ms=plain_ms)


def time_drivers(tb, packed, bounce_call, card: str) -> None:
    """Each lane driver on the 1M bounce pass, host-timed around a
    synchronise (one warm run, then the mean of ITERS)."""
    rays, active = bounce_call["rays"], bounce_call["active"]
    line = []
    for driver in lane_trace.DRIVERS:
        tracer = lane_trace.make_lane_tracer(driver=driver)
        before = lane_trace.launch_count
        tracer(tb, packed, rays, active=active)
        launches = lane_trace.launch_count - before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            _, stats = tracer(tb, packed, rays, active=active)
        line.append(f"{driver} {sync_ms(t0) / ITERS:.3f} ms ({launches} launches)")
        require(int(stats.overflow) == 0, f"lane driver {driver} left rays unfinished")
    print(f"  lane drivers on the 1M bounce pass: {', '.join(line)}  [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"phase 1: {kind}, {count} device(s); python {sys.version.split()[0]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card)

    t0 = time.perf_counter()
    _cuda_build.load_libraries(["split_trace", "lane_trace"])
    print(f"phase 2: built split_trace.cu and lane_trace.cu in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, (nvcc_s, log) in _cuda_build.BUILD_INFO.items():
        print(f"  {name}: nvcc {nvcc_s:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())

    scene = procedural.terrain(NUM_TRIS)
    dev_scene = scene_to_device(scene, device)
    camera = aerial_camera(scene, device)
    triangles = torch.as_tensor(scene.triangles, device=device)
    split = split_path(device, card, scene, dev_scene, camera, triangles)
    k1 = k1_checks(device, card, split)
    treelet_build(card, split["front"])
    lane = lane_path(device, card, dev_scene, camera, triangles, split["img"])
    k5 = lane_checks(device, card, lane, triangles)

    print(json.dumps({"kernels": [
        {"name": "split_trace", "route": "cuda",
         "source": "tpu_raytracing_torch/csrc/split_trace.cu",
         "replaces": "tpu_raytracing/trace/split_pallas.py:143",
         "launches": split["launches"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "lane_trace", "route": "cuda",
         "source": "tpu_raytracing_torch/csrc/lane_trace.cu",
         "replaces": "tpu_raytracing/trace/lane_pallas.py:107",
         "launches": lane["launches"], "max_abs_err": k5["max_abs_err"],
         "ms": k5["ms"], "plain_ms": k5["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
