#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, render.

    python3 chip_smoke.py

Drives ``tpu_raytracing_torch`` only (no JAX, no ``tpu_raytracing``) and
exits non-zero if any phase fails:

1. Device: requires CUDA; prints the card, the device count and
   ``nvidia-smi``'s name and power limit.
2. Build: compiles ``tpu_raytracing_torch/csrc/split_trace.cu`` (K1) with
   nvcc into ``tpu_raytracing_torch/build/`` and prints the ptxas register
   and spill lines.
3. Main path: the frame ``bench.py`` times — ``terrain(1_000_000)``, aerial
   camera, per-frame split-BVH rebuild + capacity check, fixed-topology
   refit, then a 1024x1024 path-traced frame with 1 bounce: one warm frame
   and 2 timed ones. K1's launch count is set to 0 before the main path
   and read after it; every frame must launch K1 at least 4 times, no ray
   may overflow its stack, and the image must be finite with a nonzero
   mean.
4. K1 against its plain PyTorch version on the card: hit, tri and per-ray
   pop counts must agree on >= 99.99% of rays and t within rtol 1e-5, in
   closest-hit and any-hit, on the sphere and soup(2000) fixtures (camera,
   axis-aligned, random and half-dead ray sets) and on 65,536 live rays
   sampled evenly from each of the 1M frame's own primary, primary-shadow,
   bounce and bounce-shadow passes, each sample with at least one hit.
   Then both are timed on the 1M bounce pass with CUDA events.

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

from tpu_raytracing_torch.bvh import bucket  # noqa: E402
from tpu_raytracing_torch.ops import _cuda_build  # noqa: E402
from tpu_raytracing_torch.scene import camera as cam  # noqa: E402
from tpu_raytracing_torch.scene import procedural  # noqa: E402
from tpu_raytracing_torch.scene.types import scene_to_device  # noqa: E402
from tpu_raytracing_torch.trace import split_trace  # noqa: E402
from tpu_raytracing_torch.trace.pathtrace import path_trace  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays, generate_primary_rays  # noqa: E402
from tpu_raytracing_torch.trace.traverse import PackedPairs, f2i, i2f  # noqa: E402

NUM_TRIS = 1_000_000
RES = 1024
BOUNCES = 1
ITERS = 2
SLICE = 65_536
T_RTOL = 1e-5
MIN_AGREE = 0.9999


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


class Capture:
    """Wraps a tracer and keeps the (rays, active) of its last call."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.rays = self.active = None

    def __call__(self, views, packed, rays, active=None):
        self.rays, self.active = rays, active
        return self.tracer(views, packed, rays, active=active)


def main_path(device, card: str) -> dict:
    """Phase 3: the bench frame end to end. Returns the captured pass rays
    and the numbers it measured."""
    torch.cuda.reset_peak_memory_stats()
    split_trace.launch_count = 0
    scene = procedural.terrain(NUM_TRIS)
    dev_scene = scene_to_device(scene, device)
    camera = aerial_camera(scene, device)
    triangles = torch.as_tensor(scene.triangles, device=device)

    def build(tris):
        return bucket.emit_split_views(bucket.split_front(tris, True),
                                       leaf_width=split_trace.LEAFW)

    views, packed, split = build(triangles)
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

    tracers = split_trace.make_frame_tracers(RES, RES)

    def frame(seed, jitter, tr):
        cam_j = dict(camera)
        cam_j["position"] = camera["position"] + jitter
        return path_trace(views, packed, dev_scene, cam_j, RES, RES, num_bounces=BOUNCES,
                          generator=torch.Generator(device=device).manual_seed(seed), **tr)

    captured = {k: Capture(v) for k, v in tracers.items()}
    img, rays_traced = frame(0, 0.0, captured)
    torch.cuda.synchronize()
    ttff_s = time.perf_counter() - T_PROCESS0
    total_rays = 0
    t0 = time.perf_counter()
    for i in range(ITERS):
        img, rays_traced = frame(i + 1, (i + 1) * 1e-4, tracers)
        total_rays += int(rays_traced)
    elapsed_ms = sync_ms(t0)
    launches = split_trace.launch_count
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    require(launches >= 4 * (ITERS + 1),
            f"K1 launched {launches} times in {ITERS + 1} frames (< 4 per frame)")
    require(bool(torch.isfinite(img).all()), "frame has non-finite pixels")
    mean = float(img.mean())
    require(mean > 0.0, f"frame mean {mean} is not positive")
    out = dict(rebuild_ms=rebuild_ms, refit_ms=refit_ms, frame_ms=elapsed_ms / ITERS,
               mrays_per_s=total_rays / (elapsed_ms / 1000.0) / 1e6,
               time_to_first_frame_s=ttff_s, peak_mem_mib=peak_mib)
    print(f"phase 3: {scene.num_triangles} tris, {int(split.num_inner)} inner rows, "
          f"{RES}x{RES}, {BOUNCES} bounce, image mean {mean:.6f}, "
          f"{total_rays} rays in {ITERS} frames")
    for key, val in out.items():
        print(f"  {key} = {val!r}  [{card}]")
    print(f"  K1 launches in {ITERS + 1} main-path frames = {launches}")
    return dict(views=views, captured=captured, launches=launches, **out)


class Agreement:
    """Running kernel-vs-plain comparison totals."""

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


def live_sample(rays: Rays, active):
    """Up to SLICE live rays of a captured pass, evenly spaced over the live
    ones in the pass's own order; returns (rays, number of live rays)."""
    num = rays.origin.shape[0]
    live = (torch.arange(num, device=rays.origin.device) if active is None
            else torch.nonzero(active).reshape(-1))
    n_live = live.shape[0]
    pick = live if n_live <= SLICE else live[
        torch.linspace(0, n_live - 1, SLICE, device=live.device).round().long()]
    return rays.take(pick), n_live


def time_bounce_pass(views, rays: Rays, active, card: str) -> dict:
    """K1 against the plain version on the 1M frame's bounce closest-hit
    pass, timed with CUDA events (K1: mean of 5 launches after a warm-up;
    plain: one run)."""
    inner, pairs = views
    ops = split_trace.kernel_operands(rays, active)
    kw = dict(leafw=split_trace.LEAFW, any_hit=False,
              stack_cap=split_trace._stack_cap(inner.shape[1], pairs.shape[0]))

    def event_ms(fn, reps):
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

    ms, kout = event_ms(lambda: split_trace.split_traverse(inner, pairs, *ops, **kw), 5)
    plain_ms, pout = event_ms(lambda: split_trace.trace_split_plain(inner, pairs, *ops, **kw), 1)
    tri_bad = int((kout[1] != pout[1]).sum())
    print(f"  1M bounce pass: {ops[0].shape[0]} rays ({int(active.sum())} live); "
          f"K1 {ms!r} ms, plain {plain_ms!r} ms, tri mismatches {tri_bad}  [{card}]")
    require(tri_bad <= (1.0 - MIN_AGREE) * ops[0].shape[0], "1M bounce pass: K1 != plain")
    return dict(ms=ms, plain_ms=plain_ms)


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
    _cuda_build.load_library("split_trace")
    build_s = time.perf_counter() - t0
    log = _cuda_build.BUILD_INFO["split_trace"][1]
    nvcc_s = _cuda_build.BUILD_INFO["split_trace"][0]
    print(f"phase 2: built split_trace.cu in {build_s:.2f} s (nvcc {nvcc_s:.2f} s)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    result = main_path(device, card)

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
    cap = result["captured"]
    for key, any_hit in (("tracer", False), ("shadow_tracer", True),
                         ("bounce_tracer", False), ("shadow_tracer_bounce", True)):
        rays, n_live = live_sample(cap[key].rays, cap[key].active)
        print(f"  terrain1M {key}: {rays.origin.shape[0]} of {n_live} live rays")
        hits = agree.check(f"terrain1M {key}", result["views"], rays, None, any_hit)
        require(hits > 0, f"terrain1M {key}: no ray of the sample hits, so it checks nothing")
    timing = time_bounce_pass(result["views"], cap["bounce_tracer"].rays,
                              cap["bounce_tracer"].active, card)
    print(f"  K1 launch count after the comparisons = {split_trace.launch_count} "
          f"(main path: {result['launches']})")

    print(json.dumps({"kernels": [{
        "name": "split_trace",
        "route": "cuda",
        "source": "tpu_raytracing_torch/csrc/split_trace.cu",
        "replaces": "tpu_raytracing/trace/split_pallas.py:143",
        "launches": result["launches"],
        "max_abs_err": agree.max_abs_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
