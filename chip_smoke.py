#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, render.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --k1-only    # phases 1-4 and 12
    python3 chip_smoke.py --app-only   # phases 1, 2 and 13 (with phase 9's fixtures)
    python3 chip_smoke.py --k5-baseline OLD/tpu_raytracing_torch/csrc/lane_trace.cu
                                       # every phase; phase 7 also times an
                                       # earlier K5 source beside K5
    python3 chip_smoke.py --k6-baseline OLD/tpu_raytracing_torch/csrc/fat_traverse.cu
                                       # every phase; phase 9 also times an
                                       # earlier K6 source beside K6 (the
                                       # flag may be given more than once)

Drives ``tpu_raytracing_torch`` only (no JAX, no ``tpu_raytracing``) and
exits non-zero if any phase fails:

1. Device: requires CUDA; prints the card, the device count and
   ``nvidia-smi``'s name and power limit.
2. Build: compiles ``csrc/split_trace.cu`` (K1), ``csrc/lane_trace.cu``
   (K5), ``csrc/fat_traverse.cu`` (K6) and the probes'
   ``csrc/micro_probe.cu`` and ``csrc/lane_probe.cu`` with nvcc, in
   parallel, into ``tpu_raytracing_torch/build/`` and prints each
   kernel's ptxas register and spill lines under its name.
3. Split path: the frame ``bench.py`` times — ``terrain(1_000_000)``,
   aerial camera, per-frame split-BVH rebuild + capacity check,
   fixed-topology refit, the ``tid`` bounce sort from ``build_pair_tid``,
   then a 1024x1024 path-traced frame with 1 bounce: one warm frame and 2
   timed ones. K1's launch count is set to 0 before these frames and read
   after them; every frame must launch K1 at least 4 times, no ray may
   overflow its stack, and the image must be finite with a nonzero mean.
   Two frames with the ``leaf`` sort are timed after, for comparison.
4. K1 against its plain PyTorch version on the card, bit for bit: t, tri,
   inner and leaf pops and the overflow flag must agree on every ray, in
   closest-hit and any-hit, on the sphere and soup(2000) fixtures (camera,
   axis-aligned, random and half-dead ray sets), on 65,536 live rays
   sampled evenly from each of the 1M frame's four passes (each sample with
   at least one hit), and on the tie fixtures: every triangle of
   terrain(32) and soup(2000) twice, pairs off and on, leaf widths 8, 40,
   64 and 128, with rays of tmax = F32_MAX for the all-miss window. Then K1
   is timed on each of the frame's four passes as the frame launches it,
   held to the plain version on every ray of each, with each pass's bound
   and mean pops per live ray; the plain version is timed on the bounce
   pass. Phase 12 runs next; ``--k1-only`` stops after it.
12. The frame-0 binned-SAH trace tree (``bench.py:175-228``) on phase 3's
   scene with pairs and 64-pair windows, with no fallback: a failed build,
   or one past its deadline, fails the phase. One build through
   ``build_sah_split`` with its ``stats`` (setup, frontier, emit seconds;
   the frontier's level count; the deepest anchor's depth) and the peak
   memory; ``check_sah_split_capacity``; the Tri
   entries' windows must tile [0, num_leaves) exactly once, and
   ``refit_split`` must give back the emitted box words (as floats); the
   tree's depth in rows must match its deepest anchor. The same build of
   terrain(65,536), pairs on, splits off and on, on the card and on the
   CPU: integer words and pair rows bit-equal, box words equal as floats.
   Then the bench frame on the SAH tree (``sah_split_views``, K1 on all
   four passes, the ``leaf`` bounce sort, phase 3's camera and seeds): one
   warm frame and 2 timed; K1 must launch on every pass, no ray may
   overflow the tree's stack bound, and the image must be finite and
   within 40 dB PSNR of phase 3's; one profiled frame. K1 is held to its
   plain version on every ray of each of the four passes and timed there,
   as in phase 4, and its hits on 4,096 primary and 4,096 bounce rays to
   brute force over the 1M triangles (0.5% may differ; a different
   triangle at exactly the same t counts as agreement).
5. Treelet build at 1M: ``build_treelet_auto`` on the phase-3 front (one
   warm build, 2 timed), its capacity check, and ``pair_tid`` equal to
   ``build_pair_tid`` on every pair.
6. Lane path: the app's ``--tracer lane`` path (``app/main.py:build_trav``)
   at 1M, 1024x1024, 1 bounce, wave driver, with phase 3's camera and
   generator seeds: one warm frame and 2 timed. K5's launch count is set
   to 0 before and read after; it must grow on every one of the 4 passes
   of every frame, no ray may be left unfinished, and the image must be
   finite and within 40 dB PSNR of phase 3's split frame. The phase ends
   with one profiled frame, as phases 3 and 8 do.
7. K5 against its plain version on the card, bit for bit on all 8 out rows
   and the whole state, in closest-hit and any-hit and in three launch
   modes (unbudgeted, budget 48, no_switch): on the sphere and soup(2000)
   fixtures with ecap 128 and with ecap 16 (8-pair windows: portals and
   the multi-round cut), on 65,536 live rays sampled evenly from each
   lane-frame pass, and on the tie fixtures: every triangle of terrain(32)
   and soup(2000) twice, pairs off and on, leaf width 16 / ecap 128 and 8 /
   16 (and 24, 40 and 128 at ecap 128), with rays of tmax = F32_MAX for the
   all-miss window. The lane
   tracer's hits on 4,096 bounce rays are held to brute force over the 1M
   triangles. Then K5 is timed on each of the lane frame's four passes as
   the frame launches it (the sum of the wave driver's launches, each
   replayed on its recorded operands) and as one unbudgeted launch, held
   to the plain version bit for bit on every ray of each pass, with each
   pass's bound and inner and window visits per live ray; the plain version
   is timed on the bounce pass; and each lane driver is timed on the bounce
   pass. With ``--k5-baseline``, the earlier K5 source (same C interface,
   reading the reference's ``tables`` layout) is built beside the others,
   held bit-equal to K5 on every replayed launch and timed on the same
   operands, and the drivers are timed on it too.
8. Binary path: the Karras build (``build_lbvh``, one warm build and 2
   timed) of phase 3's scene with pairs; ``count_nodes``' leaf count must
   equal the build's live leaf count and ``verify_hierarchy`` must find no
   error. Then ``pack_pairs`` and ``build_wide_fat`` (timed) and a
   1024x1024, 1-bounce frame with ``make_fat_tracer`` on all four passes and
   the ``leaf`` bounce sort, with phase 3's camera and generator seeds: one
   warm frame and 2 timed. K6 must launch on every pass, no ray may
   overflow, and the image must be finite and within 40 dB PSNR of phase 3's
   split frame. Phases 3 and 8 end with one frame under ``torch.profiler``:
   the device's busy share of it and the kernels with the most device
   time.
9. K6 against its plain version on the card, bit for bit on all six
   outputs and the overflow flag, and so are its clock64-profiled form and
   the profiled one-thread-per-ray kernel it replaced
   (``fat_traverse_cycles``): on the sphere and soup(2000) fixtures (pairs
   off and on; camera, axis-aligned, random and half-dead ray sets), on
   65,536 live rays sampled evenly from each pass of the phase-8 frame,
   and on the tie fixtures: every triangle of terrain(32) and soup(2000)
   twice, pairs off and on, the same ray sets and rays of tmax = F32_MAX.
   K6's hits on 4,096 bounce rays are held to brute force and to the
   scalar ``trace_rays`` on the same tree. Then K6 (and, with
   ``--k6-baseline``, each earlier source) is timed on each of the frame's
   four passes as the tiled tracer hands them over, held to the plain
   version on every ray of each, with each pass's bound, pops per live
   ray, triangle tests per pop and per live ray, and two clock64 splits
   per live ray (node loads and box tests; the Tri entries; sort, push and
   pop): K6's, taken by the warp, and the replaced kernel's, taken per
   lane; the plain version is timed on the bounce pass.
10. ``kernel_v`` 5, 4 and 2 (the reference's K3, v4 and K4) on phase 3's
   bounce pass: each launches K1, with t and tri bit-equal to
   ``kernel_v=3``, and v2's statistics have v2's shape.
11. The ``benchmarks/`` micro-probes (``tpu_raytracing_torch/benchmarks/``,
   kernels ``csrc/micro_probe.cu`` and ``csrc/lane_probe.cu``): every
   module's entry point at the reference's size (N = 200,000 loop
   iterations, ITERS = 4,096 lane iterations; each probe the median of 5
   runs with inputs varied per run, each in CUDA events queued behind a
   spin kernel so that the wrapper's host work is left out), with the
   launch counts set to 0 before and read after; every one of the 33
   probes must launch, and the one-shot gathers, the
   one shift and E2's chain must equal PyTorch's own calls
   (``take_along_dim``; ITERS ``torch.matmul`` steps). Then each kernel
   against its plain version at N = 4,096 / ITERS = 64, bit for bit on
   every output (the final stacks and comp's tile included; the scalar
   probes from seeded scratch and from interpret mode's NaN / INT32_MIN
   fill); the plain versions timed there, the library calls at the
   reference's size; the sanity orderings (dma1 > loop, pipe4 < dma1,
   fetch2 >= fetch, V3 <= V2 per packet-iter) printed; and ``fetch`` timed
   with the lanes on one column, on 128 conflict-free columns and on 128
   columns 4 to a bank, beside how the reference's chains fall on the
   banks.
13. The app's default run (``tpu_raytracing/app/args.py:23,34,56,59``:
   ``--type sah --tracer wide --bounces 0``), called in this process
   through ``app/main.py:main``: first with no flags at all (cornell,
   1024x768, mode 0, ``out/frame0000_mode0.png``); then on phase 3's scene
   with ``--pairs --cycle-modes --width 1024 --height 768 --frames 2``:
   the SAH binary build and the fat collapse timed by the app's
   ``StageTimer``, the tree's binary depth, each mode's frame (render and
   read-back), the 18 PNGs read back at full size (all but LODS opaque;
   each mode's frames 0 and 1 equal), and K6's counting launches set to 0
   before and read after: every mode must launch the counting
   instantiation, and nothing the one without counts. The default camera
   sits at the scene's centre, on the terrain, so every mode is then also
   rendered and timed from phase 3's aerial camera (more than a quarter
   of each frame lit). K6's counting instantiation is held to its plain
   version bit for bit, outputs and both counts, on 65,536 rays of the
   primary pass and of TEXTURE_LIT_SHADOWS' shadow pass from both cameras
   (and, with ``--app-only``, on phase 9's fixtures; in a full run phase 9
   holds it there and on the binary frame's passes), then timed against
   the instantiation without counts on each whole primary pass, in turns,
   with the bound and the plain version, and held to the plain version
   on every ray of it. ``--tracer split`` renders the nine modes of the
   same scene, held to the wide images at 40 dB in modes 0 and 8. Last
   the rock (``scene/genasset.py``, 6 subdivisions, 81,922 triangles and
   a 256x256 texture): generated, parsed by the native parser (which must
   run) and by the Python one (the same arrays), and rendered in all nine
   modes through the app with the wide tracer and with ``--tracer
   scalar`` (``trace_rays``) on the same SAH tree: modes 0, 3 and 5-8 at
   40 dB or more between the two, the textured modes with more than one
   colour. Images go to ``out/chip_smoke/`` (git-ignored).

For every kernel the script computes a bound: the larger of the float32
operations of its slab and triangle tests over 67 TFLOP/s and the bytes it
must move (rays in, results out, each structure row it visits once) over
3.35 TB/s, the H100 SXM's published peaks, counted from the 1M bounce
pass's per-ray statistics (K6's counting instantiation from the app
frame's primary pass; for a probe: from its inputs, outputs and loop
length at the reference's size, E2's bf16 products over the tensor cores'
989 TFLOP/s; see each module's ``work``). The last two lines of standard
output are a JSON summary of the kernels and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import io
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

T_PROCESS0 = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_raytracing_torch.app import main as app_main  # noqa: E402
from tpu_raytracing_torch.app.args import parse_cmd  # noqa: E402
from tpu_raytracing_torch.app.main import build_trav  # noqa: E402
from tpu_raytracing_torch.benchmarks import (  # noqa: E402
    _common,
    _lane,
    _micro,
    micro_control,
    micro_pallas,
    probe_lane_machine,
    probe_lane_machine2,
    probe_lane_machine3,
)
from tpu_raytracing_torch.bvh import bucket, lbvh, split_convert, treelet, wide  # noqa: E402
from tpu_raytracing_torch.bvh.verify import count_nodes, verify_hierarchy  # noqa: E402
from tpu_raytracing_torch.ops import _cuda_build, fat_traverse  # noqa: E402
from tpu_raytracing_torch.scene import camera as cam  # noqa: E402
from tpu_raytracing_torch.scene import genasset, native_loader, objio, procedural  # noqa: E402
from tpu_raytracing_torch.scene.types import scene_to_device  # noqa: E402
from tpu_raytracing_torch.trace import lane_trace, render, split_trace, wide_fat  # noqa: E402
from tpu_raytracing_torch.trace.brute import brute_force_trace  # noqa: E402
from tpu_raytracing_torch.trace.modes import RenderType  # noqa: E402
from tpu_raytracing_torch.trace.pathtrace import path_trace  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays, generate_primary_rays  # noqa: E402
from tpu_raytracing_torch.trace.packet import tile_reorder  # noqa: E402
from tpu_raytracing_torch.trace.traverse import (  # noqa: E402
    PackedPairs,
    f2i,
    i2f,
    pack_bvh,
    pack_pairs,
    trace_rays,
)
from tpu_raytracing_torch.utils.compare import psnr  # noqa: E402
from tpu_raytracing_torch.utils.png import read_png  # noqa: E402

NUM_TRIS = 1_000_000
RES = 1024
BOUNCES = 1
ITERS = 2
SLICE = 65_536
BRUTE_RAYS = 4096
T_RTOL = 1e-5
# Brute force tests each source triangle; the tracers test a pair's second
# triangle as (v2, v1, v3), so a ray at an edge may hit or miss by float32
# rounding, and neighbours sharing an edge tie on t.
BRUTE_AGREE = 0.995
MIN_PSNR = 40.0
# The SAH build's deadline (bench.py's TPURT_SAH_BUDGET_S is 1500) and the
# scene size of its card-against-CPU check.
SAH_BUDGET_S = 300.0
CPU_CHECK_TRIS = 65_536
PASSES = ("primary", "primary shadow", "bounce", "bounce shadow")
# The bench frame's tracers (make_frame_tracers' keys) in PASSES' order,
# each with its hit kind.
FRAME_TRACERS = (("tracer", False), ("shadow_tracer", True), ("bounce_tracer", False),
                 ("shadow_tracer_bounce", True))
TIE_LEAF_WIDTHS = (8, 40, split_trace.LEAFW, 128)
# K5's wider windows (2, 4 and 8 triangles a lane) on the tie fixtures
TIE_LANE_WIDTHS = (24, 40, lane_trace.MAX_LEAFW)
F32_MAX = float(torch.finfo(torch.float32).max)
LIBRARIES = ["split_trace", "lane_trace", "fat_traverse", "micro_probe", "lane_probe"]
PROBE_MODULES = (micro_pallas, micro_control, probe_lane_machine, probe_lane_machine2,
                 probe_lane_machine3)
PROBE_N_CHECK = 4096
PROBE_ITERS_CHECK = 64
# Published peaks of one H100 SXM: float32 outside the tensor cores, and
# HBM3. Operations per slab test (6 sub, 6 mul, 10 min/max, 3 compares) and
# per Möller-Trumbore test (12 sub/add and 14 mul of the edges and cross
# products, 3 dot products of 5, 3 products by 1/det, 1 divide, 9 compares
# and adds of the accept test), as the kernels compute them. bf16 products
# with float32 sums (the one probe that does them) bound at the tensor
# cores' dense bf16 peak.
# Phase 13: the app's default run (tpu_raytracing/app/args.py:23,34,56,59:
# --type sah, --tracer wide, --bounces 0) at 1024x768 on the 1M scene,
# then the rock asset (scene/genasset.py, 81,922 triangles at 6
# subdivisions). Its images go under out/chip_smoke/ (git-ignored).
APP_W, APP_H = 1024, 768
APP_FRAMES = 2
ROCK_SUBDIVISIONS = 6
NUM_MODES = 9
LODS_MODE = 4
# modes whose colour reads no texture: their images must be opaque
NO_TEXTURE_MODES = (0, 1, 2, 3, 5)
TEXTURED_MODES = (6, 7, 8)
# the rock's modes held between K6 and trace_rays: not the test-count heat
# maps (the two count differently) nor LODS (a log2 floored and times 20)
ROCK_PSNR_MODES = (0, 3, 5, 6, 7, 8)
SPLIT_PSNR_MODES = (0, 8)
OUT_DIR = Path(__file__).resolve().parent / "out" / "chip_smoke"
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
SLAB_OPS = 25
MT_OPS = 61


def demangled(log: str) -> str:
    """ptxas' log with its kernel names demangled by the toolkit's
    cu++filt (beside nvcc), or as it is where that fails."""
    filt = Path(_cuda_build.nvcc_path()).with_name("cu++filt")
    if not filt.is_file():
        return log
    proc = subprocess.run([str(filt)], input=log, capture_output=True, text=True, check=False,
                          timeout=60)
    return proc.stdout if proc.returncode == 0 and proc.stdout.strip() else log


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


def frame_psnr(a, b) -> float:
    """``utils/compare.py:psnr`` of two radiance frames, each clamped to
    [0, 1] (peak 1)."""
    return psnr(a.clamp(0, 1).cpu().numpy(), b.clamp(0, 1).cpu().numpy(), peak=1.0)


class Capture:
    """Wraps a tracer and keeps the (rays, active) of its last call."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.rays = self.active = None

    def __call__(self, views, packed, rays, active=None):
        self.rays, self.active = rays, active
        return self.tracer(views, packed, rays, active=active)


class PassRecorder:
    """Wraps a tracer: for every call, the launches of ``module``'s kernel
    it made, its overflow flag and its (rays, active)."""

    def __init__(self, tracer, module):
        self.tracer = tracer
        self.module = module
        self.calls = []

    def __call__(self, trav, packed, rays, active=None):
        before = self.module.launch_count
        rec, stats = self.tracer(trav, packed, rays, active=active)
        self.calls.append(dict(launches=self.module.launch_count - before,
                               overflow=stats.overflow, rays=rays, active=active))
        return rec, stats


def bound(ops: float, nbytes: float, bf16_ops: float = 0.0) -> dict:
    """The least time the card could take: the largest of ``ops`` float32
    operations at F32_OPS_PER_S, ``bf16_ops`` tensor-core operations at
    BF16_OPS_PER_S (the two units run side by side) and ``nbytes`` at
    HBM_BYTES_PER_S."""
    ops_ms = max(ops / F32_OPS_PER_S, bf16_ops / BF16_OPS_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


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


def profile_frame(label: str, frame, card: str, **kw) -> None:
    """One more frame under torch.profiler: the device's busy time (the
    union of its kernel intervals) against the frame's wall time, and the
    kernels with the most device time. The profiler's own overhead
    lengthens the wall time, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame(ITERS + 1, (ITERS + 1) * 1e-4, **kw)
        wall_ms = sync_ms(t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1000.0, n + 1)
    busy_ms = busy_us / 1000.0
    print(f"  {label} profiled frame: {wall_ms!r} ms wall, {busy_ms!r} ms device busy "
          f"({len(kernels)} device events, {100.0 * busy_ms / wall_ms:.1f}% busy)  [{card}]")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms:9.3f} ms {n:5d}x  {name[:100]}")


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
    profile_frame("bench", frame_fn(views, packed, dev_scene, camera, device, **tracers), card,
                  pair_loc=pair_loc)
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
    return dict(front=front, views=views, packed=packed, captured=captured, launches=launches,
                img=img, **out)


def k1_mismatches(kout, pout) -> dict:
    """Rays on which K1 and its plain version differ, per output (t bit for
    bit), and whether their overflow flags differ."""
    kt, ktri, kip, klp, kov = kout
    pt, ptri, pip, plp, pov = pout
    return {
        "hit": int(((ktri >= 0) != (ptri >= 0)).sum()),
        "tri": int((ktri != ptri).sum()),
        "inner_pops": int((kip != pip).sum()),
        "leaf_pops": int((klp != plp).sum()),
        "t": int((kt.view(torch.int32) != pt.view(torch.int32)).sum()),
        "overflow": int(int(kov) != int(pov)),
    }


class Agreement:
    """Running K1-vs-plain comparison totals: every check must agree on
    every output of every ray."""

    def __init__(self):
        self.max_abs_err = 0.0

    def check(self, label, views, rays, active, any_hit, leafw=split_trace.LEAFW) -> int:
        inner, pairs, stack_cap = views
        ops = split_trace.kernel_operands(rays, active)
        kw = dict(leafw=leafw, any_hit=any_hit, stack_cap=stack_cap)
        kout = split_trace.split_traverse(inner, pairs, *ops, **kw)
        pout = split_trace.trace_split_plain(inner, pairs, *ops, **kw)
        torch.cuda.synchronize()
        num = kout[0].shape[0]
        bad = k1_mismatches(kout, pout)
        if num:
            self.max_abs_err = max(self.max_abs_err, float((kout[0] - pout[0]).abs().max()))
        hits = int((kout[1] >= 0).sum())
        print(f"  {label:<34} any_hit={int(any_hit)} rays={num:>7} hits={hits:>7} "
              f"mismatches={bad} overflow={int(kout[4])}/{int(pout[4])}")
        require(sum(bad.values()) == 0, f"{label}: K1 and plain disagree: {bad}")
        require(int(kout[4]) == int(pout[4]) == 0, f"{label}: stack overflow")
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


def pass_operands(key: str, cap: Capture):
    """K1's operands for one pass of the bench frame, in the order the
    frame's tracer hands them over (16 x K/16 screen tiles for the primary
    passes, the caller's sorted order for the bounce passes), and the live
    mask in that order."""
    rays, active = cap.rays, cap.active
    if key in ("tracer", "shadow_tracer"):
        tw, th = 16, split_trace.K // 16
        rays = Rays(*(tile_reorder(getattr(rays, f), RES, RES, tw, th)
                      for f in ("origin", "direction", "tmin", "tmax")))
        active = None if active is None else tile_reorder(active, RES, RES, tw, th)
    if active is None:
        active = torch.ones(rays.origin.shape[0], dtype=torch.bool, device=rays.origin.device)
    return split_trace.kernel_operands(rays, active), active


def time_passes(views, captured: dict, card: str, label: str = "1M") -> dict:
    """K1 on each of a frame's four passes, as the frame launches it:
    CUDA-event ms (mean of 5 launches after a warm one), bit-equal to the
    plain version on every ray, the bound from the plain version's counts
    and the mean inner and leaf pops per live ray. Then the plain version
    is timed on the bounce pass (one run). Returns the bounce pass's
    numbers, which stand for K1 in the kernels line, and each pass's."""
    inner, pairs, stack_cap = views
    w = inner.shape[1]
    kw = dict(leafw=split_trace.LEAFW, stack_cap=stack_cap)
    out, total_ms = {}, 0.0
    for (key, any_hit), name in zip(FRAME_TRACERS, PASSES):
        ops, live = pass_operands(key, captured[key])
        ms, kout = event_ms(
            lambda: split_trace.split_traverse(inner, pairs, *ops, any_hit=any_hit, **kw), 5)
        visited = {}
        pout = split_trace.trace_split_plain(inner, pairs, *ops, any_hit=any_hit, **kw,
                                             visited=visited)
        bad = k1_mismatches(kout, pout)
        require(sum(bad.values()) == 0 and int(kout[4]) == 0,
                f"{label} {name} pass: K1 and plain disagree ({bad}) or overflow {int(kout[4])}")
        # bound: every inner pop tests w boxes, every leaf pop 2 * LEAFW
        # triangles; rays in (32 B), results out (16 B), each inner row
        # (w * 32 B) and pair row (64 B) visited once
        num = ops[0].shape[0]
        n_inner, n_pairs = int(visited["inner"].sum()), int(visited["pairs"].sum())
        n_ops = (float(kout[2].sum()) * w * SLAB_OPS
                 + float(kout[3].sum()) * 2 * split_trace.LEAFW * MT_OPS)
        nbytes = num * (32 + 16) + n_inner * w * 32 + n_pairs * 64
        b = bound(n_ops, nbytes)
        ipops = float(kout[2][live].float().mean())
        lpops = float(kout[3][live].float().mean())
        total_ms += ms
        print(f"  {label} {name} pass: {num} rays ({int(live.sum())} live), "
              f"any_hit={int(any_hit)}: "
              f"K1 {ms!r} ms, bound {b['bound_ms']!r} ms ({b['bound_by']}; {n_ops:.4g} ops, "
              f"{nbytes} bytes: {n_inner} inner rows, {n_pairs} pair rows); pops per live ray "
              f"inner {ipops!r} leaf {lpops!r}; bit-equal to plain  [{card}]")
        out[name] = dict(ms=ms, inner_pops=ipops, leaf_pops=lpops, **b)
    print(f"  K1 on the four passes: {total_ms!r} ms a frame  [{card}]")
    ops, _ = pass_operands("bounce_tracer", captured["bounce_tracer"])
    plain_ms, _ = event_ms(
        lambda: split_trace.trace_split_plain(inner, pairs, *ops, any_hit=False, **kw), 1,
        warm=False)
    print(f"  plain version on the {label} bounce pass: {plain_ms!r} ms  [{card}]")
    return dict(plain_ms=plain_ms, passes=out, **out["bounce"])


def tie_fixtures(device, agree: Agreement, rng) -> None:
    """K1 against its plain version where windows hold exact t ties: every
    triangle of terrain(32) (one 64-pair window) and of soup(2000) twice,
    pairs off and on, closest-hit and any-hit, at LEAFW and at the leaf
    widths 8, 40 and 128 (lanes past the window, four slots a lane). The
    "unbounded" rays have tmax = F32_MAX, so a window they enter and miss
    still names its all-miss slot, 2 * leafw - 1."""
    for name, base in (("terrain32x2", procedural.terrain(32)),
                       ("soup2000x2", procedural.random_triangle_soup(2000, seed=1))):
        scene = dataclasses.replace(base, triangles=np.repeat(base.triangles, 2, axis=0))
        tris = torch.as_tensor(scene.triangles, device=device)
        sets = fixture_rays(scene, device, rng)
        rays = sets["random"][0]
        sets["unbounded"] = (Rays(rays.origin, rays.direction, rays.tmin,
                                  torch.full_like(rays.tmax, F32_MAX)), None)
        for pairs in (False, True):
            front = bucket.split_front(tris, pairs)
            for leafw in TIE_LEAF_WIDTHS:
                views, _, _ = bucket.emit_split_views(front, leaf_width=leafw)
                for set_name, (rays, active) in sets.items():
                    if leafw != split_trace.LEAFW and set_name not in ("random", "unbounded"):
                        continue
                    for any_hit in (False, True):
                        agree.check(f"{name} pairs={int(pairs)} leafw={leafw} {set_name}",
                                    views, rays, active, any_hit, leafw=leafw)


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
    for key, any_hit in FRAME_TRACERS:
        rays, n_live = live_sample(cap[key].rays, cap[key].active)
        print(f"  terrain1M {key}: {rays.origin.shape[0]} of {n_live} live rays")
        hits = agree.check(f"terrain1M {key}", split["views"], rays, None, any_hit)
        require(hits > 0, f"terrain1M {key}: no ray of the sample hits, so it checks nothing")
    tie_fixtures(device, agree, rng)
    timing = time_passes(split["views"], cap, card)
    print(f"  K1 launch count after the comparisons = {split_trace.launch_count} "
          f"(main path: {split['launches']})")
    return dict(max_abs_err=agree.max_abs_err, **timing)


def same_split(a, b) -> dict:
    """Words on which two SAH split trees differ: the inner rows' integer
    words (meta, pad) and e_ranges bit for bit, their box words as floats
    (so -0.0 == +0.0), the sorted pair rows bit for bit, and the counts."""
    (sa, pa), (sb, pb) = a, b
    ia, ib = sa.inner.cpu().reshape(-1, 8), sb.inner.cpu().reshape(-1, 8)
    return {
        "shape": int(ia.shape != ib.shape or pa.rows.shape != pb.rows.shape),
        "int_words": int((ia[:, 6:] != ib[:, 6:]).sum()),
        "box_words": int((i2f(ia[:, :6]) != i2f(ib[:, :6])).sum()),
        "e_ranges": int((sa.e_ranges.cpu() != sb.e_ranges.cpu()).sum()),
        "pair_rows": int((pa.rows.cpu() != pb.rows.cpu()).sum()),
        "counts": int(int(sa.num_inner) != int(sb.num_inner)
                      or int(sa.num_leaves) != int(sb.num_leaves)),
    }


def brute_check(label: str, views, packed, rays, triangles) -> None:
    """K1's hits on sampled rays against brute force over every triangle:
    at most 0.5% of the rays may differ on hit, t or the primitive; a
    different primitive at exactly the same t (either triangle of an exact
    tie) counts as agreement."""
    tracer = split_trace.make_split_tracer(RES, RES, sort_mode="presorted")
    rec, stats = tracer(views, packed, rays)
    ref = brute_force_trace(triangles, rays, chunk=64)
    num = rays.origin.shape[0]
    both = rec.hit & ref.hit
    bad_hit = int((rec.hit != ref.hit).sum())
    bad_t = int((both & ((rec.t - ref.t).abs() > T_RTOL * ref.t.abs())).sum())
    bad_prim = int((both & (rec.prim_id != ref.prim_id) & (rec.t != ref.t)).sum())
    ties = int((both & (rec.prim_id != ref.prim_id) & (rec.t == ref.t)).sum())
    print(f"  brute force, {num} {label} rays over {triangles.shape[0]} tris: "
          f"{int(ref.hit.sum())} hits, mismatches hit={bad_hit} t={bad_t} prim={bad_prim} "
          f"(exact-t ties naming the other triangle: {ties}), overflow {int(stats.overflow)}")
    for what, count in (("hit", bad_hit), ("t", bad_t), ("prim", bad_prim)):
        require(count <= (1.0 - BRUTE_AGREE) * num,
                f"SAH tree: K1 and brute force disagree on {what} for {count} {label} rays")
    require(int(stats.overflow) == 0, f"{label} brute-force sample overflowed")
    require(int(ref.hit.sum()) > 0, f"no {label} ray of the brute-force sample hits")


def sah_checks(device, card: str, scene, dev_scene, camera, triangles, split: dict) -> dict:
    """Phase 12: the frame-0 binned-SAH trace tree at 1M, its checks, its
    agreement with a CPU build, and the bench frame traced on it by K1."""
    print("phase 12: the frame-0 binned-SAH trace tree (bench.py:175-228)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    deadline = time.monotonic() + SAH_BUDGET_S
    stats = {}
    t0 = time.perf_counter()
    tree, packed = split_convert.build_sah_split(triangles, True, split_trace.LEAFW,
                                                 deadline=deadline, stats=stats)
    stats["build_s"] = time.perf_counter() - t0
    build_peak_mib = torch.cuda.max_memory_allocated() / 2**20
    split_convert.check_sah_split_capacity(tree)
    views, packed, tree = split_convert.sah_split_views(tree, packed)
    rows = split_convert.row_depth(tree.inner, int(tree.num_inner))
    print(f"  {scene.num_triangles} tris, pairs: {int(tree.num_leaves)} leaves, "
          f"{int(tree.num_inner)} inner rows of {tree.inner.shape[0]}, {stats['levels']} frontier "
          f"levels, tree depth {stats['tree_depth']}, deepest anchor at depth "
          f"{stats['deepest_anchor']}, {rows} rows deep, stack bound {views[2]} (the bucket "
          f"tree's {bucket.stack_cap(8, views[1].shape[0])})")
    require(rows == stats["deepest_anchor"] // 3 + 1,
            f"{rows} rows deep, but the deepest anchor is at depth {stats['deepest_anchor']}")
    for key in ("setup_s", "frontier_s", "emit_s", "build_s"):
        print(f"  {key} = {stats[key]!r}  [{card}]")
    print(f"  build_peak_mem_mib = {build_peak_mib!r}  [{card}]")

    # the Tri entries' windows tile [0, num_leaves) exactly once
    ni = int(tree.num_inner)
    meta = tree.inner[:ni].reshape(-1, 8)[:, 6]
    er = tree.e_ranges[:ni].reshape(-1, 2)[(meta & 3) == 2].to(torch.int64)
    er = er[torch.argsort(er[:, 0])]
    tiled = (int(er[0, 0]) == 0 and bool((er[1:, 0] == (er[:, 0] + er[:, 1])[:-1]).all())
             and int((er[:, 0] + er[:, 1])[-1]) == int(tree.num_leaves))
    # a refit from the emitted pair rows gives back the emitted boxes
    refit = bucket.refit_split(tree, packed)
    box_bad = int((i2f(refit.inner.reshape(-1, 8)[:, :6])
                   != i2f(tree.inner.reshape(-1, 8)[:, :6])).sum())
    print(f"  check_sah_split_capacity passed; {er.shape[0]} Tri entries tile the leaves: "
          f"{tiled}; refit_split box words differing as floats: {box_bad}")
    require(tiled, "the SAH tree's Tri entries do not tile [0, num_leaves) exactly once")
    require(box_bad == 0, f"refit_split changes {box_bad} box words of the emitted SAH tree")

    # the same build on the card and on the CPU
    small = torch.as_tensor(procedural.terrain(CPU_CHECK_TRIS).triangles)
    for splits in (False, True):
        card_tree = split_convert.build_sah_split(small.to(device), True, split_trace.LEAFW,
                                                  enable_splits=splits)
        cpu_tree = split_convert.build_sah_split(small, True, split_trace.LEAFW,
                                                 enable_splits=splits)
        bad = same_split(card_tree, cpu_tree)
        print(f"  terrain({CPU_CHECK_TRIS}) pairs=1 splits={int(splits)}: "
              f"{int(cpu_tree[0].num_inner)} inner rows, card against CPU: {bad}")
        require(sum(bad.values()) == 0, f"SAH build differs between the card and the CPU: {bad}")

    # the bench frame on the SAH tree: K1 on all four passes, leaf sort
    torch.cuda.reset_peak_memory_stats()
    tracers = split_trace.make_frame_tracers(RES, RES)
    captured = {k: Capture(v) for k, v in tracers.items()}
    recorders = {k: PassRecorder(v, split_trace) for k, v in captured.items()}
    split_trace.launch_count = 0
    frame = frame_fn(views, packed, dev_scene, camera, device, **recorders)
    frame(0, 0.0, sort_kind="leaf")
    img, frame_ms, total_rays = timed_frames(frame, sort_kind="leaf")
    launches = split_trace.launch_count
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    calls = [c for r in recorders.values() for c in r.calls]
    overflowed = int(sum(int(c["overflow"].sum()) for c in calls))
    require(all(c["launches"] > 0 for c in calls) and len(calls) == 4 * (ITERS + 1),
            f"{len(calls)} tracer calls, launches {[c['launches'] for c in calls]}")
    require(launches >= 4 * (ITERS + 1), f"K1 launched {launches} times in {ITERS + 1} frames")
    require(overflowed == 0, f"{overflowed} passes overflowed a K1 stack")
    require(bool(torch.isfinite(img).all()), "SAH frame has non-finite pixels")
    db = frame_psnr(img, split["img"])
    out = dict(frame_ms=frame_ms, mrays_per_s=total_rays / (frame_ms * ITERS) / 1000.0,
               peak_mem_mib=peak_mib, psnr_vs_bucket_db=db)
    print(f"  SAH frame: {RES}x{RES}, {BOUNCES} bounce, leaf bounce sort, K1 on every pass, "
          f"{total_rays} rays in {ITERS} frames")
    for key, val in out.items():
        print(f"  {key} = {val!r}  [{card}]")
    print(f"  K1 launches in {ITERS + 1} SAH frames = {launches}")
    require(db >= MIN_PSNR, f"SAH frame {db:.2f} dB against the bucket frame (< {MIN_PSNR})")
    profile_frame("SAH", frame_fn(views, packed, dev_scene, camera, device, **tracers), card,
                  sort_kind="leaf")

    # K1 against its plain version on every ray of each pass, and brute force
    timing = time_passes(views, captured, card, label="SAH 1M")
    for label, key in (("primary", "tracer"), ("bounce", "bounce_tracer")):
        rays, active = captured[key].rays, captured[key].active
        idx = (torch.arange(rays.origin.shape[0], device=device) if active is None
               else torch.nonzero(active).reshape(-1))
        pick = idx[torch.linspace(0, idx.shape[0] - 1, BRUTE_RAYS, device=device).round().long()]
        brute_check(label, views, packed, rays.take(pick), triangles)
    return dict(launches=launches, **timing)


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
          f"tables [{tcap}, {wh}, {ecap}] = {table_mib:.1f} MiB and columns [{tcap}, {ecap}, "
          f"{wh}] = {tb.columns.numel() * 4 / 2**20:.1f} MiB, root tid {int(tb.root_tid)}, "
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
    recorder = PassRecorder(tracers["tracer"], lane_trace)
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
    db = frame_psnr(img, split_img)
    out = dict(frame_ms=frame_ms, mrays_per_s=total_rays / (frame_ms * ITERS) / 1000.0,
               peak_mem_mib=peak_mib, psnr_vs_split_db=db)
    for key, val in out.items():
        print(f"  {key} = {val!r}  [{card}]")
    print(f"  K5 launches per pass = {per_call} (total {launches})")
    require(db >= MIN_PSNR, f"lane frame {db:.2f} dB against the split frame (< {MIN_PSNR})")
    profile_frame("lane", frame_fn(tb, packed, dev_scene, camera, device,
                                   tracer=tracers["tracer"]), card)
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
                ko, ks = lane_trace.lane_traverse(tb.tables, tb.columns, r8, state, root,
                                                  lw=tb.leaf_width, any_hit=any_hit, **kw)
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


def lane_tie_fixtures(device, agree: LaneAgreement, rng) -> None:
    """K5 against its plain version where windows hold exact t ties: every
    triangle of terrain(32) and of soup(2000) twice, pairs off and on, leaf
    width 16 / ecap 128 and 8 / 16 (16 of a warp's lanes on a window), and
    on the random and unbounded rays also leaf widths 24, 40 and 128 at
    ecap 128 (2, 4 and 8 triangles a lane). The "unbounded" rays have tmax
    = F32_MAX, so a window they enter and miss still names its all-miss
    index, 2 * lw - 1."""
    for name, base in (("terrain32x2", procedural.terrain(32)),
                       ("soup2000x2", procedural.random_triangle_soup(2000, seed=1))):
        scene = dataclasses.replace(base, triangles=np.repeat(base.triangles, 2, axis=0))
        tris = torch.as_tensor(scene.triangles, device=device)
        sets = fixture_rays(scene, device, rng)
        rays = sets["random"][0]
        sets["unbounded"] = (Rays(rays.origin, rays.direction, rays.tmin,
                                  torch.full_like(rays.tmax, F32_MAX)), None)
        for pairs in (False, True):
            front = bucket.split_front(tris, pairs)
            for lw, ecap in ((16, 128), (8, 16)) + tuple((w, 128) for w in TIE_LANE_WIDTHS):
                tcap = treelet.treelet_capacity(front, lw, ecap) + 8
                tb, _ = treelet.build_treelet(front, tcap, leaf_width=lw, ecap=ecap)
                treelet.check_treelet_capacity(tb)
                for set_name, (rays, active) in sets.items():
                    if lw in TIE_LANE_WIDTHS and set_name not in ("random", "unbounded"):
                        continue
                    agree.check(f"{name} pairs={int(pairs)} lw={lw} ecap={ecap} {set_name}",
                                tb, rays, active)


def lane_checks(device, card: str, lane: dict, triangles, baseline=None) -> dict:
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
    lane_tie_fixtures(device, agree, rng)

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

    kernels = {"K5": lane_trace.lane_traverse}
    if baseline is not None:
        kernels["baseline K5"] = baseline
    timing = time_lane_passes(tb, packed, lane["passes"], card, kernels)
    for label, fn in kernels.items():
        time_drivers(tb, packed, lane["passes"][2], card, label, fn)
    print(f"  K5 launch count after the comparisons = {lane_trace.launch_count} "
          f"(lane path: {lane['launches']})")
    return dict(max_abs_err=agree.max_abs_err, **timing)


class BaselineK5:
    """An earlier K5 source given by ``--k5-baseline``: the same C interface
    as csrc/lane_trace.cu, reading the reference's ``tables`` layout. Called
    as ``lane_traverse`` is; it counts no launch."""

    NAME = "lane_trace_baseline"

    def __init__(self, source: Path):
        self.source = source

    def __call__(self, tables, columns, rays8, state, root_tid, *, lw, any_hit, budget=0,
                 no_switch=False):
        fn = _cuda_build.load_library(self.NAME, self.source).lane_trace_launch
        fn.argtypes = lane_trace._ARGTYPES
        fn.restype = ctypes.c_int
        num_p = rays8.shape[0]
        out = torch.empty((num_p, 8, 128), dtype=torch.float32, device=rays8.device)
        state_out = torch.empty_like(state)
        t, wh, ecap = tables.shape
        err = fn(tables.data_ptr(), t, wh, ecap, lw, rays8.data_ptr(), state.data_ptr(),
                 out.data_ptr(), state_out.data_ptr(), num_p, int(root_tid), state.shape[1] - 5,
                 int(budget), int(no_switch), int(any_hit),
                 torch.cuda.current_stream(rays8.device).cuda_stream)
        require(err == 0, f"baseline K5 launch failed: cudaError {err}")
        return out, state_out


def wave_launches(tb, packed, call) -> list:
    """The K5 launches the lane frame's tracer (the wave driver) makes on
    one pass, in order: (rays8, state, keyword arguments) of each."""
    launches = []
    real = lane_trace.lane_traverse

    def record(tables, columns, rays8, state, root_tid, **kw):
        launches.append((rays8, state, kw))
        return real(tables, columns, rays8, state, root_tid, **kw)

    lane_trace.lane_traverse = record
    try:
        lane_trace.make_lane_tracer()(tb, packed, call["rays"], active=call["active"])
    finally:
        lane_trace.lane_traverse = real
    return launches


def launch_ms(fn) -> float:
    """Median device time of 3 calls after a warm one, each in CUDA events
    queued behind a spin kernel (the wrapper's host work left out)."""
    return statistics.median(_common.time_runs(fn, [()] * 4, torch.device("cuda")))


def same_words(a, b) -> bool:
    return bool((a.view(torch.int32) == b.view(torch.int32)).all())


def time_lane_passes(tb, packed, passes, card: str, kernels: dict) -> dict:
    """Each kernel of ``kernels`` (K5 and any baseline) on each of the lane
    frame's four passes: as the frame launches it (the wave driver's
    launches recorded, then each replayed on its operands and timed by
    ``launch_ms``; their sum) and as one unbudgeted closest-hit launch from
    a fresh state (mean of 5 after a warm one, by CUDA events). Every replay
    of a baseline must equal K5's output bit for bit; each unbudgeted K5
    launch must equal the plain version on every out row and state word of
    every ray. The bound comes from that plain run's counts; visits per
    live ray are out rows 2 and 3 over 8 and 2 * lw. The plain version's
    time is its run on the bounce pass (with the visit marking on). Returns
    the bounce pass's numbers, which stand for K5 in the kernels line."""
    root, lw = int(tb.root_tid), tb.leaf_width
    totals = {label: 0.0 for label in kernels}
    res = {}
    for name, call in zip(PASSES, passes):
        launches = wave_launches(tb, packed, call)
        wave = {label: 0.0 for label in kernels}
        for r8, st, kw in launches:
            ref = None
            for label, fn in kernels.items():
                wave[label] += launch_ms(lambda: fn(tb.tables, tb.columns, r8, st, root, **kw))
                got = fn(tb.tables, tb.columns, r8, st, root, **kw)
                if ref is None:
                    ref = got
                else:
                    require(same_words(got[0], ref[0]) and same_words(got[1], ref[1]),
                            f"1M {name} pass: {label} != K5 on a wave launch {kw}")
        n_wave = len(launches)
        del launches
        r8, st = lane_operands(tb, call["rays"], call["active"])
        kw = dict(lw=lw, any_hit=False)
        once, outs = {}, {}
        for label, fn in kernels.items():
            once[label], outs[label] = event_ms(
                lambda: fn(tb.tables, tb.columns, r8, st, root, **kw), 5)
        k5out = outs["K5"]
        visited = {}
        plain_ms, pout = event_ms(lambda: lane_trace.trace_lane_plain(
            tb.tables, r8, st, root, **kw, visited=visited), 1, warm=False)
        bad = [int((k.view(torch.int32) != p.view(torch.int32)).sum())
               for k, p in zip(k5out, pout)]
        require(sum(bad) == 0, f"1M {name} pass: K5 != plain on {bad} out / state words")
        # bound: out rows 2-3 count each ray's box and triangle tests; rays8
        # and the state in, out and the state written back, each inner column
        # (56 words) and window column (12 lw + 1 words) visited once
        out = k5out[0]
        n_ops = float(out[:, 2].sum()) * SLAB_OPS + float(out[:, 3].sum()) * MT_OPS
        n_rays = r8.shape[0] * 128
        n_inner, n_window = int(visited["inner"].sum()), int(visited["window"].sum())
        nbytes = (n_rays * 4 * (8 + 8 + 2 * st.shape[1]) + n_inner * 56 * 4
                  + n_window * (12 * lw + 1) * 4)
        b = bound(n_ops, nbytes)
        live = call["active"]
        n_live = int(live.sum()) if live is not None else call["rays"].origin.shape[0]
        per_ray = out.transpose(1, 2).reshape(n_rays, 8)[:call["rays"].origin.shape[0]]
        if live is not None:
            per_ray = per_ray[live]
        inner_v = float(per_ray[:, 2].sum()) / 8 / n_live
        window_v = float(per_ray[:, 3].sum()) / (2 * lw) / n_live
        times = ", ".join(f"{label} {wave[label]!r} ms ({once[label]!r} unbudgeted)"
                          for label in kernels)
        print(f"  1M {name} pass: {n_rays} rays ({n_live} live), wave driver ({n_wave} "
              f"launches): {times}; "
              f"bound {b['bound_ms']!r} ms ({b['bound_by']}; {n_ops:.4g} ops, {nbytes} bytes: "
              f"{n_inner} inner, {n_window} window columns); visits per live ray inner "
              f"{inner_v!r} window {window_v!r}; K5 bit-equal to plain  [{card}]")
        for label in kernels:
            totals[label] += wave[label]
        res[name] = dict(ms=once["K5"], plain_ms=plain_ms, **b)
    print("  on the four passes, as the frame launches them: "
          + ", ".join(f"{label} {ms!r} ms a frame" for label, ms in totals.items())
          + f"  [{card}]")
    print(f"  plain version on the 1M bounce pass: {res['bounce']['plain_ms']!r} ms  [{card}]")
    return res["bounce"]


def time_drivers(tb, packed, bounce_call, card: str, label: str, traverse) -> None:
    """Each lane driver on the 1M bounce pass with ``traverse`` as the
    kernel, host-timed around a synchronise (one warm run, then the mean of
    ITERS)."""
    rays, active = bounce_call["rays"], bounce_call["active"]
    line = []
    real = lane_trace.lane_traverse
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return traverse(*args, **kw)

    lane_trace.lane_traverse = counted
    try:
        for driver in lane_trace.DRIVERS:
            tracer = lane_trace.make_lane_tracer(driver=driver)
            calls.clear()
            tracer(tb, packed, rays, active=active)
            launches = len(calls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ITERS):
                _, stats = tracer(tb, packed, rays, active=active)
            line.append(f"{driver} {sync_ms(t0) / ITERS:.3f} ms ({launches} launches)")
            require(int(stats.overflow) == 0, f"lane driver {driver} left rays unfinished")
    finally:
        lane_trace.lane_traverse = real
    print(f"  lane drivers on the 1M bounce pass, {label}: {', '.join(line)}  [{card}]")


def binary_path(device, card: str, dev_scene, camera, triangles, split_img) -> dict:
    """Phase 8: the Karras build, its checks, the fat collapse and the K6
    frame at full size."""
    torch.cuda.reset_peak_memory_stats()
    lbvh.build_lbvh(triangles, True)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        bvh, pairs = lbvh.build_lbvh(triangles, True)
    build_ms = sync_ms(t0) / ITERS
    _, _, num_leaves = lbvh.generate_morton_codes_pairs(triangles, *lbvh.scene_aabb(triangles))
    t0 = time.perf_counter()
    stats = count_nodes(bvh)
    errors = verify_hierarchy(bvh)
    check_s = time.perf_counter() - t0
    print(f"phase 8: Karras build of {triangles.shape[0]} tris: {bvh.num_slots} slots, tree height "
          f"{int(lbvh.tree_height(bvh))}; count_nodes {stats}, live leaves {int(num_leaves)}, "
          f"verify_hierarchy errors {len(errors)} (host checks {check_s:.2f} s)")
    require(stats.num_leaf_nodes == int(num_leaves),
            f"count_nodes finds {stats.num_leaf_nodes} leaves, the build made {int(num_leaves)}")
    require(not errors, f"verify_hierarchy: {len(errors)} boxes fail, first {errors[:8]}")
    packed = pack_pairs(pairs)
    wide.build_wide_fat(bvh, packed.rows)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fat = wide.build_wide_fat(bvh, packed.rows)
    fat_ms = sync_ms(t0) / ITERS
    rows256 = fat_traverse.pad_rows_256(fat.rows)
    print(f"  fat rows {tuple(fat.rows.shape)}, num_nodes {int(fat.num_nodes)}")
    del fat

    recorder = PassRecorder(fat_traverse.make_fat_tracer(None, RES, RES), fat_traverse)
    fat_traverse.launch_count = 0
    frame = frame_fn(rows256, packed, dev_scene, camera, device, tracer=recorder)
    frame(0, 0.0, sort_kind="leaf")
    img, frame_ms, total_rays = timed_frames(frame, sort_kind="leaf")
    launches = fat_traverse.launch_count
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    calls = recorder.calls
    per_call = [c["launches"] for c in calls]
    overflowed = int(sum(int(c["overflow"].sum()) for c in calls))
    print(f"  binary frame: {RES}x{RES}, {BOUNCES} bounce, leaf bounce sort, K6 on every pass, "
          f"{total_rays} rays in {ITERS} frames")
    require(len(calls) == 4 * (ITERS + 1), f"{len(calls)} tracer calls in {ITERS + 1} frames")
    require(all(n > 0 for n in per_call), f"a pass launched no K6: {per_call}")
    require(overflowed == 0, f"{overflowed} passes overflowed a K6 stack")
    require(bool(torch.isfinite(img).all()), "binary frame has non-finite pixels")
    db = frame_psnr(img, split_img)
    out = dict(build_lbvh_ms=build_ms, build_wide_fat_ms=fat_ms, frame_ms=frame_ms,
               mrays_per_s=total_rays / (frame_ms * ITERS) / 1000.0, peak_mem_mib=peak_mib,
               psnr_vs_split_db=db)
    for key, val in out.items():
        print(f"  {key} = {val!r}  [{card}]")
    print(f"  K6 launches per pass = {per_call} (total {launches})")
    require(db >= MIN_PSNR, f"binary frame {db:.2f} dB against the split frame (< {MIN_PSNR})")
    profile_frame("binary", frame_fn(rows256, packed, dev_scene, camera, device,
                                     tracer=fat_traverse.make_fat_tracer(None, RES, RES)), card,
                  sort_kind="leaf")
    return dict(bvh=bvh, packed=packed, rows256=rows256, passes=calls[-4:], launches=launches,
                **out)


def fat_mismatches(kout, pout) -> list:
    """Words of hit, t, prim, tri, u and v on which two K6 runs differ, and
    whether their overflow flags differ."""
    return ([int((k.view(torch.int32) != p.view(torch.int32)).sum())
             for k, p in zip(kout[:6], pout[:6])] + [int(int(kout[6]) != int(pout[6]))])


def count_mismatches(kout, pout, counts) -> list:
    """``fat_mismatches`` of K6's counting instantiation, then the rays on
    which its box tests and triangle-entry tests differ from the plain
    version's ``counts``."""
    return fat_mismatches(kout[:7], pout) + [
        int((kout[7] != counts["box_tests"]).sum()),
        int((kout[8] != counts["tri_entry_tests"]).sum())]


class FatAgreement:
    """K6 against its plain version, bit for bit on all six outputs and the
    overflow flag; so are both forms of ``fat_traverse_cycles``, and K6's
    counting instantiation on the outputs and both counts."""

    def __init__(self):
        self.max_abs_err = 0.0

    def check(self, label, rows256, rays, active) -> int:
        ops = fat_traverse.kernel_operands(rays, active)
        kout = fat_traverse.fat_traverse(rows256, *ops)
        counts = {}
        pout = fat_traverse.trace_fat_plain(rows256, *ops, counts=counts)
        bad = fat_mismatches(kout, pout)
        bad_count = count_mismatches(fat_traverse.fat_traverse(rows256, *ops, count=True), pout,
                                     counts)
        require(sum(bad_count) == 0, f"{label}: K6's counting instantiation != plain on "
                                     f"{bad_count} (outputs, overflow, box and entry tests)")
        for per_thread in (False, True):
            other = fat_mismatches(fat_traverse.fat_traverse_cycles(
                rows256, *ops, per_thread=per_thread), pout)
            require(sum(other) == 0, f"{label}: fat_traverse_cycles(per_thread={per_thread}) "
                                     f"!= plain on {other}")
        hit = kout[0] != 0
        if bool(hit.any()):
            self.max_abs_err = max(self.max_abs_err, float((kout[1] - pout[1])[hit].abs().max()))
        hits = int(hit.sum())
        print(f"  {label:<34} rays={hit.shape[0]:>7} hits={hits:>7} mismatches "
              f"hit/t/prim/tri/u/v/overflow={bad} overflow={int(kout[6])}/{int(pout[6])}; "
              f"both profiled forms and the counting form bit-equal")
        require(sum(bad) == 0, f"{label}: K6 != plain on {bad}")
        require(int(kout[6]) == int(pout[6]) == 0, f"{label}: stack overflow")
        return hits


def fat_tie_fixtures(device, agree: FatAgreement, rng) -> None:
    """K6 against its plain version where rows hold exact t ties: every
    triangle of terrain(32) and of soup(2000) twice, pairs off and on, on
    the camera, axis-aligned, random and half-dead rays and on the random
    rays with tmax = F32_MAX ("unbounded")."""
    for name, base in (("terrain32x2", procedural.terrain(32)),
                       ("soup2000x2", procedural.random_triangle_soup(2000, seed=1))):
        scene = dataclasses.replace(base, triangles=np.repeat(base.triangles, 2, axis=0))
        tris = torch.as_tensor(scene.triangles, device=device)
        sets = fixture_rays(scene, device, rng)
        rays = sets["random"][0]
        sets["unbounded"] = (Rays(rays.origin, rays.direction, rays.tmin,
                                  torch.full_like(rays.tmax, F32_MAX)), None)
        for pairs in (False, True):
            bvh, tp = lbvh.build_lbvh(tris, pairs)
            rows = fat_traverse.pad_rows_256(wide.build_wide_fat(bvh, pack_pairs(tp).rows).rows)
            for set_name, (rays, active) in sets.items():
                agree.check(f"{name} pairs={int(pairs)} {set_name}", rows, rays, active)


def fat_fixture_checks(device, agree: FatAgreement, rng) -> None:
    """K6's fixtures: the sphere and soup(2000), pairs off and on, on their
    camera, axis-aligned, random and half-dead rays; then the tie
    fixtures."""
    for name, scene in (("sphere", procedural.sphere_scene(3)),
                        ("soup2000", procedural.random_triangle_soup(2000, seed=1))):
        tris = torch.as_tensor(scene.triangles, device=device)
        for pairs in (False, True):
            bvh, tp = lbvh.build_lbvh(tris, pairs)
            rows = fat_traverse.pad_rows_256(wide.build_wide_fat(bvh, pack_pairs(tp).rows).rows)
            for set_name, (rays, active) in fixture_rays(scene, device, rng).items():
                agree.check(f"{name} pairs={int(pairs)} {set_name}", rows, rays, active)
    fat_tie_fixtures(device, agree, rng)


def fat_checks(device, card: str, binary: dict, triangles, baselines=()) -> dict:
    """Phase 9."""
    print("phase 9: K6 against its plain version on the card")
    agree = FatAgreement()
    rng = np.random.default_rng(0)
    fat_fixture_checks(device, agree, rng)
    rows256 = binary["rows256"]
    samples = {}
    for name, call in zip(PASSES, binary["passes"]):
        rays, n_live = live_sample(call["rays"], call["active"])
        samples[name] = rays
        print(f"  terrain1M {name}: {rays.origin.shape[0]} of {n_live} live rays")
        hits = agree.check(f"terrain1M {name}", rows256, rays, None)
        require(hits > 0, f"terrain1M {name}: no ray of the sample hits, so it checks nothing")

    # K6's hits against brute force and the scalar tracer on the same tree
    n_sample = samples["bounce"].origin.shape[0]
    rays = samples["bounce"].take(
        torch.linspace(0, n_sample - 1, min(BRUTE_RAYS, n_sample), device=device).round().long())
    rec, stats = fat_traverse.trace_rays_fat(rows256, rays)
    ref = brute_force_trace(triangles, rays, chunk=64)
    srec, sstats = trace_rays(pack_bvh(binary["bvh"]), binary["packed"], rays)
    num = rays.origin.shape[0]
    both = rec.hit & ref.hit
    bad_hit = int((rec.hit != ref.hit).sum())
    bad_t = int((both & ((rec.t - ref.t).abs() > T_RTOL * ref.t.abs())).sum())
    bad_prim = int((both & (rec.prim_id != ref.prim_id)).sum())
    both_s = rec.hit & srec.hit
    bad_hit_s = int((rec.hit != srec.hit).sum())
    bad_t_s = int((both_s & ((rec.t - srec.t).abs() > T_RTOL * srec.t.abs())).sum())
    print(f"  brute force, {num} bounce rays over {triangles.shape[0]} tris: "
          f"{int(ref.hit.sum())} hits, mismatches hit={bad_hit} t={bad_t} prim={bad_prim}; "
          f"scalar trace_rays: {int(srec.hit.sum())} hits, mismatches hit={bad_hit_s} "
          f"t={bad_t_s}; overflow K6 {int(stats.overflow)} scalar {int(sstats.overflow)}")
    for key, count in (("hit", bad_hit), ("t", bad_t), ("prim", bad_prim)):
        require(count <= (1.0 - BRUTE_AGREE) * num,
                f"K6 and brute force disagree on {key} for {count} rays")
    require(bad_hit_s == 0 and bad_t_s == 0, "K6 and the scalar tracer disagree")
    require(int(stats.overflow) == 0 and int(sstats.overflow) == 0, "stack overflow")
    timing = time_fat_passes(rows256, binary["passes"], card, baselines)
    print(f"  K6 launch count after the comparisons = {fat_traverse.launch_count} "
          f"(binary path: {binary['launches']})")
    return dict(max_abs_err=agree.max_abs_err, **timing)


class BaselineK6:
    """An earlier K6 source given by ``--k6-baseline``: the same C entry,
    ``fat_traverse_launch``. Called as ``fat_traverse`` is; it counts no
    launch."""

    def __init__(self, source: Path, index: int):
        self.source = source
        self.name = f"fat_traverse_baseline{index}"

    def __call__(self, rows, origin, direction, tmin, tmax):
        _cuda_build.load_library(self.name, self.source)
        return fat_traverse._launch("fat_traverse_launch", fat_traverse._ARGTYPES, rows, origin,
                                    direction, tmin, tmax, library=self.name)


def fat_pass_operands(call):
    """K6's operands for one pass of the binary frame in the order the tiled
    tracer hands them over (16 x 8 screen tiles), and the live mask in that
    order."""
    rays, active = call["rays"], call["active"]
    tiled = Rays(*(tile_reorder(getattr(rays, f), RES, RES, 16, 8)
                   for f in ("origin", "direction", "tmin", "tmax")))
    live = (torch.ones(rays.origin.shape[0], dtype=torch.bool, device=rays.origin.device)
            if active is None else tile_reorder(active, RES, RES, 16, 8))
    return fat_traverse.kernel_operands(tiled, live), live


def time_fat_passes(rows256, passes, card: str, baselines=()) -> dict:
    """K6 on each of the binary frame's four passes, on the operands the
    tiled tracer hands it: K6 and any baselines, CUDA-event ms (mean of 5
    launches after a warm one), each bit-equal to the plain version on every
    ray; both clock64 splits and triangle tests run per live ray
    (``fat_traverse_cycles``: K6's by the warp, the replaced kernel's per
    lane) from one launch each; the bound from the plain version's
    counts, counted as phase 4 counts K1's; pops per live
    ray and triangle tests per pop and per live ray. Then the plain version
    is timed on the bounce pass (one run). Returns K6's numbers on the
    bounce pass, which stand for it in the kernels line."""
    kernels = {"K6": fat_traverse.fat_traverse}
    for b in baselines:
        kernels[f"{b.name} ({Path(b.source).name})"] = b
    totals = dict.fromkeys(kernels, 0.0)
    res = {}
    for name, call in zip(PASSES, passes):
        ops, live = fat_pass_operands(call)
        num, n_live = ops[0].shape[0], int(live.sum())
        counts = {}
        pout = fat_traverse.trace_fat_plain(rows256, *ops, counts=counts)
        times = {}
        for label, fn in kernels.items():
            ms, kout = event_ms(lambda: fn(rows256, *ops), 5)
            bad = fat_mismatches(kout, pout)
            require(sum(bad) == 0 and int(kout[6]) == 0,
                    f"1M {name} pass: {label} and plain disagree ({bad}) or overflow")
            times[label] = ms
            totals[label] += ms
        bad = count_mismatches(fat_traverse.fat_traverse(rows256, *ops, count=True), pout, counts)
        require(sum(bad) == 0, f"1M {name} pass: K6's counting instantiation != plain on {bad}")
        splits = []
        for per_thread, label in ((False, "K6, by the warp"),
                                  (True, "the one-thread-per-ray kernel, per lane")):
            *kout, cycles, tests = fat_traverse.fat_traverse_cycles(rows256, *ops,
                                                                    per_thread=per_thread)
            bad = fat_mismatches(kout, pout)
            require(sum(bad) == 0, f"1M {name} pass: {label}: profiled form != plain on {bad}")
            if per_thread:
                require(torch.equal(tests, counts["tri_tests"].to(tests)),
                        f"1M {name} pass: {label}: triangle tests != the plain version's")
            per_ray = cycles[:, live].double().mean(dim=1).tolist()
            whole = sum(per_ray)
            splits.append(f"{label} {whole:.0f} cycles: " + ", ".join(
                f"{phase} {c:.0f} ({100.0 * c / whole:.1f}%)"
                for phase, c in zip(fat_traverse.PHASES, per_ray))
                + f"; triangle tests run {float(tests[live].double().mean())!r}")
        # bound: box tests of non-empty entries and triangle tests run; rays in
        # (32 B), results out (24 B), the node words (256 B) of each row visited
        # and the pair words (64 B) of each Tri entry whose box a ray entered
        n_box, n_tri = float(counts["box_tests"].sum()), float(counts["tri_tests"].sum())
        n_ops = n_box * SLAB_OPS + n_tri * MT_OPS
        n_rows, n_entries = int(counts["visited"].sum()), int(counts["visited_tri"].sum())
        nbytes = num * (32 + 24) + n_rows * 256 + n_entries * 64
        b = bound(n_ops, nbytes)
        pops = float(counts["pops"][live].sum())
        tri_live = float(counts["tri_tests"][live].sum())
        print(f"  1M {name} pass: {num} rays ({n_live} live): "
              + ", ".join(f"{label} {ms!r} ms" for label, ms in times.items())
              + f"; bound {b['bound_ms']!r} ms ({b['bound_by']}; {n_ops:.4g} ops, {nbytes} bytes: "
              f"{n_rows} rows, {n_entries} Tri entries); per live ray: pops {pops / n_live!r}, "
              f"triangle tests {tri_live / n_live!r}; triangle tests per pop {tri_live / pops!r}; "
              f"bit-equal to plain, the counting form too  [{card}]")
        for line in splits:
            print(f"    clock64 per live ray, {line}  [{card}]")
        res[name] = dict(ms=times["K6"], **b)
    print("  on the four passes: " + ", ".join(f"{label} {ms!r} ms a frame"
                                               for label, ms in totals.items()) + f"  [{card}]")
    ops, _ = fat_pass_operands(passes[2])
    plain_ms, _ = event_ms(lambda: fat_traverse.trace_fat_plain(rows256, *ops), 1, warm=False)
    print(f"  plain version on the 1M bounce pass: {plain_ms!r} ms  [{card}]")
    return dict(plain_ms=plain_ms, **res["bounce"])


def split_versions(split: dict) -> dict:
    """Phase 10: kernel_v 5, 4 and 2 on phase 3's bounce pass; returns
    {kernel_v: K1 launches}."""
    print("phase 10: kernel_v 5, 4 and 2 (K3, v4, K4) on the bench frame's bounce pass")
    cap = split["captured"]["bounce_tracer"]
    views, packed = split["views"], split["packed"]
    ref, ref_stats = split_trace.trace_rays_split(views, packed, cap.rays, cap.active,
                                                  kernel_v=3)
    launches = {}
    for v in (5, 4, 2):
        split_trace.launch_count = 0
        rec, stats = split_trace.trace_rays_split(views, packed, cap.rays, cap.active,
                                                  kernel_v=v)
        torch.cuda.synchronize()
        launches[v] = split_trace.launch_count
        bad_t = int((rec.t.view(torch.int32) != ref.t.view(torch.int32)).sum())
        bad_tri = int((rec.tri_id != ref.tri_id).sum())
        print(f"  kernel_v={v}: {launches[v]} K1 launch(es), t mismatches {bad_t}, "
              f"tri mismatches {bad_tri} against kernel_v=3")
        require(launches[v] > 0, f"kernel_v={v} launched no K1")
        require(bad_t == 0 and bad_tri == 0, f"kernel_v={v} differs from kernel_v=3")
        if v == 2:
            w = views[0].shape[1]
            total = (int(ref_stats.box_tests.sum()) // w
                     + int(ref_stats.tri_tests.sum()) // (2 * split_trace.LEAFW))
            print(f"  kernel_v=2 stats: box_tests[0] = {int(stats.box_tests[0])} total pops "
                  f"(kernel_v=3: {total}), other entries nonzero "
                  f"{int((stats.box_tests[1:] != 0).sum())}, tri_tests nonzero "
                  f"{int((stats.tri_tests != 0).sum())}")
            require(int(stats.box_tests[0]) == total and not bool(stats.box_tests[1:].any())
                    and not bool(stats.tri_tests.any()), "kernel_v=2 stats are not v2's shape")
    return launches


def differing_words(a, b) -> int:
    """Words of a and b that differ bit for bit (NaN against NaN counts as
    equal: both sides carry interpret mode's NaN fill through)."""
    if a.dtype.is_floating_point:
        return int(((a.view(torch.int32) != b.view(torch.int32))
                    & ~(torch.isnan(a) & torch.isnan(b))).sum())
    return int((a != b).sum())


def abs_err(a, b) -> float:
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    d = d[~torch.isnan(d)]
    return float(d.max()) if d.numel() else 0.0


def outputs(res) -> tuple:
    return tuple(x for x in (res if isinstance(res, tuple) else (res,)) if x is not None)


def check_probe(mod, kind: str, device, rows) -> dict:
    """One probe's kernel against its plain version at the check size, bit
    for bit on every output; returns max_abs_err, plain_ms and the kernel's
    check-size outputs."""
    if mod in (micro_pallas, micro_control):
        seed = torch.tensor([7], dtype=torch.int32, device=device)
        runs = (("seeded scratch", _micro.make_fill(7, device)),
                ("interpret fill", _micro.interpret_fills(device)))
        call = lambda fill, f: f(kind, rows, seed, PROBE_N_CHECK, fill)  # noqa: E731
    else:
        tab, idx = mod.inputs(kind, 3, device)
        runs = (("seeded inputs", None),)
        call = lambda fill, f: f(kind, tab, idx, PROBE_ITERS_CHECK)  # noqa: E731
    worst, plain_ms, kout = 0.0, None, None
    for label, fill in runs:
        kout = outputs(call(fill, mod.probe))
        ms, pout = event_ms(lambda: call(fill, mod.probe_plain), 1, warm=False)
        plain_ms = ms if plain_ms is None else plain_ms
        pout = outputs(pout)
        bad = [differing_words(k, p) for k, p in zip(kout, pout)]
        require(len(kout) == len(pout) and sum(bad) == 0,
                f"{mod.__name__}.{kind} ({label}): kernel != plain on {bad} words")
        worst = max([worst] + [abs_err(k, p) for k, p in zip(kout, pout)])
    return dict(max_abs_err=worst, plain_ms=plain_ms, outputs=kout)


def probe_library_ms(mod, kind: str, device, iters: int):
    """PyTorch's own calls for the same function at the reference's size,
    median of 5 runs: take_along_dim for the one-shot gathers and the one
    shift (its kernels' device time, as the probes' kernels are timed); for
    e2 the whole chain of ITERS torch.matmul and remainder steps in one
    CUDA-event window. None where there is no such call."""
    if not hasattr(mod, "library"):
        return None
    tab, idx = mod.inputs(kind, 0, device)
    if mod.library(kind, tab, idx, 1) is None:
        return None
    runs = _common.time_runs(lambda t, i, n: mod.library(kind, t, i, n),
                             _lane.arg_sets((tab, idx), iters), device, window=kind == "e2")
    return statistics.median(runs)


def lane_spread(device, card: str, iters: int) -> None:
    """What bank conflicts cost a lane gather: ``fetch`` (96 rows gathered
    per lane and iteration) with every lane on one column, on 128 distinct
    conflict-free columns, and on 128 distinct columns 4 to a bank, each
    checked against its plain version; and how the reference's own chains
    fall on the banks (they converge onto a few columns)."""
    tab, idx = probe_lane_machine2.inputs("fetch", 0, device)
    tab3, idx3 = probe_lane_machine3.inputs("V2", 0, device)
    for name, walk in (("fetch/full", _lane.pointer_walk(tab, idx[0], iters)),
                       ("V0-V4", _lane.pointer_walk(tab3, idx3[0], iters, relative=True))):
        cols, degree = _lane.bank_profile(walk)
        print(f"  {name} on the reference's inputs: {cols!r} distinct columns per warp read, "
              f"mean bank-conflict degree {degree!r}")
    for spread in probe_lane_machine2.SPREADS:
        tab, idx = probe_lane_machine2.spread_inputs(spread, 0, device)
        kout, _ = probe_lane_machine2.probe("fetch", tab, idx, PROBE_ITERS_CHECK)
        pout, _ = probe_lane_machine2.probe_plain("fetch", tab, idx, PROBE_ITERS_CHECK)
        require(differing_words(kout, pout) == 0, f"fetch ({spread} lanes): kernel != plain")
        cols, degree = _lane.bank_profile(_lane.pointer_walk(tab, idx[0], iters))
        runs = _common.time_runs(lambda *a: probe_lane_machine2.probe("fetch", *a),
                                 _lane.arg_sets((tab, idx), iters), device)
        ms = statistics.median(runs)
        print(f"  fetch, lanes {spread:<9}: {cols!r} columns per warp read, conflict degree "
              f"{degree!r}: {ms * 1e6 / iters:.1f} ns/iter ({ms!r} ms, bit-equal)  [{card}]")


def probe_phase(device, card: str) -> list:
    """Phase 11: the micro-probes' entry points, then each kernel against
    its plain version; returns the probes' entries of the kernels line."""
    print("phase 11: the benchmarks/ micro-probes")
    for mod in PROBE_MODULES:
        for kind in mod.KINDS:
            mod.launch_count[kind] = 0
    timing = {mod: mod.main([]) for mod in PROBE_MODULES}
    launches = {mod: dict(mod.launch_count) for mod in PROBE_MODULES}
    for mod in PROBE_MODULES:
        idle = [k for k, n in launches[mod].items() if n == 0]
        require(not idle, f"{mod.__name__}: no launch of {idle} on the probes' path")
        wrong = [k for k, res in timing[mod].items() if res["ok"] is False]
        require(not wrong, f"{mod.__name__}: {wrong} differ from PyTorch's own calls")
    iters_ref = int(timing[probe_lane_machine]["e1c"]["iters"])
    rows = _micro.make_rows(device)
    entries = []
    print(f"  kernel vs plain at N = {PROBE_N_CHECK} / ITERS = {PROBE_ITERS_CHECK}, bit for bit; "
          f"kernel ms at the reference's size  [{card}]")
    for mod in PROBE_MODULES:
        short = mod.__name__.rsplit(".", 1)[1]
        for kind in mod.KINDS:
            res = timing[mod][kind]
            chk = check_probe(mod, kind, device, rows)
            if mod in (micro_pallas, micro_control):
                ops, nbytes = mod.work(kind, 1, res["iters"])
                bf16_ops, lib_ms = 0.0, None
            else:
                tab, idx = mod.inputs(kind, 0, device)
                outs = chk["outputs"]
                lane_kind = "wide" if kind.startswith("wide") else kind
                ops, bf16_ops, nbytes = _lane.work(
                    lane_kind, tab, idx, outs[0].shape[0],
                    outs[1].shape[0] if len(outs) > 1 else 0, iters_ref)
                lib_ms = probe_library_ms(mod, kind, device, iters_ref)
            b = bound(ops, nbytes, bf16_ops)
            rate = (f"{res['ns_per_iter']:10.1f} ns/iter" if res["iters"] > 1
                    else "  one shot     ")
            print(f"  {short}.{kind:<8} {rate}  kernel "
                  f"{res['ms']!r} ms, plain {chk['plain_ms']!r} ms (check size), bound "
                  f"{b['bound_ms']!r} ms ({b['bound_by']}), library {lib_ms!r} ms, "
                  f"launches {launches[mod][kind]}: bit-equal")
            entries.append({
                "name": f"{short}.{kind}", "route": "cuda", "source": mod.SOURCE,
                "replaces": f"{mod.REFERENCE}:{mod.REPLACES[kind]}",
                "launches": launches[mod][kind], "max_abs_err": chk["max_abs_err"],
                "ms": res["ms"], "plain_ms": chk["plain_ms"], "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": lib_ms})
    ns = {(mod, k): timing[mod][k]["ns_per_iter"] for mod in PROBE_MODULES for k in mod.KINDS}
    for label, holds in (
            ("dma1 > loop", ns[micro_pallas, "dma1"] > ns[micro_pallas, "loop"]),
            ("pipe4 < dma1", ns[micro_pallas, "pipe4"] < ns[micro_pallas, "dma1"]),
            ("fetch2 >= fetch", ns[probe_lane_machine2, "fetch2"] >= ns[probe_lane_machine2, "fetch"]),
            ("V3 <= V2 per packet-iter",
             ns[probe_lane_machine3, "V3"] <= ns[probe_lane_machine3, "V2"])):
        print(f"  sanity ordering {label}: {'holds' if holds else 'DOES NOT HOLD'}")
    lane_spread(device, card, iters_ref)
    return entries


class ModeRecorder:
    """Wraps ``app/main.py:render_frame``: for each call, its render mode
    and the launches of K6's counting instantiation it made."""

    def __init__(self):
        self.fn = app_main.render_frame
        self.calls = []

    def __call__(self, *args, **kw):
        before = fat_traverse.count_launch_count
        out = self.fn(*args, **kw)
        self.calls.append((int(args[6]), fat_traverse.count_launch_count - before))
        return out


def run_app(argv):
    """``app/main.py:main(argv)`` in this process, its ``render_frame``
    recorded; returns (main's result, [(mode, counting launches)], wall s,
    its standard output)."""
    rec = ModeRecorder()
    app_main.render_frame = rec
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = app_main.main(argv)
    finally:
        app_main.render_frame = rec.fn
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        if not line.startswith(("Total number of box tests", "frame ")):
            print("    | " + line)
    return res, rec.calls, wall, buf.getvalue()


def mode_images(res) -> dict:
    """{(frame, mode): [H, W, 4] uint8} read back from the app's PNGs."""
    out = {}
    for frame, mode, _, path in res["frames"]:
        require(Path(path).stat().st_size > 0, f"{path} is empty")
        out[(frame, mode)] = read_png(path)
    return out


def check_mode_images(label: str, images: dict, frames: int) -> str:
    """Every mode's image decoded at full size; all but LODS (whose alpha
    is its grey) opaque, the modes that read no texture among them.
    Returns each frame-0 image's share of non-black pixels, to print."""
    for (frame, mode), img in images.items():
        require(img.shape == (APP_H, APP_W, 4), f"{label} mode {mode}: shape {img.shape}")
        if mode != LODS_MODE:
            require(bool((img[..., 3] == 255).all()), f"{label} mode {mode}: alpha not 255")
    require(sorted(m for f, m in images if f == 0) == list(range(NUM_MODES))
            and len(images) == NUM_MODES * frames, f"{label}: images {sorted(images)}")
    return ", ".join(f"{m}: {float(images[(0, m)][..., :3].any(axis=-1).mean()):.3f}"
                     for m in range(NUM_MODES))


def frame_ms_by_mode(res) -> dict:
    return {(f, m): ms for f, m, ms, _ in res["frames"]}


def aerial_modes(card: str, res) -> dict:
    """The app's structures rendered in every mode from phase 3's aerial
    camera (bench.py:85-91), whose rays cross the terrain as a user's view
    would: one warm frame and ITERS timed ones each (host clock,
    synchronised, the image left on the card), then one DEPTH and one
    TEXTURE_LIT_SHADOWS frame profiled. Returns the camera."""
    bvh = res["bvh"]
    box = dataclasses.make_dataclass("Box", ["aabb_min", "aabb_max"])(
        bvh.node_min[0].cpu().numpy(), bvh.node_max[0].cpu().numpy())
    camera = aerial_camera(box, bvh.node_min.device)
    times = {}
    for m in range(NUM_MODES):
        def frame():
            return render.render_frame(res["trav"], res["packed"], res["scene"], camera, APP_W,
                                       APP_H, RenderType(m), tracer=res["tracer"])
        img, _ = frame()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            img, tests = frame()
        times[m] = sync_ms(t0) / ITERS
        share = float((img[..., :3] != 0).any(dim=-1).float().mean())
        print(f"  terrain1M wide, aerial camera, mode {m} ({RenderType(m).name}): "
              f"{times[m]!r} ms a frame ({ITERS} frames), box tests {int(tests)}, non-black "
              f"share {share:.3f}  [{card}]")
        require(share > 0.25, f"aerial mode {m}: only {share:.3f} of the frame is lit")
    for m in (RenderType.DEPTH, RenderType.TEXTURE_LIT_SHADOWS):
        profile_frame(f"aerial mode {int(m)} ({m.name})", lambda *a, m=m: render.render_frame(
            res["trav"], res["packed"], res["scene"], camera, APP_W, APP_H, m,
            tracer=res["tracer"]), card)
    return camera


def counting_checks(card: str, res, aerial, fixtures: bool) -> dict:
    """Phase 13 (b): K6's counting instantiation against its plain version
    on 65,536 live rays of the app frame's primary pass and of
    TEXTURE_LIT_SHADOWS' shadow pass, in the 8x8 tile order the wide tracer
    hands them over, and the same from the ``aerial`` camera (with
    ``fixtures``, also phase 9's fixtures); then both instantiations timed
    on the whole aerial primary pass with the bound, and the counting one
    held to the plain version on every ray of it."""
    fat = res["trav"]
    rows256 = wide_fat.live_rows256(fat)

    def tiled(rays):
        return Rays(*(tile_reorder(getattr(rays, f), APP_W, APP_H, 8, 8)
                      for f in ("origin", "direction", "tmin", "tmax")))

    passes = {}
    for label, camera in (("app", res["camera"]), ("aerial", aerial)):
        primary = generate_primary_rays(camera, APP_W, APP_H)
        rec, _ = res["tracer"](fat, res["packed"], primary)
        passes[f"{label} primary"] = tiled(primary)
        passes[f"{label} shadow"] = tiled(render._shadow_rays(res["scene"], primary, rec))
    max_err = 0.0
    for name, rays in passes.items():
        sample, n_live = live_sample(rays, None)
        ops = fat_traverse.kernel_operands(sample)
        kout = fat_traverse.fat_traverse(rows256, *ops, count=True)
        counts = {}
        pout = fat_traverse.trace_fat_plain(rows256, *ops, counts=counts)
        bad = count_mismatches(kout, pout, counts)
        hits = int(pout[0].sum())
        print(f"  {name} pass: {sample.origin.shape[0]} of {n_live} live rays, {hits} hits; "
              f"mismatches hit/t/prim/tri/u/v/overflow/box/entry={bad}; box tests "
              f"{int(counts['box_tests'].sum())}, triangle-entry tests "
              f"{int(counts['tri_entry_tests'].sum())}")
        require(sum(bad) == 0, f"{name} pass: counting K6 != plain on {bad}")
        # the shadow rays may all reach the light; their tests are still counted
        require((hits > 0 or "shadow" in name) and int(counts["tri_entry_tests"].sum()) > 0,
                f"{name} pass: the sample checks no hit or no count")
        if hits:
            hit = kout[0] != 0
            max_err = max(max_err, float((kout[1] - pout[1])[hit].abs().max()))
    if fixtures:
        fat_fixture_checks(fat.rows.device, FatAgreement(), np.random.default_rng(0))

    res_by_pass = {}
    for name in ("app primary", "aerial primary"):
        res_by_pass[name] = time_counting(card, rows256, passes[name], name, int(fat.num_nodes))
    # the kernels line takes the main path's own pass: the app camera's
    return dict(max_abs_err=max_err, **res_by_pass["app primary"])


def time_counting(card: str, rows256, rays, name: str, num_rows: int) -> dict:
    """K6 and its counting instantiation timed on one whole pass (CUDA
    events, 5 launches after a warm one, in turns K6, counting, counting,
    K6), the plain version once, the counting one held to it on every ray;
    the bound from the plain version's counts, as phase 9 counts it."""
    ops = fat_traverse.kernel_operands(rays)
    num = ops[0].shape[0]
    counting = lambda: fat_traverse.fat_traverse(rows256, *ops, count=True)  # noqa: E731
    plain_k6 = lambda: fat_traverse.fat_traverse(rows256, *ops)  # noqa: E731
    times = {"K6": [], "K6 counting": []}
    for label, fn in (("K6", plain_k6), ("K6 counting", counting), ("K6 counting", counting),
                      ("K6", plain_k6)):
        ms, out = event_ms(fn, 5)
        times[label].append(ms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = {}
    pout = fat_traverse.trace_fat_plain(rows256, *ops, counts=counts)
    plain_ms = sync_ms(t0)
    bad = count_mismatches(counting(), pout, counts)
    require(sum(bad) == 0, f"{name} pass: counting K6 != plain on {bad}")
    # bound: box tests of non-empty entries and triangle tests run; rays in
    # (32 B), results and the two counts out (32 B), the node words (256 B)
    # of each row visited and the pair words (64 B) of each Tri entry entered
    n_box, n_tri = float(counts["box_tests"].sum()), float(counts["tri_tests"].sum())
    n_ops = n_box * SLAB_OPS + n_tri * MT_OPS
    n_rows, n_entries = int(counts["visited"].sum()), int(counts["visited_tri"].sum())
    nbytes = num * (32 + 32) + n_rows * 256 + n_entries * 64
    b = bound(n_ops, nbytes)
    print(f"  {name} pass, {num} rays, 8x8 tiles, {num_rows} fat rows: K6 "
          f"{times['K6'][0]!r} / {times['K6'][1]!r} ms, K6 counting {times['K6 counting'][0]!r} / "
          f"{times['K6 counting'][1]!r} ms (turns: K6, counting, counting, K6); bound "
          f"{b['bound_ms']!r} ms ({b['bound_by']}; {n_ops:.4g} ops, {nbytes} bytes: {n_rows} rows, "
          f"{n_entries} Tri entries); per ray: pops {float(counts['pops'].double().mean())!r}, box "
          f"tests {n_box / num!r}, triangle-entry tests "
          f"{float(counts['tri_entry_tests'].double().mean())!r}; plain version {plain_ms!r} ms; "
          f"counting K6 bit-equal to plain on every ray  [{card}]")
    return dict(ms=statistics.mean(times["K6 counting"]), plain_ms=plain_ms, **b)


def app_phase(device, card: str, fixtures: bool = False) -> dict:
    """Phase 13: the app's default run on the card (the render modes on
    the wide tracer), K6's counting instantiation against its plain
    version, the rock asset, and the split tracer's render modes."""
    print("phase 13: the app's default run: --type sah --tracer wide --bounces 0, "
          f"{APP_W}x{APP_H}, every render mode")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    scene_arg = f"terrain:{NUM_TRIS}"
    size = ["--width", str(APP_W), "--height", str(APP_H)]

    # the app with no flags at all, as a user first runs it: cornell,
    # 1024x768, mode 0, into ./out
    OUT_DIR.mkdir(parents=True)
    with contextlib.chdir(OUT_DIR):
        res, calls, wall, _ = run_app([])
    image = read_png(str(OUT_DIR / "out" / "frame0000_mode0.png"))
    require(image.shape == (768, 1024, 4) and calls == [(0, 1)],
            f"the no-flag run: image {image.shape}, counting launches {calls}")
    print(f"  no flags: cornell, out/frame0000_mode0.png {image.shape}, frame "
          f"{res['frames'][0][2]!r} ms, app wall {wall!r} s  [{card}]")
    del res

    # (a) the 1M scene through the app's default path
    fat_traverse.count_launch_count = 0
    fat_traverse.launch_count = 0
    torch.cuda.reset_peak_memory_stats()
    res, calls, wall, _ = run_app(["--scene", scene_arg, "--pairs", "--cycle-modes", *size,
                                   "--frames", str(APP_FRAMES), "--output",
                                   str(OUT_DIR / "terrain_wide")])
    launches = fat_traverse.count_launch_count
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    require(fat_traverse.launch_count == 0, "the wide tracer launched K6 without counts")
    require(len(calls) == NUM_MODES * APP_FRAMES and all(n > 0 for _, n in calls),
            f"a mode launched no counting K6: {calls}")
    stages = dict(res["stages"])
    depth = fat_traverse.binary_depth(res["bvh"])
    images = mode_images(res)
    lit = check_mode_images("terrain wide", images, APP_FRAMES)
    for m in range(NUM_MODES):
        require(np.array_equal(images[(0, m)], images[(APP_FRAMES - 1, m)]),
                f"mode {m}: frames 0 and {APP_FRAMES - 1} differ with one camera")
    ms = frame_ms_by_mode(res)
    print(f"  terrain1M wide: SAH binary build {stages['SharedTaskBuild     ']!r} ms, fat collapse "
          f"{stages['WideFatCollapse     ']!r} ms ({int(res['trav'].num_nodes)} rows, binary "
          f"depth {depth}); app wall {wall!r} s; peak {peak_mib!r} MiB  [{card}]")
    for m in range(NUM_MODES):
        print(f"  terrain1M wide mode {m} ({RenderType(m).name}): frame ms "
              + " / ".join(f"{ms[(f, m)]!r}" for f in range(APP_FRAMES))
              + f" (render and read-back, frames 0..{APP_FRAMES - 1}); counting K6 launches "
              f"{[n for mm, n in calls if mm == m]}  [{card}]")
    print(f"  counting K6 launches on the app's path = {launches}; non-black share by mode "
          f"(the default camera sits at the scene's centre, on the terrain): {lit}")
    aerial = aerial_modes(card, res)
    k6c = counting_checks(card, res, aerial, fixtures)
    wide_images = {m: images[(0, m)] for m in range(NUM_MODES)}
    del res, images

    # (d) the split tracer's render modes on the same scene
    res, _, wall, _ = run_app(["--scene", scene_arg, "--pairs", "--cycle-modes", "--tracer",
                               "split", *size, "--output", str(OUT_DIR / "terrain_split")])
    images = mode_images(res)
    lit = check_mode_images("terrain split", images, 1)
    ms = frame_ms_by_mode(res)
    dbs = {m: psnr(images[(0, m)], wide_images[m]) for m in range(NUM_MODES)}
    print(f"  terrain1M split (K1): app wall {wall!r} s; frame ms by mode "
          + ", ".join(f"{m}: {ms[(0, m)]!r}" for m in range(NUM_MODES)) + f"  [{card}]")
    print("  terrain1M split against wide, PSNR dB by mode: "
          + ", ".join(f"{m}: {db:.2f}" for m, db in dbs.items()) + f"; non-black share {lit}")
    for m in SPLIT_PSNR_MODES:
        require(dbs[m] >= MIN_PSNR, f"split mode {m}: {dbs[m]:.2f} dB against wide")
    del res, images, wide_images

    # (c) the rock: generated, loaded by both parsers, all modes on K6 and
    # on trace_rays over the same SAH tree
    t0 = time.perf_counter()
    path = genasset.generate_rock(str(OUT_DIR / "rock_asset"), subdivisions=ROCK_SUBDIVISIONS)
    gen_s = time.perf_counter() - t0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        scene_n = objio.load_obj(path)
    native_s = time.perf_counter() - t0
    require("OBJ parser: native" in buf.getvalue(), f"the native parser did not run: "
                                                    f"{buf.getvalue()!r}")
    native_parse = objio._try_native_parse
    objio._try_native_parse = lambda f: None  # the Python parser, as the tests force it
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            scene_p = objio.load_obj(path)
    finally:
        objio._try_native_parse = native_parse
    python_s = time.perf_counter() - t0
    for f in ("triangles", "normals", "uvs", "material_ids", "aabb_min", "aabb_max", "light"):
        require(np.array_equal(getattr(scene_n, f), getattr(scene_p, f)),
                f"rock: native and Python parsers differ on {f}")
    require(all(np.array_equal(a, b) for tn, tp in zip(scene_n.library.textures,
                                                       scene_p.library.textures)
                for a, b in zip(tn.mips, tp.mips)), "rock: textures differ")
    print(f"  rock: {scene_n.num_triangles} triangles, {len(scene_n.library.textures)} texture(s) "
          f"({scene_n.library.textures[0].mips[0].shape}); generated in {gen_s:.2f} s, native "
          f"parse {native_s:.2f} s ({native_loader.SRC.name}), Python parse {python_s:.2f} s; "
          f"the two parsers' arrays equal  [{card}]")
    fat_traverse.count_launch_count = 0
    res_w, calls_w, wall_w, _ = run_app([path, "--cycle-modes", *size, "--output",
                                         str(OUT_DIR / "rock_wide")])
    require(all(n > 0 for _, n in calls_w), f"rock: a mode launched no counting K6: {calls_w}")
    res_s, _, wall_s, _ = run_app([path, "--cycle-modes", "--tracer", "scalar", *size,
                                   "--output", str(OUT_DIR / "rock_scalar")])
    img_w, img_s = mode_images(res_w), mode_images(res_s)
    print(f"  rock non-black share by mode: {check_mode_images('rock wide', img_w, 1)}")
    check_mode_images("rock scalar", img_s, 1)
    ms_w, ms_s = frame_ms_by_mode(res_w), frame_ms_by_mode(res_s)
    for m in range(NUM_MODES):
        a, b = img_w[(0, m)], img_s[(0, m)]
        db = psnr(a, b)
        colours = len(np.unique(a[..., :3].reshape(-1, 3), axis=0))
        print(f"  rock mode {m} ({RenderType(m).name}): K6 {ms_w[(0, m)]!r} ms, trace_rays "
              f"{ms_s[(0, m)]!r} ms, PSNR {db:.2f} dB, {colours} colours  [{card}]")
        if m in ROCK_PSNR_MODES:
            require(db >= MIN_PSNR, f"rock mode {m}: {db:.2f} dB between K6 and trace_rays")
        if m in TEXTURED_MODES:
            require(colours > 1, f"rock mode {m} shows one colour: no texel was read")
    print(f"  rock: app wall {wall_w!r} s (wide), {wall_s!r} s (scalar); SAH build "
          f"{dict(res_w['stages'])['SharedTaskBuild     ']!r} ms, fat collapse "
          f"{dict(res_w['stages'])['WideFatCollapse     ']!r} ms  [{card}]")
    return dict(launches=launches, **k6c)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    parser.add_argument("--k1-only", action="store_true",
                        help="stop after phase 4 (build, bench frame, K1's checks and timings); "
                             "prints no summary lines")
    parser.add_argument("--app-only", action="store_true",
                        help="run phases 1, 2 and 13 only (the app's render modes, K6's "
                             "counting instantiation with phase 9's fixtures, the rock); "
                             "prints no summary lines")
    parser.add_argument("--k5-baseline", type=Path, metavar="SOURCE",
                        help="an earlier csrc/lane_trace.cu (the same C interface over the "
                             "reference's tables layout) to build, check against K5 and time "
                             "beside it in phase 7")
    parser.add_argument("--k6-baseline", type=Path, metavar="SOURCE", action="append",
                        default=[],
                        help="an earlier csrc/fat_traverse.cu (the same fat_traverse_launch) "
                             "to build, check against K6 and time beside it in phase 9; "
                             "may be given more than once")
    args = parser.parse_args(argv)
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
    baseline, sources = None, {}
    if args.k5_baseline is not None:
        baseline = BaselineK5(args.k5_baseline.resolve())
        sources[BaselineK5.NAME] = baseline.source
    baselines6 = [BaselineK6(src.resolve(), i) for i, src in enumerate(args.k6_baseline)]
    for b in baselines6:
        sources[b.name] = b.source
    _cuda_build.load_libraries(LIBRARIES + list(sources), sources)
    print(f"phase 2: built {', '.join(n + '.cu' for n in LIBRARIES)}"
          f"{''.join(f' and {src} (as {n})' for n, src in sources.items())} in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, (nvcc_s, log) in _cuda_build.BUILD_INFO.items():
        print(f"  {name}: nvcc {nvcc_s:.2f} s")
        for line in demangled(log).splitlines():
            if "Compiling entry function" in line:
                print("    " + line.split("'")[1][:110])
            elif "registers" in line or "spill" in line:
                print("      " + line.strip())

    if args.app_only:
        app_phase(device, card, fixtures=True)
        print("chip_smoke: stopped after phase 13 (--app-only)")
        return 0
    scene = procedural.terrain(NUM_TRIS)
    dev_scene = scene_to_device(scene, device)
    camera = aerial_camera(scene, device)
    triangles = torch.as_tensor(scene.triangles, device=device)
    split = split_path(device, card, scene, dev_scene, camera, triangles)
    k1 = k1_checks(device, card, split)
    sah_frame = sah_checks(device, card, scene, dev_scene, camera, triangles, split)
    if args.k1_only:
        print("chip_smoke: stopped after phases 4 and 12 (--k1-only)")
        return 0
    treelet_build(card, split["front"])
    lane = lane_path(device, card, dev_scene, camera, triangles, split["img"])
    lane_launches = lane["launches"]
    k5 = lane_checks(device, card, lane, triangles, baseline)
    del lane
    binary = binary_path(device, card, dev_scene, camera, triangles, split["img"])
    k6 = fat_checks(device, card, binary, triangles, baselines6)
    versions = split_versions(split)
    probes = probe_phase(device, card)
    k1_launches = split["launches"] + sah_frame["launches"]
    binary_launches = binary["launches"]
    del split, binary, sah_frame
    app = app_phase(device, card)

    def entry(name, source, replaces, launches, res):
        # no single PyTorch call traces rays through a BVH: library_ms is null
        return {"name": name, "route": "cuda", "source": f"tpu_raytracing_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": res["max_abs_err"],
                "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": None}

    # kernel_v only changes what the wrapper reports, so K1's measurements
    # on the bounce pass (phase 4) serve the versions it stands in for
    sp = "tpu_raytracing/trace/split_pallas.py"
    print(json.dumps({"kernels": [
        entry("split_trace", "split_trace.cu", f"{sp}:143",
              k1_launches, k1),
        entry("split_trace kernel_v=4", "split_trace.cu", f"{sp}:541", versions[4], k1),
        entry("split_trace kernel_v=5", "split_trace.cu", f"{sp}:898", versions[5], k1),
        entry("split_trace kernel_v=2", "split_trace.cu", f"{sp}:1250", versions[2], k1),
        entry("lane_trace", "lane_trace.cu", "tpu_raytracing/trace/lane_pallas.py:107",
              lane_launches, k5),
        entry("fat_traverse", "fat_traverse.cu", "tpu_raytracing/ops/pallas_traverse.py:71",
              binary_launches, k6),
        entry("fat_traverse count=True", "fat_traverse.cu",
              "tpu_raytracing/ops/pallas_traverse.py:71", app["launches"], app),
    ] + probes}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
