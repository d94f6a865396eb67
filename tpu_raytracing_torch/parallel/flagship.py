"""Multi-device rendering through the split tracer (K1), the grid tracer
and the instanced tracers, one process a row band.

Port of ``tpu_raytracing/parallel/flagship.py`` (``_band_tracer``,
``render_frame_sharded_split``, ``path_trace_sharded``,
``trace_instanced_split_sharded``, ``trace_instanced_sharded``) on
``parallel/render.py``'s ``Mesh``. The split views, the grid, the
instanced structures, the scene and the camera are replicated; each rank
runs K1 (or the grid or instanced tracer) on its own band.

The reference's semantics, kept as they are:

* The frame is tile-reordered once (16 x k/16 screen-tile packets) and
  every per-ray array stays in tiled order; pixel ids ride along and the
  final scatter (``pathtrace._finalize``) undoes the permutation.
* Compaction is band-local: each rank sorts its own live rays
  (``_bounce_stage``); pixel ids
  keep the image exact.
* The bounce uniforms are full-frame and the same on every rank, indexed
  by global pixel id: every rank draws them from a generator seeded alike.
* ``rays_traced`` adds 2 * (live rays) a bounce, the reference's count
  here (not ``path_trace``'s).
* The instanced split tracer's guard is reduced with max: each band's
  overlap and live items are checked against per-band capacities.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_raytracing_torch.parallel.render import (
    Mesh,
    all_gather,
    all_reduce,
    band_rays,
    gather_fields,
)
from tpu_raytracing_torch.scene.types import DeviceScene
from tpu_raytracing_torch.trace.modes import RenderType
from tpu_raytracing_torch.trace.packet import tile_reorder
from tpu_raytracing_torch.trace.pathtrace import _bounce_stage, _finalize
from tpu_raytracing_torch.trace.ray import Rays, generate_primary_rays, ray_spread
from tpu_raytracing_torch.trace.render import _shadow_rays, shade_rays
from tpu_raytracing_torch.trace.split_trace import check_overflow, trace_rays_split
from tpu_raytracing_torch.trace.traverse import PackedPairs


def _band_tracer(k: int, any_hit: bool = False):
    """K1 on a band of tile-ordered rays, in the caller's order."""
    def tracer(views, pairs, rays, active=None):
        return trace_rays_split(views, pairs, rays, active=active, any_hit=any_hit, k=k)
    return tracer


def _tiled_frame(camera: dict, width: int, height: int, k: int, size: int):
    """The frame's rays and pixel ids in 16 x k/16 tile order."""
    tw, th = 16, k // 16
    if width % tw or height % (th * size):
        raise ValueError(f"{width}x{height} does not tile into 16x{th} packets over "
                         f"{size} bands")
    rays = generate_primary_rays(camera, width, height)
    dev = rays.origin.device
    pixel = tile_reorder(torch.arange(width * height, dtype=torch.int64, device=dev),
                         width, height, tw, th)
    tiled = Rays(*(tile_reorder(getattr(rays, f), width, height, tw, th)
                   for f in ("origin", "direction", "tmin", "tmax")))
    return tiled, pixel


def render_frame_sharded_split(
    mesh: Mesh,
    views,
    packed: PackedPairs,
    scene: DeviceScene,
    camera: dict,
    width: int,
    height: int,
    render_type: RenderType = RenderType.TEXTURE_LIT_SHADOWS,
    k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame through K1 with the tile-ordered rays split into bands.
    ``width`` must be a multiple of 16 and each band a whole number of
    16 x k/16 packet rows. Returns ([H, W, 4] uint8, the group's box-test
    total) on every rank."""
    tiled, pixel = _tiled_frame(camera, width, height, k, mesh.size)
    flat, tests = shade_rays(views, packed, scene, camera, band_rays(mesh, tiled),
                             ray_spread(width), render_type, _band_tracer(k))
    flat = all_gather(mesh, flat)
    img = torch.zeros_like(flat)
    img[pixel] = flat
    return img.reshape(height, width, 4), all_reduce(mesh, tests)


def path_trace_sharded(
    mesh: Mesh,
    views,
    packed: PackedPairs,
    scene: DeviceScene,
    camera: dict,
    width: int,
    height: int,
    num_bounces: int = 1,
    generator: Optional[torch.Generator] = None,
    k: int = 128,
    tracer_kind: str = "split",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wavefront path trace with the tile-ordered rays split into bands
    and band-local compaction. Returns ([H, W, 3] radiance, rays traced as
    a 0-d int64 tensor) on every rank.

    ``tracer_kind="grid"``: ``views`` is a ``UniformGrid`` and every band
    runs the grid tracer. ``generator`` (default: seeded 0) draws each
    bounce's full-frame [H*W, 2] uniforms; it must be seeded alike on
    every rank (the reference's replicated ``u_frame``)."""
    if tracer_kind == "grid":
        from tpu_raytracing_torch.trace.grid_trace import trace_rays_grid

        def closest(v, p, r, active=None):
            return trace_rays_grid(v, p, r, active=active)

        def occl(v, p, r, active=None):
            return trace_rays_grid(v, p, r, active=active, any_hit=True)
    elif tracer_kind == "split":
        closest, occl = _band_tracer(k), _band_tracer(k, any_hit=True)
    else:
        raise ValueError(f"unknown tracer_kind {tracer_kind!r}")

    rays_all, pixel_all = _tiled_frame(camera, width, height, k, mesh.size)
    dev = rays_all.origin.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    num = width * height
    rays = band_rays(mesh, rays_all)
    pixel = pixel_all[mesh.band(num)]
    n_band = pixel.shape[0]
    throughput = torch.ones((n_band, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((n_band, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((n_band,), dtype=torch.bool, device=dev)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((1,), dtype=torch.int32, device=dev)
    max_t = camera["max_depth"]

    for _ in range(num_bounces + 1):
        rec, stats = closest(views, packed, rays, active=alive)
        srec, sstats = occl(views, packed, _shadow_rays(scene, rays, rec), active=alive)
        overflow = overflow + stats.overflow + sstats.overflow
        rays_traced = rays_traced + 2 * all_reduce(mesh, alive.sum())
        u_frame = torch.rand((num, 2), generator=generator, device=dev)
        radiance, throughput, alive, pixel, rays = _bounce_stage(
            scene, packed, rays, rec, srec.hit, throughput, radiance, alive, pixel, u_frame,
            max_t)

    check_overflow(all_reduce(mesh, overflow))
    img = _finalize(all_gather(mesh, radiance), all_gather(mesh, pixel))
    return img.reshape(height, width, 3), rays_traced


def trace_instanced_split_sharded(mesh: Mesh, ias, rays: Rays, k_slots: int = 8):
    """The instanced split tracer (``trace/instanced_split.py``: candidate
    bitmasks, then K1 on the band's object-space items) with the rays split
    into bands and ``ias`` replicated. Returns (HitRecord, hit instance,
    TraceStats, guard [2]) for all rays on every rank; the guard is the
    per-band maximum of (overlap, live items), for
    ``check_candidate_capacity``."""
    from tpu_raytracing_torch.trace.instanced_split import trace_rays_instanced_split

    rec, inst, stats, guard = trace_rays_instanced_split(
        ias, band_rays(mesh, rays), k_slots=k_slots)
    return (gather_fields(mesh, rec), all_gather(mesh, inst), gather_fields(mesh, stats),
            all_reduce(mesh, guard, op="max"))


def trace_instanced_sharded(mesh: Mesh, inst_as, pairs: PackedPairs, rays: Rays):
    """The two-level TLAS/BLAS tracer (``trace/instanced.py``) with the
    rays split into bands and the structure replicated. Returns
    (HitRecord, hit instance, TraceStats) for all rays on every rank."""
    from tpu_raytracing_torch.trace.instanced import trace_rays_instanced

    rec, inst, stats = trace_rays_instanced(inst_as, pairs, band_rays(mesh, rays))
    return gather_fields(mesh, rec), all_gather(mesh, inst), gather_fields(mesh, stats)
