"""Fat wide-BVH tracer of the render modes: the app's ``--tracer wide``.

Port of ``tpu_raytracing/trace/wide_fat.py`` (``trace_rays_wide_fat``,
``trace_rays_wide_fat_phased``, ``make_tiled_fat_tracer``). The reference
walks 128-ray packets over ``FatWideBVH`` rows in a lockstep XLA
``while_loop`` with a shift-register stack. It computes the same closest
hit over the same rows as the Pallas kernel ``pallas_traverse._kernel``,
with the same child order at packet granularity (wide_fat.py:23-26,
pallas_traverse.py:17-19). So here every form traces with K6
(``ops/fat_traverse.py:fat_traverse``), in its counting instantiation,
over ``pad_rows_256`` of the rows: one thread per ray, no packets.

``trace_rays_wide_fat_phased`` is the same function. The reference's
phased compaction (wide_fat.py:11-20) works around the lockstep loop, which
pays for every packet until the slowest drains; a per-ray kernel has no
lockstep, so the phased form makes the same K6 call. ``with_trips`` (the
reference's trip counts for ``benchmarks/profile_trips.py``) is not ported.

Known divergences from the reference, both deliberate:

* The counts are per ray: ``box_tests`` counts the non-empty entries of
  every row the ray pops, ``tri_tests`` the Tri entries whose box the ray
  passes (one an entry, whatever its triangle count). The reference counts
  the same per packet, over the rows the packet pops, and gives every ray
  of the packet its packet's counts (wide_fat.py:296-298). On a tile whose
  rays are all one ray the two agree.
* K6 orders a pop's children by the ray's own entry distance, the
  reference by the packet's smallest, so on an exact t tie between two
  triangles the two may name different ones, as with K1 and K6 elsewhere.
* The reference's stack of 48 registers drops the farthest pending subtree
  without a word when full (wide_fat.py:25-26); K6 sets the overflow flag
  and stops the ray, and ``render.shade_rays`` raises on it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from tpu_raytracing_torch.bvh.wide import FatWideBVH
from tpu_raytracing_torch.ops.fat_traverse import fat_traverse, kernel_operands, pad_rows_256
from tpu_raytracing_torch.trace.brute import HitRecord
from tpu_raytracing_torch.trace.packet import tile_reorder, tile_restore
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.traverse import PackedPairs, TraceStats


def live_rows256(wide: FatWideBVH) -> torch.Tensor:
    """K6's operand for ``wide``: its first ``num_nodes`` rows (the rows a
    walk from row 0 can reach; ``build_wide`` leaves the rest zero) padded
    by ``pad_rows_256``. One host read."""
    return pad_rows_256(wide.rows[:max(int(wide.num_nodes), 1)])


def _trace_rows(rows256, rays: Rays, active=None) -> Tuple[HitRecord, TraceStats]:
    hit, t, prim, tri, u, v, overflow, box, trit = fat_traverse(
        rows256, *kernel_operands(rays, active), count=True)
    hit = hit.to(torch.bool)
    # a ray that hits nothing keeps its tmax, a dead one too (not K6's -1)
    rec = HitRecord(hit=hit, t=torch.where(hit, t, rays.tmax), prim_id=prim, tri_id=tri,
                    bary_u=u, bary_v=v)
    return rec, TraceStats(box_tests=box, tri_tests=trit, overflow=overflow)


def _check_packets(num_rays: int, packet_size: int) -> None:
    if num_rays % packet_size:
        raise ValueError(f"{num_rays} rays do not split into packets of {packet_size}")


def trace_rays_wide_fat(
    wide: FatWideBVH,
    pairs: PackedPairs,
    rays: Rays,
    active=None,
    packet_size: int = 128,
    with_trips: bool = False,
) -> Tuple[HitRecord, TraceStats]:
    """Closest-hit trace against the fat wide BVH (root = row 0) with K6's
    counting instantiation. ``packet_size`` is checked against the ray
    count, as the reference's, and otherwise plays no part; ``pairs`` is
    not read (the fat rows carry the pairs)."""
    del pairs
    if with_trips:
        raise NotImplementedError("not yet ported: trace_rays_wide_fat(with_trips=True)")
    _check_packets(rays.origin.shape[0], packet_size)
    return _trace_rows(live_rows256(wide), rays, active)


def trace_rays_wide_fat_phased(
    wide: FatWideBVH,
    pairs: PackedPairs,
    rays: Rays,
    active=None,
    packet_size: int = 128,
    shrink: int = 4,
    min_packets: int = 256,
) -> Tuple[HitRecord, TraceStats]:
    """``trace_rays_wide_fat``: a per-ray kernel has no lockstep to compact
    (module docstring), so ``shrink`` and ``min_packets`` change nothing."""
    del shrink, min_packets
    return trace_rays_wide_fat(wide, pairs, rays, active=active, packet_size=packet_size)


def make_tiled_fat_tracer(wide, width: int, height: int,
                          tile_w: int = 16, tile_h: int = 8,
                          phased: bool = False):
    """Tracer ``(trav, pairs, rays, max_width=2, active=None) ->
    (HitRecord, TraceStats)`` over a row-major frame, traced in
    ``tile_w`` x ``tile_h`` screen-tile order (so a warp's rays share a
    tile) and restored.

    With ``wide=None`` the FatWideBVH is taken from the tracer's ``trav``
    argument instead, for per-frame rebuilds; its padded rows are kept
    while the same rows come back. ``phased`` selects the same trace
    (``tracer.host_staged`` records it, as the reference's).
    """
    cache = {}

    def rows_of(w: FatWideBVH) -> torch.Tensor:
        if cache.get("rows") is not w.rows:
            cache.update(rows=w.rows, rows256=live_rows256(w))
        return cache["rows256"]

    if wide is not None:
        rows_of(wide)

    def tracer(trav, pairs, rays, max_width=2, active=None):
        del pairs, max_width
        rows256 = rows_of(wide if wide is not None else trav)
        num = rays.origin.shape[0]
        _check_packets(num, tile_w * tile_h)
        tiled = Rays(*(tile_reorder(getattr(rays, f), width, height, tile_w, tile_h)
                       for f in ("origin", "direction", "tmin", "tmax")))
        act = None if active is None else tile_reorder(active, width, height, tile_w, tile_h)
        rec, stats = _trace_rows(rows256, tiled, act)
        rec = dataclasses.replace(rec, **{
            f.name: tile_restore(getattr(rec, f.name), width, height, tile_w, tile_h)
            for f in dataclasses.fields(rec)})
        stats = dataclasses.replace(
            stats, box_tests=tile_restore(stats.box_tests, width, height, tile_w, tile_h),
            tri_tests=tile_restore(stats.tri_tests, width, height, tile_w, tile_h))
        return rec, stats

    tracer.host_staged = phased
    return tracer
