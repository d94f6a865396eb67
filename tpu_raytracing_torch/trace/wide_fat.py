"""Fat wide-BVH tracer of the render modes: the app's ``--tracer wide``.

Port of ``tpu_raytracing/trace/wide_fat.py`` (``trace_rays_wide_fat``,
``make_tiled_fat_tracer``), and the path
tracer's four wide tracers (``make_fat_frame_tracers``). The reference
walks 128-ray packets over ``FatWideBVH`` rows in a lockstep XLA
``while_loop`` with a shift-register stack. It computes the same closest
hit over the same rows as the Pallas kernel ``pallas_traverse._kernel``,
with the same child order at packet granularity (wide_fat.py:23-26,
pallas_traverse.py:17-19). So here every form traces with K6
(``ops/fat_traverse.py:fat_traverse``), in its counting instantiation,
over ``pad_rows_256`` of the rows: one thread per ray, no packets.

The reference's phased form of the tracer is not ported: its compaction
(wide_fat.py:11-20) works around the lockstep loop, which pays for every
packet until the slowest drains, and a per-ray kernel has no lockstep, so
it would make the same K6 call.

``with_trips=True`` is the reference's diagnostic of that lockstep loop
(``benchmarks/profile_trips.py``): how many pops each packet needs. It
has no kernel there (an XLA ``while_loop``), and here it is the same
loop in PyTorch ops (``_trips_trace``): each iteration pops one row for
every packet at once, and the loop ends when every packet's stack is
empty. It returns the reference's per-packet counts and each packet's
trip count.

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
  and stops the ray, and ``render.shade_rays`` raises on it. The trips
  loop keeps the reference's drop, so its trip counts stay the
  reference's, and sets the overflow flag when a push drops a pending
  subtree.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from tpu_raytracing_torch.bvh.types import CHILD_BOX, CHILD_NONE, CHILD_TRI
from tpu_raytracing_torch.bvh.wide import WIDE, FatWideBVH
from tpu_raytracing_torch.ops.fat_traverse import (
    fat_traverse,
    kernel_operands,
    pad_rows_256,
    trace_rays_fat,
)
from tpu_raytracing_torch.trace.brute import HitRecord
from tpu_raytracing_torch.trace.packet import tile_reorder, tile_restore
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.traverse import (
    _META_CHILD_SHIFT,
    _META_COUNT_MASK,
    _META_COUNT_SHIFT,
    _META_TYPE_MASK,
    PackedPairs,
    TraceStats,
    i2f,
    reconstruct,
)
from tpu_raytracing_torch.trace.wide_packet import _NETWORK, _intersect_triangle

# The lockstep loop's stack registers per packet (the reference's
# STACK_REGS); a push past them drops the farthest pending subtree, as the
# reference's shift register does, and sets TraceStats.overflow.
STACK_REGS = 48
_F32_MAX = float(torch.finfo(torch.float32).max)


def live_rows256(wide: FatWideBVH) -> torch.Tensor:
    """K6's operand for ``wide``: its first ``num_nodes`` rows (the rows a
    walk from row 0 can reach; ``build_wide`` leaves the rest zero) padded
    by ``pad_rows_256``, with no host read: ``live_rows`` holds the count."""
    return pad_rows_256(wide.rows[:max(wide.live_rows, 1)])


def _trace_rows(rows256, rays: Rays, active=None) -> Tuple[HitRecord, TraceStats]:
    hit, t, prim, tri, u, v, overflow, box, trit = fat_traverse(
        rows256, *kernel_operands(rays, active), count=True)
    hit = hit.to(torch.bool)
    # a ray that hits nothing keeps its tmax, a dead one too (not K6's -1)
    rec = HitRecord(hit=hit, t=torch.where(hit, t, rays.tmax), prim_id=prim, tri_id=tri,
                    bary_u=u, bary_v=v)
    return rec, TraceStats(box_tests=box, tri_tests=trit, overflow=overflow)


def _trace_uncounted(rows256, rays: Rays, active=None,
                     any_hit: bool = False) -> Tuple[HitRecord, TraceStats]:
    """K6 without counts, or its any-hit instantiation: the record as
    ``_trace_rows`` builds it (an any-hit record's t is tmax), zero
    counts."""
    rec, stats = trace_rays_fat(rows256, rays, active, any_hit=any_hit)
    # a ray that hits nothing keeps its tmax, a dead one too (not K6's -1)
    return dataclasses.replace(rec, t=torch.where(rec.hit, rec.t, rays.tmax)), stats


def _trace_counted(rows256, rays: Rays, active=None) -> Tuple[HitRecord, TraceStats]:
    # ``_trace_rows`` looked up at each call, so a tracer made before it is
    # replaced (``rtbench/faults.py``) calls the replacement
    return _trace_rows(rows256, rays, active)


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
    not read (the fat rows carry the pairs).

    ``with_trips=True`` runs the reference's lockstep packet loop instead
    (``_trips_trace``) and returns (HitRecord, TraceStats, trips [R /
    packet_size] int32), with per-packet counts as the reference gives
    them."""
    _check_packets(rays.origin.shape[0], packet_size)
    if with_trips:
        return _trips_trace(wide.rows, pairs, rays, active, packet_size)
    return _trace_rows(live_rows256(wide), rays, active)


def _trips_trace(rows: torch.Tensor, pairs: PackedPairs, rays: Rays, active, k: int):
    """The reference's lockstep loop (``wide_fat.py:_ray_data``,
    ``_init_state``, ``_make_body``) over packets of ``k`` consecutive
    rays, every packet one pop an iteration. A pop tests the row's 8
    entries in order, each against every ray's running tmax: a Tri entry
    whose box some ray enters tests its triangles A and B on those rays;
    the Box entries some ray enters are pushed far to near by the packet's
    smallest entry distance (the higher child id nearer on a tie). The
    counts are per packet: non-empty entries tested and Tri entries
    entered. Möller-Trumbore rounds as XLA's CPU compiler contracts it
    (``wide_packet._intersect_triangle``). Returns (HitRecord, TraceStats
    with each ray its packet's counts and ``overflow`` set if a push
    dropped a pending subtree, trips [P] int32)."""
    num = rays.origin.shape[0]
    num_p = num // k
    dev = rays.origin.device
    num_nodes = rows.shape[0]
    origin = rays.origin.reshape(num_p, k, 3)
    direction = rays.direction.reshape(num_p, k, 3)
    safe = torch.where(direction.abs() < 1e-30,
                       torch.where(direction < 0, -1e-30, 1e-30), direction)
    inv_dir = 1.0 / safe
    tmin = rays.tmin.reshape(num_p, k)
    ray_on = (torch.ones((num_p, k), dtype=torch.bool, device=dev) if active is None
              else active.reshape(num_p, k).to(torch.bool))
    regs = torch.full((num_p, STACK_REGS), -1, dtype=torch.int64, device=dev)
    regs[:, 0] = torch.where(ray_on.any(dim=1), 0, -1)
    tmax = rays.tmax.reshape(num_p, k).clone()
    tri_id = torch.full((num_p, k), -1, dtype=torch.int64, device=dev)
    box_tests = torch.zeros((num_p, 1), dtype=torch.int32, device=dev)
    tri_tests = torch.zeros((num_p, 1), dtype=torch.int32, device=dev)
    trips = torch.zeros((num_p,), dtype=torch.int32, device=dev)
    neg1 = torch.full((num_p, 1), -1, dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.bool, device=dev)

    while bool((regs[:, 0] >= 0).any()):
        wid = regs[:, 0]
        active_p = wid >= 0
        regs = torch.where(active_p[:, None], torch.cat([regs[:, 1:], neg1], dim=1), regs)
        row = rows[wid.clamp(0, num_nodes - 1)]  # [P, 192]
        cand_dist, cand_id = [], []
        for e in range(WIDE):
            node = row[:, e * 8:e * 8 + 8]
            pair = i2f(row[:, 64 + e * 16:64 + e * 16 + 12])
            meta = node[:, 6].to(torch.int64)
            ntype = meta & _META_TYPE_MASK
            child = meta >> _META_CHILD_SHIFT
            ccount = (meta >> _META_COUNT_SHIFT) & _META_COUNT_MASK
            valid = active_p & (ntype != CHILD_NONE)
            nmin = i2f(node[:, 0:3])[:, None, :]
            nmax = i2f(node[:, 3:6])[:, None, :]
            t1 = (nmin - origin) * inv_dir
            t2 = (nmax - origin) * inv_dir
            front = torch.minimum(t1, t2).amax(dim=-1)
            back = torch.maximum(t1, t2).amin(dim=-1)
            box_hit = ((back >= front) & (front <= tmax) & (back >= tmin) & ray_on
                       & valid[:, None])
            box_tests = box_tests + valid[:, None].to(torch.int32)
            any_hit = box_hit.any(dim=1)
            do_leaf = any_hit & (ntype == CHILD_TRI)
            tri_tests = tri_tests + do_leaf[:, None].to(torch.int32)
            v = [pair[:, None, 3 * i:3 * i + 3] for i in range(4)]
            acc, t, _, _ = _intersect_triangle(v[0], v[1], v[2], origin,
                                               direction, tmin, tmax)
            take = do_leaf[:, None] & box_hit & acc
            tmax = torch.where(take, t, tmax)
            tri_id = torch.where(take, (child << 1)[:, None], tri_id)
            acc, t, _, _ = _intersect_triangle(v[2], v[1], v[3], origin,
                                               direction, tmin, tmax)
            take = do_leaf[:, None] & box_hit & (ccount > 0)[:, None] & acc
            tmax = torch.where(take, t, tmax)
            tri_id = torch.where(take, ((child << 1) + 1)[:, None], tri_id)
            do_box = any_hit & (ntype == CHILD_BOX)
            dist_p = torch.where(box_hit, front, _F32_MAX).amin(dim=1)
            cand_dist.append(torch.where(do_box, dist_p, -_F32_MAX))
            cand_id.append(torch.where(do_box, child, -1))
        d, c = cand_dist, cand_id
        for a, b in _NETWORK:  # descending distance; on a tie the higher id nearer
            swap = (d[a] < d[b]) | ((d[a] == d[b]) & (c[a] > c[b]))
            d[a], d[b] = torch.where(swap, d[b], d[a]), torch.where(swap, d[a], d[b])
            c[a], c[b] = torch.where(swap, c[b], c[a]), torch.where(swap, c[a], c[b])
        for e in range(WIDE):  # far to near: shift down and insert at the top
            push = c[e] >= 0
            dropped |= (push & (regs[:, -1] >= 0)).any()
            regs = torch.where(push[:, None],
                               torch.cat([c[e][:, None], regs[:, :-1]], dim=1), regs)
        trips = trips + active_p.to(torch.int32)

    rec = reconstruct(pairs, rays, tmax.reshape(num), tri_id.reshape(num).to(torch.int32))
    stats = TraceStats(box_tests=box_tests.expand(num_p, k).reshape(num),
                       tri_tests=tri_tests.expand(num_p, k).reshape(num),
                       overflow=dropped.to(torch.int32).reshape(1))
    return rec, stats, trips


def _padded_rows(wide):
    """``rows_of(trav)``: K6's padded rows of ``wide``, or with ``wide=None``
    of the FatWideBVH that rides in the tracer's ``trav`` argument, for
    per-frame rebuilds; kept while the same rows come back."""
    cache = {}

    def rows_of(trav) -> torch.Tensor:
        w = wide if wide is not None else trav
        if cache.get("rows") is not w.rows:
            cache.update(rows=w.rows, rows256=live_rows256(w))
        return cache["rows256"]

    if wide is not None:
        rows_of(None)
    return rows_of


def _tiled(trace, rows_of, width: int, height: int, tile_w: int, tile_h: int):
    """Tracer ``(trav, pairs, rays, active=None)`` over a
    row-major frame: ``trace(rows256, rays, active)`` in ``tile_w`` x
    ``tile_h`` screen-tile order (so a warp's rays share a tile), the
    record and the counts restored."""

    def tracer(trav, pairs, rays, active=None):
        del pairs
        rows256 = rows_of(trav)
        num = rays.origin.shape[0]
        _check_packets(num, tile_w * tile_h)
        tiled = Rays(*(tile_reorder(getattr(rays, f), width, height, tile_w, tile_h)
                       for f in ("origin", "direction", "tmin", "tmax")))
        act = None if active is None else tile_reorder(active, width, height, tile_w, tile_h)
        rec, stats = trace(rows256, tiled, act)
        rec = dataclasses.replace(rec, **{
            f.name: tile_restore(getattr(rec, f.name), width, height, tile_w, tile_h)
            for f in dataclasses.fields(rec)})
        stats = dataclasses.replace(
            stats, box_tests=tile_restore(stats.box_tests, width, height, tile_w, tile_h),
            tri_tests=tile_restore(stats.tri_tests, width, height, tile_w, tile_h))
        return rec, stats

    return tracer


def make_tiled_fat_tracer(wide, width: int, height: int,
                          tile_w: int = 16, tile_h: int = 8):
    """Tracer ``(trav, pairs, rays, active=None) ->
    (HitRecord, TraceStats)`` over a row-major frame, traced with K6's
    counting instantiation in ``tile_w`` x ``tile_h`` screen-tile order (so
    a warp's rays share a tile) and restored.

    With ``wide=None`` the FatWideBVH is taken from the tracer's ``trav``
    argument instead, for per-frame rebuilds; its padded rows are kept
    while the same rows come back.
    """
    return _tiled(_trace_counted, _padded_rows(wide), width, height, tile_w, tile_h)


def make_fat_frame_tracers(width: int, height: int) -> dict:
    """The path-traced frame's four tracers over fat rows that ride in
    ``trav`` (per-frame rebuilds), the counterpart of
    ``split_trace.make_frame_tracers``: the primary pass closest-hit with
    K6's counting instantiation in 8 x 8 screen tiles (the render modes'
    tracer), the primary shadow pass any-hit in the same tiles, the bounce
    pass closest-hit in the order the compaction left the rays, and the
    bounce shadow pass any-hit in the shadow sort's order, both without
    counts. One copy of the padded rows serves all four. Returns
    ``path_trace`` keyword arguments.

    The image is bit-equal to one traced with the primary tracer alone:
    K6 traces each ray on its own, and an any-hit verdict is the
    closest-hit ``hit`` for the same tmax."""
    rows_of = _padded_rows(None)

    def in_order(any_hit: bool):
        def tracer(trav, pairs, rays, active=None):
            del pairs
            return _trace_uncounted(rows_of(trav), rays, active, any_hit)

        return tracer

    return dict(
        tracer=_tiled(_trace_counted, rows_of, width, height, 8, 8),
        shadow_tracer=_tiled(functools.partial(_trace_uncounted, any_hit=True), rows_of,
                             width, height, 8, 8),
        bounce_tracer=in_order(False),
        shadow_tracer_bounce=in_order(True),
    )
