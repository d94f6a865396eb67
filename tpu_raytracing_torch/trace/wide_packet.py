"""Packet traversal of the 8-wide BVH.

Port of ``tpu_raytracing/trace/wide_packet.py`` (``_NETWORK``,
``trace_rays_wide``, ``make_tiled_wide_tracer``). PyTorch ops in a host
loop over the packets that still have work, as ``trace/packet.py``; the
reference has no Pallas kernel here.

One stack of wide-node ids per packet of ``packet_size`` rays, root = row
0. A pop reads one row of 8 entries; each entry slab-tests every ray of the
packet (each ray against its own tmax, updated entry by entry). A Tri entry
hit by any ray tests its pair's triangles A then B on the rays that hit
its box; the Box entries hit by any ray are ordered by the packet's
smallest entry distance (the higher child id first on a tie, so it pops
later: the reference's near-child rule, ``src/Tracer.cu:346-347``) with a
fixed 19-comparator sorting network and pushed far to near. Box and
triangle tests are counted per ray, for the rays that are on.

The Möller-Trumbore rounds once where XLA's CPU compiler fuses a multiply
into the add or subtract that consumes it in the reference's loop
(``_intersect_triangle``), so t, the barycentrics and the per-ray counts
equal the reference's bit for bit on the CPU.

The reference clamps a push past ``STACK_DEPTH`` onto the top slot
(``wide_packet.py:185``), which loses a subtree without a word. Here such
a packet sets ``TraceStats.overflow`` and stops, as ``trace/packet.py``
does, and ``path_trace`` and ``render.shade_rays`` raise on the flag.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_raytracing_torch.bvh.types import CHILD_BOX, CHILD_NONE, CHILD_TRI, STACK_DEPTH
from tpu_raytracing_torch.bvh.wide import WIDE, WideBVH
from tpu_raytracing_torch.bvh.sah import _fma
from tpu_raytracing_torch.ops.intersect import TRI_EPSILON, intersect_ray_aabb
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
)

_F32_MAX = float(torch.finfo(torch.float32).max)
_NEG = -_F32_MAX

# Optimal 8-input sorting network (19 comparators).
_NETWORK = [
    (0, 1), (2, 3), (4, 5), (6, 7),
    (0, 2), (1, 3), (4, 6), (5, 7),
    (1, 2), (5, 6), (0, 4), (3, 7),
    (1, 5), (2, 6),
    (1, 4), (3, 6),
    (2, 4), (3, 5),
    (3, 4),
]


def _intersect_triangle(v0, v1, v2, origin, direction, tmin, tmax):
    """``ops/intersect.py:intersect_ray_triangle`` with XLA's contractions
    in the reference's while loop: x y - z w as fma(x, y, -(z w)) and a dot
    product as fma(a2, b2, fma(a1, b1, a0 b0)). Returns (accept, t, u, v)."""
    def dif(p, q, r, s):
        return _fma(p, q, -(r * s))

    def dot(a, b):
        return _fma(a[..., 2], b[2], _fma(a[..., 1], b[1], a[..., 0] * b[0]))

    e1, e2 = v1 - v0, v2 - v0
    dx, dy, dz = direction.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    h = (dif(dy, e2z, dz, e2y), dif(dz, e2x, dx, e2z), dif(dx, e2y, dy, e2x))
    a = dot(e1, h)
    degenerate = (a > -TRI_EPSILON) & (a < TRI_EPSILON)
    f = 1.0 / a
    s = origin - v0
    sx, sy, sz = s.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    q = (dif(sy, e1z, sz, e1y), dif(sz, e1x, sx, e1z), dif(sx, e1y, sy, e1x))
    u = f * dot(s, h)
    v = f * dot(direction, q)
    t = f * dot(e2, q)
    accept = (~degenerate & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t >= tmin) & (t <= tmax))
    return accept, t, u, v


def trace_rays_wide(wide: WideBVH, pairs: PackedPairs, rays: Rays, active=None,
                    packet_size: int = 128) -> Tuple[HitRecord, TraceStats]:
    """Closest-hit trace of packets of ``packet_size`` consecutive rays
    against the wide BVH (see the module docstring); the ray count must be
    a multiple of ``packet_size``. ``active`` ([R] bool) turns rays off; a
    packet with no ray on starts with an empty stack."""
    num_rays = rays.origin.shape[0]
    k = packet_size
    if num_rays % k:
        raise ValueError(f"{num_rays} rays do not split into packets of {k}")
    num_p = num_rays // k
    dev = rays.origin.device
    num_nodes = wide.rows.shape[0]
    num_pairs = pairs.rows.shape[0]

    def pk(a):
        return a.reshape(num_p, k, *a.shape[1:])

    origin, direction, tmin = pk(rays.origin), pk(rays.direction), pk(rays.tmin)
    ray_on = (torch.ones((num_p, k), dtype=torch.bool, device=dev) if active is None
              else pk(active.to(torch.bool)))
    stack = torch.zeros((num_p, STACK_DEPTH), dtype=torch.int64, device=dev)
    size = ray_on.any(dim=1).to(torch.int64)
    tmax = pk(rays.tmax).clone()
    hit = torch.zeros((num_p, k), dtype=torch.bool, device=dev)
    prim_id = torch.zeros((num_p, k), dtype=torch.int32, device=dev)
    tri_id = torch.zeros((num_p, k), dtype=torch.int32, device=dev)
    bary_u = torch.zeros((num_p, k), dtype=torch.float32, device=dev)
    bary_v = torch.zeros((num_p, k), dtype=torch.float32, device=dev)
    box_tests = torch.zeros((num_p, k), dtype=torch.int32, device=dev)
    tri_tests = torch.zeros((num_p, k), dtype=torch.int32, device=dev)
    overflow = torch.zeros((1,), dtype=torch.int32, device=dev)

    while True:
        p = torch.nonzero(size > 0).reshape(-1)
        if p.numel() == 0:
            break
        sz = size[p] - 1
        wid = stack[p, sz].clamp(0, num_nodes - 1)
        row = wide.rows[wid].reshape(-1, WIDE, 8)
        o, d, tmn, on = origin[p], direction[p], tmin[p], ray_on[p]
        tm, ht, pid, tid = tmax[p], hit[p], prim_id[p], tri_id[p]
        bu, bv, bt, tt = bary_u[p], bary_v[p], box_tests[p], tri_tests[p]
        cand_dist, cand_id = [], []
        for e in range(WIDE):
            meta = row[:, e, 6]
            ntype = meta & _META_TYPE_MASK
            child = meta >> _META_CHILD_SHIFT
            ccount = (meta >> _META_COUNT_SHIFT) & _META_COUNT_MASK
            valid = ntype != CHILD_NONE
            box_hit, dist = intersect_ray_aabb(i2f(row[:, None, e, 0:3]),
                                               i2f(row[:, None, e, 3:6]), o, d, tmn, tm)
            box_hit = box_hit & on & valid[:, None]
            bt = bt + (valid[:, None] & on).to(torch.int32)
            any_box = box_hit.any(dim=1)

            do_leaf = any_box & (ntype == CHILD_TRI)
            prow = pairs.rows[child.clamp(0, num_pairs - 1).to(torch.int64)]
            v0, v1, v2, v3 = (i2f(prow[:, None, 3 * j:3 * j + 3]) for j in range(4))
            leaf_rays = do_leaf[:, None] & box_hit
            tt = tt + leaf_rays.to(torch.int32)
            acc, t_a, u_a, v_a = _intersect_triangle(v0, v1, v2, o, d, tmn, tm)
            take = leaf_rays & acc
            tm = torch.where(take, t_a, tm)
            ht = ht | take
            pid = torch.where(take, prow[:, 12:13], pid)
            tid = torch.where(take, (child << 1)[:, None], tid)
            bu = torch.where(take, u_a, bu)
            bv = torch.where(take, v_a, bv)
            acc, t_b, u_b, v_b = _intersect_triangle(v2, v1, v3, o, d, tmn, tm)
            take = leaf_rays & (ccount > 0)[:, None] & acc
            tm = torch.where(take, t_b, tm)
            ht = ht | take
            pid = torch.where(take, prow[:, 13:14], pid)
            tid = torch.where(take, ((child << 1) + 1)[:, None], tid)
            bu = torch.where(take, u_b, bu)
            bv = torch.where(take, v_b, bv)

            do_box = any_box & (ntype == CHILD_BOX)
            dist_p = torch.where(box_hit, dist, _F32_MAX).amin(dim=1)
            cand_dist.append(torch.where(do_box, dist_p, _NEG))
            cand_id.append(torch.where(do_box, child, -1))

        # descending by distance, a higher id later on a tie (so it pops first)
        for a, b in _NETWORK:
            da, db, ca, cb = cand_dist[a], cand_dist[b], cand_id[a], cand_id[b]
            swap = (da < db) | ((da == db) & (ca > cb))
            cand_dist[a], cand_dist[b] = torch.where(swap, db, da), torch.where(swap, da, db)
            cand_id[a], cand_id[b] = torch.where(swap, cb, ca), torch.where(swap, ca, cb)
        pushes = sum((c >= 0).to(torch.int64) for c in cand_id)
        full = sz + pushes > STACK_DEPTH
        for c in cand_id:
            m = (c >= 0) & ~full
            stack[p[m], sz[m]] = c[m].to(torch.int64)
            sz = sz + m.to(torch.int64)

        size[p] = torch.where(full, 0, sz)
        overflow |= full.any().to(torch.int32)
        tmax[p], hit[p], prim_id[p], tri_id[p] = tm, ht, pid, tid
        bary_u[p], bary_v[p], box_tests[p], tri_tests[p] = bu, bv, bt, tt

    def unpk(a):
        return a.reshape(num_rays)

    rec = HitRecord(hit=unpk(hit), t=unpk(tmax), prim_id=unpk(prim_id), tri_id=unpk(tri_id),
                    bary_u=unpk(bary_u), bary_v=unpk(bary_v))
    return rec, TraceStats(box_tests=unpk(box_tests), tri_tests=unpk(tri_tests),
                           overflow=overflow)


def make_tiled_wide_tracer(wide: WideBVH, width: int, height: int, tile_w: int = 16,
                           tile_h: int = 8):
    """Tracer ``(trav, pairs, rays, active=None) ->
    (HitRecord, TraceStats)``: rays reordered into ``tile_w`` x ``tile_h``
    screen-tile packets, traced against the bound ``wide`` (``trav`` is not
    read), results back in row-major order."""

    def tracer(trav, pairs, rays, active=None):
        del trav
        tiled = Rays(*(tile_reorder(getattr(rays, f), width, height, tile_w, tile_h)
                       for f in ("origin", "direction", "tmin", "tmax")))
        act = None if active is None else tile_reorder(active, width, height, tile_w, tile_h)
        rec, stats = trace_rays_wide(wide, pairs, tiled, active=act,
                                     packet_size=tile_w * tile_h)
        back = lambda a: tile_restore(a, width, height, tile_w, tile_h)  # noqa: E731
        rec = HitRecord(*(back(getattr(rec, f)) for f in
                          ("hit", "t", "prim_id", "tri_id", "bary_u", "bary_v")))
        stats.box_tests, stats.tri_tests = back(stats.box_tests), back(stats.tri_tests)
        return rec, stats

    return tracer
