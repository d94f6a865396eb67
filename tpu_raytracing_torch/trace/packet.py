"""Packet BVH traversal, screen-tile ray orders and frame padding.

Port of ``tpu_raytracing/trace/packet.py``: ``tile_permutation``,
``tile_reorder``, ``tile_restore``, ``pad_frame``, ``crop_frame``,
``pad_live_mask``, ``trace_rays_packet`` and ``make_tiled_packet_tracer``
(the app's ``--tracer packet``). On the card the split kernel runs one
thread per ray, so tile order keeps the rays of one warp on one compact
screen tile.

``trace_rays_packet`` keeps one traversal stack per packet of
``packet_size`` rays. A packet descends a node when any of its rays hits
the node's box; each ray still applies its own box mask and its own tmax,
so the closest hit is the scalar tracer's. Near children are ordered by the
packet's smallest entry distance over the rays that hit, a tie going to the
higher child id (src/Tracer.cu:341-362 at packet granularity); triangle A is
tested, then B; box and triangle tests are counted per ray, for the rays
that are on. Hits and counts equal the reference's. Each step runs over
the packets that still have work.

The reference clamps a push past ``STACK_DEPTH`` onto the top slot
(packet.py:263, 268), which loses a subtree without a word. Here such a
packet sets ``TraceStats.overflow`` and stops, as ``trace_rays`` does, and
``path_trace`` and ``render.shade_rays`` raise on the flag.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpu_raytracing_torch.bvh.types import CHILD_BOX, CHILD_NONE, CHILD_TRI, STACK_DEPTH
from tpu_raytracing_torch.ops.intersect import intersect_ray_aabb, intersect_ray_triangle
from tpu_raytracing_torch.trace.brute import HitRecord
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.traverse import (
    _COUNT_MASK,
    _ENTRY_SHIFT,
    _GROUP_WIDTH,
    _META_CHILD_SHIFT,
    _META_COUNT_MASK,
    _META_COUNT_SHIFT,
    _META_TYPE_MASK,
    TraceStats,
    i2f,
)

_F32_MAX = float(torch.finfo(torch.float32).max)


def tile_permutation(width: int, height: int, tile_w: int = 16, tile_h: int = 8):
    """(perm, inv_perm) numpy int32 arrays with rays_tiled = rays[perm],
    results_rowmajor = results_tiled[inv_perm]."""
    if width % tile_w or height % tile_h:
        raise ValueError(f"{width}x{height} does not tile by {tile_w}x{tile_h}")
    idx = np.arange(width * height, dtype=np.int32).reshape(height, width)
    tiles = idx.reshape(height // tile_h, tile_h, width // tile_w, tile_w)
    perm = tiles.transpose(0, 2, 1, 3).reshape(-1)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def tile_reorder(a: torch.Tensor, width: int, height: int, tile_w: int = 16,
                 tile_h: int = 8) -> torch.Tensor:
    """Row-major -> tile-major [H*W, ...]."""
    lead = a.shape[1:]
    x = a.reshape(height // tile_h, tile_h, width // tile_w, tile_w, *lead)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(lead)))
    return x.permute(*perm).reshape(width * height, *lead)


def tile_restore(a: torch.Tensor, width: int, height: int, tile_w: int = 16,
                 tile_h: int = 8) -> torch.Tensor:
    """Inverse of tile_reorder."""
    lead = a.shape[1:]
    x = a.reshape(height // tile_h, width // tile_w, tile_h, tile_w, *lead)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(lead)))
    return x.permute(*perm).reshape(width * height, *lead)


def pad_frame(a: torch.Tensor, width: int, height: int, pw: int, ph: int) -> torch.Tensor:
    """Row-major [H*W, ...] -> [ph*pw, ...] edge-replicated pad; pad rays
    stay geometrically valid and are masked dead by ``pad_live_mask``."""
    lead = a.shape[1:]
    x = a.reshape(height, width, *lead)
    rows = torch.arange(ph, device=a.device).clamp(max=height - 1)
    cols = torch.arange(pw, device=a.device).clamp(max=width - 1)
    return x[rows][:, cols].reshape(ph * pw, *lead)


def crop_frame(a: torch.Tensor, width: int, height: int, pw: int, ph: int) -> torch.Tensor:
    """Inverse of pad_frame: [ph*pw, ...] -> row-major [H*W, ...]."""
    lead = a.shape[1:]
    x = a.reshape(ph, pw, *lead)
    return x[:height, :width].reshape(height * width, *lead)


def pad_live_mask(width: int, height: int, pw: int, ph: int, device=None) -> torch.Tensor:
    """[ph*pw] bool: True on the live (unpadded) pixel region."""
    row = torch.arange(ph, device=device)[:, None] < height
    col = torch.arange(pw, device=device)[None, :] < width
    return (row & col).reshape(ph * pw)


def trace_rays_packet(trav, pairs, rays: Rays, active=None,
                      packet_size: int = 128) -> Tuple[HitRecord, TraceStats]:
    """Closest-hit trace with one stack per packet of ``packet_size``
    consecutive rays (see the module docstring). ``trav`` is a
    ``TraversalBVH``, ``pairs`` its ``PackedPairs``; the ray count must be
    a multiple of ``packet_size``. ``active`` ([R] bool) turns rays off; a
    packet with no ray on starts with an empty stack."""
    num_rays = rays.origin.shape[0]
    k = packet_size
    if num_rays % k:
        raise ValueError(f"{num_rays} rays do not split into packets of {k}")
    num_p = num_rays // k
    dev = rays.origin.device
    num_slots = trav.rows.shape[0]
    num_pairs = pairs.rows.shape[0]
    depth = STACK_DEPTH

    def pk(a):
        return a.reshape(num_p, k, *a.shape[1:])

    origin, direction, tmin = pk(rays.origin), pk(rays.direction), pk(rays.tmin)
    ray_on = (torch.ones((num_p, k), dtype=torch.bool, device=dev) if active is None
              else pk(active.to(torch.bool)))
    stack = torch.zeros((num_p, depth), dtype=torch.int32, device=dev)
    stack[:, 0] = (trav.root.to(torch.int32) << _ENTRY_SHIFT) | trav.root_count.to(torch.int32)
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
        entry = stack[p, sz]
        index = (entry >> _ENTRY_SHIFT).to(torch.int64)
        count = entry & _COUNT_MASK
        o, d, tmn, on = origin[p], direction[p], tmin[p], ray_on[p]
        tm, ht, pid, tid = tmax[p], hit[p], prim_id[p], tri_id[p]
        bu, bv, bt, tt = bary_u[p], bary_v[p], box_tests[p], tri_tests[p]
        have_buf = torch.zeros_like(p, dtype=torch.bool)
        buf_entry = torch.zeros_like(entry)
        buf_dist = torch.zeros((p.numel(),), dtype=torch.float32, device=dev)
        full = torch.zeros_like(have_buf)

        def push(mask, value, sz):
            nonlocal full
            over = mask & (sz >= depth)
            full = full | over
            ok = mask & ~over
            stack[p[ok], sz[ok]] = value[ok]
            return sz + mask.to(torch.int64)

        for i in range(_GROUP_WIDTH):
            slot = (index + i).clamp(0, num_slots - 1)
            row = trav.rows[slot]  # one node row per packet
            meta = row[:, 6]
            child = meta >> _META_CHILD_SHIFT
            ccount = (meta >> _META_COUNT_SHIFT) & _META_COUNT_MASK
            ntype = meta & _META_TYPE_MASK
            valid = (i < count) & (ntype != CHILD_NONE)
            box_hit, dist = intersect_ray_aabb(i2f(row[:, None, 0:3]), i2f(row[:, None, 3:6]),
                                               o, d, tmn, tm)
            box_hit = box_hit & on
            bt = bt + (valid[:, None] & on).to(torch.int32)
            any_hit = box_hit.any(dim=1) & valid

            do_leaf = any_hit & (ntype == CHILD_TRI)
            prow = pairs.rows[child.clamp(0, num_pairs - 1).to(torch.int64)]
            v0, v1, v2, v3 = (i2f(prow[:, None, 3 * j:3 * j + 3]) for j in range(4))
            leaf_rays = do_leaf[:, None] & box_hit
            tt = tt + leaf_rays.to(torch.int32)
            acc, t_a, u_a, v_a = intersect_ray_triangle(v0, v1, v2, o, d, tmn, tm)
            take = leaf_rays & acc
            tm = torch.where(take, t_a, tm)
            ht = ht | take
            pid = torch.where(take, prow[:, 12:13], pid)
            tid = torch.where(take, (child << 1)[:, None], tid)
            bu = torch.where(take, u_a, bu)
            bv = torch.where(take, v_a, bv)
            acc, t_b, u_b, v_b = intersect_ray_triangle(v2, v1, v3, o, d, tmn, tm)
            take = leaf_rays & (ccount > 0)[:, None] & acc
            tm = torch.where(take, t_b, tm)
            ht = ht | take
            pid = torch.where(take, prow[:, 13:14], pid)
            tid = torch.where(take, ((child << 1) + 1)[:, None], tid)
            bu = torch.where(take, u_b, bu)
            bv = torch.where(take, v_b, bv)

            # interior: packet-level near-child ordering by the smallest
            # entry distance of the rays that hit
            do_box = any_hit & (ntype == CHILD_BOX)
            dist_p = torch.where(box_hit, dist, _F32_MAX).amin(dim=1)
            new_entry = (child << _ENTRY_SHIFT) | ccount
            first = do_box & ~have_buf
            buf_entry = torch.where(first, new_entry, buf_entry)
            buf_dist = torch.where(first, dist_p, buf_dist)
            second = do_box & have_buf
            closer = (dist_p < buf_dist) | ((dist_p == buf_dist)
                                            & (child > (buf_entry >> _ENTRY_SHIFT)))
            sz = push(second, torch.where(closer, buf_entry, new_entry), sz)
            buf_entry = torch.where(second & closer, new_entry, buf_entry)
            buf_dist = torch.where(second & closer, dist_p, buf_dist)
            have_buf = have_buf | do_box
        sz = push(have_buf, buf_entry, sz)

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


def make_tiled_packet_tracer(width: int, height: int, tile_w: int = 16, tile_h: int = 8):
    """Tracer ``(trav, pairs, rays, active=None) ->
    (HitRecord, TraceStats)`` that reorders a row-major frame into
    ``tile_w`` x ``tile_h`` screen tiles, traces one packet a tile and
    restores row-major order."""

    def tracer(trav, pairs, rays, active=None):
        tiled = Rays(*(tile_reorder(getattr(rays, f), width, height, tile_w, tile_h)
                       for f in ("origin", "direction", "tmin", "tmax")))
        act = None if active is None else tile_reorder(active, width, height, tile_w, tile_h)
        rec, stats = trace_rays_packet(trav, pairs, tiled, active=act,
                                       packet_size=tile_w * tile_h)
        back = lambda a: tile_restore(a, width, height, tile_w, tile_h)  # noqa: E731
        rec = HitRecord(*(back(getattr(rec, f)) for f in
                          ("hit", "t", "prim_id", "tri_id", "bary_u", "bary_v")))
        stats.box_tests, stats.tri_tests = back(stats.box_tests), back(stats.tri_tests)
        return rec, stats

    return tracer
