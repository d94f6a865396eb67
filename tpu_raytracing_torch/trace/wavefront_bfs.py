"""Breadth-first wavefront tracer over a split BVH, one (ray, node) visit
at a time.

Port of ``tpu_raytracing/trace/wavefront_bfs.py`` (``BFSViews``,
``prep_bfs_views``, ``trace_rays_bfs``, ``make_bfs_tracer``). PyTorch ops;
the reference has no Pallas kernel here.

Traversal is level-synchronous. Level 0 visits the root row once per live
ray. At each level every visit slab-tests the row's w entries against its
ray's best t so far; the Box children it hits become the next level's
visits and the Tri children this level's leaf visits, both in (visit,
entry) order. Each leaf visit runs Möller-Trumbore on its window of
``leaf_width`` pairs against its own ray, in chunks of ``mt_chunk`` visits,
and the winners reduce into the per-ray best: the smallest t, and on an
exact tie the larger encoded triangle (pair index * 2 + second); a window
none of whose triangles hits names no winner (``tm < F32_MAX``), so a ray
with tmax = F32_MAX has no phantom hit here (ROADMAP Queue 3). In any-hit
mode a ray with a hit takes t = -F32_MAX after its level, so its pending
visits fail the next slab test.

The reference holds each level in static buffers: the next level's visits
in ``max(cap_factor * R, min(cap_floor, R * w))`` slots (at most the
level's own slots times w) and its leaf visits in the same with
``leaf_factor``; a level past its buffer drops its last visits and sets the
overflow flag, and ``max_levels`` levels run. Here each level keeps only
its valid visits, in the same order, and drops the same ones past the same
caps, so hits, tests and the flag are the reference's. Two differences:

* the reference's ``make_bfs_tracer`` throws the flag away
  (``wavefront_bfs.py:315``); here it is ``TraceStats.overflow``, on which
  ``path_trace`` and ``render.shade_rays`` raise;
* visits still pending after the last of ``max_levels`` levels (the
  reference drops them) also set it: the default level count is a bucket
  tree's depth bound, and an SAH tree can be deeper.

The Möller-Trumbore is K1's plain one (``split_trace._mt``), in the
reference's operation order: XLA's CPU compiler fuses no multiply-add in
this module's, so t equals the reference's bit for bit on the CPU.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpu_raytracing_torch.bvh.bucket import SplitBVH
from tpu_raytracing_torch.bvh.types import CHILD_BOX, CHILD_TRI
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.split_trace import _mt
from tpu_raytracing_torch.trace.traverse import (
    _META_CHILD_SHIFT,
    _META_TYPE_MASK,
    PackedPairs,
    TraceStats,
    i2f,
    reconstruct,
)

_F32_MAX = float(torch.finfo(torch.float32).max)


@dataclasses.dataclass
class BFSViews:
    """The BFS tracer's node table."""

    inner: torch.Tensor  # [icap, w, 8] int32 inner rows (box words bit-cast)
    pair_rows: torch.Tensor  # [P, 16] int32 packed pairs
    leaf_width: int = 16  # pairs per leaf window; must match the build


def prep_bfs_views(split: SplitBVH, packed: PackedPairs) -> BFSViews:
    icap, words = split.inner.shape
    return BFSViews(inner=split.inner.reshape(icap, words // 8, 8), pair_rows=packed.rows,
                    leaf_width=split.leaf_width)


def _leaf_chunk(pair_rows, leafw, lray, lwin, origin, direction, tmin, t_best, tri_best,
                tri_tests):
    """One chunk of leaf visits (``mt_chunk_pass``): each visit's window
    against its own ray, then the per-ray winner update."""
    num_pairs = pair_rows.shape[0]
    widx = (lwin[:, None] + torch.arange(leafw, device=lwin.device)[None, :]).clamp(
        0, num_pairs - 1)  # [V, leafw]
    v = i2f(pair_rows[widx][..., :12])
    o = tuple(origin[lray, i:i + 1] for i in range(3))
    d = tuple(direction[lray, i:i + 1] for i in range(3))
    tmn, tcur = tmin[lray, None], t_best[lray, None]
    vert = [tuple(v[..., 3 * j + i] for i in range(3)) for j in range(4)]
    cand_a = _mt(vert[0], vert[1], vert[2], o, d, tmn, tcur)
    cand_b = _mt(vert[2], vert[1], vert[3], o, d, tmn, tcur)
    cand = torch.minimum(cand_a, cand_b)
    enc = (widx << 1) | (cand_b <= cand_a).to(torch.int64)
    tm = cand.amin(dim=1)
    wenc = torch.where(cand == tm[:, None], enc, -1).amax(dim=1)
    t_new = t_best.scatter_reduce(0, lray, tm, "amin")
    # a ray whose best t improved drops its old winner; a tie keeps competing
    tri_base = torch.where(t_new < t_best, -1, tri_best)
    win = (tm <= t_new[lray]) & (tm < _F32_MAX)
    tri_new = tri_base.scatter_reduce(0, lray[win], wenc[win].to(torch.int32), "amax")
    tri_tests.index_add_(0, lray, torch.full_like(lray, 2 * leafw, dtype=torch.int32))
    return t_new, tri_new


def trace_rays_bfs(views: BFSViews, packed: PackedPairs, rays: Rays, active=None,
                   max_levels: int = None, cap_factor: float = 3.0, leaf_factor: float = 3.0,
                   cap_floor: int = 65536, mt_chunk: int = 524288, any_hit: bool = False,
                   level_visits: list = None):
    """Closest-hit (or any-hit) BFS trace (see the module docstring).
    Returns (HitRecord, TraceStats, overflow [] bool); ``stats.overflow``
    carries the same flag. With ``level_visits`` (a list), appends each
    level's (visits, next-level visits, leaf visits), the last two before
    their caps."""
    inner, pair_rows, leafw = views.inner, views.pair_rows, views.leaf_width
    w = inner.shape[1]
    icap = inner.shape[0]
    num = rays.origin.shape[0]
    dev = rays.origin.device
    if max_levels is None:  # a bucket tree's level bound (wavefront_bfs.py:99-104)
        max_levels = 2 + -(-30 // (w.bit_length() - 1)) + math.ceil(
            math.log(max(pair_rows.shape[0], 2), w))
    d = rays.direction
    inv = 1.0 / torch.where(d.abs() < 1e-30, torch.where(d < 0, -1e-30, 1e-30), d)
    tmin, t_best = rays.tmin, rays.tmax
    if active is not None:
        tmin = torch.where(active, tmin, _F32_MAX)
        t_best = torch.where(active, t_best, -_F32_MAX)
    tri_best = torch.full((num,), -1, dtype=torch.int32, device=dev)
    box_tests = torch.zeros((num,), dtype=torch.int32, device=dev)
    tri_tests = torch.zeros((num,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)

    vray = (torch.arange(num, device=dev) if active is None
            else torch.nonzero(active).reshape(-1))
    vnode = torch.zeros_like(vray)
    slots = num  # the reference's static visit count of this level
    vcap = max(int(num * cap_factor), min(cap_floor, num * w))
    lcap = max(int(num * leaf_factor), min(cap_floor, num * w))
    for _ in range(max_levels):
        if vray.numel() == 0:
            break
        row = inner[vnode.clamp(0, icap - 1)]  # [V, w, 8]
        box = i2f(row[..., :6])
        meta = row[..., 6]
        o, iv = rays.origin[vray], inv[vray]
        tx0 = (box[..., 0] - o[:, 0:1]) * iv[:, 0:1]
        ty0 = (box[..., 1] - o[:, 1:2]) * iv[:, 1:2]
        tz0 = (box[..., 2] - o[:, 2:3]) * iv[:, 2:3]
        tx1 = (box[..., 3] - o[:, 0:1]) * iv[:, 0:1]
        ty1 = (box[..., 4] - o[:, 1:2]) * iv[:, 1:2]
        tz1 = (box[..., 5] - o[:, 2:3]) * iv[:, 2:3]
        front = torch.maximum(torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                              torch.minimum(tz0, tz1))
        back = torch.minimum(torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                             torch.maximum(tz0, tz1))
        ehit = (back >= front) & (front <= t_best[vray, None]) & (back >= tmin[vray, None])
        etype = meta & _META_TYPE_MASK
        child = (meta >> _META_CHILD_SHIFT).to(torch.int64)
        box_tests.index_add_(0, vray, torch.full_like(vray, w, dtype=torch.int32))

        # the next level's visits and this level's leaf visits, in (visit,
        # entry) order, each list cut at its cap
        cap_next = min(vcap, slots * w)
        lcap_l = min(lcap, slots * w)
        nxt = torch.nonzero((ehit & (etype == CHILD_BOX)).reshape(-1)).reshape(-1)
        leaf = torch.nonzero((ehit & (etype == CHILD_TRI)).reshape(-1)).reshape(-1)
        if level_visits is not None:
            level_visits.append((vray.numel(), nxt.numel(), leaf.numel()))
        overflow |= (nxt.numel() > cap_next) | (leaf.numel() > lcap_l)
        nxt, leaf = nxt[:cap_next], leaf[:lcap_l]
        lray, lwin = vray[leaf // w], child.reshape(-1)[leaf]
        for s in range(0, lray.numel(), mt_chunk):
            t_best, tri_best = _leaf_chunk(pair_rows, leafw, lray[s:s + mt_chunk],
                                           lwin[s:s + mt_chunk], rays.origin, rays.direction,
                                           tmin, t_best, tri_best, tri_tests)
        if any_hit:
            t_best = torch.where(tri_best >= 0, -_F32_MAX, t_best)
        vray, vnode = vray[nxt // w], child.reshape(-1)[nxt]
        slots = cap_next
    if vray.numel():  # visits left after the last level
        overflow = torch.ones_like(overflow)

    if any_hit:
        t_best = rays.tmax
    rec = reconstruct(packed, rays, t_best, tri_best, any_hit=any_hit)
    stats = TraceStats(box_tests=box_tests, tri_tests=tri_tests,
                       overflow=overflow.to(torch.int32).reshape(1))
    return rec, stats, overflow


def make_bfs_tracer(views=None, packed=None, cap_factor: float = 3.0,
                    leaf_factor: float = 3.0, cap_floor: int = 65536, any_hit: bool = False):
    """Tracer ``(trav, pairs, rays, active=None) ->
    (HitRecord, TraceStats)``; with ``views`` None the ``BFSViews`` ride in
    ``trav`` (and with ``packed`` None the pairs in ``pairs``). The overflow
    flag is ``TraceStats.overflow``."""
    def tracer(trav, pairs, rays, active=None):
        rec, stats, _ = trace_rays_bfs(views if views is not None else trav,
                                       packed if packed is not None else pairs, rays,
                                       active=active, cap_factor=cap_factor,
                                       leaf_factor=leaf_factor, cap_floor=cap_floor,
                                       any_hit=any_hit)
        return rec, stats

    return tracer
