"""Treelet-binned tracing: rays expanded into items by the root's children.

Port of ``tpu_raytracing/trace/binned.py`` (``_root_entries``,
``trace_rays_binned``), the split tracer's ``sort_mode="binned"``.

1. Every ray slab-tests the w child boxes of the root row (``inner[0]``).
2. Each (ray, child) pair it hits becomes an item. Items are laid out
   child-major, each child's list in ray order and padded to a multiple of
   the packet size ``k``, in a buffer of ``cap`` slots
   (``cap_factor * n`` rounded up to ``k``, at least ``8 k``).
3. One K1 pass traces the items (``raw=True``), each packet of ``k`` items
   starting at its child's tag: an inner row, or a leaf window for a Tri
   child (``split_trace.trace_rays_split(packet_tags=...)``).
4. The items' hits combine per ray: the smallest t (a scatter-min), and on
   an exact tie of t the larger encoded triangle (a scatter-max over the
   winners), the global form of K1's later-slot rule. Only live items add
   to the ray's box and triangle tests.

On the TPU the binning made a packet's rays share a subtree. K1 runs one
ray per thread, so here it only splits each ray's traversal at the root;
a ray's items cannot share the t they learn, so they do at least the box
work of the ray's own traversal.

The reference drops the items past ``cap`` without a word
(``binned.py:36-40, 115-116``) and returns the needed count only on
request. Here ``needed > cap`` also sets ``TraceStats.overflow``, on which
``path_trace`` and ``render.shade_rays`` raise.
"""

from __future__ import annotations

import torch

from tpu_raytracing_torch.bvh.types import CHILD_TRI
from tpu_raytracing_torch.trace import split_trace
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.traverse import PackedPairs, TraceStats, i2f, reconstruct

_F32_MAX = float(torch.finfo(torch.float32).max)


def _root_entries(inner: torch.Tensor):
    """The root row's entries: (min [w, 3], max [w, 3], start tag [w],
    valid [w]). ``inner`` is K1's [ICAP, w, 8] view."""
    words = inner[0]
    f = i2f(words[:, 0:6])
    meta = words[:, 6]
    ntype = meta & 3
    tag = ((meta >> 5) << 1) | (ntype == CHILD_TRI).to(torch.int32)
    return f[:, 0:3], f[:, 3:6], tag, ntype != 0


def item_capacity(n: int, k: int, cap_factor: float) -> int:
    """Item slots for ``n`` rays: ``cap_factor * n`` rounded up to a
    multiple of ``k``, at least ``8 k`` (``binned.py:106``)."""
    return int(max(((int(cap_factor * n) + k - 1) // k) * k, 8 * k))


def trace_rays_binned(views, packed: PackedPairs, rays: Rays, active=None,
                      any_hit: bool = False, k: int = split_trace.K,
                      cap_factor: float = 2.0, return_needed: bool = False):
    """Closest-hit (or any-hit) trace of ``rays`` through K1 with the rays
    binned by root child (see the module docstring). ``views`` are K1's
    (``split_trace.trace_rays_split``). Returns (HitRecord, TraceStats),
    and with ``return_needed`` also ``needed``, the item slots the rays
    needed ([] int64 on the rays' device), against ``item_capacity``."""
    inner = views[0]
    w = inner.shape[1]
    n = rays.origin.shape[0]
    dev = rays.origin.device
    mn, mx, tag_e, valid_e = _root_entries(inner)

    # --- per-ray root-children slab ([n, w]) ---
    d = rays.direction
    inv = 1.0 / torch.where(d.abs() < 1e-30, torch.where(d < 0, -1e-30, 1e-30), d)
    t0 = (mn[None, :, :] - rays.origin[:, None, :]) * inv[:, None, :]
    t1 = (mx[None, :, :] - rays.origin[:, None, :]) * inv[:, None, :]
    front = torch.minimum(t0, t1).amax(dim=2)
    back = torch.maximum(t0, t1).amin(dim=2)
    live = rays.tmax > rays.tmin
    if active is not None:
        live = live & active
    hit = ((back >= front) & (front <= rays.tmax[:, None]) & (back >= rays.tmin[:, None])
           & valid_e[None, :] & live[:, None])

    # --- expansion: child-major item slots, each child padded to k ---
    v = hit.T.to(torch.int64)  # [w, n]
    counts = v.sum(dim=1)
    padded = (counts + k - 1) // k * k
    ends = torch.cumsum(padded, dim=0)
    offs = ends - padded
    needed = ends[-1]
    cap = item_capacity(n, k, cap_factor)
    child, ray = torch.nonzero(v, as_tuple=True)  # child-major, rays in order
    rank = (torch.cumsum(v, dim=1) - v)[child, ray]
    slot = offs[child] + rank
    keep = slot < cap
    srcmap = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    srcmap[slot[keep]] = ray[keep]

    # --- item rays; empty slots get an empty interval ---
    valid_item = srcmap >= 0
    ridx = srcmap.clamp(min=0)
    items = Rays(rays.origin[ridx], rays.direction[ridx],
                 torch.where(valid_item, rays.tmin[ridx], _F32_MAX),
                 torch.where(valid_item, rays.tmax[ridx], -_F32_MAX))

    # --- per-packet start tags: the child whose padded list holds the packet ---
    pkt_child = torch.searchsorted(ends // k, torch.arange(cap // k, device=dev), right=True)
    ptags = tag_e[pkt_child.clamp(max=w - 1)]
    (t_items, tri_items), istats = split_trace.trace_rays_split(
        views, packed, items, any_hit=any_hit, packet_tags=ptags, raw=True, k=k)

    # --- combine per ray: scatter-min t, then the larger winning tri ---
    src, t_src = srcmap[valid_item], t_items[valid_item]
    tb = rays.tmax.scatter_reduce(0, src, t_src, "amin")
    win = (t_src <= tb[src]) & (tri_items[valid_item] >= 0)
    tri_r = torch.full((n,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, src[win], tri_items[valid_item][win], "amax")
    box_tests = torch.zeros((n,), dtype=torch.int32, device=dev).index_add_(
        0, src, istats.box_tests[valid_item])
    tri_tests = torch.zeros((n,), dtype=torch.int32, device=dev).index_add_(
        0, src, istats.tri_tests[valid_item])

    t_r = rays.tmax if any_hit else tb
    rec = reconstruct(packed, rays, t_r, tri_r, any_hit=any_hit)
    overflow = istats.overflow + (needed > cap).to(torch.int32)
    stats = TraceStats(box_tests=box_tests, tri_tests=tri_tests, overflow=overflow)
    if return_needed:
        return rec, stats, needed
    return rec, stats
