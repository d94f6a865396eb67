"""Brute-force O(rays x triangles) reference intersector — the CPU oracle.

Port of ``tpu_raytracing/trace/brute.py`` (``HitRecord``,
``make_brute_tracer``, ``brute_force_trace``). It shares the traversal's Möller-Trumbore
semantics (src/Tracer.cu:256-291) but needs no acceleration structure;
equal-t ties go to the highest triangle index, the reference loop's
sequential-overwrite behaviour.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_raytracing_torch.ops.intersect import intersect_ray_triangle
from tpu_raytracing_torch.trace.ray import Rays

_F32_MAX = float(torch.finfo(torch.float32).max)


@dataclasses.dataclass
class HitRecord:
    hit: torch.Tensor  # [R] bool
    t: torch.Tensor  # [R] float32 — updated ray tmax
    prim_id: torch.Tensor  # [R] int32 — attribute/primitive index
    tri_id: torch.Tensor  # [R] int32 — (pair_id << 1) | second_tri
    bary_u: torch.Tensor  # [R] float32
    bary_v: torch.Tensor  # [R] float32


@dataclasses.dataclass
class InstancedHitRecord(HitRecord):
    """A two-level closest hit (``trace/instanced_split.py``): ``tri_id``,
    ``prim_id`` and the barycentrics name the hit instance's object-space
    triangle, ``t`` is a distance along the world ray."""

    inst: torch.Tensor  # [R] int32: the hit instance, -1 for none


def make_brute_tracer(triangles: torch.Tensor, chunk: int = 1024):
    """Tracer with the BVH tracers' ``(trav, pairs, rays)`` signature over no
    structure at all, so the render pipeline can swap in the oracle (with
    identity pairs: pair i is triangle i). Its statistics are zero."""
    from tpu_raytracing_torch.trace.traverse import TraceStats

    def tracer(trav, pairs, rays):
        rec = brute_force_trace(triangles, rays, chunk=chunk)
        zeros = torch.zeros_like(rec.prim_id)
        return rec, TraceStats(box_tests=zeros, tri_tests=zeros.clone(),
                               overflow=torch.zeros((1,), dtype=torch.int32,
                                                    device=zeros.device))

    return tracer


def brute_force_trace(triangles: torch.Tensor, rays: Rays, chunk: int = 1024) -> HitRecord:
    """Intersect every ray with every triangle, ``chunk`` rays at a time.

    triangles: [T, 3, 3] float32. tri_id follows the identity-pairs
    convention (triangle i -> pair i, first triangle).
    """
    v0, v1, v2 = (triangles[None, :, i] for i in range(3))
    idx = torch.arange(triangles.shape[0], dtype=torch.int32, device=triangles.device)
    outs = []
    for s in range(0, rays.origin.shape[0], chunk):
        o = rays.origin[s:s + chunk, None, :]
        d = rays.direction[s:s + chunk, None, :]
        lo = rays.tmin[s:s + chunk, None]
        hi = rays.tmax[s:s + chunk]
        accept, t, u, v = intersect_ray_triangle(v0, v1, v2, o, d, lo, hi[:, None])
        t_masked = torch.where(accept, t, _F32_MAX)
        best_t = t_masked.min(dim=1).values
        hit = accept.any(dim=1)
        is_best = accept & (t_masked == best_t[:, None])
        win = torch.where(is_best, idx[None, :], -1).max(dim=1).values
        ws = win.clamp(min=0)[:, None].to(torch.int64)
        outs.append((
            hit,
            torch.where(hit, best_t, hi),
            torch.where(hit, win, 0).to(torch.int32),
            torch.where(hit, win << 1, 0).to(torch.int32),
            torch.where(hit, u.gather(1, ws)[:, 0], 0.0),
            torch.where(hit, v.gather(1, ws)[:, 0], 0.0),
        ))
    return HitRecord(*(torch.cat(parts) for parts in zip(*outs)))
