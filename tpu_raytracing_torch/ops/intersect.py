"""Ray-triangle test and triangle box helpers.

Port of ``tpu_raytracing/ops/intersect.py`` (``intersect_ray_aabb``,
``triangle_aabb``, ``aabb_surface_area``, ``intersect_ray_triangle``). The
traversal kernels' plain versions write their own slab tests in their
kernels' operation order.
Cross and dot products are written out term by term, so every float
operation happens in a stated order.
"""

from __future__ import annotations

import torch

# Möller-Trumbore determinant epsilon (reference: src/Tracer.cu:260).
TRI_EPSILON = 1e-9


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the trailing axis of size 3, written out."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a.x*b.x + a.y*b.y) + a.z*b.z over the trailing axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def safe_inverse(direction: torch.Tensor) -> torch.Tensor:
    """1 / d with components |d| < 1e-30 replaced by +-1e-30 (-0.0 ->
    +1e-30), so the slab test never forms 0 * inf = NaN."""
    d = torch.where(direction.abs() < 1e-30, torch.where(direction < 0, -1e-30, 1e-30),
                    direction)
    return 1.0 / d


def intersect_ray_aabb(box_min, box_max, origin, direction, tmin, tmax):
    """Slab test (reference: src/Tracer.cu:187-200).

    Returns (hit, front); ``front`` is the entry distance that orders near
    children. The direction goes through ``safe_inverse``: torch's
    min/max propagate NaN, where the reference CUDA's fminf ignores it.
    """
    inv = safe_inverse(direction)
    t1 = (box_min - origin) * inv
    t2 = (box_max - origin) * inv
    front = torch.minimum(t1, t2).amax(dim=-1)
    back = torch.maximum(t1, t2).amin(dim=-1)
    hit = (back >= front) & (front <= tmax) & (back >= tmin)
    return hit, front


def intersect_ray_triangle(v0, v1, v2, origin, direction, tmin, tmax):
    """Möller-Trumbore (reference: src/Tracer.cu:256-291).

    Returns (accept, t, u, v); ``accept`` means the hit lies in
    [tmin, tmax] with the reference's inclusive bounds.
    """
    edge1 = v1 - v0
    edge2 = v2 - v0
    h = cross(direction, edge2)
    a = dot(edge1, h)
    degenerate = (a > -TRI_EPSILON) & (a < TRI_EPSILON)
    f = 1.0 / a
    s = origin - v0
    u = f * dot(s, h)
    q = cross(s, edge1)
    v = f * dot(direction, q)
    t = f * dot(edge2, q)
    accept = (
        ~degenerate
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= tmin)
        & (t <= tmax)
    )
    return accept, t, u, v


def triangle_aabb(v0, v1, v2):
    """Triangle bounding box (reference: src/Common.cuh:263-267)."""
    lo = torch.minimum(torch.minimum(v0, v1), v2)
    hi = torch.maximum(torch.maximum(v0, v1), v2)
    return lo, hi


def aabb_surface_area(box_min, box_max):
    """Surface-area metric used by pairing (src/Common.cuh:293-297)."""
    length = box_max - box_min
    return 2.0 * (
        length[..., 0] * length[..., 1]
        + length[..., 0] * length[..., 2]
        + length[..., 1] * length[..., 2]
    )
