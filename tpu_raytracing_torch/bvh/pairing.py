"""Triangle pairing: shared-edge detection, rotations, quad assembly.

Port of ``tpu_raytracing/bvh/pairing.py`` (``can_form_pair``,
``should_form_pair``, ``create_pairs``, ``identity_pairs``), and
``pair_vertices``, which re-assembles stored pairs on other vertex
positions (the animated app's rest pose): exact float
vertex equality, edge matching in the reference's iteration order
(src/Pairing.cuh:1-78), the merge heuristic
``sa(pair) * 0.5 < sa(a) + sa(b)`` and quad assembly with rotation
encoding. Triangles are [..., 3, 3] tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_raytracing_torch.bvh.types import TrianglePairs
from tpu_raytracing_torch.ops.intersect import aabb_surface_area


def _vertex_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = (a vertex i == b vertex j), exact float compare."""
    return (a[..., :, None, :] == b[..., None, :, :]).all(dim=-1)


def _find_shared_edge(eq: torch.Tensor, x: int, y: int) -> torch.Tensor:
    """B's rotation in {0, 1, 2} for A-edge (x -> y), or -1
    (src/Pairing.cuh:26-33)."""
    r0 = eq[..., x, 0] & eq[..., y, 1]
    r2 = eq[..., x, 1] & eq[..., y, 2]
    r1 = eq[..., x, 2] & eq[..., y, 0]
    out = torch.full(eq.shape[:-2], -1, dtype=torch.int32, device=eq.device)
    out = torch.where(r1, 1, out)
    out = torch.where(r2, 2, out)
    out = torch.where(r0, 0, out)
    return out.to(torch.int32)


def can_form_pair(a: torch.Tensor,
                  b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CanFormTrianglePair (src/Pairing.cuh:42-58): probes A's edges
    (v0,v2) rot 2, (v1,v0) rot 1, (v2,v1) rot 0, first match wins.
    Returns (can, rot_a, rot_b)."""
    eq = _vertex_equal(a, b)
    shape = a.shape[:-2]
    can = torch.zeros(shape, dtype=torch.bool, device=a.device)
    rot_a = torch.zeros(shape, dtype=torch.int32, device=a.device)
    rot_b = torch.zeros(shape, dtype=torch.int32, device=a.device)
    for x, y, ra in [(0, 2, 2), (1, 0, 1), (2, 1, 0)]:
        r = _find_shared_edge(eq, x, y)
        found = r >= 0
        take = found & ~can
        rot_a = torch.where(take, ra, rot_a).to(torch.int32)
        rot_b = torch.where(take, r, rot_b).to(torch.int32)
        can = can | found
    return can, rot_a, rot_b


def should_form_pair(a_min, a_max, b_min, b_max, p_min, p_max) -> torch.Tensor:
    """Merge heuristic (src/Pairing.cuh:35-39)."""
    return aabb_surface_area(p_min, p_max) * 0.5 < (
        aabb_surface_area(a_min, a_max) + aabb_surface_area(b_min, b_max)
    )


_ROT1 = [2, 0, 1]
_ROT2 = [1, 2, 0]


def _rotate_triangle(tri: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """RotateTriangle (src/Pairing.cuh:9-21): rot 1 -> (v2, v0, v1),
    rot 2 -> (v1, v2, v0)."""
    r = rot[..., None, None]
    return torch.where(r == 1, tri[..., _ROT1, :],
                       torch.where(r == 2, tri[..., _ROT2, :], tri))


def create_pairs(a, b, a_id, b_id, is_pair) -> TrianglePairs:
    """CreateTrianglePair (src/Pairing.cuh:60-78), vectorised.

    Paired: A is rotated so the shared edge is (v1, v2); v3 is B's vertex
    opposite that edge. Unpaired: v3 = v2 and both ids point at A.
    """
    _, rot_a, rot_b = can_form_pair(a, b)
    rot_a = torch.where(is_pair, rot_a, 0)
    rot_b = torch.where(is_pair, rot_b, 0)
    a_rot = _rotate_triangle(a, rot_a)
    v3_pair = torch.where(
        (rot_b == 2)[..., None], b[..., 0, :],
        torch.where((rot_b == 1)[..., None], b[..., 1, :], b[..., 2, :]),
    )
    v3 = torch.where(is_pair[..., None], v3_pair, a_rot[..., 2, :])
    return TrianglePairs(
        v0=a_rot[..., 0, :],
        v1=a_rot[..., 1, :],
        v2=a_rot[..., 2, :],
        v3=v3,
        prim_id_0=a_id.to(torch.int32),
        prim_id_1=torch.where(is_pair, b_id, a_id).to(torch.int32),
        rot_0=rot_a.to(torch.int32),
        rot_1=rot_b.to(torch.int32),
    )


def pair_vertices(triangles, prim_id_0, prim_id_1, rot_0, rot_1) -> torch.Tensor:
    """The four vertices [P, 4, 3] of pairs assembled by ``create_pairs``,
    taken from ``triangles`` by the pairs' stored primitive ids and
    rotations, without a geometric test: A rotated by ``rot_0``, and v3 the
    vertex ``rot_1`` names of B, or A's v2 where the pair holds one
    triangle (``prim_id_1 == prim_id_0``)."""
    a = _rotate_triangle(triangles[prim_id_0.long()], rot_0)
    b = triangles[prim_id_1.long()]
    r1 = rot_1[:, None]
    v3 = torch.where(r1 == 2, b[:, 0], torch.where(r1 == 1, b[:, 1], b[:, 2]))
    v3 = torch.where((prim_id_1 != prim_id_0)[:, None], v3, a[:, 2])
    return torch.cat([a, v3[:, None]], dim=1)


def identity_pairs(triangles: torch.Tensor) -> TrianglePairs:
    """Pair i == triangle i, unpaired."""
    num = triangles.shape[0]
    idx = torch.arange(num, dtype=torch.int32, device=triangles.device)
    false = torch.zeros((num,), dtype=torch.bool, device=triangles.device)
    return create_pairs(triangles, triangles, idx, idx, false)
