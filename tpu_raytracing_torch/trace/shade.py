"""Shading helpers of the path tracer.

Port of the parts of ``tpu_raytracing/trace/shade.py`` that the
path-traced frame uses: ``rotate_attributes``, ``interpolate`` and
``light_colour``. Texturing, LOD, bump mapping and the Phong shader wait
with the render modes.
"""

from __future__ import annotations

import torch

LIGHT_COLOUR_RGB = (1.0, 0.9, 0.8)

_PERM1 = [2, 0, 1]
_PERM2 = [1, 2, 0]


def rotate_attributes(normals, uvs, rot):
    """Undo pairing rotation at shade time (src/Tracer.cu:57-82): rot 1 ->
    corners (2, 0, 1); rot 2 -> corners (1, 2, 0). normals [R, 3, 3],
    uvs [R, 3, 2], rot [R]."""
    r = rot[:, None, None]
    n = torch.where(r == 1, normals[:, _PERM1], torch.where(r == 2, normals[:, _PERM2], normals))
    u = torch.where(r == 1, uvs[:, _PERM1], torch.where(r == 2, uvs[:, _PERM2], uvs))
    return n, u


def interpolate(corner_vals, bary_u, bary_v):
    """Barycentric interpolation over [R, 3, C] corner values
    (src/Tracer.cu:42-55)."""
    w0 = (1.0 - bary_u - bary_v)[:, None]
    return (
        corner_vals[:, 0] * w0
        + corner_vals[:, 1] * bary_u[:, None]
        + corner_vals[:, 2] * bary_v[:, None]
    )


def light_colour(device=None) -> torch.Tensor:
    return torch.tensor(LIGHT_COLOUR_RGB, dtype=torch.float32, device=device)
