"""30-bit Morton codes (reference: src/BottomUpBuilder.cu:10-32).

Port of ``tpu_raytracing/ops/morton.py`` (``expand_bits``, ``morton3d``).
torch's uint32 supports few operations, so codes are computed in int64 and
masked with ``& 0xFFFFFFFF`` after every multiply, which reproduces the
reference's uint32 wrap-around bit for bit.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Insert two zeros after each of the low 10 bits; int64 in and out."""
    v = v.to(torch.int64)
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton3d(xyz: torch.Tensor) -> torch.Tensor:
    """Morton code of points in the unit cube, [..., 3] float -> [...] int64
    holding the reference's uint32 value.

    The float -> int step truncates like the reference's
    ``clip(x * 1024, 0, 1023).astype(uint32)``. A NaN coordinate (a flat
    scene extent divides 0 by 0) becomes 0, which is what the reference
    gives on the CPU; torch's own NaN conversion is undefined, so it is
    replaced explicitly.
    """
    q = torch.nan_to_num(xyz * 1024.0, nan=0.0).clamp(0.0, 1023.0)
    q = q.to(torch.int64)
    xx = expand_bits(q[..., 0])
    yy = expand_bits(q[..., 1])
    zz = expand_bits(q[..., 2])
    return (xx * 4 + yy * 2 + zz) & _U32
