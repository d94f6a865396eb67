"""Morton-sorted pair rows: the front end of the split-BVH build.

Port of the parts of ``tpu_raytracing/bvh/lbvh.py`` that the bucket build
uses: ``scene_aabb``, ``_pair_assembly`` and ``fused_sorted_pairs``. The
Karras hierarchy and its refit wait.

Morton codes are uint32 values held in int64 tensors; invalid entries get
the key ``0xFFFFFFFF`` and sort to the end. The reference's multi-payload
stable ``lax.sort`` becomes one stable argsort plus a row gather, which
puts ties in the same slots.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_raytracing_torch.bvh.pairing import can_form_pair, create_pairs, should_form_pair
from tpu_raytracing_torch.ops.intersect import triangle_aabb
from tpu_raytracing_torch.ops.morton import morton3d
from tpu_raytracing_torch.trace.traverse import pack_pairs

_INVALID_CODE = 0xFFFFFFFF
# XLA evaluates ``jnp.mean`` over 3 vertices as sum * float32(1/3); the
# port uses the same constant so centroids, and hence codes, match bit
# for bit.
_THIRD = 1.0 / 3.0


def scene_aabb(triangles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scene bounds over all vertices (src/Multiblock.cu:104-114)."""
    pts = triangles.reshape(-1, 3)
    return pts.amin(dim=0), pts.amax(dim=0)


def _centre(tri: torch.Tensor) -> torch.Tensor:
    return (tri[:, 0] + tri[:, 1] + tri[:, 2]) * _THIRD


def _pair_assembly(triangles, aabb_min, aabb_max, enable_pairs: bool):
    """Pairing tests + packed rows + Morton keys/values, before the sort.

    Returns (codes [n] int64, values [n] int64 holding uint32 bits with the
    MSB pair flag, rows [n, 16] int32).
    """
    num = triangles.shape[0]
    dev = triangles.device
    extent = aabb_max - aabb_min

    def code_of(c):
        return morton3d(((c - aabb_min) / extent).clamp(0.0, 1.0))

    if not enable_pairs:
        idx = torch.arange(num, dtype=torch.int32, device=dev)
        codes = code_of(_centre(triangles))
        values = idx.to(torch.int64)
        rows = pack_pairs(create_pairs(
            triangles, triangles, idx, idx,
            torch.zeros((num,), dtype=torch.bool, device=dev))).rows
        return codes, values, rows

    num_even = (num + 1) // 2
    a = triangles[0::2]
    has_b = torch.arange(num_even, device=dev) * 2 + 1 < num
    tri_even = torch.cat([triangles, triangles[-1:]], dim=0) if num % 2 else triangles
    b = tri_even[1::2]
    a_min, a_max = triangle_aabb(a[:, 0], a[:, 1], a[:, 2])
    b_min, b_max = triangle_aabb(b[:, 0], b[:, 1], b[:, 2])
    c_min = torch.minimum(a_min, b_min)
    c_max = torch.maximum(a_max, b_max)
    can, _, _ = can_form_pair(a, b)
    merge = has_b & can & should_form_pair(a_min, a_max, b_min, b_max, c_min, c_max)
    centre_a = _centre(a)
    centre_b = _centre(b)
    centre_first = torch.where(merge[:, None], (centre_a + centre_b) * 0.5, centre_a)
    tid = torch.arange(num_even, dtype=torch.int64, device=dev) * 2
    codes_a = code_of(centre_first)
    val_a = torch.where(merge, tid | 0x80000000, tid)
    second_valid = has_b & ~merge
    codes_b = torch.where(second_valid, code_of(centre_b), _INVALID_CODE)
    val_b = tid + 1
    idx_a = tid.to(torch.int32)
    idx_b = torch.clamp(idx_a + 1, max=num - 1)
    rows_a = pack_pairs(create_pairs(a, b, idx_a, idx_b, merge)).rows
    # B entries are always unpaired: create_pairs ignores its b operand.
    rows_b = pack_pairs(create_pairs(
        b, b, idx_b, idx_b,
        torch.zeros((num_even,), dtype=torch.bool, device=dev))).rows
    codes = torch.stack([codes_a, codes_b], dim=1).reshape(-1)[:num]
    values = torch.stack([val_a, val_b], dim=1).reshape(-1)[:num]
    rows = torch.stack([rows_a, rows_b], dim=1).reshape(-1, 16)[:num]
    return codes, values, rows


def fused_sorted_pairs(triangles, aabb_min, aabb_max, enable_pairs: bool):
    """Morton sort carrying the packed pair rows.

    Returns (sorted_codes [n] int64, sorted_rows [n, 16] int32,
    sorted_values [n] int64, num_leaves [] int64 tensor).
    """
    codes, values, rows = _pair_assembly(triangles, aabb_min, aabb_max, enable_pairs)
    perm = torch.sort(codes, stable=True).indices
    num_leaves = (codes != _INVALID_CODE).sum()
    return codes[perm], rows[perm], values[perm], num_leaves
