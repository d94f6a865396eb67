"""Packed pair rows, trace statistics and node meta-word layout.

Port of the parts of ``tpu_raytracing/trace/traverse.py`` that the split
path uses: the ``_META_*`` constants, ``PackedPairs``, ``TraceStats`` and
``pack_pairs``. The scalar wavefront tracer (``trace_rays``, ``pack_bvh``)
waits for the binary builders.

Rows are int32 with float fields bit-cast in, exactly as in the
reference, so pair rows compare bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_raytracing_torch.bvh.types import TrianglePairs

# Node meta word: child << 5 | count << 2 | type.
_META_TYPE_MASK = 3
_META_COUNT_SHIFT = 2
_META_COUNT_MASK = 7
_META_CHILD_SHIFT = 5


@dataclasses.dataclass
class PackedPairs:
    rows: torch.Tensor  # [P, 16] i32: v0..v3 xyz (bitcast), prim0, prim1, rot0, rot1


@dataclasses.dataclass
class TraceStats:
    box_tests: torch.Tensor  # [R] int32
    tri_tests: torch.Tensor  # [R] int32
    # [1] int32, nonzero when a ray's traversal stack overflowed: the split
    # traversal stops that ray, and trace/split_trace.py:check_overflow
    # raises on the host.
    overflow: torch.Tensor


def f2i(a: torch.Tensor) -> torch.Tensor:
    """Bit-cast float32 -> int32 (``bitcast_convert_type``)."""
    return a.to(torch.float32).contiguous().view(torch.int32)


def i2f(a: torch.Tensor) -> torch.Tensor:
    """Bit-cast int32 -> float32."""
    return a.contiguous().view(torch.float32)


def pack_pairs(pairs: TrianglePairs) -> PackedPairs:
    rows = torch.cat(
        [
            f2i(pairs.v0),
            f2i(pairs.v1),
            f2i(pairs.v2),
            f2i(pairs.v3),
            pairs.prim_id_0.to(torch.int32)[:, None],
            pairs.prim_id_1.to(torch.int32)[:, None],
            pairs.rot_0.to(torch.int32)[:, None],
            pairs.rot_1.to(torch.int32)[:, None],
        ],
        dim=1,
    )
    return PackedPairs(rows=rows)
