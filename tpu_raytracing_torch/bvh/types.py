"""Core BVH constants and the triangle-pair container.

Port of ``tpu_raytracing/bvh/types.py`` (``CHILD_*``, ``STACK_DEPTH``,
``TrianglePairs``, ``BVH``, ``empty_bvh``). Plain dataclasses of torch
tensors replace the ``flax.struct`` pytrees; ``dataclasses.replace`` takes
the place of ``.replace``.
"""

from __future__ import annotations

import dataclasses

import torch

# ChildType enum values (reference: src/Common.cuh:36-42).
CHILD_NONE = 0
CHILD_BOX = 1
CHILD_TRI = 2
CHILD_INST = 3
CHILD_PROC = 4

# Traversal stack depth (reference: src/Tracer.cu:313).
STACK_DEPTH = 64


@dataclasses.dataclass
class TrianglePairs:
    """SoA of quad-compressed triangle pairs (reference: src/Common.cuh:161-197).

    Triangle A is (v0, v1, v2), triangle B is (v2, v1, v3). Unpaired entries
    store v3 == v2 so the second triangle is degenerate.
    """

    v0: torch.Tensor  # [P, 3] float32
    v1: torch.Tensor  # [P, 3] float32
    v2: torch.Tensor  # [P, 3] float32
    v3: torch.Tensor  # [P, 3] float32
    prim_id_0: torch.Tensor  # [P] int32 — source primitive of triangle A
    prim_id_1: torch.Tensor  # [P] int32 — source primitive of triangle B
    rot_0: torch.Tensor  # [P] int32 in {0,1,2}
    rot_1: torch.Tensor  # [P] int32 in {0,1,2}

    @property
    def num_pairs(self) -> int:
        return self.v0.shape[0]


@dataclasses.dataclass
class BVH:
    """SoA binary BVH; node slot ``i`` mirrors the reference ``Node``
    (src/Common.cuh:152-159). ``root``/``root_count`` name the root group
    the traversal starts from (the Karras build's root is the sibling pair
    at slots 0..1, count 2)."""

    node_min: torch.Tensor  # [N, 3] float32
    node_max: torch.Tensor  # [N, 3] float32
    child: torch.Tensor  # [N] int32 — child group start (Box) or pair index (Tri)
    count: torch.Tensor  # [N] int32 — child group size (Box); pair-valid flag (Tri)
    type: torch.Tensor  # [N] int32 — ChildType
    parent: torch.Tensor  # [N] int32 — parent slot (root slots: self)
    root: torch.Tensor  # [] int32 — root group start slot
    root_count: torch.Tensor  # [] int32 — root group size

    @property
    def num_slots(self) -> int:
        return self.child.shape[0]


def empty_bvh(num_slots: int, device=None) -> BVH:
    """Zero-initialised BVH arena with all slots ChildType_None."""
    f32_max = float(torch.finfo(torch.float32).max)
    f = torch.zeros((num_slots, 3), dtype=torch.float32, device=device)
    i = torch.zeros((num_slots,), dtype=torch.int32, device=device)
    return BVH(node_min=f + f32_max, node_max=f - f32_max, child=i, count=i.clone(),
               type=i.clone(), parent=i.clone(),
               root=torch.tensor(0, dtype=torch.int32, device=device),
               root_count=torch.tensor(1, dtype=torch.int32, device=device))
