"""Core BVH constants and the triangle-pair container.

Port of ``tpu_raytracing/bvh/types.py`` (``CHILD_*``, ``STACK_DEPTH``,
``TrianglePairs``); the binary ``BVH`` waits for the Karras build. A plain
dataclass of torch tensors replaces the ``flax.struct`` pytree.
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
