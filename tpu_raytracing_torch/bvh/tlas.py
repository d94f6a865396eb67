"""Two-level TLAS/BLAS with instancing.

Port of ``tpu_raytracing/bvh/tlas.py`` (``InstancedAS``,
``instance_world_aabbs``, ``invert_affine``, ``build_instanced``). The
reference declares ChildType_Inst but never builds it (src/Common.cuh:40).
The TLAS is an LBVH over the instances' world boxes
(``lbvh.build_lbvh_from_aabbs``) whose leaves carry instance ids with
ChildType_Inst; the one BLAS's nodes follow the TLAS's, their Box child
pointers rebased, and ``trace/instanced.py`` pushes the BLAS root entry,
tagged with the instance, when a ray hits an instance leaf.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_raytracing_torch.bvh.lbvh import build_lbvh_from_aabbs
from tpu_raytracing_torch.bvh.types import BVH, CHILD_BOX, CHILD_INST
from tpu_raytracing_torch.trace.traverse import TraversalBVH, pack_bvh


@dataclasses.dataclass
class InstancedAS:
    """The combined two-level structure."""

    trav: TraversalBVH  # TLAS slots [0, T), then the rebased BLAS slots [T, T + B)
    inv_transforms: torch.Tensor  # [I + 1, 3, 4] object <- world; row 0 the identity
    blas_entry: torch.Tensor  # [] int32: (rebased BLAS root << 3) | root count


def instance_world_aabbs(blas_min, blas_max, transforms):
    """World box of each instance: the BLAS root box ([3] each) through
    ``transforms`` ([I, 3, 4] world <- object), by the per-component min
    and max of R times the box's extremes, exact for affine maps. Returns
    (wmin, wmax), [I, 3] each."""
    r = transforms[:, :, :3]
    t = transforms[:, :, 3]
    lo = r * blas_min[None, None, :]
    hi = r * blas_max[None, None, :]
    mn = torch.minimum(lo, hi)
    mx = torch.maximum(lo, hi)
    return (t + (mn[..., 0] + mn[..., 1] + mn[..., 2]),
            t + (mx[..., 0] + mx[..., 1] + mx[..., 2]))


def invert_affine(transforms: torch.Tensor) -> torch.Tensor:
    """Inverses of [I, 3, 4] affine transforms (float32, LU)."""
    r_inv = torch.linalg.inv(transforms[:, :, :3])
    t_inv = -(r_inv @ transforms[:, :, 3:4])
    return torch.cat([r_inv, t_inv], dim=2)


def instance_normal_maps(inv_transforms: torch.Tensor) -> torch.Tensor:
    """[I, 3, 3] float32, contiguous: each instance's normal matrix, the
    transpose of its inverse linear part (``inv_transforms`` [I, 3, 4],
    object <- world) turned by the sign of its determinant, so that an
    object-space face normal maps to the world face normal of the
    transformed triangle (a mirror flips the winding). The determinant is
    the cofactor expansion along the first row."""
    m = inv_transforms[:, :, :3]
    det = (m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1])
           - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 0])
           + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0]))
    sign = torch.where(det < 0, -1.0, 1.0).to(m.dtype)
    return (m.transpose(1, 2) * sign[:, None, None]).contiguous()


def build_instanced(blas: BVH, transforms: torch.Tensor) -> InstancedAS:
    """The TLAS over ``transforms`` ([I, 3, 4]) instances of one BLAS, both
    levels packed. The BLAS root group is the slot pair (root, root + 1) of
    a bottom-up build or the single root node of an SAH build; either way
    its packed entry (rebased root << 3 | root count) is what an instance
    leaf pushes."""
    dev = transforms.device
    num_inst = transforms.shape[0]
    root = blas.root.to(torch.int32)
    rc = blas.root_count.to(torch.int32)
    idx = torch.arange(blas.num_slots, device=dev)
    in_root = ((idx >= root) & (idx < root + rc))[:, None]
    inf = float("inf")
    root_min = torch.where(in_root, blas.node_min, inf).amin(dim=0)
    root_max = torch.where(in_root, blas.node_max, -inf).amax(dim=0)
    wmin, wmax = instance_world_aabbs(root_min, root_max, transforms)
    tlas = build_lbvh_from_aabbs(wmin, wmax, torch.arange(num_inst, dtype=torch.int32,
                                                          device=dev),
                                 leaf_type=CHILD_INST, leaf_count=1)

    offset = tlas.num_slots
    combined = BVH(
        node_min=torch.cat([tlas.node_min, blas.node_min]),
        node_max=torch.cat([tlas.node_max, blas.node_max]),
        child=torch.cat([tlas.child, torch.where(blas.type == CHILD_BOX, blas.child + offset,
                                                 blas.child)]),
        count=torch.cat([tlas.count, blas.count]),
        type=torch.cat([tlas.type, blas.type]),
        parent=torch.cat([tlas.parent, blas.parent + offset]),
        root=tlas.root,
        root_count=tlas.root_count,
    )
    identity = torch.eye(3, 4, dtype=torch.float32, device=dev)
    inv = torch.cat([identity[None], invert_affine(transforms.to(torch.float32))])
    return InstancedAS(trav=pack_bvh(combined), inv_transforms=inv,
                       blas_entry=((root + offset) << 3) | rc)
