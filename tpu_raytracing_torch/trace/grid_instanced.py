"""Two-level instancing over the uniform grid: a dense candidate sweep, then
one grid pass over all (ray, instance) items.

Port of ``tpu_raytracing/trace/grid_instanced.py`` (``InstancedGridAS``,
``build_instanced_grid``, ``trace_rays_instanced_grid``,
``check_instanced_grid_capacity``). PyTorch ops; the reference has no
Pallas kernel here.

1. Every ray slab-tests every instance's world box, 128 instances at a
   time ([I, R] overlaps, instance-major).
2. The overlaps become a work list of (ray, instance) items, instance-major,
   at most ``work_factor * R`` of them (at least 1,024, at most I * R); the
   count past that cap is returned (``check_instanced_grid_capacity``
   raises on it) and also sets ``TraceStats.overflow``. Each item's ray goes
   through its instance's inverse transform (``instanced.transform_rays``,
   rounded as XLA's CPU code rounds the reference's einsum; the direction
   stays unnormalised, so t is a distance along the world ray), and one
   ``trace_rays_grid`` pass traces all items through the shared
   object-space grid.
3. Per ray, the smallest t wins, and on a tie of t the earliest item (the
   lowest instance).

The items past the cap are dropped, as in the reference; the reference pads
the list to the cap with dead items, here it holds only the kept ones.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_raytracing_torch.bvh.grid import UniformGrid, build_grid
from tpu_raytracing_torch.bvh.tlas import instance_world_aabbs, invert_affine
from tpu_raytracing_torch.trace.brute import HitRecord
from tpu_raytracing_torch.trace.grid_trace import trace_rays_grid
from tpu_raytracing_torch.trace.instanced import transform_rays
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.traverse import PackedPairs, TraceStats, i2f

_F32_MAX = float(torch.finfo(torch.float32).max)
# instances per slab of the candidate sweep
_CHUNK = 128


@dataclasses.dataclass
class InstancedGridAS:
    """One object-space grid shared by every instance."""

    blas_grid: UniformGrid  # the grid over the mesh's pair rows
    inst_min: torch.Tensor  # [I, 3] instance world boxes
    inst_max: torch.Tensor  # [I, 3]
    inv_transforms: torch.Tensor  # [I, 3, 4] object <- world


def build_instanced_grid(pairs: PackedPairs, transforms: torch.Tensor,
                         res=None) -> InstancedGridAS:
    """The grid over the mesh's pair rows (``build_grid``, ``res`` as
    there) and each instance's world box and inverse transform;
    ``transforms`` is [I, 3, 4] world <- object."""
    rows = pairs.rows
    v = i2f(rows[:, :12]).reshape(rows.shape[0], 4, 3)
    bmin = v.amin(dim=(0, 1))
    bmax = v.amax(dim=(0, 1))
    grid = build_grid(rows, rows.shape[0], res=res)
    wmin, wmax = instance_world_aabbs(bmin, bmax, transforms)
    return InstancedGridAS(blas_grid=grid, inst_min=wmin, inst_max=wmax,
                           inv_transforms=invert_affine(transforms))


def candidate_mask(ias: InstancedGridAS, rays: Rays) -> torch.Tensor:
    """[I, R] bool: ray r overlaps instance i's world box within its
    [tmin, tmax]. Direction components below 1e-20 in magnitude become
    +1e-20 (the reference's ``safe``)."""
    o, d = rays.origin, rays.direction
    inv = 1.0 / torch.where(d.abs() < 1e-20, 1e-20, d)
    ox, oy, oz = o[:, 0][None], o[:, 1][None], o[:, 2][None]
    ivx, ivy, ivz = inv[:, 0][None], inv[:, 1][None], inv[:, 2][None]
    masks = []
    for c0 in range(0, ias.inst_min.shape[0], _CHUNK):
        lo = ias.inst_min[c0:c0 + _CHUNK]
        hi = ias.inst_max[c0:c0 + _CHUNK]
        t0x, t1x = (lo[:, 0:1] - ox) * ivx, (hi[:, 0:1] - ox) * ivx
        t0y, t1y = (lo[:, 1:2] - oy) * ivy, (hi[:, 1:2] - oy) * ivy
        t0z, t1z = (lo[:, 2:3] - oz) * ivz, (hi[:, 2:3] - oz) * ivz
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                           torch.maximum(torch.minimum(t0z, t1z), rays.tmin[None]))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                           torch.minimum(torch.maximum(t0z, t1z), rays.tmax[None]))
        masks.append(tn <= tf)
    return torch.cat(masks)


def trace_rays_instanced_grid(ias: InstancedGridAS, pairs: PackedPairs, rays: Rays,
                              work_factor: int = 4, any_hit: bool = False, block: int = 4):
    """Closest-hit (or any-hit) trace over the instanced grid (see the
    module docstring). Returns (HitRecord, hit instance [R] int32 (-1:
    none), TraceStats, overflow [] int64: items past the work list's cap).
    The reference's candidate count, which it does not read, has no
    counterpart."""
    num = rays.origin.shape[0]
    n_inst = ias.inst_min.shape[0]
    dev = rays.origin.device
    live = candidate_mask(ias, rays).reshape(-1)
    work_cap = min(max(work_factor * num, 1024), n_inst * num)
    widx = torch.nonzero(live).reshape(-1)
    overflow = (widx.numel() - work_cap) if widx.numel() > work_cap else 0
    widx = widx[:work_cap]
    ray_id = widx % num
    inst = widx // num
    worig, wdir = transform_rays(ias.inv_transforms[inst], rays.origin[ray_id],
                                 rays.direction[ray_id], fused=True)
    wrays = Rays(worig, wdir, rays.tmin[ray_id], rays.tmax[ray_id])
    rec_w, st_w = trace_rays_grid(ias.blas_grid, pairs, wrays, any_hit=any_hit, block=block)

    # per ray: the smallest t, then the earliest item among its winners
    wt = torch.where(rec_w.hit, rec_w.t, _F32_MAX)
    min_t = torch.full((num,), _F32_MAX, dtype=torch.float32, device=dev).scatter_reduce(
        0, ray_id, wt, "amin")
    is_win = rec_w.hit & (wt <= min_t[ray_id])
    item = torch.arange(widx.numel(), device=dev)
    win_idx = torch.full((num,), work_cap, dtype=torch.int64, device=dev).scatter_reduce(
        0, ray_id[is_win], item[is_win], "amin")
    got = win_idx < work_cap
    n_items = widx.numel()
    wsel = win_idx.clamp(max=n_items)  # n_items: a default past the items

    def pick(a, dflt):
        return torch.where(got, torch.cat([a, a.new_full((1,), dflt)])[wsel], dflt)

    rec = HitRecord(hit=got, t=torch.where(got, pick(rec_w.t, 0.0), rays.tmax),
                    prim_id=pick(rec_w.prim_id, 0), tri_id=pick(rec_w.tri_id, 0),
                    bary_u=pick(rec_w.bary_u, 0.0), bary_v=pick(rec_w.bary_v, 0.0))
    inst_id = pick(inst.to(torch.int32), -1)
    zero = torch.zeros((num,), dtype=torch.int32, device=dev)
    stats = TraceStats(
        box_tests=zero + n_inst + zero.index_add(0, ray_id, st_w.box_tests),
        tri_tests=zero.index_add(0, ray_id, st_w.tri_tests),
        overflow=st_w.overflow + int(overflow > 0))
    return rec, inst_id, stats, torch.tensor(overflow, dtype=torch.int64)


def check_instanced_grid_capacity(overflow) -> None:
    """Host check: raises if the work list dropped items."""
    ov = int(overflow)
    if ov > 0:
        raise RuntimeError(f"instanced-grid overflow: {ov} (ray, instance) items past "
                           f"work_factor * rays; raise work_factor (trace/grid_instanced.py)")
