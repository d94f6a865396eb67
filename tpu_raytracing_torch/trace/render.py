"""Hit context and shadow rays shared by the renderers.

Port of the parts of ``tpu_raytracing/trace/render.py`` that the
path-traced frame uses: ``SHADOW_TMIN``, ``_gather_hit_context`` and
``_shadow_rays``. The nine render modes (``render_frame``, ``shade_rays``)
wait.
"""

from __future__ import annotations

import torch

from tpu_raytracing_torch.scene.types import DeviceScene
from tpu_raytracing_torch.trace import shade
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.traverse import PackedPairs, i2f

# Shadow-ray epsilon (reference: src/Tracer.cu:453).
SHADOW_TMIN = 1e-3


def _gather_hit_context(scene: DeviceScene, pairs: PackedPairs, rec) -> dict:
    """Per-ray attributes, rotations, triangle vertices and material of the
    hit pair (src/Tracer.cu:505-509)."""
    second = (rec.tri_id & 1).to(torch.bool)
    pair_idx = (rec.tri_id >> 1).clamp(0, pairs.rows.shape[0] - 1).to(torch.int64)
    prow = pairs.rows[pair_idx]
    v = i2f(prow[:, :12]).reshape(-1, 4, 3)
    v0, v1, v2, v3 = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
    rot = torch.where(second, prow[:, 15], prow[:, 14])
    # Triangle A = (v0, v1, v2); B = (v2, v1, v3) (src/Tracer.cu:297-298).
    tri_v0 = torch.where(second[:, None], v2, v0)
    tri_v2 = torch.where(second[:, None], v3, v2)

    prim = rec.prim_id.clamp(0, scene.normals.shape[0] - 1).to(torch.int64)
    normals3, uvs3 = shade.rotate_attributes(scene.normals[prim], scene.uvs[prim], rot)
    material_id = scene.material_ids[prim]
    mats = scene.materials
    num_mats = mats.ambient.shape[0]  # includes the default slot
    mat_idx = torch.where(material_id < 0, num_mats - 1, material_id)
    mat_idx = mat_idx.clamp(0, num_mats - 1).to(torch.int64)
    return dict(
        second=second,
        normals3=normals3,
        uvs3=uvs3,
        tri_v0=tri_v0,
        tri_v1=v1,
        tri_v2=tri_v2,
        material_id=material_id,
        mat_ambient=mats.ambient[mat_idx],
        mat_diffuse=mats.diffuse[mat_idx],
        mat_specular=mats.specular[mat_idx],
        mat_specular_exp=mats.specular_exp[mat_idx],
        mat_texture=mats.texture[mat_idx],
        mat_bump=mats.bump[mat_idx],
        mat_disp=mats.disp[mat_idx],
    )


def _shadow_rays_from(light: torch.Tensor, hit_pos: torch.Tensor) -> Rays:
    """Shadow rays from ``hit_pos`` toward the light."""
    to_light = light - hit_pos
    dist = torch.linalg.vector_norm(to_light, dim=-1)
    return Rays(
        origin=hit_pos,
        direction=to_light / torch.clamp(dist, min=1e-30)[:, None],
        tmin=torch.full_like(dist, SHADOW_TMIN),
        tmax=dist,
    )


def _shadow_rays(scene: DeviceScene, rays: Rays, rec) -> Rays:
    """Shadow rays from hit points toward the light (src/Tracer.cu:446-456)."""
    return _shadow_rays_from(scene.light, rays.origin + rays.direction * rec.t[:, None])
