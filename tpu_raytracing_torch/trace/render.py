"""Frame rendering: ray gen -> trace -> shade, all nine render modes
(reference: TraceRays, src/Tracer.cu:471-596).

Port of ``tpu_raytracing/trace/render.py`` (``SHADOW_TMIN``,
``_gather_hit_context``, ``_shadow_rays``, ``_ambient``, ``render_frame``,
``shade_rays``, ``render_frame_host``). The reference megakernel becomes a
wavefront: primary trace, optional shadow trace (a second traversal pass
over the whole batch instead of a nested per-thread call), then shading
and uint8 framebuffer packing, run eagerly.

``tracer`` is any of the port's tracers, ``(trav, pairs, rays, active=None)
-> (HitRecord, TraceStats)``: ``trace_rays`` (the default, ``trav`` a
``TraversalBVH``), ``split_trace.make_split_tracer``,
``lane_trace.make_lane_tracer`` or ``wide_fat.make_tiled_fat_tracer``.
Unlike the reference, ``shade_rays`` reads the tracers' overflow flags once
a frame (``split_trace.check_overflow``, as ``path_trace`` does) and raises
if a ray's stack overflowed, in the shadow pass too.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpu_raytracing_torch.scene.types import DeviceScene
from tpu_raytracing_torch.trace import shade
from tpu_raytracing_torch.trace.modes import RenderType
from tpu_raytracing_torch.trace.ray import Rays, generate_primary_rays, ray_spread
from tpu_raytracing_torch.trace.split_trace import check_overflow
from tpu_raytracing_torch.trace.traverse import PackedPairs, i2f, trace_rays
from tpu_raytracing_torch.utils import timing

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


def _ambient(scene, ctx, rays, rec, spread, use_textures, use_shadows, use_bump,
             shadow_hit=None):
    return shade.ambient_shader(
        scene, rays.origin, rays.direction, rec.t, rec.bary_u, rec.bary_v,
        ctx["normals3"], ctx["uvs3"], ctx["tri_v0"], ctx["tri_v1"], ctx["tri_v2"],
        ctx["mat_ambient"], ctx["mat_diffuse"], ctx["mat_specular"], ctx["mat_specular_exp"],
        ctx["mat_texture"], ctx["mat_bump"], ctx["mat_disp"], spread,
        use_textures, use_shadows, use_bump, shadow_hit,
    )


@timing.spanned("render_frame")
def render_frame(
    trav,
    pairs: PackedPairs,
    scene: DeviceScene,
    camera: dict,
    width: int,
    height: int,
    render_type: RenderType = RenderType.DEPTH,
    tracer=trace_rays,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render one frame; returns ([H, W, 4] uint8, total box tests as a
    0-d int64 tensor).

    Per-mode colour formulas replicate src/Tracer.cu:511-593, including the
    truncating float->uchar casts.
    """
    rays = generate_primary_rays(camera, width, height)
    flat, tests = shade_rays(
        trav, pairs, scene, camera, rays, ray_spread(width), render_type, tracer
    )
    return flat.reshape(height, width, 4), tests


def _u8_mod(x: torch.Tensor) -> torch.Tensor:
    """int32 -> uint8 wrapping mod 256, as XLA's integer narrowing."""
    return (x & 0xFF).to(torch.uint8)


def shade_rays(
    trav,
    pairs: PackedPairs,
    scene: DeviceScene,
    camera: dict,
    rays: Rays,
    spread: float,
    render_type: RenderType = RenderType.DEPTH,
    tracer=trace_rays,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trace + shade an arbitrary ray batch; returns ([R, 4] uint8, total
    box tests). Raises if a traversal's stack overflowed. The trace is the
    span ``render_frame.trace``, the rest ``render_frame.shade``, inside
    which the shadow trace is ``render_frame.shadow_trace``."""
    with timing.span("render_frame.trace"):
        rec, stats = tracer(trav, pairs, rays)
    with timing.span("render_frame.shade"):
        overflow = stats.overflow
        hit = rec.hit
        depth = torch.where(hit, rec.t, 0.0)
        max_depth = camera["max_depth"]

        ctx = _gather_hit_context(scene, pairs, rec)
        u8 = shade._trunc_u8
        num = rays.origin.shape[0]
        dev = rays.origin.device
        alpha = torch.full((num, 1), 255, dtype=torch.uint8, device=dev)
        black = torch.zeros((num, 3), dtype=torch.uint8, device=dev)

        if render_type == RenderType.DEPTH:
            grey = u8(torch.clamp(depth / max_depth, max=1.0) * 255.0)
            rgb = torch.stack([grey, grey, grey], dim=-1)
        elif render_type == RenderType.BOX_TESTS:
            heat = u8(torch.clamp(stats.box_tests / 180.0, max=1.0) * 255.0)
            rgb = torch.stack([torch.zeros_like(heat), heat, heat], dim=-1)
        elif render_type == RenderType.TRIANGLE_TESTS:
            frac = torch.clamp(stats.tri_tests / 32.0, max=1.0)
            rgb = torch.stack([u8(frac * 100.0), u8(frac * 255.0), u8(frac * 100.0)], dim=-1)
        elif render_type == RenderType.MATERIAL_ID:
            h = ctx["material_id"].to(torch.float32) / float(scene.num_materials)
            one = torch.ones_like(h)
            rgb = u8(shade.hsv_to_rgb(h, one, one))
            rgb = torch.where(hit[:, None], rgb, black)
        elif render_type == RenderType.DIFFUSE:
            col = _ambient(scene, ctx, rays, rec, spread, False, False, False)
            rgb = torch.where(hit[:, None], u8(col), black)
        elif render_type == RenderType.LODS:
            lod = shade.compute_lod(
                scene.textures, ctx["mat_texture"], ctx["tri_v0"], ctx["tri_v1"],
                ctx["tri_v2"], ctx["uvs3"], rec.bary_u, rec.bary_v,
                rays.origin, rays.direction, rec.t, spread,
            )
            # make_uchar4(int(lod) * 20) wraps mod 256 and fills all channels.
            grey = _u8_mod(shade._to_i32(lod) * 20)
            valid = hit & (ctx["mat_texture"] != -1)
            magenta = torch.tensor([[255, 0, 255]], dtype=torch.uint8, device=dev).expand(num, 3)
            rgb = torch.where(valid[:, None], torch.stack([grey] * 3, -1), magenta)
            a = torch.where(valid[:, None], grey[:, None], alpha)
            check_overflow(overflow)
            return torch.cat([rgb, a], dim=1), stats.box_tests.sum()
        elif render_type == RenderType.TEXTURE:
            lod = shade.compute_lod(
                scene.textures, ctx["mat_texture"], ctx["tri_v0"], ctx["tri_v1"],
                ctx["tri_v2"], ctx["uvs3"], rec.bary_u, rec.bary_v,
                rays.origin, rays.direction, rec.t, spread,
            )
            uvs = shade.interpolate(ctx["uvs3"], rec.bary_u, rec.bary_v)
            smp = shade.trilinear_sample(scene.textures, ctx["mat_texture"], uvs, lod)
            flat = u8(ctx["mat_diffuse"] * 255.0)
            rgb = torch.where((ctx["mat_texture"] != -1)[:, None], u8(smp[:, 0:3]), flat)
            rgb = torch.where(hit[:, None], rgb, black)
        elif render_type == RenderType.TEXTURE_LIT:
            col = _ambient(scene, ctx, rays, rec, spread, True, False, True)
            rgb = torch.where(hit[:, None], u8(col), black)
        elif render_type == RenderType.TEXTURE_LIT_SHADOWS:
            with timing.span("render_frame.shadow_trace"):
                srec, sstats = tracer(trav, pairs, _shadow_rays(scene, rays, rec))
            overflow = overflow + sstats.overflow
            col = _ambient(
                scene, ctx, rays, rec, spread, True, True, True, shadow_hit=srec.hit
            )
            rgb = torch.where(hit[:, None], u8(col), black)
        else:
            raise ValueError(f"unknown render type {render_type}")

        check_overflow(overflow)
        return torch.cat([rgb, alpha], dim=1), stats.box_tests.sum()


def render_frame_host(trav, pairs, scene, camera, width, height, render_type,
                      tracer=trace_rays):
    """Convenience wrapper returning a numpy image and the box-test total."""
    img, tests = render_frame(trav, pairs, scene, camera, width, height, render_type, tracer)
    return np.asarray(img.cpu()), int(tests)
