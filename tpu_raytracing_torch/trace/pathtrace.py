"""Wavefront diffuse path tracer with ray compaction.

Port of ``tpu_raytracing/trace/pathtrace.py`` (``_sky``,
``_cosine_sample``, ``_bounce_stage``, ``_jit_shadow_pair`` ->
``_shadow_pair``, ``_finalize``, ``path_trace``). PyTorch runs eagerly, so
the reference's jit caches have no counterpart.

Lighting model: Lambertian surfaces, cosine-weighted hemisphere bounces
keyed by *pixel id* (so compaction permutations don't change the image),
sky radiance on miss, and next-event estimation toward the scene point
light with a shadow trace per bounce. Compaction stable-sorts live rays to
the front, ordered by a locality key so the next traversal is coherent.

Differences from the reference, all deliberate:

* ``generator`` (a ``torch.Generator``) replaces ``key``; jax.random and
  torch draw different numbers, so ``_bounce_stage`` takes ``u_frame``
  explicitly and the tests inject it.
* The bounce sort is the ``sort_kind`` argument (``leaf``, ``cell``,
  ``tid``, ``tid_cell``), with the reference's default: ``tid`` when
  ``pair_loc`` is given, else ``leaf``. The reference reads
  ``TPURT_BOUNCE_SORT`` and falls back from ``tid`` to ``leaf`` without a
  ``pair_loc``; here that request raises. The other TPURT_* knobs are not
  ported (the hit-pair shadow sort is always on).
* ``_finalize`` scatters radiance to its pixel directly; the reference
  gathers by the inverse permutation because a random scatter is slow on
  the TPU.
* The traversal's stack-overflow flags are checked once per frame, on the
  host, and raise.
* On the card a bounce's shading (``bounce_shade``: the sky, the hit
  context, NEE, the next rays) is one CUDA kernel, ``csrc/bounce_shade.cu``,
  bit-equal to ``bounce_shade_plain``, which the CPU runs; the reference
  leaves these operations to XLA, which fuses them.
* A two-level frame (``trav`` an ``InstancedSplitAS`` with its
  ``normal_maps``, traced by ``trace/instanced_split.py``'s tracers) shades
  a hit with its object triangle's normal mapped by the hit instance's
  normal matrix; the reference path tracer has no instances.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from tpu_raytracing_torch.ops import _cuda_build
from tpu_raytracing_torch.ops.intersect import dot
from tpu_raytracing_torch.ops.morton import morton3d
from tpu_raytracing_torch.scene.types import DeviceScene
from tpu_raytracing_torch.trace import shade
from tpu_raytracing_torch.trace.ray import Rays, generate_primary_rays
from tpu_raytracing_torch.trace.render import (
    SHADOW_TMIN,
    _gather_hit_context,
    _shadow_rays,
    _shadow_rays_from,
)
from tpu_raytracing_torch.trace.split_trace import check_overflow
from tpu_raytracing_torch.trace.traverse import trace_rays
from tpu_raytracing_torch.utils import timing

SKY_HORIZON = (1.0, 1.0, 1.0)
SKY_ZENITH = (0.5, 0.7, 1.0)
SORT_KINDS = ("leaf", "cell", "tid", "tid_cell")

# Bounce-shade kernel launches since the count was last set to 0:
# bounce_shade adds one where it launches the kernel and nowhere else.
launch_count = 0


def _sky(direction):
    t = 0.5 * (direction[:, 1] + 1.0)
    horizon = torch.tensor(SKY_HORIZON, dtype=torch.float32, device=direction.device)
    zenith = torch.tensor(SKY_ZENITH, dtype=torch.float32, device=direction.device)
    return horizon[None, :] * (1.0 - t[:, None]) + zenith[None, :] * t[:, None]


def _cosine_sample(normal, u):
    """Cosine-weighted hemisphere directions; ``u`` is [R, 2] uniforms
    indexed by pixel, so results are invariant under compaction."""
    r = torch.sqrt(u[:, 0])
    phi = 2.0 * math.pi * u[:, 1]
    local = torch.stack(
        [r * torch.cos(phi), r * torch.sin(phi), torch.sqrt(torch.clamp(1.0 - u[:, 0], min=0.0))],
        dim=-1,
    )
    n = normal
    sign = torch.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + sign * n[:, 0] ** 2 * a, sign * b, -sign * n[:, 0]], dim=-1)
    bt = torch.stack([b, sign + n[:, 1] ** 2 * a, -n[:, 1]], dim=-1)
    return t * local[:, 0:1] + bt * local[:, 1:2] + n * local[:, 2:3]


def _octant(d):
    return ((d[:, 0] > 0).to(torch.int64)
            | ((d[:, 1] > 0).to(torch.int64) << 1)
            | ((d[:, 2] > 0).to(torch.int64) << 2))


def _unit_cube(o):
    """Points scaled into the unit cube of their own bounds."""
    lo = o.amin(dim=0)
    hi = o.amax(dim=0)
    return (o - lo) / torch.clamp(hi - lo, min=1e-20)


def _check_sort_kind(sort_kind: str, pair_loc) -> None:
    if sort_kind not in SORT_KINDS:
        raise ValueError(f"unknown bounce sort kind {sort_kind!r}; choose from {SORT_KINDS}")
    if sort_kind in ("tid", "tid_cell") and pair_loc is None:
        raise ValueError(f"bounce sort kind {sort_kind!r} needs pair_loc "
                         "(bvh/treelet.py:build_pair_tid)")


def _instances(rec, normal_maps):
    """The hit instances a bounce shades with: ``rec.inst`` of an instanced
    record (``InstancedHitRecord``), which needs ``normal_maps``; None for
    a one-level record, whatever ``normal_maps`` is."""
    inst = getattr(rec, "inst", None)
    if inst is not None and normal_maps is None:
        raise ValueError("bounce_shade: an instanced hit record needs the instances' "
                         "normal_maps")
    return inst


def bounce_shade_plain(scene: DeviceScene, pairs, rays: Rays, rec, srec_hit, throughput,
                       radiance, alive, pixel, u_frame, max_t, sample_next: bool = True,
                       normal_maps=None):
    """The bounce-shade kernel's plain version: one bounce's sky, hit
    context, normal, next-event estimation and, with ``sample_next``, the
    next rays, for every ray (dead ones too). An instanced record's normal
    is mapped by its instance's row of ``normal_maps`` ([I, 3, 3]) before
    it is normalised.

    Returns (radiance, throughput, alive, rays): with ``sample_next`` the
    throughput times the albedo and the next rays (from the hit point off
    the surface, cosine-sampled about the normal from ``u_frame[pixel]``,
    tmin ``SHADOW_TMIN``, tmax ``max_t``); without, the throughput and rays
    given.
    """
    miss = alive & ~rec.hit
    radiance = radiance + torch.where(miss[:, None], throughput * _sky(rays.direction), 0.0)
    alive = alive & rec.hit

    ctx = _gather_hit_context(scene, pairs, rec)
    albedo = ctx["mat_diffuse"]
    normal = shade.interpolate(ctx["normals3"], rec.bary_u, rec.bary_v)
    inst = _instances(rec, normal_maps)
    if inst is not None:
        m = normal_maps[inst.clamp(min=0).to(torch.int64)]
        mapped = (m[:, :, 0] * normal[:, 0:1] + m[:, :, 1] * normal[:, 1:2]
                  + m[:, :, 2] * normal[:, 2:3])
        normal = torch.where((inst >= 0)[:, None], mapped, normal)
    normal = normal / torch.clamp(
        torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-20)
    normal = torch.where((dot(normal, rays.direction) > 0.0)[:, None], -normal, normal)
    hit_pos = rays.origin + rays.direction * rec.t[:, None]

    # Next-event estimation using the caller-provided shadow trace.
    srays_dir = _shadow_rays(scene, rays, rec).direction
    ndotl = torch.clamp(dot(normal, srays_dir), min=0.0)
    radiance = radiance + torch.where(
        (alive & ~srec_hit)[:, None],
        throughput * albedo * ndotl[:, None] * shade.light_colour(normal.device)[None, :],
        0.0,
    )
    if not sample_next:
        return radiance, throughput, alive, rays

    num = pixel.shape[0]
    new_rays = Rays(
        origin=hit_pos + normal * 1e-4,
        direction=_cosine_sample(normal, u_frame[pixel]),
        tmin=torch.full((num,), SHADOW_TMIN, dtype=torch.float32, device=normal.device),
        tmax=torch.as_tensor(max_t, dtype=torch.float32, device=normal.device).expand(num),
    )
    return radiance, throughput * albedo, alive, new_rays


def _check_shade_operands(scene: DeviceScene, pairs, rays: Rays, rec, srec_hit, throughput,
                          radiance, alive, pixel, u_frame, max_t, inst=None,
                          normal_maps=None) -> torch.Tensor:
    """Raises unless the operands are what the kernel takes; returns
    ``max_t`` as a [1] float32 tensor on the rays' device."""
    dev = rays.origin.device
    num = rays.origin.shape[0]
    max_t = torch.as_tensor(max_t, dtype=torch.float32, device=dev).reshape(-1)
    specs = [("rays.origin", rays.origin, torch.float32, (num, 3)),
             ("rays.direction", rays.direction, torch.float32, (num, 3)),
             ("rec.hit", rec.hit, torch.bool, (num,)),
             ("rec.t", rec.t, torch.float32, (num,)),
             ("rec.prim_id", rec.prim_id, torch.int32, (num,)),
             ("rec.tri_id", rec.tri_id, torch.int32, (num,)),
             ("rec.bary_u", rec.bary_u, torch.float32, (num,)),
             ("rec.bary_v", rec.bary_v, torch.float32, (num,)),
             ("srec_hit", srec_hit, torch.bool, (num,)),
             ("throughput", throughput, torch.float32, (num, 3)),
             ("radiance", radiance, torch.float32, (num, 3)),
             ("alive", alive, torch.bool, (num,)),
             ("pixel", pixel, torch.int64, (num,)),
             ("u_frame", u_frame, torch.float32, (max(u_frame.shape[0], 1), 2)),
             ("max_t", max_t, torch.float32, (1,)),
             ("pairs.rows", pairs.rows, torch.int32, (max(pairs.rows.shape[0], 1), 16)),
             ("scene.normals", scene.normals, torch.float32,
              (max(scene.normals.shape[0], 1), 3, 3)),
             ("scene.material_ids", scene.material_ids, torch.int32,
              (max(scene.normals.shape[0], 1),)),
             ("scene.materials.diffuse", scene.materials.diffuse, torch.float32,
              (max(scene.materials.diffuse.shape[0], 1), 3)),
             ("scene.light", scene.light, torch.float32, (3,))]
    if inst is not None:
        specs += [("rec.inst", inst, torch.int32, (num,)),
                  ("normal_maps", normal_maps, torch.float32,
                   (max(normal_maps.shape[0], 1), 3, 3))]
    for name, x, dtype, shape in specs:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"bounce_shade: {name} must be a contiguous {dtype} tensor of shape {shape} "
                f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
                f"{'' if x.is_contiguous() else ', not contiguous'}")
    return max_t


_SHADE_ARGTYPES = ([ctypes.c_void_p] * 29 + [ctypes.POINTER(ctypes.c_float)]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
# the kernel's shading constants, in bounce_shade_launch's order
_SHADE_CONSTS = (ctypes.c_float * 10)(*SKY_HORIZON, *SKY_ZENITH, *shade.LIGHT_COLOUR_RGB,
                                      SHADOW_TMIN)


def bounce_shade(scene: DeviceScene, pairs, rays: Rays, rec, srec_hit, throughput, radiance,
                 alive, pixel, u_frame, max_t, sample_next: bool = True, normal_maps=None):
    """One bounce's shading (``bounce_shade_plain``'s arguments and
    results; a one-level record hands the kernel no instance data). CPU
    tensors run ``bounce_shade_plain``; CUDA tensors launch the
    bounce-shade kernel (``csrc/bounce_shade.cu``), one launch a call,
    or raise. ``pixel`` indexes the rows of ``u_frame``; a pixel out of
    range stops the kernel, as it fails PyTorch's index check."""
    global launch_count
    dev = rays.origin.device
    if dev.type == "cpu":
        return bounce_shade_plain(scene, pairs, rays, rec, srec_hit, throughput, radiance,
                                  alive, pixel, u_frame, max_t, sample_next=sample_next,
                                  normal_maps=normal_maps)
    if dev.type != "cuda":
        raise ValueError(f"bounce_shade: unsupported device {dev}")
    inst = _instances(rec, normal_maps)
    maps = None if inst is None else normal_maps
    max_t = _check_shade_operands(scene, pairs, rays, rec, srec_hit, throughput, radiance,
                                  alive, pixel, u_frame, max_t, inst, maps)
    fn = _cuda_build.load_library("bounce_shade").bounce_shade_launch
    fn.argtypes = _SHADE_ARGTYPES
    fn.restype = ctypes.c_int
    num = pixel.shape[0]
    rad_out = torch.empty_like(radiance)
    alive_out = torch.empty_like(alive)
    if sample_next:
        thr_out = torch.empty_like(throughput)
        new_rays = Rays(origin=torch.empty_like(rays.origin),
                        direction=torch.empty_like(rays.direction),
                        tmin=torch.empty((num,), dtype=torch.float32, device=dev),
                        tmax=torch.empty((num,), dtype=torch.float32, device=dev))
        outs = (thr_out.data_ptr(), new_rays.origin.data_ptr(), new_rays.direction.data_ptr(),
                new_rays.tmin.data_ptr(), new_rays.tmax.data_ptr())
    else:
        thr_out, new_rays, outs = throughput, rays, (None,) * 5
    if num == 0:
        return rad_out, thr_out, alive_out, new_rays
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(rays.origin.data_ptr(), rays.direction.data_ptr(), rec.hit.data_ptr(),
             rec.t.data_ptr(), rec.prim_id.data_ptr(), rec.tri_id.data_ptr(),
             rec.bary_u.data_ptr(), rec.bary_v.data_ptr(), srec_hit.data_ptr(),
             throughput.data_ptr(), radiance.data_ptr(), alive.data_ptr(), pixel.data_ptr(),
             u_frame.data_ptr(), max_t.data_ptr(), pairs.rows.data_ptr(),
             scene.normals.data_ptr(), scene.material_ids.data_ptr(),
             scene.materials.diffuse.data_ptr(), scene.light.data_ptr(),
             None if inst is None else inst.data_ptr(),
             None if maps is None else maps.data_ptr(),
             rad_out.data_ptr(), alive_out.data_ptr(), *outs, _SHADE_CONSTS,
             num, u_frame.shape[0], pairs.rows.shape[0], scene.normals.shape[0],
             scene.materials.diffuse.shape[0], 0 if maps is None else maps.shape[0],
             int(sample_next), stream)
    if err != 0:
        raise RuntimeError(f"bounce_shade kernel launch failed: cudaError {err}")
    launch_count += 1
    return rad_out, thr_out, alive_out, new_rays


# Morton bits below the origin cell of the ``"cell"`` bounce key, and
# pair-index bits below the ``"leaf"`` key's window (the reference's
# defaults, the only values its callers pass)
_CELL_SHIFT = 15
_LEAF_SHIFT = 6


def _bounce_stage(scene: DeviceScene, pairs, rays: Rays, rec, srec_hit, throughput,
                  radiance, alive, pixel, u_frame, max_t, pair_loc=None,
                  sample_next: bool = True, sort_kind: str = "cell", normal_maps=None):
    """Shading + NEE + next-ray sampling (``bounce_shade``) + compaction
    for one bounce: a stable sort of the next rays by ``sort_kind``'s key,
    dead rays last.

    Returns (radiance, throughput, alive, pixel, rays). With
    ``sample_next=False`` (the final bounce) sampling and compaction are
    skipped. The spans ``path_trace.shade`` and ``path_trace.compact``
    cover the two parts. ``normal_maps``: as ``bounce_shade``'s.
    """
    _check_sort_kind(sort_kind, pair_loc)
    with timing.span("path_trace.shade"):
        radiance, throughput, alive, new_rays = bounce_shade(
            scene, pairs, rays, rec, srec_hit, throughput, radiance, alive, pixel, u_frame,
            max_t, sample_next=sample_next, normal_maps=normal_maps)
    if not sample_next:
        return radiance, throughput, alive, pixel, rays
    with timing.span("path_trace.compact"):
        dead = (~alive).to(torch.int64)
        octant = _octant(new_rays.direction)
        pair = torch.clamp(rec.tri_id.to(torch.int64) >> 1, min=0)
        if sort_kind == "tid_cell":
            # treelet major, then octant, then the coarse origin cell
            tid = pair_loc[pair].to(torch.int64)
            cellm = morton3d(_unit_cube(new_rays.origin))
            key = ((dead << 30) | ((tid & 0xFFF) << 18) | (octant << 15)
                   | ((cellm >> 15) & 0x7FFF))
        else:
            if sort_kind == "tid":
                # the origin hit pair's treelet: subtree-aligned groups
                loc = pair_loc[pair].to(torch.int64)
            elif sort_kind == "leaf":
                # hit pair's sorted index: a space-filling-curve position
                # at leaf granularity, aligned to the tree's windows
                loc = pair >> _LEAF_SHIFT
            else:
                loc = morton3d(_unit_cube(new_rays.origin)) >> _CELL_SHIFT
            key = (dead << 30) | (loc << 3) | octant
        perm = torch.sort(key, stable=True).indices
        new_rays = new_rays.take(perm)
        throughput = throughput[perm]
        radiance = radiance[perm]
        alive = alive[perm]
        pixel = pixel[perm]
    return radiance, throughput, alive, pixel, new_rays


def _shadow_pair(scene: DeviceScene, rays: Rays, rec, alive):
    """Bounce-shadow rays permuted by their origin hit's pair index; rays
    whose closest trace missed are dead and sunk to the back. Returns
    (sorted rays, sorted active, inverse permutation)."""
    act = alive & rec.hit
    key = ((~act).to(torch.int64) << 30) | (torch.clamp(rec.tri_id, min=0).to(torch.int64) >> 1)
    perm = torch.sort(key, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    hit_pos = rays.origin + rays.direction * rec.t[:, None]
    return _shadow_rays_from(scene.light, hit_pos[perm]), act[perm], inv


def _finalize(radiance, pixel):
    """Radiance back in pixel order: a direct scatter (``pixel`` is a
    permutation of [0, num))."""
    img = torch.empty_like(radiance)
    img[pixel] = radiance
    return img


@timing.spanned("path_trace")
def path_trace(
    trav,
    pairs,
    scene: DeviceScene,
    camera: dict,
    width: int,
    height: int,
    num_bounces: int = 4,
    generator: Optional[torch.Generator] = None,
    tracer=None,
    shadow_tracer=None,
    shadow_tracer_bounce=None,
    bounce_tracer=None,
    pair_loc=None,
    sort_kind: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ([H, W, 3] float32 radiance, total rays traced as a 0-d
    int64 tensor).

    Tracers have the signature ``(trav, pairs, rays, active=None) ->
    (HitRecord, TraceStats)``; ``tracer`` defaults to the scalar
    ``trace_rays`` (``trav`` a ``TraversalBVH``), and ``shadow_tracer``
    (any-hit, primary NEE), ``bounce_tracer`` and ``shadow_tracer_bounce``
    default to ``tracer``.
    ``pair_loc`` is an optional [P] treelet id per sorted pair
    (``bvh/treelet.py:build_pair_tid``); ``sort_kind`` picks the bounce
    compaction key: ``"tid"`` (the default with ``pair_loc``), ``"leaf"``
    (the default without), ``"tid_cell"`` or ``"cell"``.

    The call is the span ``path_trace``; each tracer call is a child span
    (``.primary``, ``.primary_shadow``, ``.bounce``, ``.bounce_shadow``),
    and so are the bounce shadows' sort and restore (``.shadow_sort``) and
    ``_bounce_stage``'s parts (``.shade``, ``.compact``).

    Where ``trav`` carries ``normal_maps`` (an ``InstancedSplitAS``), an
    instanced tracer's hits are shaded with them.
    """
    if tracer is None:
        tracer = trace_rays
    if sort_kind is None:
        sort_kind = "tid" if pair_loc is not None else "leaf"
    _check_sort_kind(sort_kind, pair_loc)
    dev = camera["position"].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    shadow_t = tracer if shadow_tracer is None else shadow_tracer
    shadow_tb = shadow_t if shadow_tracer_bounce is None else shadow_tracer_bounce
    traced_b = tracer if bounce_tracer is None else bounce_tracer

    rays = generate_primary_rays(camera, width, height)
    num = width * height
    pixel = torch.arange(num, dtype=torch.int64, device=dev)
    throughput = torch.ones((num, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((num, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((num,), dtype=torch.bool, device=dev)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((1,), dtype=torch.int32, device=dev)
    max_t = camera["max_depth"]
    normal_maps = getattr(trav, "normal_maps", None)

    for bounce in range(num_bounces + 1):
        ct = tracer if bounce == 0 else traced_b
        with timing.span("path_trace.primary" if bounce == 0 else "path_trace.bounce"):
            rec, stats = ct(trav, pairs, rays, active=alive)
        if bounce >= 1:
            with timing.span("path_trace.shadow_sort"):
                srt, act_s, inv_s = _shadow_pair(scene, rays, rec, alive)
            with timing.span("path_trace.bounce_shadow"):
                srec, sstats = shadow_tb(trav, pairs, srt, active=act_s)
            with timing.span("path_trace.shadow_sort"):
                srec_hit = srec.hit[inv_s]
            n_shadow = act_s.sum()
        else:
            with timing.span("path_trace.primary_shadow"):
                srec, sstats = shadow_t(trav, pairs, _shadow_rays(scene, rays, rec),
                                        active=alive)
            srec_hit = srec.hit
            n_shadow = alive.sum()
        overflow = overflow + stats.overflow + sstats.overflow
        # rays whose closest trace missed cast no shadow ray and are not counted
        rays_traced = rays_traced + alive.sum() + n_shadow

        u_frame = torch.rand((num, 2), generator=generator, device=dev)
        radiance, throughput, alive, pixel, rays = _bounce_stage(
            scene, pairs, rays, rec, srec_hit, throughput, radiance, alive, pixel,
            u_frame, max_t, pair_loc=pair_loc, sample_next=bounce < num_bounces,
            sort_kind=sort_kind, normal_maps=normal_maps)

    check_overflow(overflow)
    img = _finalize(radiance, pixel)
    return img.reshape(height, width, 3), rays_traced
