"""Faults planted in the program's timed path, by name, to show that the
comparison (``judge.py``) reads them as not correct: the CPU tests
(``tests/test_rtbench_control.py``) plant each at a small size, and
``control.py --fault`` at a cell's own size on the card.

``install(name, set_attr)`` replaces one function of the program with a
broken one through ``set_attr(module, attribute, value)``: pytest's
``monkeypatch.setattr`` in a test, ``setattr`` in a process that ends
with the readings.
"""

from __future__ import annotations

import dataclasses

import torch

# the light the "light_moved" fault shades with: moved sideways by a tenth
# of its height above the terrain
LIGHT_SHIFT = (20.0, 0.0, 0.0)


def _half(rays, active):
    keep = torch.arange(rays.origin.shape[0], device=rays.origin.device) < \
        rays.origin.shape[0] // 2
    return keep if active is None else active & keep


def _split_trace(fault, set_attr):
    """K1's tracer: half of each batch left out, or every hit's distance
    altered where it is produced."""
    from tpu_raytracing_torch.trace import split_trace

    real = split_trace.trace_rays_split

    def broken(views, packed, rays, active=None, **kw):
        if fault == "half":
            active = _half(rays, active)
        rec, stats = real(views, packed, rays, active=active, **kw)
        if fault == "altered":
            rec = dataclasses.replace(rec, t=rec.t * 1.001)
        return rec, stats

    set_attr(split_trace, "trace_rays_split", broken)


def _wide_fat(fault, set_attr):
    """K6's tracer: half of each batch left out, or every hit's distance
    altered."""
    from tpu_raytracing_torch.trace import wide_fat

    real = wide_fat._trace_rows

    def broken(rows, rays, active=None):
        if fault == "half":
            active = _half(rays, active)
        rec, stats = real(rows, rays, active)
        if fault == "altered":
            rec = dataclasses.replace(rec, t=rec.t * 1.001)
        return rec, stats

    set_attr(wide_fat, "_trace_rows", broken)


def _image_altered(set_attr):
    """The path tracer's radiance altered where the image is produced."""
    from tpu_raytracing_torch.trace import pathtrace

    real = pathtrace._finalize
    set_attr(pathtrace, "_finalize", lambda rad, pix: real(rad, pix) * 0.9)


def _build_unchanged(set_attr):
    """The animated step hands back the geometry it started from: the tree
    of the rest pose, whatever the frame's time."""
    from tpu_raytracing_torch.app import main as app

    real = app.animated_trees
    set_attr(app, "animated_trees",
             lambda args, tris0, t, views, sched, rest: real(args, tris0, 0.0, views, sched,
                                                             rest))


def _colour_altered(set_attr):
    """Every render mode's colour altered where it is produced."""
    from tpu_raytracing_torch.trace import render

    real = render.shade_rays

    def brighter(*a, **kw):
        flat, tests = real(*a, **kw)
        return (flat.to(torch.int32) + 8).clamp(0, 255).to(torch.uint8), tests

    set_attr(render, "shade_rays", brighter)


def _shading(fault, set_attr):
    """The lit modes' shader: the shadow trace's verdicts dropped, or the
    light moved by ``LIGHT_SHIFT`` (the shadow rays still aim at the
    scene's light)."""
    from tpu_raytracing_torch.trace import render

    real = render._ambient

    def broken(scene, ctx, rays, rec, spread, use_textures, use_shadows, use_bump,
               shadow_hit=None):
        if fault == "shadow_dropped":
            shadow_hit = None
        else:
            shift = torch.tensor(LIGHT_SHIFT, device=scene.light.device)
            scene = dataclasses.replace(scene, light=scene.light + shift)
        return real(scene, ctx, rays, rec, spread, use_textures, use_shadows, use_bump,
                    shadow_hit)

    set_attr(render, "_ambient", broken)


FAULTS = {
    "split_half": lambda s: _split_trace("half", s),
    "split_altered": lambda s: _split_trace("altered", s),
    "image_altered": _image_altered,
    "build_unchanged": _build_unchanged,
    "modes_half": lambda s: _wide_fat("half", s),
    "modes_altered": lambda s: _wide_fat("altered", s),
    "colour_altered": _colour_altered,
    "shadow_dropped": lambda s: _shading("shadow_dropped", s),
    "light_moved": lambda s: _shading("light_moved", s),
}


def install(name: str, set_attr) -> None:
    """Plants the fault ``name`` in the program."""
    FAULTS[name](set_attr)
