"""The path tracer's bounce-shade wrapper (``trace/pathtrace.py:bounce_shade``)
on the CPU: CPU tensors take the plain version and launch nothing, the
operand checks that guard the CUDA kernel refuse what it does not take, and
every tracer the app's path tracer runs hands the kernel operands it takes.

The kernel itself (``csrc/bounce_shade.cu``) runs only on the card, where
``chip_smoke.py`` holds it to ``bounce_shade_plain`` bit for bit; the plain
version is held to the JAX bounce stage in ``test_torch_pathtrace.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing_torch.bvh import bucket  # noqa: E402
from tpu_raytracing_torch.scene import camera as tcam  # noqa: E402
from tpu_raytracing_torch.scene import procedural as tproc  # noqa: E402
from tpu_raytracing_torch.scene.types import scene_to_device  # noqa: E402
from tpu_raytracing_torch.trace import pathtrace as tpt  # noqa: E402
from tpu_raytracing_torch.trace import split_trace as st  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays, generate_primary_rays  # noqa: E402
from tpu_raytracing_torch.trace.render import _shadow_rays  # noqa: E402

torch.set_num_threads(2)
W, H = 16, 16


@pytest.fixture(scope="module")
def shade_inputs():
    """One bounce's operands on cornell: a traced primary pass, its shadow
    verdicts and seeded throughput, radiance, alive, pixel and uniforms."""
    scene = tproc.cornell_box()
    views, packed, _ = bucket.emit_split_views(
        bucket.split_front(torch.from_numpy(scene.triangles), True), leaf_width=st.LEAFW)
    camera = tcam.camera_to_device(
        tcam.update_camera(tcam.initialise_camera(scene.aabb_min, scene.aabb_max)), "cpu")
    tscene = scene_to_device(scene, "cpu")
    rays = generate_primary_rays(camera, W, H)
    rec, _ = st.trace_rays_split(views, packed, rays)
    srec, _ = st.trace_rays_split(views, packed, _shadow_rays(tscene, rays, rec), any_hit=True)
    rng = np.random.default_rng(181)
    num = W * H
    return dict(
        scene=tscene, pairs=packed, rays=rays, rec=rec, srec_hit=srec.hit,
        throughput=torch.from_numpy(rng.uniform(0.2, 1.0, (num, 3)).astype(np.float32)),
        radiance=torch.from_numpy(rng.uniform(0.0, 0.5, (num, 3)).astype(np.float32)),
        # some rays dead on entry, as after a compaction
        alive=torch.from_numpy(rng.random(num) < 0.8),
        pixel=torch.from_numpy(rng.permutation(num)),
        u_frame=torch.from_numpy(rng.random((num, 2)).astype(np.float32)),
        max_t=camera["max_depth"])


def _args(s):
    return [s[k] for k in ("scene", "pairs", "rays", "rec", "srec_hit", "throughput", "radiance",
                           "alive", "pixel", "u_frame", "max_t")]


def _outputs(out):
    rad, thr, alive, rays = out
    return [rad, thr, alive, rays.origin, rays.direction, rays.tmin, rays.tmax]


@pytest.mark.parametrize("sample_next", [True, False])
def test_cpu_takes_the_plain_version(shade_inputs, sample_next):
    before = tpt.launch_count
    out = tpt.bounce_shade(*_args(shade_inputs), sample_next=sample_next)
    ref = tpt.bounce_shade_plain(*_args(shade_inputs), sample_next=sample_next)
    assert tpt.launch_count == before == 0
    for a, b in zip(_outputs(out), _outputs(ref)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rad, thr, alive, rays = out
    s = shade_inputs
    assert torch.equal(alive, s["alive"] & s["rec"].hit)
    if sample_next:
        # the next rays: off the surface, unit length, the frame's tmax
        assert torch.allclose(torch.linalg.vector_norm(rays.direction, dim=-1),
                              torch.ones(W * H), atol=1e-5)
        assert bool((rays.tmin == np.float32(1e-3)).all())
        assert bool((rays.tmax == s["max_t"]).all())
    else:
        # the final bounce keeps the throughput and rays it was given
        assert thr is s["throughput"] and rays is s["rays"]


def test_bounce_stage_launches_nothing_on_cpu(shade_inputs):
    s = shade_inputs
    tpt.path_trace(*_frame_args(), num_bounces=2, **st.make_frame_tracers(8, 8))
    assert tpt.launch_count == 0
    with pytest.raises(ValueError, match="unsupported device"):
        r = s["rays"]
        meta = Rays(*(x.to("meta") for x in (r.origin, r.direction, r.tmin, r.tmax)))
        tpt.bounce_shade(s["scene"], s["pairs"], meta, *_args(s)[3:])


def _frame_args():
    scene = tproc.cornell_box()
    views, packed, _ = bucket.emit_split_views(
        bucket.split_front(torch.from_numpy(scene.triangles), True), leaf_width=st.LEAFW)
    camera = tcam.camera_to_device(
        tcam.update_camera(tcam.initialise_camera(scene.aabb_min, scene.aabb_max)), "cpu")
    return views, packed, scene_to_device(scene, "cpu"), camera, 8, 8


def _replace_rec(field, fn):
    def edit(s):
        s["rec"] = dataclasses.replace(s["rec"], **{field: fn(getattr(s["rec"], field))})
    return edit


def _replace_rays(field, fn):
    def edit(s):
        s["rays"] = dataclasses.replace(s["rays"], **{field: fn(getattr(s["rays"], field))})
    return edit


def _replace(key, fn):
    def edit(s):
        s[key] = fn(s[key])
    return edit


def _replace_scene(field, fn):
    def edit(s):
        s["scene"] = dataclasses.replace(s["scene"], **{field: fn(getattr(s["scene"], field))})
    return edit


def _noncontig(x):
    """The same values in a tensor that is not contiguous."""
    return torch.stack([x, x], dim=-1)[..., 0]


BAD = {
    # dtypes
    "t_float64": _replace_rec("t", lambda x: x.double()),
    "prim_id_int64": _replace_rec("prim_id", lambda x: x.long()),
    "hit_uint8": _replace_rec("hit", lambda x: x.to(torch.uint8)),
    "pixel_int32": _replace("pixel", lambda x: x.int()),
    "alive_int32": _replace("alive", lambda x: x.int()),
    "pair_rows_float": _replace("pairs", lambda p: dataclasses.replace(p, rows=p.rows.float())),
    # shapes
    "throughput_4": _replace("throughput", lambda x: torch.cat([x, x[:, :1]], dim=1)),
    "radiance_short": _replace("radiance", lambda x: x[:-1].contiguous()),
    "bary_u_short": _replace_rec("bary_u", lambda x: x[:-1].contiguous()),
    "u_frame_3": _replace("u_frame", lambda x: torch.cat([x, x[:, :1]], dim=1)),
    "u_frame_empty": _replace("u_frame", lambda x: x[:0]),
    "max_t_2": _replace("max_t", lambda x: torch.stack([x, x])),
    "pair_rows_15": _replace("pairs", lambda p: dataclasses.replace(
        p, rows=p.rows[:, :15].contiguous())),
    "normals_3x2": _replace_scene("normals", lambda x: x[:, :, :2].contiguous()),
    "material_ids_short": _replace_scene("material_ids", lambda x: x[:-1].contiguous()),
    "light_4": _replace_scene("light", lambda x: torch.cat([x, x[:1]])),
    # not contiguous
    "direction_noncontig": _replace_rays("direction", _noncontig),
    "tri_id_noncontig": _replace_rec("tri_id", _noncontig),
    "throughput_noncontig": _replace("throughput", _noncontig),
    "normals_noncontig": _replace_scene("normals", _noncontig),
    # another device than the rays'
    "t_meta": _replace_rec("t", lambda x: x.to("meta")),
    "srec_hit_meta": _replace("srec_hit", lambda x: x.to("meta")),
    "normals_meta": _replace_scene("normals", lambda x: x.to("meta")),
}


def _checked(s):
    tpt._check_shade_operands(*_args(s))


def test_operand_checks_take_a_frames_operands(shade_inputs):
    _checked(dict(shade_inputs))


@pytest.mark.parametrize("case", sorted(BAD))
def test_operand_checks_refuse(shade_inputs, case):
    s = dict(shade_inputs)
    BAD[case](s)
    with pytest.raises(ValueError, match="bounce_shade: "):
        _checked(s)


@pytest.mark.parametrize("tracer", ["scalar", "packet", "wide", "split", "grid", "lane"])
def test_every_path_tracer_hands_the_kernel_its_operands(tmp_path, monkeypatch, tracer):
    """The app's ``--bounces`` path with each tracer: every bounce's
    operands pass the kernel's checks, so on the card none of them makes
    ``bounce_shade`` raise."""
    from tpu_raytracing_torch.app import main as app

    real, calls = tpt.bounce_shade, []

    def checking(*args, sample_next=True, normal_maps=None):
        s = dict(zip(("scene", "pairs", "rays", "rec", "srec_hit", "throughput", "radiance",
                      "alive", "pixel", "u_frame", "max_t"), args))
        _checked(s)
        calls.append(sample_next)
        return real(*args, sample_next=sample_next, normal_maps=normal_maps)

    monkeypatch.setattr(tpt, "bounce_shade", checking)
    app.main(["--scene", "cornell", "--type", "bottom-up", "--pairs", "--tracer", tracer,
              "--bounces", "1", "--width", "16", "--height", "8", "--device", "cpu",
              "--output", str(tmp_path)])
    assert calls == [True, False]
