"""The wide path tracer's frame tracers (``trace/wide_fat.py:
make_fat_frame_tracers``) and K6's any-hit instantiation, on the CPU with
the plain versions: the any-hit verdict against the benchmark's brute-force
reference and K6's closest hit, the 8-bounce frame over a Karras tree
bit-equal to the single tiled tracer's and held to the reference's pixels,
and the app's wide path tracer handing out the shadow tracers."""

import numpy as np
import pytest
import torch

from rtbench import judge
from rtbench import reference as ref
from tpu_raytracing_torch.app import main as app
from tpu_raytracing_torch.bvh import lbvh, wide
from tpu_raytracing_torch.ops import fat_traverse as ft
from tpu_raytracing_torch.scene import camera as cam
from tpu_raytracing_torch.scene import procedural
from tpu_raytracing_torch.scene.types import Library, scene_to_device
from tpu_raytracing_torch.trace import wide_fat
from tpu_raytracing_torch.trace.pathtrace import path_trace
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.traverse import pack_pairs
from tpu_raytracing_torch.utils.timing import StageTimer

torch.set_num_threads(2)
_RNG = np.random.default_rng(20261018)
NUM_TRIS = 2000
EXTENT, HEIGHT = 100.0, 8.0
LIGHT = (0.0, 200.0, 0.0)
ALBEDO = (0.55, 0.5, 0.45)
W = H = 32
BOUNCES = 8
FRAME_TIME = 0.7
FRAME_POS, PERIOD = 5, 64
TRACER_KEYS = {"tracer", "shadow_tracer", "bounce_tracer", "shadow_tracer_bounce"}


def _terrain(seed) -> np.ndarray:
    return ref.terrain_triangles(NUM_TRIS, EXTENT, HEIGHT, int(seed))


def _fat_rows(tris: torch.Tensor) -> torch.Tensor:
    bvh, pairs = lbvh.build_lbvh(tris, enable_pairs=True)
    ft.check_stack_depth(bvh)
    return wide_fat.live_rows256(wide.build_wide_fat(bvh, pack_pairs(pairs).rows))


def test_any_hit_plain_matches_reference_occlusion():
    tris = torch.as_tensor(_terrain(_RNG.integers(1 << 31)))
    rows = _fat_rows(tris)
    n = 2048
    origin = torch.as_tensor(np.stack([_RNG.uniform(-45, 45, n), _RNG.uniform(15, 40, n),
                                       _RNG.uniform(-45, 45, n)], 1), dtype=torch.float32)
    d = torch.as_tensor(_RNG.normal(size=(n, 3)), dtype=torch.float32)
    d[:, 1] = -d[:, 1].abs() - 0.3
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    tmin = torch.full((n,), 1e-3)
    big = torch.full((n,), 1e4)
    hit, t_hit, *_ = ft.trace_fat_plain(rows, origin, d, tmin, big)
    assert 0.3 < hit.float().mean() < 1.0
    # a quarter stops short of the first hit, a quarter just past it, a
    # quarter far beyond; the last quarter is dead (tmax -1)
    q = n // 4
    tmax = big.clone()
    tmax[:q] = torch.where(hit[:q].bool(), t_hit[:q] * 0.5, 30.0)
    tmax[q:2 * q] = torch.where(hit[q:2 * q].bool(), t_hit[q:2 * q] * 1.01, 30.0)
    tmax[3 * q:] = -1.0
    out = ft.trace_fat_plain(rows, origin, d, tmin, tmax, any_hit=True)
    any_hit, t_any, prim, tri, u, v, overflow = out
    want = ref.Caster(tris).occluded(origin, d, tmin, tmax)
    assert torch.equal(any_hit.bool(), want)
    assert not any_hit[:q].any() and any_hit[q:2 * q].bool().equal(hit[q:2 * q].bool())
    closest = ft.trace_fat_plain(rows, origin, d, tmin, tmax)
    assert torch.equal(any_hit, closest[0])
    assert torch.equal(t_any, tmax)
    for x in (prim, tri, u, v, overflow):
        assert not x.any()
    # the wrapper's CPU path is the plain version
    assert all(torch.equal(a, b) for a, b in zip(
        ft.fat_traverse(rows, origin, d, tmin, tmax, any_hit=True), out))
    with pytest.raises(ValueError, match="does not count"):
        ft.fat_traverse(rows, origin, d, tmin, tmax, count=True, any_hit=True)


def _parse(extra=()):
    return app.parse_cmd(["--scene", f"terrain:{NUM_TRIS}", "--type", "bottom-up", "--pairs",
                          "--tracer", "wide", "--width", str(W), "--height", str(H),
                          "--bounces", str(BOUNCES), "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def frame():
    """A wobbled terrain's Karras tree and fat rows through the app's
    ``build_accel`` and ``build_trav``, its scene and the aerial camera."""
    rest = _terrain(_RNG.integers(1 << 31))
    lib = Library()
    lib.add_material("ground")
    lib.materials[-1].diffuse = np.asarray(ALBEDO, np.float32)
    lib.materials[-1].ambient = np.asarray(ALBEDO, np.float32)
    scene = procedural._finish(rest, np.zeros(rest.shape[0], np.int32), lib,
                               np.asarray(LIGHT, np.float32))
    tris = procedural.animate_triangles(torch.as_tensor(rest), FRAME_TIME)
    args = _parse(["--animate"])
    bvh, pairs = app.build_accel(tris, args, StageTimer())
    trav, packed, tracers = app.build_trav(args, tris, bvh, pairs, StageTimer())
    lo, hi = rest.reshape(-1, 3).min(0), rest.reshape(-1, 3).max(0)
    host_cam = ref.CAMERAS["aerial_orbit"](lo, hi, FRAME_POS, PERIOD)
    cam_dev = cam.camera_to_device(cam.Camera(
        position=host_cam["position"], w=host_cam["w"], u=host_cam["u"], v=host_cam["v"],
        max_depth=float(host_cam["max_depth"])), torch.device("cpu"))
    return dict(rest=rest, trav=trav, packed=packed, tracers=tracers,
                scene=scene_to_device(scene, torch.device("cpu")), host_cam=host_cam,
                cam=cam_dev)


def _render(f, tracers, seed):
    img, rays = path_trace(f["trav"], f["packed"], f["scene"], f["cam"], W, H,
                           num_bounces=BOUNCES,
                           generator=torch.Generator().manual_seed(seed), **tracers)
    return img, rays


def test_frame_tracers_bit_equal_to_single_tracer_and_reference(frame):
    assert set(frame["tracers"]) == TRACER_KEYS
    seed = int(_RNG.integers(1 << 31))
    img, rays = _render(frame, frame["tracers"], seed)
    single = dict(tracer=wide_fat.make_tiled_fat_tracer(None, W, H, 8, 8))
    img1, rays1 = _render(frame, single, seed)
    assert torch.equal(img, img1) and int(rays) == int(rays1)
    assert int(rays) > W * H

    # the sampled pixels against the benchmark's tree-free reference
    pixels = torch.as_tensor(_RNG.choice(W * H, 256, replace=False))
    rest = torch.as_tensor(frame["rest"])
    caster = ref.Caster(ref.wobble(rest, FRAME_TIME))
    uni = ref.path_uniforms(seed, W * H, BOUNCES, torch.device("cpu"))
    want = ref.path_trace_pixels(caster, ref.flat_normals(rest), ALBEDO, LIGHT,
                                 frame["host_cam"], W, H, BOUNCES, uni, pixels) * 255.0
    got = (img * 255.0).clamp(0, 255).to(torch.uint8).reshape(-1, 3)[pixels]
    assert not judge.pixel_off(got, want).any()


def test_shadow_tracers_any_hit(frame, monkeypatch):
    """Each tracer's K6 form: the shadow tracers any-hit, the bounce
    tracers in the caller's order."""
    calls = []
    real = wide_fat.trace_rays_fat

    def spy(rows256, rays, active=None, any_hit=False):
        calls.append(any_hit)
        return real(rows256, rays, active, any_hit=any_hit)

    monkeypatch.setattr(wide_fat, "trace_rays_fat", spy)
    t = frame["tracers"]
    f = frame
    num = W * H
    g = torch.Generator().manual_seed(3)
    rays = Rays(origin=torch.rand((num, 3), generator=g) * 40 - 20 + torch.tensor([0, 30.0, 0]),
                direction=torch.nn.functional.normalize(
                    torch.rand((num, 3), generator=g) - torch.tensor([0.5, 1.0, 0.5]), dim=-1),
                tmin=torch.full((num,), 1e-3), tmax=torch.full((num,), 1e3))
    active = torch.rand(num, generator=g) < 0.7
    perm = torch.randperm(num, generator=g)
    closest, _ = t["tracer"](f["trav"], f["packed"], rays, active=active)
    for key, order in (("shadow_tracer", None), ("bounce_tracer", perm),
                       ("shadow_tracer_bounce", perm)):
        calls.clear()
        r = rays if order is None else rays.take(order)
        a = active if order is None else active[order]
        rec, stats = t[key](f["trav"], f["packed"], r, active=a)
        assert calls == ["shadow" in key]
        want = closest if order is None else closest.__class__(
            **{k: getattr(closest, k)[order] for k in closest.__dataclass_fields__})
        assert torch.equal(rec.hit, want.hit)
        if key == "bounce_tracer":
            for name in ("t", "prim_id", "tri_id", "bary_u", "bary_v"):
                assert torch.equal(getattr(rec, name), getattr(want, name)), name
        else:
            assert torch.equal(rec.t, r.tmax)
        assert not stats.overflow.any()


def test_app_wide_path_tracer_takes_shadow_tracers(tmp_path, monkeypatch):
    """The app's ``--type bottom-up --tracer wide --bounces 2 --animate``:
    its tracers are the frame's four, and each frame's shadow passes run
    K6's any-hit form (the primary shadow pass and one a bounce)."""
    args = app.parse_cmd(["--scene", "terrain:800", "--type", "bottom-up", "--tracer", "wide",
                          "--bounces", "2", "--animate", "--width", "16", "--height", "16",
                          "--device", "cpu"])
    tris = torch.as_tensor(procedural.terrain(800).triangles)
    bvh, pairs = app.build_accel(tris, args, StageTimer())
    _, _, tracers = app.build_trav(args, tris, bvh, pairs, StageTimer())
    assert set(tracers) == TRACER_KEYS
    modes_args = app.parse_cmd(["--scene", "terrain:800", "--tracer", "wide", "--width", "16",
                                "--height", "16", "--device", "cpu"])
    _, _, mode_tracers = app.build_trav(modes_args, tris, bvh, pairs, StageTimer())
    assert set(mode_tracers) == {"tracer"}

    kinds = []
    real = ft.fat_traverse

    def spy(*a, count=False, any_hit=False):
        kinds.append("any" if any_hit else "count" if count else "closest")
        return real(*a, count=count, any_hit=any_hit)

    monkeypatch.setattr(ft, "fat_traverse", spy)
    monkeypatch.setattr(wide_fat, "fat_traverse", spy)
    res = app.main(["--scene", "terrain:800", "--type", "bottom-up", "--tracer", "wide",
                    "--bounces", "2", "--animate", "--frames", "2", "--width", "16",
                    "--height", "16", "--device", "cpu", "--output", str(tmp_path)])
    assert len(res["frames"]) == 2 and len(res["animated"]) == 1
    assert [n.strip() for n, _ in res["animated"][0]["stages"]] == [
        "Animate", "BottomUpBuild", "WideFatCollapse"]
    # per frame: the tiled counting primary, then per bounce one
    # closest-hit and one any-hit call beside the primary shadow pass's
    assert kinds == 2 * ["count", "any", "closest", "any", "closest", "any"]
