"""The app's instanced path: the instanced tracers of
``trace/instanced_split.py`` (the candidate sweep, the object-space items,
K1, the resolve), the instances' normal matrices
(``tlas.instance_normal_maps``) in the path tracer's shading, the app's
``--instances`` functions, and the benchmark's instanced scene kind
(``rtbench/scenes/instanced.py``) through ``rtbench`` at a tiny size, all
against the benchmark's plain two-level reference (``rtbench/reference.py``:
``InstancedCaster``, ``InstanceNormals``) on the CPU, where every kernel
runs as its plain version. The instances turn about random axes, scale
unevenly, and one is a mirror.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from rtbench import harness, judge, reference
from rtbench.scenes import instanced as kind
from tpu_raytracing_torch.app import main as app
from tpu_raytracing_torch.bvh import tlas
from tpu_raytracing_torch.trace import instanced_split, pathtrace, split_trace
from tpu_raytracing_torch.trace.brute import InstancedHitRecord
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.utils import timing

torch.set_num_threads(2)
WORKLOAD = "instanced1k-split.animate-rebuild"
NUM_INST = 12
NUM_RAYS = 600
ARGV = ["--scene", "soup:320", "--type", "bottom-up", "--pairs", "--tracer", "split",
        "--bounces", "2", "--device", "cpu", "--instances", str(NUM_INST)]


def rotation(axis, angle):
    """A rotation about ``axis`` by ``angle`` (Rodrigues), [3, 3]."""
    k = axis / np.linalg.norm(axis)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(angle) * kx + (1 - math.cos(angle)) * kx @ kx


def transforms(num, rng):
    """[num, 3, 4] float32: turns about random axes, uneven scales, spread
    translations; instance 0 mirrored in x."""
    out = np.zeros((num, 3, 4))
    for i in range(num):
        scale = np.diag(rng.uniform(0.6, 1.6, 3))
        out[i, :, :3] = rotation(rng.normal(size=3), rng.uniform(0, 2 * math.pi)) @ scale
        out[i, :, 3] = rng.uniform(-4.0, 4.0, 3)
    out[0, :, 0] *= -1.0
    return out.astype(np.float32)


def scatter_rays(num, rng, tmax=40.0):
    """Rays from a shell around the instances, half toward a random instance
    centre and half in random directions; unit directions."""
    o = rng.normal(size=(num, 3))
    o = 12.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    target = rng.uniform(-4.0, 4.0, (num, 3))
    d = np.where((np.arange(num) % 2 == 0)[:, None], target - o, rng.normal(size=(num, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Rays(origin=torch.as_tensor(o, dtype=torch.float32),
                direction=torch.as_tensor(d, dtype=torch.float32),
                tmin=torch.full((num,), 1e-3), tmax=torch.full((num,), tmax))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    obj = kind.icosphere(2, rng)
    tf = transforms(NUM_INST, rng)
    args = app.parse_cmd(ARGV)
    blas = app.instance_blas(args, torch.as_tensor(obj))
    ias = app.instance_level(blas, torch.as_tensor(tf))
    ref = reference.InstancedCaster(torch.as_tensor(obj), torch.as_tensor(tf))
    return dict(obj=obj, tf=tf, args=args, blas=blas, ias=ias, ref=ref,
                rays=scatter_rays(NUM_RAYS, rng), tracers=app.make_instanced_tracers())


def test_normal_maps_are_the_signed_inverse_transpose(scene):
    maps = scene["ias"].normal_maps.numpy()
    for i, x in enumerate(scene["tf"].astype(np.float64)):
        a = x[:, :3]
        want = np.linalg.inv(a).T * np.sign(np.linalg.det(a))
        np.testing.assert_allclose(maps[i], want, rtol=1e-5, atol=1e-6)
    # the mirror's turn of sign keeps every map's determinant positive
    assert np.linalg.det(scene["tf"][0, :, :3]) < 0
    assert (np.linalg.det(maps) > 0).all()


@pytest.mark.parametrize("active", [False, True], ids=["all-live", "some-dead"])
def test_closest_hits_match_the_two_level_reference(scene, active):
    rays = scene["rays"]
    act = (torch.arange(NUM_RAYS) % 5 != 0) if active else None
    rec, stats = scene["tracers"]["tracer"](scene["ias"], scene["blas"].packed, rays, act)
    assert isinstance(rec, InstancedHitRecord)
    hit, t, ids, _, _ = scene["ref"].closest(rays.origin, rays.direction, rays.tmin, rays.tmax)
    live = torch.ones(NUM_RAYS, dtype=torch.bool) if act is None else act
    np.testing.assert_array_equal(rec.hit.numpy(), (hit & live).numpy())
    both = (rec.hit & hit).numpy()
    far = (rec.t - t).abs() > judge.T_REL * t.abs() + judge.T_ABS
    assert not far[rec.hit & hit].any()
    # the instance and object triangle where t is no tie
    num_t = scene["obj"].shape[0]
    got = (rec.inst.to(torch.int64) * num_t + rec.prim_id).numpy()
    assert (got[both] == ids.numpy()[both]).mean() > 0.98
    assert (rec.inst.numpy()[~rec.hit.numpy()] == -1).all()
    assert int(stats.overflow) == 0 and both.sum() > NUM_RAYS // 6
    assert not stats.box_tests[~live].any()


@pytest.mark.parametrize("active", [False, True], ids=["all-live", "some-dead"])
def test_occlusion_matches_the_two_level_reference(scene, active):
    rays = scene["rays"]
    # shadow-like intervals: some rays end before they reach an instance
    rays = dataclasses.replace(rays, tmax=torch.linspace(2.0, 30.0, NUM_RAYS))
    act = (torch.arange(NUM_RAYS) % 3 != 0) if active else None
    rec, stats = scene["tracers"]["shadow_tracer"](scene["ias"], scene["blas"].packed, rays,
                                                   act)
    want = scene["ref"].occluded(rays.origin, rays.direction, rays.tmin, rays.tmax)
    if act is not None:
        want = want & act
    np.testing.assert_array_equal(rec.hit.numpy(), want.numpy())
    assert torch.equal(rec.t, rays.tmax) and 0 < int(want.sum()) < NUM_RAYS
    assert int(stats.overflow) == 0


def test_instanced_shading_uses_the_reference_normals(scene):
    """``bounce_shade_plain`` with the instances' normal matrices: with
    uniforms (0, 0) the next ray leaves along the shading normal, which must
    be the reference's normal of the hit id, turned to face the ray."""
    rays = scene["rays"]
    tr = scene["tracers"]
    rec, _ = tr["tracer"](scene["ias"], scene["blas"].packed, rays)
    obj = scene["obj"]
    lib_scene = _device_scene(obj)
    num = NUM_RAYS
    out = pathtrace.bounce_shade_plain(
        lib_scene, scene["blas"].packed, rays, rec, torch.zeros(num, dtype=torch.bool),
        torch.ones(num, 3), torch.zeros(num, 3), torch.ones(num, dtype=torch.bool),
        torch.arange(num), torch.zeros(num, 2), 50.0, normal_maps=scene["ias"].normal_maps)
    got = out[3].direction[rec.hit]
    ids = rec.inst.to(torch.int64) * obj.shape[0] + rec.prim_id
    want = scene["ref"].normals[ids[rec.hit]]
    want = torch.where(((want * rays.direction[rec.hit]).sum(-1) > 0)[:, None], -want, want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    # without the normal matrices an instanced record is refused
    with pytest.raises(ValueError, match="normal_maps"):
        pathtrace.bounce_shade_plain(lib_scene, scene["blas"].packed, rays, rec,
                                     out[2], out[1], out[0], out[2], torch.arange(num),
                                     torch.zeros(num, 2), 50.0)


def _device_scene(obj):
    from tpu_raytracing_torch.scene import procedural
    from tpu_raytracing_torch.scene.types import Library, scene_to_device

    lib = Library()
    lib.add_material("ball")
    host = procedural._finish(obj, np.zeros(obj.shape[0], np.int32), lib,
                              np.array([0.0, 50.0, 0.0], np.float32))
    return scene_to_device(host, "cpu")


def test_candidate_sweep_matches_a_brute_force_box_test(scene):
    """``candidate_masks`` + ``peel_candidates`` (and ``sweep_plain``'s slots)
    against every ray tested against every instance box in float64."""
    rays, ias = scene["rays"], scene["ias"]
    act = torch.arange(NUM_RAYS) % 7 != 0
    o, d = rays.origin.double().numpy(), rays.direction.double().numpy()
    inv = 1.0 / np.where(np.abs(d) < 1e-30, np.where(d < 0, -1e-30, 1e-30), d)
    lo, hi = ias.wmin.double().numpy(), ias.wmax.double().numpy()
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    front = np.minimum(t0, t1).max(-1)
    back = np.maximum(t0, t1).min(-1)
    want = ((back >= front) & (front <= rays.tmax.numpy()[:, None])
            & (back >= rays.tmin.numpy()[:, None]) & act.numpy()[:, None])
    words, nov = instanced_split.candidate_masks(ias.wmin, ias.wmax, rays, active=act)
    np.testing.assert_array_equal(nov.numpy(), want.sum(1))
    cands = instanced_split.peel_candidates(words, NUM_INST).numpy()
    for r in range(NUM_RAYS):
        np.testing.assert_array_equal(cands[r][cands[r] >= 0], np.flatnonzero(want[r]))
    sw = instanced_split.sweep_plain(ias.wmin, ias.wmax, rays, act, 4 * NUM_RAYS, False,
                                     keep_first=True)
    assert sw.stats.tolist() == [int(want.sum()), int(act.sum()), int(want.sum(1).max()), 0]
    for r in np.flatnonzero(want.any(1))[:50]:
        s = int(sw.first[r])
        run = sw.item_key[s:s + int(nov[r])].numpy()
        assert (sw.item_ray[s:s + int(nov[r])].numpy() == r).all()
        np.testing.assert_array_equal((run - 1) >> 3, np.flatnonzero(want[r]))


def test_overflowing_the_item_slots_raises_at_the_frame_check(scene):
    """No hit is dropped without a word: a call whose overlaps outnumber its
    slots flags it, and the frame's overflow check raises."""
    rec, stats = instanced_split.trace_instanced(scene["ias"], scene["blas"].packed,
                                                 scene["rays"], items_per_ray=0.1)
    assert int(stats.overflow) >= split_trace.CANDIDATE_OVERFLOW
    with pytest.raises(instanced_split.InstancedCandidateOverflow, match="item slots"):
        split_trace.check_overflow(stats.overflow)


def test_instance_structures_hold_the_object_once(scene):
    """The timed path holds the object's triangles once (its pair rows and
    tree) and per-instance rows only: no [I x T] world expansion."""
    num_t, ias = scene["obj"].shape[0], scene["ias"]
    tensors = [t for t in timing._tensors(ias)] + [scene["blas"].lo, scene["blas"].hi]
    assert all(t.shape[0] < NUM_INST * num_t // 4 for t in tensors)
    assert scene["blas"].packed.rows.shape[0] <= num_t
    for f in ("wmin", "wmax", "inv_transforms", "normal_maps"):
        assert getattr(ias, f).shape[0] == NUM_INST


def test_the_app_renders_instances(tmp_path):
    """``--instances`` on the app's command line: frames path-traced over the
    instance level, rebuilt each animated frame from the moved scatter."""
    res = app.main(["--scene", "sphere:1", "--type", "bottom-up", "--pairs", "--tracer",
                    "split", "--bounces", "1", "--instances", "16", "--width", "24",
                    "--height", "16", "--device", "cpu", "--animate", "--frames", "2",
                    "--output", str(tmp_path)])
    assert isinstance(res["trav"], instanced_split.InstancedSplitAS)
    assert [a["kind"] for a in res["animated"]] == ["instances"]
    from tpu_raytracing_torch.utils.png import read_png

    img = read_png(res["frames"][-1][3])
    assert img.shape[:2] == (16, 24) and len(np.unique(img.reshape(-1, img.shape[-1]),
                                                       axis=0)) > 4
    with pytest.raises(SystemExit, match="--instances"):
        app.main(["--instances", "4", "--tracer", "wide", "--device", "cpu"])


def test_count_max_keeps_the_largest():
    timing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        timing.count_max("t.top", torch.tensor(3))
        timing.count_max("t.top", 7)
        timing.count_max("t.top", torch.tensor(5))
        timing.count("t.sum", torch.tensor(5))
        timing.count("t.sum", 2)
    assert timing.recorded()["counters"] == {"t.top": 7, "t.sum": 7}
    timing.clear()


# the benchmark's instanced cell at a size the CPU holds: 12 instances of a
# 320-triangle object, large enough on the screen that one instance's fault
# shows on the judge's samples
SMALL_SCENE = {"subdivisions": 2, "grid": [4, 3], "spacing": 10.0, "scale": [3.0, 4.0]}


def small_overrides():
    scene = dict(harness.resolve(WORKLOAD)["config"]["scene"], **SMALL_SCENE)
    return {"config": {"scene": scene, "width": 32, "height": 32, "bounces": 2},
            "traffic": {"period": 4, "capture_span": 2, "captures": 2, "profile_steps": 2}}


def test_the_kind_reads_zero_and_its_control_fails():
    r = harness.run_cell(WORKLOAD, 2**31 + 11, 0.2, False, device="cpu",
                         overrides=small_overrides(), control_dtype=torch.bfloat16)
    rd = r["_readings"]
    assert r["correct"] and r["failed"] == 0
    assert rd["program"] == {"hit_miss": 0.0, "shadow_miss": 0.0, "pixel_miss": 0.0}
    limits = harness.resolve(WORKLOAD)["limits"]
    assert all(rd["control"][k] > limits[k] for k in limits), rd["control"]
    assert set(r["metrics"]) == {"setup_s", "frame_ms", "frame_ms_p95", "peak_mem_gib"}


def test_the_kind_traced_reads_its_layers():
    r = harness.run_cell(WORKLOAD, 17, 0.2, True, device="cpu", overrides=small_overrides())
    assert r["correct"]
    m = r["metrics"]
    # the device readers read nothing on the CPU; the program's spans do
    for name in ("tlas_build_ms", "inst_stage_ms.candidates", "inst_stage_ms.items",
                 "inst_stage_ms.resolve", "inst_items_per_ray"):
        assert m[name]["value"] > 0, name
    assert "inst_cand_roofline_pct" not in m and "k1_device_ms" not in m


def _fault(name, monkeypatch):
    """A planted fault in the program: one instance's normal matrix left at
    the identity, or one instance left out of the sweep."""
    level = app.instance_level

    def faulty(blas, transforms):
        ias = level(blas, transforms)
        # the largest instance
        k = int(torch.argmax((ias.wmax - ias.wmin).prod(dim=1)))
        if name == "identity_normals":
            maps = ias.normal_maps.clone()
            maps[k] = torch.eye(3)
            return dataclasses.replace(ias, normal_maps=maps)
        wmin, wmax = ias.wmin.clone(), ias.wmax.clone()
        far = torch.full((3,), 1e30)
        wmin[k], wmax[k] = far, far
        return dataclasses.replace(ias, wmin=wmin, wmax=wmax)

    monkeypatch.setattr(app, "instance_level", faulty)


@pytest.mark.parametrize("fault", ["identity_normals", "dropped_instance"])
def test_planted_faults_read_false(fault, monkeypatch):
    _fault(fault, monkeypatch)
    r = harness.run_cell(WORKLOAD, 23, 0.2, False, device="cpu", overrides=small_overrides())
    assert not r["correct"], r["_readings"]["program"]


def test_roofline_count_reads_as_documented():
    from rtbench import instanced_roofline

    nbytes = instanced_roofline.sweep_bytes(18 * 1_048_576, 2_000_000, 18, 1000)
    assert nbytes == 613_275_776
    pct = instanced_roofline.sweep_roofline_pct(18 * 1_048_576, 2_000_000, 18, 1000, 1,
                                                18.3067395820895)
    assert abs(pct - 1.0) < 1e-9
    assert instanced_roofline.sweep_roofline_pct(1, 1, 1, 1, 1, 0.0) is None
