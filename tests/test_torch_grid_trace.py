"""PyTorch port's grid tracer (``trace/grid_trace.py``) and the app's
``--tracer grid`` vs the JAX reference.

Both tracers walk the same grid: the port's build, bit-equal to the
reference's (tests/test_torch_grid.py), handed to the reference as its own
``UniformGrid``. hit, tri_id and prim_id are held exactly, and so are the
per-ray DDA steps (``box_tests``) and triangle tests; t to rtol 1e-6 (1e-5
on the soup) and the barycentrics to rtol 1e-6 / atol 1e-5
(tests/test_torch_traverse.py says why), in closest-hit and any-hit. The
residue and segment schedules give the single-phase result bit for bit. A
1-bounce frame, with the reference's uniforms fed to the port, is held at
40 dB; so is the app's grid frame against the reference's render.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import grid as jgrid  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.scene import procedural as jproc  # noqa: E402
from tpu_raytracing.scene.types import scene_to_device as jscene_to_device  # noqa: E402
from tpu_raytracing.trace import grid_trace as jgt  # noqa: E402
from tpu_raytracing.trace import pathtrace as jpt  # noqa: E402
from tpu_raytracing.trace import render as jrender  # noqa: E402
from tpu_raytracing.trace.modes import RenderType as JRenderType  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jprimary  # noqa: E402
from tpu_raytracing.trace.traverse import PackedPairs as JPackedPairs  # noqa: E402
from test_torch_grid import SOUP_TRIS  # noqa: E402
from tpu_raytracing_torch.app import main as app  # noqa: E402
from tpu_raytracing_torch.bvh import grid  # noqa: E402
from tpu_raytracing_torch.bvh.pairing import identity_pairs  # noqa: E402
from tpu_raytracing_torch.scene import camera as cam  # noqa: E402
from tpu_raytracing_torch.scene.types import scene_to_device  # noqa: E402
from tpu_raytracing_torch.trace import grid_trace, pathtrace, render  # noqa: E402
from tpu_raytracing_torch.trace.brute import make_brute_tracer  # noqa: E402
from tpu_raytracing_torch.trace.modes import RenderType  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402
from tpu_raytracing_torch.trace.traverse import pack_pairs  # noqa: E402
from tpu_raytracing_torch.utils.compare import psnr  # noqa: E402
from tpu_raytracing_torch.utils.png import read_png  # noqa: E402

torch.set_num_threads(2)
FIELDS = ("cell_start", "cell_count", "refs", "big", "num_big", "overflow", "grid_min",
          "grid_max", "cell_size", "cell_word")
REC = ("hit", "t", "prim_id", "tri_id", "bary_u", "bary_v")
_jtrace = jax.jit(jgt.trace_rays_grid, static_argnames=("any_hit", "block", "segments",
                                                        "residue_after", "residue_width"))


def to_jax(ugrid, packed):
    """The port's grid and rows as the reference's ``UniformGrid`` and
    ``PackedPairs``."""
    g = jgrid.UniformGrid(res=ugrid.res, **{f: jnp.asarray(getattr(ugrid, f).numpy())
                                            for f in FIELDS})
    return g, JPackedPairs(rows=jnp.asarray(packed.rows.numpy()))


@pytest.fixture(scope="module")
def grids():
    """name -> (scene, port grid, port rows, reference grid, reference rows)."""
    out = {}
    # the soup as large as the terrain (tests/test_torch_grid.py): the two
    # grids are shaped alike, so one compile of the reference's tracer
    # serves both
    for name, scene, pairs in (("soup", jproc.random_triangle_soup(SOUP_TRIS, seed=5), True),
                               ("terrain", jproc.terrain(2000), False),
                               ("cornell", jproc.cornell_box(), False)):
        ugrid, packed = grid.build_grid_from_triangles(torch.from_numpy(scene.triangles), pairs)
        out[name] = (scene, ugrid, packed, *to_jax(ugrid, packed))
    return out


def ray_sets(scene, rng):
    """Camera rays, rays scattered inside the scene (the bounce-like case),
    rays aimed at triangles along their normals and half-dead camera rays:
    {name: ((o, d, tmin, tmax), active)}."""
    c = jcam.camera_to_device(jcam.initialise_camera(scene.aabb_min, scene.aabb_max))
    r = jprimary(c, 16, 16)
    camera = tuple(np.array(a, np.float32) for a in (r.origin, r.direction, r.tmin, r.tmax))
    n = 256
    span = scene.aabb_max - scene.aabb_min
    o = (scene.aabb_min + rng.uniform(0.1, 0.9, (n, 3)) * span).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inner = (o, d, np.zeros(n, np.float32), np.full(n, 1e6, np.float32))
    pick = rng.integers(0, scene.num_triangles, n)
    normal = scene.normals[pick, 0]
    ao = scene.triangles[pick].mean(axis=1) + normal * rng.uniform(0.2, 1.0, (n, 1))
    ad = -normal + rng.normal(scale=0.01, size=(n, 3))
    ad /= np.linalg.norm(ad, axis=1, keepdims=True)
    aimed = (ao.astype(np.float32), ad.astype(np.float32), np.zeros(n, np.float32),
             np.full(n, 1e6, np.float32))
    return {"camera": (camera, None), "interior": (inner, None), "aimed": (aimed, None),
            "half-dead": (camera, rng.random(256) < 0.5)}


def both(arrays):
    return (JRays(*(jnp.asarray(a) for a in arrays)),
            Rays(*(torch.from_numpy(np.array(a)) for a in arrays)))


def assert_records(rec, ref, t_rtol=1e-6, uv=True):
    for f in ("hit", "tri_id", "prim_id"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    hit = rec.hit.numpy()
    np.testing.assert_allclose(rec.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=t_rtol)
    for f in ("bary_u", "bary_v") if uv else ():
        np.testing.assert_allclose(getattr(rec, f).numpy()[hit], np.asarray(getattr(ref, f))[hit],
                                   rtol=1e-6, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any-hit"])
@pytest.mark.parametrize("name", ["soup", "terrain", "cornell"])
def test_trace_rays_grid_matches_jax(name, any_hit, grids):
    scene, ugrid, packed, jg, jp = grids[name]
    rng = np.random.default_rng(31)
    hits = 0
    for set_name, (arrays, active) in ray_sets(scene, rng).items():
        jr, tr = both(arrays)
        ref, jstats = _jtrace(jg, jp, jr, any_hit=any_hit,
                              active=None if active is None else jnp.asarray(active))
        rec, stats = grid_trace.trace_rays_grid(
            ugrid, packed, tr, any_hit=any_hit,
            active=None if active is None else torch.from_numpy(active))
        assert_records(rec, ref, t_rtol=1e-5 if name == "soup" else 1e-6,
                       uv=name != "soup" and set_name != "aimed")
        np.testing.assert_array_equal(stats.box_tests.numpy(), np.asarray(jstats.box_tests),
                                      err_msg=f"{set_name} steps")
        np.testing.assert_array_equal(stats.tri_tests.numpy(), np.asarray(jstats.tri_tests),
                                      err_msg=f"{set_name} tri_tests")
        assert int(stats.overflow) == 0
        if active is not None:
            assert not rec.hit.numpy()[~active].any()
        hits += int(rec.hit.sum())
    assert hits > 64
    if name == "cornell":
        assert int(ugrid.num_big) > 0  # the walls ride the big list


def test_grid_matches_brute_force(grids):
    """Closest hits on every scene against brute force over the triangles
    (identity pairs), any-hit occlusion against the closest hits."""
    for name in ("soup", "terrain", "cornell"):
        scene, ugrid, packed, _, _ = grids[name]
        tris = torch.from_numpy(scene.triangles)
        for arrays, _ in list(ray_sets(scene, np.random.default_rng(9)).values())[:3]:
            _, tr = both(arrays)
            rec, _ = grid_trace.trace_rays_grid(ugrid, packed, tr)
            ref, _ = make_brute_tracer(tris)(None, pack_pairs(identity_pairs(tris)), tr)
            np.testing.assert_array_equal(rec.hit.numpy(), ref.hit.numpy())
            hit = rec.hit.numpy()
            np.testing.assert_allclose(rec.t.numpy()[hit], ref.t.numpy()[hit], rtol=1e-4,
                                       atol=1e-5)
            same = np.isclose(rec.t.numpy(), ref.t.numpy(), rtol=0, atol=0)
            np.testing.assert_array_equal(rec.prim_id.numpy()[hit & same],
                                          ref.prim_id.numpy()[hit & same])
            occ, _ = grid_trace.trace_rays_grid(ugrid, packed, tr, any_hit=True)
            np.testing.assert_array_equal(occ.hit.numpy(), ref.hit.numpy())


@pytest.mark.parametrize("kw", [dict(residue_after=3, residue_width=64),
                                dict(residue_after=1), dict(segments=4),
                                dict(segments=2, residue_after=2, residue_width=32)],
                         ids=["residue-64", "residue-default", "segments", "both"])
def test_residue_and_segments_match_single_phase(kw, grids):
    """The schedules give the single-phase walk's records and counts bit
    for bit, and the reference's scheduled result."""
    scene, ugrid, packed, jg, jp = grids["terrain"]
    arrays, _ = ray_sets(scene, np.random.default_rng(12))["interior"]
    jr, tr = both(arrays)
    base, bstats = grid_trace.trace_rays_grid(ugrid, packed, tr)
    rec, stats = grid_trace.trace_rays_grid(ugrid, packed, tr, **kw)
    for f in REC:
        np.testing.assert_array_equal(getattr(rec, f).numpy(), getattr(base, f).numpy(),
                                      err_msg=f)
    np.testing.assert_array_equal(stats.box_tests.numpy(), bstats.box_tests.numpy())
    np.testing.assert_array_equal(stats.tri_tests.numpy(), bstats.tri_tests.numpy())
    ref, jstats = _jtrace(jg, jp, jr, **kw)
    assert_records(rec, ref)
    np.testing.assert_array_equal(stats.box_tests.numpy(), np.asarray(jstats.box_tests))
    # some rays outlast the first phase, so the residue chunks run
    assert int((bstats.box_tests > kw.get("residue_after", 0)).sum()) > 0


def test_grid_path_trace_matches_jax(grids, monkeypatch):
    """A 1-bounce frame with the grid's closest-hit tracer and its any-hit
    tracer for the shadows, the reference's uniforms fed to the port: the
    same ray count and at least 40 dB."""
    w = h = 32
    scene, ugrid, packed, jg, jp = grids["cornell"]
    host = jcam.update_camera(jcam.initialise_camera(scene.aabb_min, scene.aabb_max))
    img_ref, rays_ref = jpt.path_trace(jg, jp, jscene_to_device(scene), jcam.camera_to_device(host),
                                       w, h, num_bounces=1, key=jax.random.PRNGKey(0),
                                       tracer=jgt.make_grid_tracer(),
                                       shadow_tracer=jgt.make_grid_tracer(any_hit=True))
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(2):  # pathtrace.py: one split and one draw per bounce
        key, k_dir = jax.random.split(key)
        draws.append(np.asarray(jax.random.uniform(k_dir, (w * h, 2))))
    it = iter(draws)
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.from_numpy(np.array(next(it))))
    tcam = cam.update_camera(cam.initialise_camera(scene.aabb_min, scene.aabb_max))
    img, rays = pathtrace.path_trace(ugrid, packed, scene_to_device(scene, "cpu"),
                                     cam.camera_to_device(tcam, "cpu"), w, h, num_bounces=1,
                                     tracer=grid_trace.make_grid_tracer(),
                                     shadow_tracer=grid_trace.make_grid_tracer(any_hit=True))
    assert int(rays) == int(rays_ref)
    db = psnr(np.clip(np.asarray(img_ref), 0, 1), img.clamp(0, 1).numpy(), peak=1.0)
    assert db >= 40.0 and float(img.mean()) > 0


def test_app_grid_scale_and_animate(tmp_path, capsys):
    """``--tracer grid --grid-scale 0.5 --animate`` on cornell: frame 0's
    grid over the ``--type`` tree's rows at ``auto_res3(scale=0.5)``, its
    image the reference's render of that grid at 40 dB; each animated
    frame rebuilds only the grid, from the moved triangles, at frame 0's
    resolution."""
    w, h, mode = 32, 24, RenderType.DIFFUSE
    res = app.main(["--scene", "cornell", "--type", "bottom-up", "--tracer", "grid",
                    "--grid-scale", "0.5", "--animate", "--frames", "3", "--render-mode",
                    str(int(mode)), "--width", str(w), "--height", str(h), "--device", "cpu",
                    "--output", str(tmp_path)])
    out = capsys.readouterr().out
    scene = jproc.cornell_box()
    res3 = grid.auto_res3(scene.aabb_max - scene.aabb_min, scene.num_triangles, 0.5)
    assert res3 != grid.auto_res3(scene.aabb_max - scene.aabb_min, scene.num_triangles)
    assert res["trav"].res == res3 and "Uniform grid" in out
    assert [r["kind"] for r in res["animated"]] == ["rebuild", "rebuild"]
    for r in res["animated"]:
        assert [n.strip() for n, _ in r["stages"]] == ["Animate", "GridBuild"]
    images = [read_png(p) for _, _, _, p in res["frames"]]
    assert all(img.shape == (h, w, 4) for img in images)
    assert not np.array_equal(images[0], images[2])  # the geometry moved
    # frame 0 against the reference's render of the same grid
    from tpu_raytracing_torch.bvh import lbvh

    bvh, pairs = lbvh.build_lbvh(torch.from_numpy(scene.triangles), False)
    packed = pack_pairs(pairs)
    ugrid = grid.build_grid(packed.rows, packed.rows.shape[0], res=res3, **grid.tier_params(0.5))
    jg, jp = to_jax(ugrid, packed)
    jcamera = jcam.camera_to_device(jcam.initialise_camera(scene.aabb_min, scene.aabb_max))
    ref, _ = jrender.render_frame(jg, jp, jscene_to_device(scene), jcamera, w, h,
                                  JRenderType(int(mode)), tracer=jgt.make_grid_tracer())
    assert psnr(images[0], np.asarray(ref)) >= 40.0
    own, _ = render.render_frame(ugrid, packed, scene_to_device(scene, "cpu"),
                                 cam.camera_to_device(cam.initialise_camera(
                                     scene.aabb_min, scene.aabb_max), "cpu"),
                                 w, h, mode, tracer=grid_trace.make_grid_tracer())
    np.testing.assert_array_equal(images[0], own.numpy())
