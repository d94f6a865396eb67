"""PyTorch port's scalar wavefront tracer (``trace_rays``) vs the JAX
reference's, on trees both build bit-equal.

hit, tri_id, prim_id and the per-ray box_tests and tri_tests are held
exactly. t is held to rtol 1e-6: XLA's CPU compiler may contract the
Möller-Trumbore products into fused multiply-adds, so the two differ by an
ulp or two. u and v are products of 1/det with such sums, which multiplies
those ulps by 10-100 on the cornell box and the sphere: they are held to
atol 1e-5 (and rtol 1e-6), an absolute bound because near a triangle's
edge they approach 0, where a relative one means nothing. Rays aimed at
small triangles from close by, and the soup's rays, meet triangles small
against their distance, where 1/det multiplies those ulps of u and v by
up to 1e4: there u and v are not compared (hit, tri_id, prim_id and the
counters still are), and on the soup t is held to rtol 1e-5, the split
tests' bar against brute force.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import lbvh as jlbvh  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.trace import traverse as jtraverse  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jprimary  # noqa: E402
from tpu_raytracing_torch.bvh import lbvh  # noqa: E402
from tpu_raytracing_torch.trace import split_trace  # noqa: E402
from tpu_raytracing_torch.trace import traverse  # noqa: E402
from tpu_raytracing_torch.trace.brute import brute_force_trace  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402

torch.set_num_threads(2)
_jbuild = jax.jit(jlbvh.build_lbvh, static_argnames="enable_pairs")
_jtrace = jax.jit(jtraverse.trace_rays)


def aimed_rays(scene, rng, num):
    """Rays shot at triangles along their normals, from 0.5-3 units away."""
    pick = rng.integers(0, scene.num_triangles, num)
    n = scene.normals[pick, 0]
    o = scene.triangles[pick].mean(axis=1) + n * rng.uniform(0.5, 3.0, (num, 1))
    d = -n + rng.normal(scale=0.05, size=(num, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32), np.zeros(num, np.float32),
            np.full(num, 1e6, np.float32))


def ray_sets(scene, rng):
    """Camera, axis-aligned, random, aimed and half-dead rays as numpy
    arrays: {name: ((origin, direction, tmin, tmax), active or None)}."""
    c = jcam.camera_to_device(jcam.update_camera(
        jcam.initialise_camera(scene.aabb_min, scene.aabb_max)))
    r = jprimary(c, 16, 16)
    cam = tuple(np.asarray(a, np.float32) for a in (r.origin, r.direction, r.tmin, r.tmax))
    lo, hi = scene.aabb_min.astype(np.float64), scene.aabb_max.astype(np.float64)
    n = 8
    gx, gz = np.meshgrid(np.linspace(lo[0] + 1e-3, hi[0] - 1e-3, n),
                         np.linspace(lo[2] + 1e-3, hi[2] - 1e-3, n))
    o = np.stack([gx.ravel(), np.full(n * n, hi[1] + 1.0), gz.ravel()], 1)
    d = np.tile([0.0, -1.0, 0.0], (n * n, 1))
    d[::5] = [-0.0, -1.0, 0.0]  # a negative zero takes the safe inverse's +1e-30
    m = 256
    ro = lo + (hi - lo) * rng.random((m, 3))
    rd = rng.normal(size=(m, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)

    def arrays(o, d):
        k = o.shape[0]
        return (o.astype(np.float32), d.astype(np.float32), np.zeros(k, np.float32),
                np.full(k, 1e6, np.float32))

    return {"camera": (cam, None), "axis-aligned": (arrays(o, d), None),
            "random": (arrays(ro, rd), None), "aimed": (aimed_rays(scene, rng, 1024), None),
            "half-dead": (cam, rng.random(256) < 0.5)}


def both_rays(arrays):
    return (JRays(*(jnp.asarray(a) for a in arrays)),
            Rays(*(torch.from_numpy(np.array(a)) for a in arrays)))


def _trees(scene, pairs):
    jb, jp = _jbuild(jnp.asarray(scene.triangles), enable_pairs=pairs)
    tb, tp = lbvh.build_lbvh(torch.from_numpy(scene.triangles), pairs)
    return ((jtraverse.pack_bvh(jb), jtraverse.pack_pairs(jp)),
            (traverse.pack_bvh(tb), traverse.pack_pairs(tp)))


def assert_records_close(rec, ref, exact=("hit", "tri_id", "prim_id"), uv=True, t_rtol=1e-6):
    for f in exact:
        np.testing.assert_array_equal(getattr(rec, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    hit = rec.hit.numpy()
    np.testing.assert_allclose(rec.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=t_rtol)
    for f in ("bary_u", "bary_v") if uv else ():
        np.testing.assert_allclose(getattr(rec, f).numpy()[hit], np.asarray(getattr(ref, f))[hit],
                                   rtol=1e-6, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("name,pairs", [("cornell", True), ("sphere", False),
                                        ("sphere", True), ("soup", True)])
def test_trace_rays_matches_jax(name, pairs, request):
    rng = np.random.default_rng(109)  # its own: the shared rng fixture depends on file order
    scene = request.getfixturevalue(name)
    (jtrav, jpacked), (trav, packed) = _trees(scene, pairs)
    total_hits = 0
    for set_name, (arrays, active) in ray_sets(scene, rng).items():
        jr, tr = both_rays(arrays)
        ref, jstats = _jtrace(jtrav, jpacked, jr,
                              active=None if active is None else jnp.asarray(active))
        rec, stats = traverse.trace_rays(trav, packed, tr, active=None if active is None
                                         else torch.from_numpy(active))
        assert_records_close(rec, ref, uv=name != "soup" and set_name != "aimed",
                             t_rtol=1e-5 if name == "soup" else 1e-6)
        np.testing.assert_array_equal(stats.box_tests.numpy(), np.asarray(jstats.box_tests))
        np.testing.assert_array_equal(stats.tri_tests.numpy(), np.asarray(jstats.tri_tests))
        assert int(stats.overflow) == 0, set_name
        if active is not None:
            assert not rec.hit.numpy()[~active].any()
            assert (stats.box_tests.numpy()[~active] == 0).all()
        total_hits += int(rec.hit.sum())
    assert total_hits > 16


def test_trace_rays_matches_brute_force(soup):
    """Rays shot at triangles along their normals: the scalar tracer finds
    brute force's closest hit (t to rtol 1e-5, as in the split tests)."""
    _, (trav, packed) = _trees(soup, False)
    _, tr = both_rays(aimed_rays(soup, np.random.default_rng(3), 512))
    rec, _ = traverse.trace_rays(trav, packed, tr)
    ref = brute_force_trace(torch.from_numpy(soup.triangles), tr)
    np.testing.assert_array_equal(rec.hit.numpy(), ref.hit.numpy())
    hit = rec.hit.numpy()
    assert hit.sum() > 8
    np.testing.assert_allclose(rec.t.numpy()[hit], ref.t.numpy()[hit], rtol=1e-5)
    np.testing.assert_array_equal(rec.prim_id.numpy()[hit], ref.prim_id.numpy()[hit])


def test_overflow_flag_with_a_small_stack(sphere, monkeypatch):
    """A stack too small for the tree raises the overflow flag, stops the
    ray instead of overwriting its top entry, and path_trace's check raises."""
    _, (trav, packed) = _trees(sphere, False)
    c = jcam.camera_to_device(jcam.update_camera(
        jcam.initialise_camera(sphere.aabb_min, sphere.aabb_max)))
    r = jprimary(c, 8, 8)
    _, tr = both_rays(tuple(np.asarray(a, np.float32) for a in (r.origin, r.direction, r.tmin,
                                                                 r.tmax)))
    _, stats = traverse.trace_rays(trav, packed, tr)
    split_trace.check_overflow(stats.overflow)
    monkeypatch.setattr(traverse, "STACK_DEPTH", 2)
    _, small = traverse.trace_rays(trav, packed, tr)
    assert int(small.overflow) == 1
    assert (small.box_tests <= stats.box_tests).all()
    with pytest.raises(RuntimeError, match="stack overflow"):
        split_trace.check_overflow(small.overflow)


def test_pack_bvh_meta_layout(cornell):
    """meta = child << 5 | min(count, 7) << 2 | type, floats bit-cast."""
    tb, _ = lbvh.build_lbvh(torch.from_numpy(cornell.triangles), True)
    rows = traverse.pack_bvh(tb).rows
    meta = rows[:, 6]
    np.testing.assert_array_equal((meta >> 5).numpy(), tb.child.numpy())
    np.testing.assert_array_equal(((meta >> 2) & 7).numpy(), tb.count.clamp(0, 7).numpy())
    np.testing.assert_array_equal((meta & 3).numpy(), tb.type.numpy())
    np.testing.assert_array_equal(traverse.i2f(rows[:, :3]).numpy(), tb.node_min.numpy())
    assert (rows[:, 7] == 0).all()
