"""The breadth-first wavefront tracer (``trace/wavefront_bfs.py``) in the
PyTorch port against the JAX reference's pure-XLA ``trace_rays_bfs``.

Both packages trace the same JAX-built bucket tree, its views carried over
by ``convert.bfs_views_from_numpy``. Held equal bit for bit: hit, t,
tri_id, prim_id, the per-ray box and triangle tests and the overflow flag,
at the default caps and at caps so small that levels drop visits, in
closest-hit and any-hit, with an active mask. (XLA's CPU compiler fuses no
multiply-add in the reference's Möller-Trumbore here, so the port's
unfused one is bit-equal.) ``make_bfs_tracer`` carries the flag in
``TraceStats.overflow``, which the reference's drops, and visits left after
the last level set it too, where the reference drops them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import bucket as jbucket  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.trace import wavefront_bfs as jbfs  # noqa: E402
from tpu_raytracing.trace.brute import brute_force_trace as jbrute  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jprimary  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import bucket  # noqa: E402
from tpu_raytracing_torch.trace import split_trace, wavefront_bfs  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402

torch.set_num_threads(2)
SCENES = [("cornell", False, 16), ("sphere", True, 16), ("soup", False, 8)]
TINY = dict(cap_factor=0.05, leaf_factor=0.02, cap_floor=8)


def trees(scene, pairs, lw):
    tris = jnp.asarray(scene.triangles)
    split, jpacked = jax.jit(lambda t: jbucket.build_bucket_split(t, pairs, leaf_width=lw))(tris)
    jviews = jbfs.prep_bfs_views(split, jpacked)
    views = convert.bfs_views_from_numpy(np.asarray(jviews.inner_i), np.asarray(
        jviews.pair_rows), jviews.leaf_width, "cpu")
    return (jviews, jpacked), (views, convert.packed_from_numpy(np.asarray(jpacked.rows), "cpu"))


def rays_for(scene, seed, w=32, h=16):
    """Camera rays, and for half of them random origins and directions in
    the scene's box (incoherent rays, many levels)."""
    c = jcam.camera_to_device(jcam.update_camera(
        jcam.initialise_camera(scene.aabb_min, scene.aabb_max)))
    r = jprimary(c, w, h)
    o, d, lo, hi = (np.array(a, np.float32) for a in (r.origin, r.direction, r.tmin, r.tmax))
    rng = np.random.default_rng(seed)
    n = o.shape[0] // 2
    o[:n] = scene.aabb_min + rng.random((n, 3)) * (scene.aabb_max - scene.aabb_min)
    dd = rng.normal(size=(n, 3))
    d[:n] = dd / np.linalg.norm(dd, axis=1, keepdims=True)
    return o, d, lo, hi


def both(arrays):
    return (JRays(*(jnp.asarray(a) for a in arrays)),
            Rays(*(torch.from_numpy(np.array(a)) for a in arrays)))


def assert_same(out, ref):
    rec, stats, ov = out
    jrec, jstats, jov = ref
    for f in ("hit", "t", "tri_id", "prim_id"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(), np.asarray(getattr(jrec, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(stats.box_tests.numpy(), np.asarray(jstats.box_tests))
    np.testing.assert_array_equal(stats.tri_tests.numpy(), np.asarray(jstats.tri_tests))
    assert bool(ov) == bool(jov) == bool(int(stats.overflow))


@pytest.mark.parametrize("name,pairs,lw", SCENES)
def test_bfs_matches_reference(name, pairs, lw, request):
    scene = request.getfixturevalue(name)
    (jviews, jpacked), (views, packed) = trees(scene, pairs, lw)
    arrays = rays_for(scene, 41)
    jr, tr = both(arrays)
    act = np.random.default_rng(42).random(arrays[0].shape[0]) < 0.75
    for kw, active in ((dict(), None), (dict(), act), (dict(any_hit=True), act), (TINY, None),
                       (dict(TINY, any_hit=True), act)):
        jact = None if active is None else jnp.asarray(active)
        tact = None if active is None else torch.from_numpy(active)
        ref = jbfs.trace_rays_bfs(jviews, jpacked, jr, active=jact, **kw)
        out = wavefront_bfs.trace_rays_bfs(views, packed, tr, active=tact, **kw)
        assert_same(out, ref)
        assert bool(out[2]) == (kw.get("cap_floor") == 8), kw
        if not kw:
            assert int(out[0].hit.sum()) > 0


def test_bfs_brute_force_and_level_visits(sphere):
    """The port's own tree (bit-equal to the reference's) against brute
    force (hit exactly, t to rtol 1e-5, the primitive but for exact-t
    ties); the visit counts per level add up to the box tests."""
    tris = torch.from_numpy(sphere.triangles)
    split, packed = bucket.build_bucket_split(tris, True, leaf_width=16)
    views = wavefront_bfs.prep_bfs_views(split, packed)
    arrays = rays_for(sphere, 43)
    jr, tr = both(arrays)
    levels = []
    rec, stats, ov = wavefront_bfs.trace_rays_bfs(views, packed, tr, level_visits=levels)
    assert not bool(ov)
    ref = jbrute(jnp.asarray(sphere.triangles), jr)
    hit = rec.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_allclose(rec.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-5)
    ok = (rec.prim_id.numpy() == np.asarray(ref.prim_id)) | (rec.t.numpy() == np.asarray(ref.t))
    assert ok[hit].all() and hit.sum() > 64
    w = views.inner.shape[1]
    assert sum(v for v, _, _ in levels) * w == int(stats.box_tests.sum())
    assert sum(lv for _, _, lv in levels) * 2 * 16 == int(stats.tri_tests.sum())
    assert levels[0][0] == arrays[0].shape[0]
    assert [n for _, n, _ in levels[:-1]] == [v for v, _, _ in levels[1:]]


def test_bfs_tracer_carries_the_flag(sphere):
    """make_bfs_tracer's TraceStats.overflow is the flag (the reference's
    tracer drops it), and check_overflow raises on it; too few levels set
    it as well, where the reference's result silently loses the deeper
    visits."""
    (jviews, jpacked), (views, packed) = trees(sphere, False, 16)
    jr, tr = both(rays_for(sphere, 44))
    _, stats = wavefront_bfs.make_bfs_tracer(views, packed)(None, None, tr)
    split_trace.check_overflow(stats.overflow)
    _, small = wavefront_bfs.make_bfs_tracer(views, packed, **TINY)(None, None, tr)
    assert int(small.overflow) == 1
    with pytest.raises(RuntimeError, match="BFS"):
        split_trace.check_overflow(small.overflow)
    # two levels for a deeper tree: the reference drops the rest unflagged
    jrec, _, jov = jbfs.trace_rays_bfs(jviews, jpacked, jr, max_levels=2)
    rec, _, ov = wavefront_bfs.trace_rays_bfs(views, packed, tr, max_levels=2)
    full, _, _ = wavefront_bfs.trace_rays_bfs(views, packed, tr)
    assert not bool(jov) and bool(ov)
    np.testing.assert_array_equal(rec.hit.numpy(), np.asarray(jrec.hit))
    assert int(rec.hit.sum()) < int(full.hit.sum())
