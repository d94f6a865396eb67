"""The split tracer's sort modes (``make_split_tracer``'s ``"origin"``,
``"cell_octant"`` and ``sort_origin=True``) in the PyTorch port against the
JAX reference.

The sort keys and the stable permutation equal the reference's bit for bit
(the key as ``split_pallas.py:1928-1946`` and ``:1965-1970`` compute it,
over the JAX package's ``morton3d``), with and without dead rays. Each
mode's record equals the ``"presorted"`` tracer's on the same rays, field
for field (the per-ray traversal does not depend on the order), and meets
brute force (hit exactly, t to rtol 1e-5). Each mode also meets the
reference's tracer with its split kernel in Pallas interpret mode
(``c_slots=1``, 128 rays, one packet): hit exactly and, in closest-hit, t
to rtol 1e-6 and tri_id but for ties within that distance, since XLA's CPU
compiler fuses multiply-adds in the interpreted kernel and K1's plain
version does not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import bucket as jbucket  # noqa: E402
from tpu_raytracing.ops.morton import morton3d as jmorton3d  # noqa: E402
from tpu_raytracing.trace.brute import brute_force_trace as jbrute  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.trace import split_trace  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402

torch.set_num_threads(2)
K = 128
MODES = [("origin", False), ("cell_octant", False), (None, True)]


@pytest.fixture(scope="module")
def jsp():
    from jax.experimental import pallas as pl

    from tpu_raytracing.trace import split_pallas as mod

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    yield mod
    pl.pallas_call = orig


@pytest.fixture(scope="module")
def tree(sphere):
    fn = jax.jit(lambda t: jbucket.emit_split_views(
        jbucket.split_front(t, enable_pairs=True), leaf_width=split_trace.LEAFW))
    jviews, jpacked, _ = fn(jnp.asarray(sphere.triangles))
    views = convert.split_views_from_numpy(*(np.asarray(a) for a in jviews), "cpu")
    packed = convert.packed_from_numpy(np.asarray(jpacked.rows), "cpu")
    return jviews, jpacked, views, packed


def scatter_rays(scene, num, seed):
    rng = np.random.default_rng(seed)
    lo, hi = scene.aabb_min, scene.aabb_max
    o = lo + rng.random((num, 3)) * (hi - lo) * np.float32([1.0, 1.6, 1.0])
    d = rng.normal(size=(num, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::9, 1] = 0.0  # some octants decided by a zero component
    far = float((hi - lo).max()) * 4.0
    return [np.asarray(a, np.float32) for a in (o, d, np.zeros(num), np.full(num, far))]


def both(arrays):
    return (JRays(*(jnp.asarray(a) for a in arrays)),
            Rays(*(torch.from_numpy(np.array(a)) for a in arrays)))


def reference_key(rays, active, sort_mode, sort_origin, cell_shift=9):
    """The reference tracer's sort key, as split_pallas.py computes it."""
    o = rays.origin
    lo = jnp.min(o, axis=0)
    hi = jnp.max(o, axis=0)
    unit = (o - lo) / jnp.maximum(hi - lo, 1e-20)
    if sort_origin:
        key = (jmorton3d(unit) >> jnp.uint32(2)).astype(jnp.int32)
    else:
        cell = jmorton3d(unit).astype(jnp.int32)
        if sort_mode == "cell_octant":
            d = rays.direction
            octant = ((d[:, 0] > 0).astype(jnp.int32) | ((d[:, 1] > 0).astype(jnp.int32) << 1)
                      | ((d[:, 2] > 0).astype(jnp.int32) << 2))
            key = ((cell >> cell_shift) << 3) | octant
        else:
            key = cell >> 2
    dead = jnp.zeros(key.shape, jnp.int32) if active is None else (~active).astype(jnp.int32)
    return (dead << 28) | key


@pytest.mark.parametrize("sort_mode,sort_origin", MODES)
def test_sort_keys_and_permutation_bit_equal(sphere, sort_mode, sort_origin):
    jr, tr = both(scatter_rays(sphere, 2048, 21))
    act = np.random.default_rng(22).random(2048) < 0.8
    for active in (None, act):
        jkey = reference_key(jr, None if active is None else jnp.asarray(active), sort_mode,
                             sort_origin)
        key = split_trace.sort_keys(tr, None if active is None else torch.from_numpy(active),
                                    "origin" if sort_origin else sort_mode)
        np.testing.assert_array_equal(key.numpy(), np.asarray(jkey).astype(np.int64))
        np.testing.assert_array_equal(torch.argsort(key, stable=True).numpy(),
                                      np.asarray(jnp.argsort(jkey, stable=True)))
        assert len(np.unique(np.asarray(jkey))) > 64  # the key separates the rays


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("sort_mode,sort_origin", MODES)
def test_modes_equal_presorted_and_brute(sphere, tree, sort_mode, sort_origin, any_hit):
    _, _, views, packed = tree
    jr, tr = both(scatter_rays(sphere, 1024, 23))
    act = torch.from_numpy(np.arange(1024) % 4 != 0)
    tracer = split_trace.make_split_tracer(32, 32, any_hit=any_hit, sort_mode=sort_mode,
                                           sort_origin=sort_origin)
    rec, stats = tracer(views, packed, tr, active=act)
    pre, pstats = split_trace.make_split_tracer(32, 32, any_hit=any_hit, sort_mode="presorted")(
        views, packed, tr, active=act)
    np.testing.assert_array_equal(rec.hit.numpy(), pre.hit.numpy())
    if not (any_hit or sort_origin):
        # the whole record and the statistics come back in the caller's order
        for f in ("t", "tri_id", "prim_id", "bary_u", "bary_v"):
            np.testing.assert_array_equal(getattr(rec, f).numpy(), getattr(pre, f).numpy())
        np.testing.assert_array_equal(stats.box_tests.numpy(), pstats.box_tests.numpy())
        np.testing.assert_array_equal(stats.tri_tests.numpy(), pstats.tri_tests.numpy())
    ref = jbrute(jnp.asarray(sphere.triangles), jr)
    hit = rec.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref.hit) & act.numpy())
    if not (any_hit or sort_origin):
        np.testing.assert_allclose(rec.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-5)
    assert hit.sum() > 64


@pytest.mark.parametrize("sort_mode,sort_origin", MODES)
def test_modes_match_pallas(sphere, tree, jsp, sort_mode, sort_origin):
    jviews, jpacked, views, packed = tree
    any_hit = sort_origin
    jr, tr = both(scatter_rays(sphere, K, 24))
    act = np.arange(K) % 5 != 0
    jtracer = jsp.make_split_pallas_tracer(jviews, jpacked, 16, 8, any_hit=any_hit,
                                           sort_mode=sort_mode, sort_origin=sort_origin, k=K,
                                           c_slots=1)
    ref, _ = jtracer(None, None, jr, active=jnp.asarray(act))
    rec, _ = split_trace.make_split_tracer(16, 8, any_hit=any_hit, sort_mode=sort_mode,
                                           sort_origin=sort_origin)(
        views, packed, tr, active=torch.from_numpy(act))
    hit = rec.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    assert hit.sum() > 16
    if not any_hit:
        np.testing.assert_allclose(rec.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-6)
        tri, rtri = rec.tri_id.numpy(), np.asarray(ref.tri_id)
        tie = hit & (tri != rtri)
        assert tie.sum() <= 2
        np.testing.assert_array_equal(np.where(tie, 0, tri), np.where(tie, 0, rtri))
