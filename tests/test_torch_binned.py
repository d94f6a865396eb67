"""The treelet-binned tracer (``trace/binned.py``, the split tracer's
``sort_mode="binned"``) in the PyTorch port against the JAX reference.

Both packages trace the same JAX-built bucket tree (carried over by
``convert.py``) with the reference's test packet size k = 128; the
reference's split kernel runs in Pallas interpret mode with
``c_slots=1`` (128 rays make 1,024 item slots, eight packets). Held equal:
``needed``, ``hit``, and ``tri_id`` but for ties of t within rtol 1e-6;
t to rtol 1e-6: XLA's CPU compiler fuses multiply-adds in the interpreted
kernel's Möller-Trumbore and K1's plain version keeps its own order (it is
bit-equal to K1 on the card), so t moves by up to a few ulps. Statistics
are per ray here and per packet there, so they are not compared. The port
also meets brute force, the active mask, the capacity flag (where the
reference drops items) and the all-miss window at tmax = F32_MAX.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import bucket as jbucket  # noqa: E402
from tpu_raytracing.trace.brute import brute_force_trace as jbrute  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.trace import binned, split_trace  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402

torch.set_num_threads(2)
F32_MAX = float(np.finfo(np.float32).max)
K = 128


@pytest.fixture(scope="module")
def jbinned():
    from jax.experimental import pallas as pl

    from tpu_raytracing.trace import binned as mod

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


def scatter_rays(scene, num, seed, tmax=None):
    """Random origins in and above the scene's box, random directions: the
    incoherent rays binning is for."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.aabb_min, scene.aabb_max
    o = lo + rng.random((num, 3)) * (hi - lo) * np.float32([1.0, 1.6, 1.0])
    d = rng.normal(size=(num, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    far = float((hi - lo).max()) * 4.0 if tmax is None else tmax
    return [np.asarray(a, np.float32) for a in (o, d, np.zeros(num), np.full(num, far))]


def both(arrays):
    return (JRays(*(jnp.asarray(a) for a in arrays)),
            Rays(*(torch.from_numpy(np.array(a)) for a in arrays)))


def assert_records_match(rec, ref):
    """hit exactly; t to rtol 1e-6; tri_id exactly but for ties of t within
    that distance (at most two rays)."""
    hit = rec.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    t, rt = rec.t.numpy(), np.asarray(ref.t)
    np.testing.assert_allclose(np.where(hit, t, 0.0), np.where(hit, rt, 0.0), rtol=1e-6)
    tri, rtri = rec.tri_id.numpy(), np.asarray(ref.tri_id)
    tie = hit & (tri != rtri)
    assert tie.sum() <= 2
    np.testing.assert_array_equal(np.where(tie, 0, tri), np.where(tie, 0, rtri))


@pytest.mark.parametrize("any_hit", [False, True])
def test_binned_matches_reference(sphere, tree, jbinned, any_hit):
    jviews, jpacked, views, packed = tree
    jr, tr = both(scatter_rays(sphere, K, 11))
    ref, _, jneeded = jbinned.trace_rays_binned(jviews, jpacked, jr, any_hit=any_hit, k=K,
                                                c_slots=1, return_needed=True)
    rec, stats, needed = binned.trace_rays_binned(views, packed, tr, any_hit=any_hit, k=K,
                                                  return_needed=True)
    assert int(needed) == int(jneeded) <= binned.item_capacity(K, K, 2.0)
    assert int(stats.overflow) == 0
    assert int(rec.hit.sum()) > 16
    if any_hit:
        np.testing.assert_array_equal(rec.hit.numpy(), np.asarray(ref.hit))
        np.testing.assert_array_equal(rec.t.numpy(), np.asarray(jr.tmax))
    else:
        assert_records_match(rec, ref)
    # the split tracer's sort mode is this function, with the port's packet size
    rec1, _ = binned.trace_rays_binned(views, packed, tr, any_hit=any_hit)
    rec2, _ = split_trace.make_split_tracer(16, 8, any_hit=any_hit, sort_mode="binned")(
        views, packed, tr)
    for f in ("hit", "t", "tri_id", "prim_id"):
        np.testing.assert_array_equal(getattr(rec2, f).numpy(), getattr(rec1, f).numpy())
        np.testing.assert_array_equal(getattr(rec1, f).numpy()[rec.hit.numpy()],
                                      getattr(rec, f).numpy()[rec.hit.numpy()])


def test_binned_brute_force_and_active_mask(sphere, tree):
    """Against brute force on 512 scattered rays (hit exactly, t to rtol
    1e-5, the primitive but for exact-t ties), with every third ray dead;
    per-ray tests only for live rays."""
    _, jpacked, views, packed = tree
    arrays = scatter_rays(sphere, 512, 12)
    jr, tr = both(arrays)
    ref = jbrute(jnp.asarray(sphere.triangles), jr)
    act = np.arange(512) % 3 != 0
    rec, stats = binned.trace_rays_binned(views, packed, tr, active=torch.from_numpy(act))
    assert int(stats.overflow) == 0
    hit = rec.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref.hit) & act)
    np.testing.assert_allclose(rec.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-5)
    prim_ok = (rec.prim_id.numpy() == np.asarray(ref.prim_id)) | (rec.t.numpy() == np.asarray(
        ref.t))
    assert prim_ok[hit].all()
    np.testing.assert_array_equal(rec.t.numpy()[~act], arrays[3][~act])
    assert not stats.box_tests.numpy()[~act].any() and (stats.box_tests.numpy()[act] > 0).any()
    # the same through the presorted tracer
    pre, _ = split_trace.trace_rays_split(views, packed, tr, active=torch.from_numpy(act))
    np.testing.assert_array_equal(pre.hit.numpy(), hit)


def test_binned_capacity_flag(sphere, tree):
    """A cap_factor too small for the items: the reference drops the items
    past the cap without a word (binned.py:115-116); the port drops the
    same items and sets TraceStats.overflow, and path_trace's check raises
    on it."""
    _, _, views, packed = tree
    num = 1024
    _, tr = both(scatter_rays(sphere, num, 13))
    rec, stats, needed = binned.trace_rays_binned(views, packed, tr, k=K, cap_factor=0.25,
                                                  return_needed=True)
    cap = binned.item_capacity(num, K, 0.25)
    assert int(needed) > cap and int(stats.overflow) == 1
    with pytest.raises(RuntimeError, match="binned"):
        split_trace.check_overflow(stats.overflow)
    full, full_stats = binned.trace_rays_binned(views, packed, tr, k=K)
    assert int(full_stats.overflow) == 0
    # the dropped items lose hits
    assert int(rec.hit.sum()) < int(full.hit.sum())


def test_binned_all_miss_window_is_a_miss(sphere, tree):
    """Rays with tmax = F32_MAX that enter a leaf window and miss all of
    it: K1's raw output names the window's last slot at t = F32_MAX (the
    reference's phantom hit); the binned record calls the ray a miss, as
    the presorted one does."""
    _, _, views, packed = tree
    arrays = scatter_rays(sphere, 512, 14, tmax=F32_MAX)
    _, tr = both(arrays)
    rec, stats = binned.trace_rays_binned(views, packed, tr, k=K, cap_factor=4.0)
    assert int(stats.overflow) == 0
    pre, _ = split_trace.trace_rays_split(views, packed, tr)
    (t_raw, tri_raw), _ = split_trace.trace_rays_split(views, packed, tr, raw=True)
    phantom = (tri_raw >= 0) & (t_raw == F32_MAX)
    assert int(phantom.sum()) > 0
    assert not rec.hit[phantom].any()
    np.testing.assert_array_equal(rec.hit.numpy(), pre.hit.numpy())
    np.testing.assert_allclose(rec.t.numpy()[pre.hit.numpy()], pre.t.numpy()[pre.hit.numpy()],
                               rtol=0)
