"""PyTorch port's split-BVH traversal (K1's plain version on the CPU) vs the
JAX reference: brute force, the Pallas kernels in interpret mode, and a
JAX-built tree traced by the port.

As in tests/test_split_pallas.py, hits are held to brute force on ``hit``,
``t`` (rtol 1e-5) and ``prim_id``: exact-t ties between neighbouring
triangles may pick another ``tri_id`` than the TPU kernel's packet order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import bucket as jbucket  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.trace.brute import brute_force_trace as jbrute  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jprimary  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import bucket as tbucket  # noqa: E402
from tpu_raytracing_torch.trace import split_trace as st  # noqa: E402
from tpu_raytracing_torch.trace.brute import brute_force_trace as tbrute  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402

torch.set_num_threads(2)
# the reference's bucket tree and K1 views, one jit for the module's cases
_jviews = jax.jit(lambda t: jbucket.emit_split_views(
    jbucket.split_front(t, enable_pairs=True), leaf_width=st.LEAFW))


def _np_rays(rays):
    return tuple(np.asarray(a, np.float32) for a in (rays.origin, rays.direction, rays.tmin,
                                                      rays.tmax))


def _both(o, d, lo, hi):
    """The same numpy rays as a JAX Rays and a port Rays."""
    return (JRays(*(jnp.asarray(a) for a in (o, d, lo, hi))),
            Rays(*(torch.from_numpy(np.array(a)) for a in (o, d, lo, hi))))


def _camera_rays(scene, width, height):
    c = jcam.camera_to_device(jcam.update_camera(
        jcam.initialise_camera(scene.aabb_min, scene.aabb_max)))
    return _np_rays(jprimary(c, width, height))


def _port_tree(scene, pairs):
    tris = torch.from_numpy(scene.triangles)
    views, packed, _ = tbucket.emit_split_views(tbucket.split_front(tris, pairs),
                                                leaf_width=st.LEAFW)
    return views, packed


def _assert_matches(rec, ref, live=None):
    hit = rec.hit.numpy()
    ref_hit = np.asarray(ref.hit)
    if live is not None:
        ref_hit = ref_hit & live
    np.testing.assert_array_equal(hit, ref_hit)
    np.testing.assert_allclose(np.where(hit, rec.t.numpy(), 0.0),
                               np.where(hit, np.asarray(ref.t), 0.0), rtol=1e-5)
    np.testing.assert_array_equal(np.where(hit, rec.prim_id.numpy(), 0),
                                  np.where(hit, np.asarray(ref.prim_id), 0))


@pytest.mark.parametrize("name,pairs", [("cornell", True), ("sphere", False),
                                        ("sphere", True), ("soup", True)])
def test_plain_matches_brute(name, pairs, request):
    scene = request.getfixturevalue(name)
    views, packed = _port_tree(scene, pairs)
    o, d, lo, hi = _camera_rays(scene, 32, 32)
    if name == "soup":
        # The camera sees few soup triangles: shoot at triangles along their
        # normals instead (grazing hits on these tiny triangles are
        # ill-conditioned in t at the 1e-5 bar).
        rng = np.random.default_rng(3)
        pick = rng.integers(0, scene.num_triangles, 1024)
        n = scene.normals[pick, 0]
        target = scene.triangles[pick].mean(axis=1)
        o = (target + n * rng.uniform(0.5, 3.0, (1024, 1))).astype(np.float32)
        d = (-n + rng.normal(scale=0.05, size=(1024, 3))).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    jr, tr = _both(o, d, lo, hi)
    ref = jbrute(jnp.asarray(scene.triangles), jr)
    assert int(np.asarray(ref.hit).sum()) > 16
    rec, stats = st.trace_rays_split(views, packed, tr)
    _assert_matches(rec, ref)
    w = views[0].shape[1]
    assert (stats.box_tests % w == 0).all() and (stats.box_tests >= w).all()
    assert (stats.tri_tests % (2 * st.LEAFW) == 0).all()
    # any-hit finds the same occluded set and reports t = tmax
    arec, _ = st.trace_rays_split(views, packed, tr, any_hit=True)
    np.testing.assert_array_equal(arec.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(arec.t.numpy(), hi)
    # the port's own oracle agrees with the reference's
    _assert_matches(tbrute(torch.from_numpy(scene.triangles), tr), ref)


def test_dead_and_axis_aligned_rays(sphere):
    rng = np.random.default_rng(106)  # its own: the shared rng fixture depends on file order
    views, packed = _port_tree(sphere, True)
    lo, hi = sphere.aabb_min, sphere.aabb_max
    n = 16
    gx, gz = np.meshgrid(np.linspace(lo[0] + 1e-3, hi[0] - 1e-3, n),
                         np.linspace(lo[2] + 1e-3, hi[2] - 1e-3, n))
    o = np.stack([gx.ravel(), np.full(n * n, hi[1] + 1.0), gz.ravel()], 1).astype(np.float32)
    d = np.tile(np.float32([0.0, -1.0, 0.0]), (n * n, 1))
    d[::7] = [-0.0, -1.0, -0.0]  # negative zeros sanitise to +1e-30
    tmin = np.zeros(n * n, np.float32)
    tmax = np.full(n * n, 1e6, np.float32)
    jr, tr = _both(o, d, tmin, tmax)
    ref = jbrute(jnp.asarray(sphere.triangles), jr)
    assert int(np.asarray(ref.hit).sum()) > 8
    rec, _ = st.trace_rays_split(views, packed, tr)
    _assert_matches(rec, ref)
    live = rng.random(n * n) < 0.5
    rec, stats = st.trace_rays_split(views, packed, tr, active=torch.from_numpy(live))
    _assert_matches(rec, ref, live=live)
    # a dead ray pops the root row only, and its record keeps its own tmax
    assert (stats.box_tests[~torch.from_numpy(live)] == views[0].shape[1]).all()
    np.testing.assert_array_equal(rec.t.numpy()[~live], tmax[~live])


def test_non_tiling_frame(cornell):
    """A 24x10 frame does not tile by 16x16: the tiled tracer edge-pads,
    masks the pad dead and crops back."""
    views, packed = _port_tree(cornell, True)
    o, d, lo, hi = _camera_rays(cornell, 24, 10)
    jr, tr = _both(o, d, lo, hi)
    ref = jbrute(jnp.asarray(cornell.triangles), jr)
    rec, stats = st.make_split_tracer(24, 10)(views, packed, tr)
    assert rec.hit.shape == (240,) and stats.box_tests.shape == (240,)
    _assert_matches(rec, ref)
    presorted, _ = st.make_split_tracer(24, 10, sort_mode="presorted")(views, packed, tr)
    for a, b in zip((rec.hit, rec.t, rec.tri_id), (presorted.hit, presorted.t, presorted.tri_id)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_jax_built_tree_traced_by_port(sphere):
    (inner_i, inner_v, pairs_f), jpacked, _ = _jviews(jnp.asarray(sphere.triangles))
    views = convert.split_views_from_numpy(np.asarray(inner_i), np.asarray(inner_v),
                                           np.asarray(pairs_f), "cpu")
    packed = convert.packed_from_numpy(np.asarray(jpacked.rows), "cpu")
    o, d, lo, hi = _camera_rays(sphere, 32, 32)
    jr, tr = _both(o, d, lo, hi)
    ref = jbrute(jnp.asarray(sphere.triangles), jr)
    rec, stats = st.trace_rays_split(views, packed, tr)
    _assert_matches(rec, ref)
    # the port's own tree is bit-equal, so the traversal is identical too
    own, own_stats = st.trace_rays_split(*_port_tree(sphere, True), tr)
    for a, b in ((rec.tri_id, own.tri_id), (rec.t, own.t),
                 (stats.box_tests, own_stats.box_tests)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.fixture(scope="module")
def pallas_sp():
    """The reference split kernels in Pallas interpret mode, as
    tests/test_split_pallas.py runs them off the TPU."""
    from jax.experimental import pallas as pl

    from tpu_raytracing.trace import split_pallas as sp_mod

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    yield sp_mod
    pl.pallas_call = orig


@pytest.mark.parametrize("kernel_v", [2, 3, 4, 5])
def test_plain_matches_pallas_kernel(sphere, pallas_sp, kernel_v):
    """The port's one tracer (K1's plain version here) against each of the
    reference's kernel versions. For kernel_v=5 the reference runs the v3
    kernel and the port is also held to brute force, not to the Pallas v5
    kernel, whose stack can drop entries (ROADMAP Queue 3); 2, 3 and 4 run
    their own kernels, on one packet slot (``c_slots=1`` keeps interpret
    mode short)."""
    jviews, jpacked, _ = _jviews(jnp.asarray(sphere.triangles))
    o, d, lo, hi = _camera_rays(sphere, 16, 8)  # one 128-ray packet
    jr, tr = _both(o, d, lo, hi)
    ref, _ = pallas_sp.trace_rays_split_pallas(jviews, jpacked, jr, c_slots=1,
                                               kernel_v=3 if kernel_v == 5 else kernel_v)
    rec, _ = st.trace_rays_split(*_port_tree(sphere, True), tr)
    _assert_matches(rec, ref)
    np.testing.assert_allclose(rec.bary_u.numpy(), np.asarray(ref.bary_u), rtol=1e-4, atol=1e-5)
    if kernel_v == 5:
        _assert_matches(rec, jbrute(jnp.asarray(sphere.triangles), jr))


def test_per_ray_stats_raw_and_packet_tags(sphere):
    """The statistics are per ray, in a padded tiled frame too; ``raw``
    returns K1's (t, tri) before the reconstruction; ``packet_tags`` are
    refused unless they tile the rays in packets of ``k``, and root tags
    (0) for every packet trace as no tags."""
    views, packed = _port_tree(sphere, True)
    _, tr = _both(*_camera_rays(sphere, 16, 8))
    rec3, st3 = st.trace_rays_split(views, packed, tr)
    _, _, ipops, lpops, _ = st.split_traverse(
        *views[:2], *st.kernel_operands(tr), leafw=st.LEAFW, any_hit=False,
        stack_cap=views[2])
    np.testing.assert_array_equal(st3.box_tests.numpy(), (ipops * views[0].shape[1]).numpy())
    np.testing.assert_array_equal(st3.tri_tests.numpy(), (lpops * 2 * st.LEAFW).numpy())
    _, tiled = st.make_split_tracer(24, 10)(views, packed, _both(
        *_camera_rays(sphere, 24, 10))[1])
    assert tiled.box_tests.shape == (240,) and bool((tiled.box_tests > 0).all())
    with pytest.raises(ValueError, match="packets of 256"):
        st.trace_rays_split(views, packed, tr, packet_tags=torch.zeros(1))
    (t5, tri5), _ = st.trace_rays_split(views, packed, tr, raw=True)
    np.testing.assert_array_equal(tri5.numpy() >= 0, rec3.hit.numpy())
    np.testing.assert_array_equal(t5.numpy()[rec3.hit.numpy()], rec3.t.numpy()[rec3.hit.numpy()])
    (t5t, tri5t), st5t = st.trace_rays_split(views, packed, tr, raw=True, k=128,
                                             packet_tags=torch.zeros(1, dtype=torch.int32))
    np.testing.assert_array_equal(t5t.numpy(), t5.numpy())
    np.testing.assert_array_equal(tri5t.numpy(), tri5.numpy())
    np.testing.assert_array_equal(st5t.box_tests.numpy(), st3.box_tests.numpy())


def test_stack_overflow_flag_raises(sphere):
    views, packed = _port_tree(sphere, True)
    _, tr = _both(*_camera_rays(sphere, 16, 8))
    rec, stats = st.trace_rays_split(views, packed, tr)
    st.check_overflow(stats.overflow)  # the derived bound holds
    _, stats = st.trace_rays_split((*views[:2], 2), packed, tr)
    assert int(stats.overflow) == 1
    with pytest.raises(RuntimeError, match="stack overflow"):
        st.check_overflow(stats.overflow)


def test_wrapper_routes_by_device(sphere):
    """CPU tensors take the plain version and never count a launch; other
    devices raise instead of falling back."""
    views, packed = _port_tree(sphere, True)
    _, tr = _both(*_camera_rays(sphere, 16, 8))
    ops = st.kernel_operands(tr)
    before = st.launch_count
    out = st.split_traverse(*views[:2], *ops, leafw=st.LEAFW, any_hit=False, stack_cap=64)
    ref = st.trace_split_plain(*views[:2], *ops, leafw=st.LEAFW, any_hit=False, stack_cap=64)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert st.launch_count == before
    meta = [x.to("meta") for x in (*views[:2], *ops)]
    with pytest.raises(ValueError, match="unsupported device"):
        st.split_traverse(*meta, leafw=st.LEAFW, any_hit=False, stack_cap=64)


def _tie_scene():
    """terrain(32) with every triangle twice: the same vertices in the same
    order, so the two copies tie exactly on t. Its 64 pair rows make one
    64-pair leaf window under the root row."""
    from tpu_raytracing.scene import procedural as jprocedural

    scene = jprocedural.terrain(32)
    return scene, np.repeat(scene.triangles, 2, axis=0)


def test_plain_matches_pallas_on_exact_ties(pallas_sp):
    """The window winner's tie rule against the Pallas v3 kernel: the
    smallest t and, on an equal t, the larger 2 * slot + second (the later
    copy), which the warp reduction of K1 reproduces. The scene is one leaf
    window, so the TPU's packet order cannot matter. 96 camera rays hit
    copies; 32 rays start on the box's top face, point up and have tmax =
    F32_MAX, so they enter the window, miss every triangle and still take
    its all-miss slot, 2 * LEAFW - 1, as the reference does (K1's raw output;
    the port's closest-hit record calls that a miss, ``traverse.reconstruct``,
    and its any-hit record a hit, as the reference's). The copies do
    not pair, so pairs on builds the tree that pairs off would. One packet
    needs one of the kernel's slots (``c_slots=1`` keeps interpret mode
    short)."""
    scene, tris = _tie_scene()
    jviews, jpacked, _ = _jviews(jnp.asarray(tris))
    front = tbucket.split_front(torch.from_numpy(tris), True)
    views, packed, split = tbucket.emit_split_views(front, leaf_width=st.LEAFW)
    assert int(split.num_inner) == 1 and packed.rows.shape[0] == st.LEAFW
    o, d, lo, hi = _camera_rays(scene, 16, 6)
    rng = np.random.default_rng(5)
    bmin, bmax = scene.aabb_min, scene.aabb_max
    up_o = np.stack([rng.uniform(bmin[0], bmax[0], 32), np.full(32, bmax[1]),
                     rng.uniform(bmin[2], bmax[2], 32)], 1)
    up_d = np.tile([0.0, 1.0, 0.0], (32, 1)) + rng.normal(scale=0.05, size=(32, 3))
    up_d /= np.linalg.norm(up_d, axis=1, keepdims=True)
    f32_max = np.finfo(np.float32).max
    o, d = (np.concatenate(a).astype(np.float32) for a in ((o, up_o), (d, up_d)))
    lo = np.concatenate([lo, np.zeros(32)]).astype(np.float32)
    hi = np.concatenate([hi, np.full(32, f32_max)]).astype(np.float32)
    jr, tr = _both(o, d, lo, hi)
    for any_hit in (False, True):
        ref, _ = pallas_sp.trace_rays_split_pallas(jviews, jpacked, jr, any_hit=any_hit,
                                                   c_slots=1)
        rec, _ = st.trace_rays_split(views, packed, tr, any_hit=any_hit)
        (_, raw_tri), _ = st.trace_rays_split(views, packed, tr, any_hit=any_hit, raw=True)
        ref_tri = np.asarray(ref.tri_id)
        # K1 keeps the all-miss slot; a closest-hit record calls it a miss
        # (t = F32_MAX), where the reference's calls it a hit
        assert (raw_tri.numpy()[96:] == 2 * st.LEAFW - 1).all()
        want_hit, want_tri = np.asarray(ref.hit).copy(), ref_tri.copy()
        if not any_hit:
            want_hit[96:], want_tri[96:] = False, 0
        np.testing.assert_array_equal(rec.hit.numpy(), want_hit)
        np.testing.assert_array_equal(rec.tri_id.numpy(), want_tri)
        # XLA's CPU compiler contracts Möller-Trumbore differently: t only
        # agrees to a few ulps here (bit for bit on the card, K1 to plain)
        np.testing.assert_allclose(rec.t.numpy(), np.asarray(ref.t), rtol=1e-5)
        # every camera hit lands on a copy and ties with it: the later copy
        # (an odd pair row) wins
        cam_hit = np.asarray(ref.hit)[:96]
        assert cam_hit.sum() > 16
        assert (ref_tri[:96][cam_hit] >> 1 & 1 == 1).all()
        assert (ref_tri[96:] == 2 * st.LEAFW - 1).all()


@pytest.mark.parametrize("leafw", [0, -1, st.MAX_LEAFW + 1, 256])
def test_check_operands_refuses_leafw(sphere, leafw):
    """The kernel takes 1 <= leafw <= 128 (four pair slots a lane); the
    wrapper refuses any other width before a launch."""
    views, _ = _port_tree(sphere, True)
    ops = st.kernel_operands(_both(*_camera_rays(sphere, 16, 8))[1])
    inner, pairs, stack_cap = views
    for ok in (1, st.LEAFW, st.MAX_LEAFW):
        st._check_operands(inner, pairs, *ops, ok, stack_cap)
    with pytest.raises(ValueError, match="leafw"):
        st._check_operands(inner, pairs, *ops, leafw, stack_cap)
