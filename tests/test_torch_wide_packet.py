"""The 8-wide packet tracer (``trace/wide_packet.py``) in the PyTorch port
against the JAX reference.

Both packages trace the same wide rows: the port's Karras tree collapsed by
``build_wide`` (bit-equal to the reference's build, tests/test_torch_wide.py),
handed to the reference as its ``WideBVH``. Held equal, bit for bit: hit,
t, tri_id, prim_id, the barycentrics and the per-ray box and triangle tests
(the port's Möller-Trumbore rounds where XLA's CPU code fuses a
multiply-add, ``wide_packet._intersect_triangle``). Its hits also equal the
scalar tracer's on the binary tree (t to rtol 1e-6: ``trace_rays`` keeps
its unfused order). A stack too small for the tree sets the overflow flag
where the reference overwrites its top slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh.wide import WideBVH as JWideBVH  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.trace import wide_packet as jwp  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jprimary  # noqa: E402
from tpu_raytracing.trace.traverse import PackedPairs as JPackedPairs  # noqa: E402
from tpu_raytracing_torch.bvh import lbvh, wide  # noqa: E402
from tpu_raytracing_torch.scene import camera as cam  # noqa: E402
from tpu_raytracing_torch.scene.types import scene_to_device  # noqa: E402
from tpu_raytracing_torch.trace import render, split_trace, traverse, wide_packet  # noqa: E402
from tpu_raytracing_torch.trace.modes import RenderType  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402

torch.set_num_threads(2)
_jtrace = jax.jit(jwp.trace_rays_wide, static_argnames=("packet_size",))
SCENES = [("cornell", True), ("sphere", False), ("sphere", True)]


def trees(scene, pairs):
    bvh, tpairs = lbvh.build_lbvh(torch.from_numpy(scene.triangles), pairs)
    wbvh, packed = wide.build_wide(bvh), traverse.pack_pairs(tpairs)
    jw = JWideBVH(rows=jnp.asarray(wbvh.rows.numpy()), num_nodes=jnp.asarray(
        int(wbvh.num_nodes)))
    return (jw, JPackedPairs(rows=jnp.asarray(packed.rows.numpy()))), (wbvh, packed)


def camera_rays(scene, w, h):
    c = jcam.camera_to_device(jcam.update_camera(
        jcam.initialise_camera(scene.aabb_min, scene.aabb_max)))
    r = jprimary(c, w, h)
    return tuple(np.array(a, np.float32) for a in (r.origin, r.direction, r.tmin, r.tmax))


def both(arrays):
    return (JRays(*(jnp.asarray(a) for a in arrays)),
            Rays(*(torch.from_numpy(np.array(a)) for a in arrays)))


def assert_records(rec, ref, stats=None, jstats=None):
    for f in ("hit", "t", "tri_id", "prim_id", "bary_u", "bary_v"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    if stats is not None:
        np.testing.assert_array_equal(stats.box_tests.numpy(), np.asarray(jstats.box_tests))
        np.testing.assert_array_equal(stats.tri_tests.numpy(), np.asarray(jstats.tri_tests))


@pytest.mark.parametrize("name,pairs", SCENES)
def test_trace_rays_wide_matches_reference(name, pairs, request):
    scene = request.getfixturevalue(name)
    (jw, jpacked), (wbvh, packed) = trees(scene, pairs)
    arrays = camera_rays(scene, 32, 16)
    jr, tr = both(arrays)
    act = np.random.default_rng(31).random(512) < 0.7
    act[:128] = False  # a packet with no ray on
    for active in (None, act):
        jact = None if active is None else jnp.asarray(active)
        ref, jstats = _jtrace(jw, jpacked, jr, active=jact, packet_size=128)
        rec, stats = wide_packet.trace_rays_wide(
            wbvh, packed, tr, active=None if active is None else torch.from_numpy(active))
        assert_records(rec, ref, stats, jstats)
        assert int(stats.overflow) == 0
        if active is not None:
            assert not rec.hit.numpy()[~active].any()
            assert (stats.box_tests.numpy()[~active] == 0).all()
        assert int(rec.hit.sum()) > 32


@pytest.mark.parametrize("name,pairs", SCENES)
def test_tiled_wide_tracer_matches_reference(name, pairs, request):
    scene = request.getfixturevalue(name)
    (jw, jpacked), (wbvh, packed) = trees(scene, pairs)
    jr, tr = both(camera_rays(scene, 32, 16))
    ref, jstats = jwp.make_tiled_wide_tracer(jw, 32, 16)(None, jpacked, jr)
    rec, stats = wide_packet.make_tiled_wide_tracer(wbvh, 32, 16)(None, packed, tr)
    assert_records(rec, ref, stats, jstats)
    # the same closest hits as the scalar tracer on the binary tree
    bvh, tpairs = lbvh.build_lbvh(torch.from_numpy(scene.triangles), pairs)
    sref, _ = traverse.trace_rays(traverse.pack_bvh(bvh), traverse.pack_pairs(tpairs), tr)
    np.testing.assert_array_equal(rec.hit.numpy(), sref.hit.numpy())
    np.testing.assert_allclose(rec.t.numpy(), sref.t.numpy(), rtol=1e-6)


def test_overflow_flag_with_a_small_stack(sphere, monkeypatch):
    """A tree deeper than the stack: the packet sets the overflow flag and
    stops instead of overwriting its top entry; ``render.shade_rays``
    raises on it."""
    _, (wbvh, packed) = trees(sphere, True)
    w, h = 16, 8
    _, tr = both(camera_rays(sphere, w, h))
    _, stats = wide_packet.trace_rays_wide(wbvh, packed, tr)
    split_trace.check_overflow(stats.overflow)
    monkeypatch.setattr(wide_packet, "STACK_DEPTH", 3)
    _, small = wide_packet.trace_rays_wide(wbvh, packed, tr)
    assert int(small.overflow) == 1
    assert (small.box_tests <= stats.box_tests).all()
    tcamera = cam.camera_to_device(cam.initialise_camera(sphere.aabb_min, sphere.aabb_max), "cpu")
    bvh, _ = lbvh.build_lbvh(torch.from_numpy(sphere.triangles), True)
    with pytest.raises(RuntimeError, match="stack overflow"):
        render.render_frame(traverse.pack_bvh(bvh), packed, scene_to_device(sphere, "cpu"),
                            tcamera, w, h, RenderType.DEPTH,
                            tracer=wide_packet.make_tiled_wide_tracer(wbvh, w, h))
