"""PyTorch port's packet tracer (``trace/packet.py``) and brute-force
tracer adapter vs the JAX reference.

``trace_rays_packet`` runs one stack per packet in the reference's order
(packet-level near-child choice, triangle A then B), so hit, tri_id,
prim_id and the per-ray box and triangle test counts are held exactly, on
the same packed tree fed to both sides; t to rtol 1e-6 and the
barycentrics to rtol 1e-6 / atol 1e-5 (``tests/test_torch_traverse.py``
says why). The tiled tracer is held inside ``render_frame`` against the
reference's image, the test-count heat map bit for bit. The reference's
clamp of a push past the stack becomes the overflow flag here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.scene.types import scene_to_device as jscene_to_device  # noqa: E402
from tpu_raytracing.trace import brute as jbrute  # noqa: E402
from tpu_raytracing.trace import packet as jpacket  # noqa: E402
from tpu_raytracing.trace import render as jrender  # noqa: E402
from tpu_raytracing.trace import traverse as jtraverse  # noqa: E402
from tpu_raytracing.trace.modes import RenderType as JRenderType  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jprimary  # noqa: E402
from tpu_raytracing_torch.bvh import lbvh, sah  # noqa: E402
from tpu_raytracing_torch.bvh.pairing import identity_pairs  # noqa: E402
from tpu_raytracing_torch.scene import camera as cam  # noqa: E402
from tpu_raytracing_torch.scene.types import scene_to_device  # noqa: E402
from tpu_raytracing_torch.trace import packet, render, split_trace, traverse  # noqa: E402
from tpu_raytracing_torch.trace.brute import make_brute_tracer  # noqa: E402
from tpu_raytracing_torch.trace.modes import RenderType  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402
from tpu_raytracing_torch.utils.compare import psnr  # noqa: E402
from tests.test_torch_traverse import padded_trees  # noqa: E402

torch.set_num_threads(2)
_jtrace = jax.jit(jpacket.trace_rays_packet, static_argnames=("packet_size",))


def _trees(scene, kind):
    """(JAX TraversalBVH and PackedPairs, the port's), the same rows: the
    port's Karras (pairs on) or binned-SAH tree, both bit-equal to the
    reference's builds (tests/test_torch_lbvh.py, tests/test_torch_sah.py)."""
    tris = torch.from_numpy(scene.triangles)
    bvh, pairs = (lbvh.build_lbvh(tris, True) if kind == "karras"
                  else sah.build_sah(tris, False))
    trav, packed = traverse.pack_bvh(bvh), traverse.pack_pairs(pairs)
    jtrav = jtraverse.TraversalBVH(rows=jnp.asarray(trav.rows.numpy()),
                                   root=jnp.asarray(trav.root.numpy()),
                                   root_count=jnp.asarray(trav.root_count.numpy()))
    return (jtrav, jtraverse.PackedPairs(rows=jnp.asarray(packed.rows.numpy()))), (trav, packed)


def _camera_rays(scene, w, h):
    c = jcam.camera_to_device(jcam.update_camera(
        jcam.initialise_camera(scene.aabb_min, scene.aabb_max)))
    r = jprimary(c, w, h)
    return tuple(np.array(a, np.float32) for a in (r.origin, r.direction, r.tmin, r.tmax))


def _random_rays(scene, rng, num):
    lo, hi = scene.aabb_min, scene.aabb_max
    o = lo + (hi - lo) * rng.random((num, 3))
    d = rng.normal(size=(num, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32), np.zeros(num, np.float32),
            np.full(num, 1e6, np.float32))


def _both(arrays):
    return (JRays(*(jnp.asarray(a) for a in arrays)),
            Rays(*(torch.from_numpy(np.array(a)) for a in arrays)))


def _assert_records(rec, ref, uv=True):
    for f in ("hit", "tri_id", "prim_id"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    hit = rec.hit.numpy()
    np.testing.assert_allclose(rec.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-6)
    for f in ("bary_u", "bary_v") if uv else ():
        np.testing.assert_allclose(getattr(rec, f).numpy()[hit], np.asarray(getattr(ref, f))[hit],
                                   rtol=1e-6, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("name,kind", [("cornell", "karras"), ("sphere", "sah")])
@pytest.mark.parametrize("masked", [False, True], ids=["all-on", "active-mask"])
def test_trace_rays_packet_matches_jax(name, kind, masked, request):
    """Camera packets (16 x 8 tiles) and incoherent random-ray packets,
    traced as one batch (both sets fill whole packets, so every packet is
    the same as on its own): one compile of the reference's tracer."""
    scene = request.getfixturevalue(name)
    rng = np.random.default_rng(111)
    jtrees, ttrees = _trees(scene, kind)
    # both sides trace the same zero-padded rows: one compile for both scenes
    (jtrav, jpacked), (trav, packed) = padded_trees(*jtrees, *ttrees)
    sets = (_camera_rays(scene, 32, 16), _random_rays(scene, rng, 256))
    arrays = tuple(np.concatenate(a) for a in zip(*sets))
    active = (np.concatenate([rng.random(a[0].shape[0]) < 0.6 for a in sets]) if masked
              else None)
    jr, tr = _both(arrays)
    ref, jstats = _jtrace(jtrav, jpacked, jr, packet_size=128,
                          active=None if active is None else jnp.asarray(active))
    rec, stats = packet.trace_rays_packet(
        trav, packed, tr, packet_size=128,
        active=None if active is None else torch.from_numpy(active))
    _assert_records(rec, ref)
    np.testing.assert_array_equal(stats.box_tests.numpy(), np.asarray(jstats.box_tests))
    np.testing.assert_array_equal(stats.tri_tests.numpy(), np.asarray(jstats.tri_tests))
    assert int(stats.overflow) == 0
    if active is not None:
        assert not rec.hit.numpy()[~active].any()
        assert (stats.box_tests.numpy()[~active] == 0).all()
    assert int(rec.hit.sum()) > 32


def test_packet_hits_equal_the_scalar_tracer(sphere):
    """Closest hits equal ``trace_rays``' on the same tree: a packet visits
    every node any of its rays hits."""
    _, (trav, packed) = _trees(sphere, "karras")
    _, tr = _both(_random_rays(sphere, np.random.default_rng(5), 512))
    rec, _ = packet.trace_rays_packet(trav, packed, tr)
    ref, _ = traverse.trace_rays(trav, packed, tr)
    np.testing.assert_array_equal(rec.hit.numpy(), ref.hit.numpy())
    np.testing.assert_array_equal(rec.t.numpy(), ref.t.numpy())
    assert rec.hit.sum() > 16


@pytest.mark.parametrize("mode", [RenderType.DEPTH, RenderType.BOX_TESTS,
                                  RenderType.TEXTURE_LIT_SHADOWS], ids=lambda m: m.name)
def test_tiled_packet_tracer_in_render_frame(cornell, mode):
    """The app's 8 x 8 tiled packet tracer inside ``render_frame`` against
    the reference's: the box-test heat map (per-ray counts) and the frame's
    test total exactly, the shaded modes at 40 dB."""
    w, h = 32, 24
    (jtrav, jpacked), (trav, packed) = _trees(cornell, "karras")
    jcamera = jcam.camera_to_device(jcam.initialise_camera(cornell.aabb_min, cornell.aabb_max))
    tcamera = cam.camera_to_device(cam.initialise_camera(cornell.aabb_min, cornell.aabb_max),
                                   "cpu")
    ref, ref_tests = jrender.render_frame(jtrav, jpacked, jscene_to_device(cornell), jcamera,
                                          w, h, JRenderType(int(mode)),
                                          tracer=jpacket.make_tiled_packet_tracer(w, h, 8, 8))
    img, tests = render.render_frame(trav, packed, scene_to_device(cornell, "cpu"), tcamera,
                                     w, h, mode,
                                     tracer=packet.make_tiled_packet_tracer(w, h, 8, 8))
    img, ref = img.numpy(), np.asarray(ref)
    assert int(tests) == int(ref_tests)
    if mode == RenderType.BOX_TESTS:
        np.testing.assert_array_equal(img, ref)
    else:
        assert psnr(img, ref) >= 40.0
    assert len(np.unique(img.reshape(-1, 4), axis=0)) > 1


def test_overflow_flag_with_a_small_stack(sphere, monkeypatch):
    """A stack too small for the tree sets the overflow flag and stops the
    packet instead of overwriting its top entry; ``render.shade_rays``
    raises on it."""
    _, (trav, packed) = _trees(sphere, "karras")
    w, h = 16, 8
    _, tr = _both(_camera_rays(sphere, w, h))
    _, stats = packet.trace_rays_packet(trav, packed, tr)
    split_trace.check_overflow(stats.overflow)
    monkeypatch.setattr(packet, "STACK_DEPTH", 2)
    _, small = packet.trace_rays_packet(trav, packed, tr)
    assert int(small.overflow) == 1
    assert (small.box_tests <= stats.box_tests).all()
    tcamera = cam.camera_to_device(cam.initialise_camera(sphere.aabb_min, sphere.aabb_max),
                                   "cpu")
    with pytest.raises(RuntimeError, match="stack overflow"):
        render.render_frame(trav, packed, scene_to_device(sphere, "cpu"), tcamera, w, h,
                            RenderType.DEPTH, tracer=packet.make_tiled_packet_tracer(w, h, 8, 8))


def test_make_brute_tracer_matches_jax(cornell):
    """The oracle behind the BVH tracers' signature: the reference's
    brute force through identity pairs, zero statistics."""
    rng = np.random.default_rng(7)
    arrays = _random_rays(cornell, rng, 200)
    jr, tr = _both(arrays)
    tris = torch.from_numpy(cornell.triangles)
    jtris = jnp.asarray(cornell.triangles)
    ref, jstats = jbrute.make_brute_tracer(jtris)(None, None, jr)
    rec, stats = make_brute_tracer(tris)(None, traverse.pack_pairs(identity_pairs(tris)), tr)
    _assert_records(rec, ref, uv=False)
    np.testing.assert_allclose(rec.bary_u.numpy(), np.asarray(ref.bary_u), rtol=1e-5, atol=1e-5)
    assert not stats.box_tests.any() and not stats.tri_tests.any() and int(stats.overflow) == 0
    assert rec.hit.sum() > 16


def test_app_packet_frames_and_the_8_divisible_rule(tmp_path, capsys):
    """``--tracer packet`` renders the scalar tracer's image (the same
    closest hits) on an 8-divisible frame; on a 20x12 frame it warns and
    falls back to the scalar tracer, as the reference; the grid tracer
    takes the 20x12 frame as it is."""
    from tpu_raytracing_torch.app import main as app
    from tpu_raytracing_torch.utils.png import read_png

    def run(tracer, w, h):
        out = tmp_path / f"{tracer}{w}"
        res = app.main(["--device", "cpu", "--type", "bottom-up", "--tracer", tracer,
                        "--width", str(w), "--height", str(h), "--output", str(out)])
        return res, read_png(str(out / "frame0000_mode0.png")), capsys.readouterr().err

    res, img, err = run("packet", 32, 16)
    assert "WARNING" not in err and isinstance(res["trav"], traverse.TraversalBVH)
    np.testing.assert_array_equal(img, run("scalar", 32, 16)[1])
    _, img, err = run("packet", 20, 12)
    assert "WARNING: 20x12 is not 8-divisible; downgrading --tracer packet -> scalar" in err
    np.testing.assert_array_equal(img, run("scalar", 20, 12)[1])
    _, img, err = run("grid", 20, 12)
    assert "WARNING" not in err and img.shape == (12, 20, 4)
