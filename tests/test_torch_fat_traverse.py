"""PyTorch port's fat wide-BVH traversal (K6's plain version on the CPU) vs
the JAX reference: the Pallas kernel in interpret mode, the scalar tracers,
brute force, and a JAX-built fat tree traced by the port.

The Pallas kernel orders a 128-ray packet's children by the packet's
minimum entry distance, the port each ray by its own, so on an exact t tie
between two triangles the two may report different ones: tri_id is held
equal except where t ties. hit is held exactly and t to rtol 1e-6 (as
tests/test_pallas.py:51-55); u and v to atol 1e-5 (see
tests/test_torch_traverse.py for why).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import lbvh as jlbvh  # noqa: E402
from tpu_raytracing.bvh import wide as jwide  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jprimary  # noqa: E402
from tpu_raytracing.trace.traverse import pack_pairs as jpack_pairs  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import lbvh, wide  # noqa: E402
from tpu_raytracing_torch.ops import fat_traverse as ft  # noqa: E402
from tpu_raytracing_torch.scene import procedural  # noqa: E402
from tpu_raytracing_torch.trace import split_trace  # noqa: E402
from tpu_raytracing_torch.trace.brute import brute_force_trace  # noqa: E402
from tpu_raytracing_torch.trace.traverse import pack_bvh, pack_pairs, trace_rays  # noqa: E402
from tests.test_torch_traverse import aimed_rays, both_rays, ray_sets  # noqa: E402

torch.set_num_threads(2)
_jbuild = jax.jit(jlbvh.build_lbvh, static_argnames="enable_pairs")


@pytest.fixture(scope="module")
def pallas_pt():
    """The reference K6 in Pallas interpret mode, as tests/test_pallas.py
    runs it off the TPU."""
    from jax.experimental import pallas as pl

    from tpu_raytracing.ops import pallas_traverse

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    yield pallas_traverse
    pl.pallas_call = orig


def _port_tree(scene, pairs):
    bvh, tp = lbvh.build_lbvh(torch.from_numpy(scene.triangles), pairs)
    packed = pack_pairs(tp)
    fat = wide.build_wide_fat(bvh, packed.rows)
    return bvh, packed, ft.pad_rows_256(fat.rows)


def _camera_arrays(scene, width, height):
    c = jcam.camera_to_device(jcam.update_camera(
        jcam.initialise_camera(scene.aabb_min, scene.aabb_max)))
    r = jprimary(c, width, height)
    return tuple(np.asarray(a, np.float32) for a in (r.origin, r.direction, r.tmin, r.tmax))


def assert_hits_match(rec, ref, t_rtol=1e-6, uv=True):
    """hit exact, t to t_rtol on hits, tri_id and prim_id equal except on
    exact t ties, u and v to atol 1e-5."""
    hit = rec.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    t, rt = rec.t.numpy()[hit], np.asarray(ref.t)[hit]
    np.testing.assert_allclose(t, rt, rtol=t_rtol)
    same_tri = rec.tri_id.numpy()[hit] == np.asarray(ref.tri_id)[hit]
    assert (same_tri | (t == rt)).all()
    same_prim = rec.prim_id.numpy()[hit] == np.asarray(ref.prim_id)[hit]
    assert (same_prim | (t == rt)).all()
    if uv:
        for f in ("bary_u", "bary_v"):
            a, b = getattr(rec, f).numpy()[hit], np.asarray(getattr(ref, f))[hit]
            np.testing.assert_allclose(a[same_tri], b[same_tri], rtol=1e-6, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("name", ["cornell", "sphere"])
def test_plain_matches_pallas_kernel(name, request, pallas_pt):
    scene = request.getfixturevalue(name)
    jb, jp = _jbuild(jnp.asarray(scene.triangles), enable_pairs=False)
    fat = jax.jit(jwide.build_wide_fat)(jb, jpack_pairs(jp).rows)
    arrays = _camera_arrays(scene, 16, 8)  # one 128-ray packet
    jr, tr = both_rays(arrays)
    ref, _ = pallas_pt.trace_rays_pallas(pallas_pt.pad_rows_256(fat.rows), jr)
    _, _, rows = _port_tree(scene, False)
    rec, stats = ft.trace_rays_fat(rows, tr)
    assert int(np.asarray(ref.hit).sum()) > 16
    assert_hits_match(rec, ref)
    assert int(stats.overflow) == 0 and not stats.box_tests.any() and not stats.tri_tests.any()


@pytest.mark.parametrize("pairs", [False, True])
def test_plain_matches_pallas_within_row_ties(pairs, pallas_pt):
    """Four terrain triangles, each given twice: the fat tree is one row of 8
    Tri entries whose duplicates tie exactly on t. With one row the packet's
    child order plays no part, so the plain version and the Pallas kernel
    must name the same triangle of every tie (the later test wins an equal
    t). 64 camera rays, then the same rays with tmax = F32_MAX."""
    tris = np.repeat(procedural.terrain(2).triangles[:4], 2, axis=0)
    scene = types.SimpleNamespace(triangles=tris, aabb_min=tris.min(axis=(0, 1)),
                                  aabb_max=tris.max(axis=(0, 1)))
    jb, jp = _jbuild(jnp.asarray(tris), enable_pairs=pairs)
    fat = jax.jit(jwide.build_wide_fat)(jb, jpack_pairs(jp).rows)
    assert int(fat.num_nodes) == 1
    o, d, tmin, tmax = _camera_arrays(scene, 8, 8)
    arrays = (np.concatenate([o, o]), np.concatenate([d, d]), np.concatenate([tmin, tmin]),
              np.concatenate([tmax, np.full_like(tmax, np.finfo(np.float32).max)]))
    jr, tr = both_rays(arrays)
    ref, _ = pallas_pt.trace_rays_pallas(pallas_pt.pad_rows_256(fat.rows), jr)
    rec, _ = ft.trace_rays_fat(_port_tree(scene, pairs)[2], tr)
    hit = rec.hit.numpy()
    assert hit.sum() > 32
    for f in ("hit", "tri_id", "prim_id"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    # every hit is a tie, and the later duplicate (odd leaf) names it
    assert (rec.tri_id.numpy()[hit] % 4 >= 2).all()
    assert_hits_match(rec, ref)


def test_pallas_active_mask(cornell, pallas_pt):
    """Dead rays (tmax = -1) hit nothing; live ones as the reference's."""
    jb, jp = _jbuild(jnp.asarray(cornell.triangles), enable_pairs=True)
    fat = jax.jit(jwide.build_wide_fat)(jb, jpack_pairs(jp).rows)
    jr, tr = both_rays(_camera_arrays(cornell, 16, 8))
    active = np.arange(128) % 2 == 0
    ref, _ = pallas_pt.trace_rays_pallas(pallas_pt.pad_rows_256(fat.rows), jr,
                                         active=jnp.asarray(active))
    rec, _ = ft.trace_rays_fat(_port_tree(cornell, True)[2], tr, active=torch.from_numpy(active))
    hit = rec.hit.numpy()
    assert not hit[1::2].any() and hit[0::2].any()
    assert_hits_match(rec, ref)
    np.testing.assert_array_equal(rec.t.numpy()[~active], -1.0)


@pytest.mark.parametrize("pairs", [False, True])
def test_plain_matches_scalar_and_brute(soup, sphere, pairs):
    """The soup and sphere ray sets against the port's trace_rays on the
    same binary tree (the same Möller-Trumbore, so t is exact) and against
    brute force."""
    rng = np.random.default_rng(108)  # its own: the shared rng fixture depends on file order
    for scene in (soup, sphere):
        bvh, packed, rows = _port_tree(scene, pairs)
        trav = pack_bvh(bvh)
        sets = dict(ray_sets(scene, rng), aimed=(aimed_rays(scene, rng, 1024), None))
        hits = 0
        for set_name, (arrays, active) in sets.items():
            _, tr = both_rays(arrays)
            act = None if active is None else torch.from_numpy(active)
            rec, stats = ft.trace_rays_fat(rows, tr, active=act)
            srec, _ = trace_rays(trav, packed, tr, active=act)
            assert int(stats.overflow) == 0
            assert_hits_match(rec, srec, t_rtol=0.0)
            if active is None and not pairs:
                # brute force tests each source triangle, as the unpaired tree
                assert_hits_match(rec, brute_force_trace(torch.from_numpy(scene.triangles), tr),
                                  t_rtol=1e-5, uv=False)
            hits += int(rec.hit.sum())
        assert hits > 16


@pytest.mark.parametrize("pairs", [False, True])
def test_plain_counts_match_reference_packets_of_one(soup, sphere, pairs):
    """The plain version's per-ray counts on the soup and sphere ray sets
    against the reference's wide tracer with packets of one ray
    (``wide_fat.trace_rays_wide_fat(packet_size=1)``), whose per-packet
    counts are then per ray and whose child order is the ray's own, as
    K6's: ``box_tests`` and ``tri_entry_tests`` (Tri entries whose box the
    ray passes) equal on every live ray, and the hits too. ``tri_tests``
    (the triangles run) lies between one and two a counted entry. A dead
    ray (tmax = -1) pops the root row in the port and no row in the
    reference."""
    from tpu_raytracing.trace import wide_fat as jwide_fat

    rng = np.random.default_rng(110)
    for scene in (soup, sphere):
        jb, jp = _jbuild(jnp.asarray(scene.triangles), enable_pairs=pairs)
        jpacked = jpack_pairs(jp)
        jfat = jax.jit(jwide.build_wide_fat)(jb, jpacked.rows)
        _, _, rows = _port_tree(scene, pairs)
        sets = dict(ray_sets(scene, rng), aimed=(aimed_rays(scene, rng, 512), None))
        entries = 0
        for set_name, (arrays, active) in sets.items():
            jr, tr = both_rays(arrays)
            live = np.ones(arrays[0].shape[0], bool) if active is None else active
            ref, jstats = jwide_fat.trace_rays_wide_fat(
                jfat, jpacked, jr, active=None if active is None else jnp.asarray(active),
                packet_size=1)
            counts = {}
            ops = ft.kernel_operands(tr, None if active is None else torch.from_numpy(active))
            out = ft.trace_fat_plain(rows, *ops, counts=counts)
            box, ent, tri = (counts[k].numpy() for k in (
                "box_tests", "tri_entry_tests", "tri_tests"))
            np.testing.assert_array_equal(box[live], np.asarray(jstats.box_tests)[live],
                                          err_msg=set_name)
            np.testing.assert_array_equal(ent[live], np.asarray(jstats.tri_tests)[live],
                                          err_msg=set_name)
            assert (ent <= tri).all() and (tri <= 2 * ent).all()
            assert (ent[~live] == 0).all()
            np.testing.assert_array_equal(out[0].numpy().astype(bool), np.asarray(ref.hit))
            hit = np.asarray(ref.hit)
            np.testing.assert_array_equal(out[3].numpy()[hit], np.asarray(ref.tri_id)[hit])
            entries += int(ent.sum())
        assert entries > 20


def test_jax_built_fat_tree_traced_by_port(sphere):
    jb, jp = _jbuild(jnp.asarray(sphere.triangles), enable_pairs=True)
    jf = jax.jit(jwide.build_wide_fat)(jb, jpack_pairs(jp).rows)
    fat = convert.fat_from_numpy(np.asarray(jf.rows), np.asarray(jf.num_nodes), "cpu")
    _, tr = both_rays(_camera_arrays(sphere, 16, 16))
    rec, _ = ft.trace_rays_fat(ft.pad_rows_256(fat.rows), tr)
    own, _ = ft.trace_rays_fat(_port_tree(sphere, True)[2], tr)
    assert int(rec.hit.sum()) > 16
    for f in ("hit", "t", "prim_id", "tri_id", "bary_u", "bary_v"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(), getattr(own, f).numpy(),
                                      err_msg=f)


def test_stack_overflow_flag_raises(sphere, monkeypatch):
    _, _, rows = _port_tree(sphere, False)
    _, tr = both_rays(_camera_arrays(sphere, 8, 8))
    _, stats = ft.trace_rays_fat(rows, tr)
    split_trace.check_overflow(stats.overflow)
    monkeypatch.setattr(ft, "STACK", 3)
    _, stats = ft.trace_rays_fat(rows, tr)
    assert int(stats.overflow) == 1
    with pytest.raises(RuntimeError, match="stack overflow"):
        split_trace.check_overflow(stats.overflow)


def test_tiled_tracer_and_routing(cornell):
    """make_fat_tracer tiles and restores a frame; CPU tensors take the
    plain version and count no launch; other devices raise, and so does the
    cycle diagnostic off the card."""
    _, packed, rows = _port_tree(cornell, True)
    _, tr = both_rays(_camera_arrays(cornell, 32, 16))
    flat, _ = ft.trace_rays_fat(rows, tr)
    before = ft.launch_count
    tiled, stats = ft.make_fat_tracer(None, 32, 16)(rows, packed, tr)
    assert ft.launch_count == before
    for f in ("hit", "t", "prim_id", "tri_id", "bary_u", "bary_v"):
        np.testing.assert_array_equal(getattr(tiled, f).numpy(), getattr(flat, f).numpy())
    assert stats.box_tests.shape == (512,)
    ops = [x.to("meta") for x in (rows, *ft.kernel_operands(tr))]
    with pytest.raises(ValueError, match="unsupported device"):
        ft.fat_traverse(*ops)
    with pytest.raises(ValueError, match="only on the card"):
        ft.fat_traverse_cycles(rows, *ft.kernel_operands(tr))
    assert ft.STACK == 155 and ft.pad_rows_256(rows[:, :192]).shape == rows.shape

