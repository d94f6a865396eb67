"""PyTorch port's wide tracer (``trace/wide_fat.py``, K6's counting
instantiation; its plain version here on the CPU) vs the JAX reference's
``trace/wide_fat.py``, on the same fat rows.

The reference walks 8x8-tile packets and orders children by the packet's
smallest entry distance, the port each ray by its own, so on an exact t
tie two triangles may swap: ``hit`` is held exactly, ``t`` to rtol 1e-6,
``tri_id`` and ``prim_id`` equal except where t ties exactly. The counts
are per packet in the reference and per ray in the port; on a frame whose
every 8x8 tile is one ray repeated, packet order equals ray order and the
two are held equal exactly. ``build_wide_fat`` of a JAX-built binned-SAH
tree (the app's ``--type sah --tracer wide``) is held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import lbvh as jlbvh  # noqa: E402
from tpu_raytracing.bvh import sah as jsah  # noqa: E402
from tpu_raytracing.bvh import wide as jwide  # noqa: E402
from tpu_raytracing.trace import wide_fat as jwide_fat  # noqa: E402
from tpu_raytracing.trace.traverse import pack_pairs as jpack_pairs  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import lbvh, sah, wide  # noqa: E402
from tpu_raytracing_torch.ops import fat_traverse as ft  # noqa: E402
from tpu_raytracing_torch.scene import procedural  # noqa: E402
from tpu_raytracing_torch.trace import wide_fat  # noqa: E402
from tpu_raytracing_torch.trace.traverse import pack_pairs  # noqa: E402
from tests.test_torch_fat_traverse import _camera_arrays, assert_hits_match  # noqa: E402
from tests.test_torch_traverse import both_rays  # noqa: E402

torch.set_num_threads(2)
W, H = 32, 16
_jlbvh = jax.jit(jlbvh.build_lbvh, static_argnames="enable_pairs")
_jsah = jax.jit(jsah.build_sah, static_argnums=(1, 2))
_jfat = jax.jit(jwide.build_wide_fat)

SCENES = {
    "cornell": lambda: procedural.cornell_box(),
    "sphere": lambda: procedural.sphere_scene(3),
    "soup": lambda: procedural.random_triangle_soup(2000, seed=1),
    "terrain": lambda: procedural.terrain(2048),
}


def _jax_tree(name, build):
    """A JAX-built tree (``build`` "sah" or "lbvh", pairs on) as numpy
    fields, its fat rows and its packed pair rows."""
    tris = jnp.asarray(SCENES[name]().triangles)
    jb, jp = _jsah(tris, True, False) if build == "sah" else _jlbvh(tris, enable_pairs=True)
    jpacked = jpack_pairs(jp)
    return jb, jpacked, _jfat(jb, jpacked.rows)


def _bvh_fields(jb):
    return {f: np.asarray(getattr(jb, f)) for f in (
        "node_min", "node_max", "child", "count", "type", "parent", "root", "root_count")}


@pytest.mark.parametrize("name", ["cornell", "sphere", "soup"])
def test_build_wide_fat_on_jax_sah_tree_bit_equal(name):
    jb, jpacked, jfat = _jax_tree(name, "sah")
    bvh = convert.bvh_from_numpy(_bvh_fields(jb), "cpu")
    fat = wide.build_wide_fat(bvh, torch.from_numpy(np.array(jpacked.rows)))
    np.testing.assert_array_equal(fat.rows.numpy(), np.asarray(jfat.rows))
    assert int(fat.num_nodes) == int(jfat.num_nodes)
    ft.check_stack_depth(bvh)


@pytest.mark.parametrize("build,name", [("sah", "cornell"), ("sah", "sphere"),
                                        ("lbvh", "sphere"), ("sah", "terrain")])
def test_tiled_tracer_matches_jax(build, name):
    """The camera frame through the same (JAX-built) fat rows, 8x8 tiles,
    with both packages' ``make_tiled_fat_tracer(None, ...)``."""
    jb, jpacked, jfat = _jax_tree(name, build)
    scene = SCENES[name]()
    jr, tr = both_rays(_camera_arrays(scene, W, H))
    ref, _ = jwide_fat.make_tiled_fat_tracer(None, W, H, 8, 8)(jfat, jpacked, jr)
    fat = convert.fat_from_numpy(np.asarray(jfat.rows), np.asarray(jfat.num_nodes), "cpu")
    packed = convert.packed_from_numpy(np.asarray(jpacked.rows), "cpu")
    for phased in (False, True):
        tracer = wide_fat.make_tiled_fat_tracer(None, W, H, 8, 8, phased=phased)
        rec, stats = tracer(fat, packed, tr)
        assert tracer.host_staged == phased
        assert int(stats.overflow) == 0
        assert int(rec.hit.sum()) > 16
        assert_hits_match(rec, ref)
        assert stats.box_tests.shape == stats.tri_tests.shape == (W * H,)
        assert int(stats.box_tests.min()) > 0


def _repeated_tile_rays(scene):
    """A WxH frame whose every 8x8 tile is one camera ray repeated: the
    tile's centre pixel's ray."""
    arrays = _camera_arrays(scene, W, H)
    src = np.arange(W * H).reshape(H, W)
    src = src[(np.arange(H) // 8 * 8 + 4)[:, None],
              (np.arange(W) // 8 * 8 + 4)[None, :]].reshape(-1)
    return tuple(a[src] for a in arrays)


@pytest.mark.parametrize("build,name", [("sah", "cornell"), ("lbvh", "sphere"),
                                        ("sah", "terrain")])
def test_per_ray_counts_equal_per_packet_counts(build, name):
    jb, jpacked, jfat = _jax_tree(name, build)
    jr, tr = both_rays(_repeated_tile_rays(SCENES[name]()))
    ref, jstats = jwide_fat.make_tiled_fat_tracer(None, W, H, 8, 8)(jfat, jpacked, jr)
    fat = convert.fat_from_numpy(np.asarray(jfat.rows), np.asarray(jfat.num_nodes), "cpu")
    rec, stats = wide_fat.make_tiled_fat_tracer(None, W, H, 8, 8)(fat, None, tr)
    for f in ("hit", "tri_id", "prim_id"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(), np.asarray(getattr(ref, f)))
    np.testing.assert_array_equal(stats.box_tests.numpy(), np.asarray(jstats.box_tests))
    np.testing.assert_array_equal(stats.tri_tests.numpy(), np.asarray(jstats.tri_tests))
    assert int(stats.tri_tests.max()) > 0


def test_untiled_forms_and_active_mask():
    """``trace_rays_wide_fat`` and its phased form give the same records
    as the reference's; a dead ray hits nothing and keeps its tmax (the
    reference's reconstruction), and ``with_trips`` is not ported."""
    jb, jpacked, jfat = _jax_tree("sphere", "lbvh")
    arrays = _camera_arrays(SCENES["sphere"](), 16, 8)
    jr, tr = both_rays(arrays)
    active = np.arange(128) % 3 != 0
    ref, _ = jwide_fat.trace_rays_wide_fat(jfat, jpacked, jr, active=jnp.asarray(active))
    fat = convert.fat_from_numpy(np.asarray(jfat.rows), np.asarray(jfat.num_nodes), "cpu")
    for fn in (wide_fat.trace_rays_wide_fat, wide_fat.trace_rays_wide_fat_phased):
        rec, _ = fn(fat, None, tr, active=torch.from_numpy(active))
        assert_hits_match(rec, ref)
        hit = rec.hit.numpy()
        assert not hit[~active].any() and hit.any()
        np.testing.assert_array_equal(rec.t.numpy()[~hit], np.asarray(ref.t)[~hit])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        wide_fat.trace_rays_wide_fat(fat, None, tr, with_trips=True)
    with pytest.raises(ValueError, match="packets of 128"):
        wide_fat.trace_rays_wide_fat(fat, None, tr.take(torch.arange(100)))


def test_stack_depth_check():
    """The depth bound: a Karras tree always passes and its depth is
    ``tree_height``'s; a bound below the tree's need raises."""
    tris = torch.from_numpy(SCENES["soup"]().triangles)
    bvh, _ = lbvh.build_lbvh(tris, True)
    assert ft.binary_depth(bvh) == int(lbvh.tree_height(bvh))
    ft.check_stack_depth(bvh)
    sbvh, _ = sah.build_sah(tris, True)
    depth = ft.binary_depth(sbvh)
    levels = 1 + -(-(depth - 3) // 3)
    ft.check_stack_depth(sbvh)
    old = ft.STACK
    try:
        ft.STACK = 7 * levels
        with pytest.raises(ValueError, match="binary levels deep"):
            ft.check_stack_depth(sbvh)
        ft.STACK = 7 * levels + 1
        ft.check_stack_depth(sbvh)
    finally:
        ft.STACK = old


def test_counting_wrapper_routes_to_plain_on_cpu():
    """On CPU tensors the counting form runs the plain version with its
    counts and counts no launch."""
    bvh, tp = lbvh.build_lbvh(torch.from_numpy(SCENES["sphere"]().triangles), True)
    rows = ft.pad_rows_256(wide.build_wide_fat(bvh, pack_pairs(tp).rows).rows)
    _, tr = both_rays(_camera_arrays(SCENES["sphere"](), 16, 8))
    ops = ft.kernel_operands(tr)
    before = (ft.launch_count, ft.count_launch_count)
    out = ft.fat_traverse(rows, *ops, count=True)
    counts = {}
    plain = ft.trace_fat_plain(rows, *ops, counts=counts)
    assert (ft.launch_count, ft.count_launch_count) == before
    for a, b in zip(out[:7], plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(out[7].numpy(), counts["box_tests"].numpy())
    np.testing.assert_array_equal(out[8].numpy(), counts["tri_entry_tests"].numpy())
    assert (counts["tri_entry_tests"] <= counts["tri_tests"]).all()
