"""PyTorch port vs the JAX reference: the hybrid build (``bvh/hybrid.py``:
the LBVH's sub-root pairs at depth 8 under an SAH-built top) and the build
dispatcher (``bvh/build.py``).

``extract_depth``, ``build_hybrid`` and the fat collapse of the hybrid tree
are bit-equal to the reference's; the hybrid tree passes
``verify_hierarchy`` and K6's stack check, and is traced by ``trace_rays``
against brute force and by K6's plain version against the reference's K6 in
Pallas interpret mode on 128 rays (hit exact, t to rtol 1e-6, the triangle
equal but on exact t ties).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import build as jbuild  # noqa: E402
from tpu_raytracing.bvh import hybrid as jhybrid  # noqa: E402
from tpu_raytracing.bvh import lbvh as jlbvh  # noqa: E402
from tpu_raytracing.bvh import verify as jverify  # noqa: E402
from tpu_raytracing.bvh import wide as jwide  # noqa: E402
from tpu_raytracing.scene import procedural  # noqa: E402
from tpu_raytracing.trace.brute import brute_force_trace as jbrute  # noqa: E402
from tpu_raytracing.trace.modes import BuildType as JBuildType  # noqa: E402
from tpu_raytracing.trace.traverse import pack_pairs as jpack_pairs  # noqa: E402
from tpu_raytracing_torch.bvh import build, hybrid, lbvh, wide  # noqa: E402
from tpu_raytracing_torch.bvh.verify import count_nodes, verify_hierarchy  # noqa: E402
from tpu_raytracing_torch.ops import fat_traverse as ft  # noqa: E402
from tpu_raytracing_torch.trace.modes import BuildType  # noqa: E402
from tpu_raytracing_torch.trace.traverse import pack_bvh, pack_pairs, trace_rays  # noqa: E402
from tests.test_torch_fat_traverse import _camera_arrays, assert_hits_match  # noqa: E402
from tests.test_torch_traverse import aimed_rays, both_rays  # noqa: E402

torch.set_num_threads(2)
SCENES = {
    "cornell": procedural.cornell_box,
    "sphere": lambda: procedural.sphere_scene(3),
    "terrain": lambda: procedural.terrain(8000),
}
FIXTURES = ("sphere", "terrain")
BVH_FIELDS = ("node_min", "node_max", "child", "count", "type", "parent", "root", "root_count")


@functools.lru_cache(maxsize=None)
def scene(name):
    return SCENES[name]()


def same(ref, out, name=""):
    """Bit-equal: float32 compared as int32 words."""
    ref = np.asarray(ref)
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    if ref.dtype == np.float32:
        ref, out = ref.view(np.int32), out.astype(np.float32).view(np.int32)
    assert ref.shape == out.shape, (name, ref.shape, out.shape)
    np.testing.assert_array_equal(ref, out.astype(ref.dtype), err_msg=name)


@functools.lru_cache(maxsize=None)
def jax_hybrid(name, pairs):
    fn = jax.jit(jhybrid.build_hybrid, static_argnames="enable_pairs")
    return jax.tree.map(np.asarray, fn(jnp.asarray(scene(name).triangles), enable_pairs=pairs))


@functools.lru_cache(maxsize=None)
def port_hybrid(name, pairs):
    return hybrid.build_hybrid(torch.from_numpy(scene(name).triangles), pairs)


@pytest.mark.parametrize("pairs", [False, True], ids=["tris", "pairs"])
@pytest.mark.parametrize("name", FIXTURES)
def test_build_hybrid_bit_equal(name, pairs):
    """``extract_depth`` on the same LBVH and ``build_hybrid`` end to end:
    every field bit for bit (the sub-roots in the same BFS order), the pair
    table too; the hierarchy checks agree with the reference's."""
    jb, jp = jax_hybrid(name, pairs)
    tb, tp = port_hybrid(name, pairs)
    for f in BVH_FIELDS:
        same(getattr(jb, f), getattr(tb, f), f)
    for f in ("v0", "v1", "v2", "v3", "prim_id_0", "prim_id_1"):
        same(getattr(jp, f), getattr(tp, f), f)
    tris = scene(name).triangles
    jbase, _ = jax.jit(jlbvh.build_lbvh, static_argnames="enable_pairs")(
        jnp.asarray(tris), enable_pairs=pairs)
    tbase, _ = lbvh.build_lbvh(torch.from_numpy(tris), pairs)
    for a, b in zip(jax.jit(jhybrid.extract_depth)(jbase), hybrid.extract_depth(tbase)):
        same(a, b, "extract_depth")
    assert int(tb.root) == tbase.num_slots and int(tb.root_count) == 1
    ref = jverify.count_nodes(jax.tree.map(jnp.asarray, jb))
    out = count_nodes(tb)
    assert (out.num_nodes, out.num_tree_nodes, out.num_leaf_nodes) == (
        ref.num_nodes, ref.num_tree_nodes, ref.num_leaf_nodes)
    assert verify_hierarchy(tb) == [] == jverify.verify_hierarchy(jax.tree.map(jnp.asarray, jb))
    ft.check_stack_depth(tb)


@pytest.mark.parametrize("pairs", [False, True], ids=["tris", "pairs"])
def test_hybrid_traced_by_trace_rays_and_collapsed(pairs):
    """The hybrid tree's single appended root through the port's scalar
    ``trace_rays`` (against brute force on camera and aimed rays) and
    through ``build_wide_fat``, bit-equal to the reference's collapse."""
    sc = scene("sphere")
    jb, jp = jax_hybrid("sphere", pairs)
    tb, tp = port_hybrid("sphere", pairs)
    packed = pack_pairs(tp)
    rng = np.random.default_rng(1001)
    for arrays in (_camera_arrays(sc, 16, 16), aimed_rays(sc, rng, 256)):
        jr, tr = both_rays(arrays)
        ref = jbrute(jnp.asarray(sc.triangles), jr)
        rec, stats = trace_rays(pack_bvh(tb), packed, tr)
        hit = np.asarray(ref.hit)
        assert int(stats.overflow.sum()) == 0 and int(hit.sum()) > 32
        # brute force names source triangles: hit exact, t, and the
        # primitive but on exact t ties
        np.testing.assert_array_equal(rec.hit.numpy(), hit)
        t, rt = rec.t.numpy()[hit], np.asarray(ref.t)[hit]
        np.testing.assert_allclose(t, rt, rtol=1e-5)
        assert ((rec.prim_id.numpy()[hit] == np.asarray(ref.prim_id)[hit]) | (t == rt)).all()
    jfat = jax.jit(jwide.build_wide_fat)(jax.tree.map(jnp.asarray, jb),
                                         jpack_pairs(jax.tree.map(jnp.asarray, jp)).rows)
    fat = wide.build_wide_fat(tb, packed.rows)
    same(jfat.rows, fat.rows, "fat rows")
    same(jfat.num_nodes, fat.num_nodes, "wide rows")


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


@pytest.mark.parametrize("name", ["sphere", "terrain"])
def test_hybrid_fat_plain_matches_pallas_kernel(name, pallas_pt):
    """K6's plain version on the port's collapse of the hybrid tree against
    the reference's K6 on the reference's, one packet of 128 camera rays."""
    jb, jp = jax_hybrid(name, True)
    jfat = jax.jit(jwide.build_wide_fat)(jax.tree.map(jnp.asarray, jb),
                                         jpack_pairs(jax.tree.map(jnp.asarray, jp)).rows)
    arrays = _camera_arrays(scene(name), 16, 8)
    jr, tr = both_rays(arrays)
    ref, _ = pallas_pt.trace_rays_pallas(pallas_pt.pad_rows_256(jfat.rows), jr)
    tb, tp = port_hybrid(name, True)
    rows = ft.pad_rows_256(wide.build_wide_fat(tb, pack_pairs(tp).rows).rows)
    rec, stats = ft.trace_rays_fat(rows, tr)
    assert int(np.asarray(ref.hit).sum()) > 16 and int(stats.overflow) == 0
    assert_hits_match(rec, ref)


@pytest.mark.parametrize("build_type", list(BuildType), ids=[b.value for b in BuildType])
def test_build_dispatcher_and_memory_quotes(build_type):
    """``build.build`` over every BuildType against the reference's
    dispatcher on the same triangles, and both memory quotes."""
    tris = scene("cornell").triangles
    jb, jp = jax.jit(jbuild.build, static_argnums=(1, 2))(
        jnp.asarray(tris), JBuildType(build_type.value), True)
    tb, tp = build.build(torch.from_numpy(tris), build_type, True)
    for f in BVH_FIELDS:
        same(getattr(jb, f), getattr(tb, f), f)
    same(jp.v0, tp.v0, "pairs")
    for n in (1, 2, 1000, 999_698, 1 << 24):
        assert build.sah_memory_requirements(n) == jbuild.sah_memory_requirements(n)
        assert build.bu_memory_requirements(n) == jbuild.bu_memory_requirements(n)
    with pytest.raises(ValueError, match="unknown build type"):
        build.build(torch.from_numpy(tris), "octree")
