"""PyTorch port's Karras LBVH build and hierarchy checks vs the JAX reference.

The build is integer and min/max arithmetic on the same float inputs, so
every field is held bit for bit: child, count, type, parent, root,
root_count, the bits of node_min/node_max and the packed pair rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import lbvh as jlbvh  # noqa: E402
from tpu_raytracing.bvh import verify as jverify  # noqa: E402
from tpu_raytracing.scene import procedural  # noqa: E402
from tpu_raytracing.trace.traverse import pack_pairs as jpack_pairs  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import lbvh  # noqa: E402
from tpu_raytracing_torch.bvh import verify  # noqa: E402
from tpu_raytracing_torch.trace.traverse import pack_pairs  # noqa: E402

torch.set_num_threads(2)
_jbuild = jax.jit(jlbvh.build_lbvh, static_argnames="enable_pairs")
_FIELDS = ("child", "count", "type", "parent", "root", "root_count")


@pytest.fixture(scope="module")
def terrain():
    return procedural.terrain(8000)


def _builds(scene, pairs):
    jb, jp = _jbuild(jnp.asarray(scene.triangles), enable_pairs=pairs)
    tb, tp = lbvh.build_lbvh(torch.from_numpy(scene.triangles), pairs)
    return jb, jp, tb, tp


def _assert_bvh_equal(jb, tb):
    for f in _FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jb, f)), getattr(tb, f).numpy(),
                                      err_msg=f)
    for f in ("node_min", "node_max"):
        np.testing.assert_array_equal(np.asarray(getattr(jb, f)).view(np.int32),
                                      getattr(tb, f).numpy().view(np.int32), err_msg=f)


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("name", ["cornell", "sphere", "soup", "terrain"])
def test_build_lbvh_bit_equal(name, pairs, request):
    scene = request.getfixturevalue(name)
    jb, jp, tb, tp = _builds(scene, pairs)
    _assert_bvh_equal(jb, tb)
    np.testing.assert_array_equal(np.asarray(jpack_pairs(jp).rows), pack_pairs(tp).rows.numpy())
    assert int(jlbvh.tree_height(jb)) == int(lbvh.tree_height(tb))


@pytest.mark.parametrize("pairs", [False, True])
def test_morton_stages_match(soup, pairs):
    """The build's front stages, one at a time."""
    tris = jnp.asarray(soup.triangles)
    ttris = torch.from_numpy(soup.triangles)
    jaabb = jlbvh.scene_aabb(tris)
    taabb = lbvh.scene_aabb(ttris)
    if pairs:
        jc, jv, jn = jlbvh.generate_morton_codes_pairs(tris, *jaabb)
        tc, tv, tn = lbvh.generate_morton_codes_pairs(ttris, *taabb)
        assert int(jn) == int(tn)
    else:
        jc, jv = jlbvh.generate_morton_codes(tris, *jaabb)
        tc, tv = lbvh.generate_morton_codes(ttris, *taabb)
    np.testing.assert_array_equal(np.asarray(jc).astype(np.int64), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jv).astype(np.int64), tv.numpy())
    jsc, jsv = jlbvh.sort_codes(jc, jv)
    tsc, tsv = lbvh.sort_codes(tc, tv)
    np.testing.assert_array_equal(np.asarray(jsc).astype(np.int64), tsc.numpy())
    np.testing.assert_array_equal(np.asarray(jsv).astype(np.int64), tsv.numpy())


def test_clz_every_power_of_two():
    x = torch.tensor([0] + [1 << k for k in range(32)] + [(1 << k) - 1 for k in range(2, 33)])
    want = np.asarray(jax.lax.clz(jnp.asarray(x.numpy().astype(np.uint32))), np.int64)
    np.testing.assert_array_equal(lbvh.clz32(x).numpy(), want)
    assert int(lbvh.clz32(torch.tensor(0))) == 32 and int(lbvh.clz32(torch.tensor(1))) == 31


def test_cpl_duplicate_codes_break_ties_by_index():
    """Equal codes fall back to 32 + clz(i ^ j); out-of-range j gives -1."""
    codes = np.array([5, 5, 5, 9, 9, 0xFFFFFFFF, 0xFFFFFFFF], np.uint32)
    n = 5  # the last two are padding
    i = np.array([0, 0, 1, 3, 2, 4, 4, 0], np.int32)
    j = np.array([1, 2, 2, 4, 3, 5, -1, 4], np.int32)
    ref = np.asarray(jlbvh._cpl(jnp.asarray(codes), jnp.asarray(i), jnp.asarray(j), n))
    got = lbvh._cpl(torch.from_numpy(codes.astype(np.int64)), torch.from_numpy(i).long(),
                    torch.from_numpy(j).long(), n)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[0] == 32 + 31 and got[5] == -1 and got[6] == -1


@pytest.mark.parametrize("count", [2, 7, 10])
def test_hierarchy_cpu_takes_plain_path(count):
    """On CPU tensors the hierarchy is the plain version's, live count an int
    or a 0-d tensor, and the card's kernel is never launched."""
    codes = torch.tensor([3, 3, 5, 9, 9, 9, 17, 40, 40, 41, 0xFFFFFFFF, 0xFFFFFFFF])
    before = lbvh.launch_count
    want = lbvh.generate_hierarchy_plain(codes, count)
    for c in (count, torch.tensor(count)):
        got = lbvh.generate_hierarchy(codes, c)
        for f in _FIELDS:
            assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert lbvh.launch_count == before


def test_hierarchy_on_duplicate_centroids():
    """Many triangles with one centroid: the index tie-break shapes the tree."""
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tris = np.concatenate([np.repeat(base[None], 37, 0),
                           base[None] + np.float32([[3, 2, 1]])], 0)
    jb, _ = _jbuild(jnp.asarray(tris), enable_pairs=False)
    tb, _ = lbvh.build_lbvh(torch.from_numpy(tris), False)
    _assert_bvh_equal(jb, tb)
    assert verify.verify_hierarchy(tb) == []


@pytest.mark.parametrize("name,pairs", [("sphere", False), ("terrain", True)])
def test_hierarchy_checks_match(name, pairs, request):
    scene = request.getfixturevalue(name)
    jb, jp, tb, tp = _builds(scene, pairs)
    js, ts = jverify.count_nodes(jb), verify.count_nodes(tb)
    assert dataclasses.astuple(js) == dataclasses.astuple(ts)
    assert jverify.verify_hierarchy(jb) == [] and verify.verify_hierarchy(tb) == []
    np.testing.assert_array_equal(verify.leaf_primitive_ids(tb, tp),
                                  jverify.leaf_primitive_ids(jb, jp))
    if pairs:
        _, _, num_leaves = lbvh.generate_morton_codes_pairs(
            torch.from_numpy(scene.triangles), *lbvh.scene_aabb(torch.from_numpy(scene.triangles)))
        assert ts.num_leaf_nodes == int(num_leaves)
    # one corrupted box: it and its parent fail the exact union, and both
    # checks report the same indices
    node_min = np.asarray(jb.node_min).copy()
    bad = int(np.nonzero(np.asarray(jb.type) == 1)[0][7])
    node_min[bad, 1] -= 1.0
    jbad = jb.replace(node_min=jnp.asarray(node_min))
    tbad = dataclasses.replace(tb, node_min=torch.from_numpy(node_min))
    errors = sorted(verify.verify_hierarchy(tbad))
    assert bad in errors and errors == sorted(jverify.verify_hierarchy(jbad))
    # the loose check only catches the parent, whose box no longer contains it
    loose = sorted(verify.verify_hierarchy(tbad, exact=False))
    assert bad not in loose and loose == sorted(jverify.verify_hierarchy(jbad, exact=False))


def test_refit_level_sync_matches_range_refit(sphere):
    """The level-synchronous refit (leaf boxes placed by
    _leaf_slots_from_hierarchy) equals the range refit, bit for bit."""
    tris = torch.from_numpy(sphere.triangles)
    tb, tp = lbvh.build_lbvh(tris, False)
    lo = torch.minimum(torch.minimum(tp.v0, tp.v1), torch.minimum(tp.v2, tp.v3))
    hi = torch.maximum(torch.maximum(tp.v0, tp.v1), torch.maximum(tp.v2, tp.v3))
    n = tris.shape[0]
    slots = lbvh._leaf_slots_from_hierarchy(tb, n)
    blank = dataclasses.replace(tb, node_min=torch.zeros_like(tb.node_min),
                                node_max=torch.zeros_like(tb.node_max))
    out = lbvh.refit(blank, lo, hi, slots, n)
    np.testing.assert_array_equal(out.node_min.numpy(), tb.node_min.numpy())
    np.testing.assert_array_equal(out.node_max.numpy(), tb.node_max.numpy())
    jb, _ = _jbuild(jnp.asarray(sphere.triangles), enable_pairs=False)
    np.testing.assert_array_equal(
        slots.numpy(), np.asarray(jlbvh._leaf_slots_from_hierarchy(jb, n)))


def test_empty_bvh_matches():
    from tpu_raytracing.bvh.types import empty_bvh as jempty
    from tpu_raytracing_torch.bvh.types import empty_bvh

    jb, tb = jempty(5), empty_bvh(5)
    _assert_bvh_equal(jb, tb)
    assert tb.num_slots == 5


def test_jax_built_tree_converts(cornell):
    jb, _ = _jbuild(jnp.asarray(cornell.triangles), enable_pairs=True)
    tb = convert.bvh_from_numpy({f: np.asarray(getattr(jb, f)) for f in (
        "node_min", "node_max", *_FIELDS)}, "cpu")
    _assert_bvh_equal(jb, tb)
    assert verify.verify_hierarchy(tb) == []
