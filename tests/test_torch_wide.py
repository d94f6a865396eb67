"""PyTorch port's binary packing and 8-wide collapse vs the JAX reference:
``pack_bvh``, ``build_wide`` and ``build_wide_fat`` rows (int32, float bits
cast in) and ``num_nodes``, bit for bit, on trees both packages build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import lbvh as jlbvh  # noqa: E402
from tpu_raytracing.bvh import wide as jwide  # noqa: E402
from tpu_raytracing.scene import procedural  # noqa: E402
from tpu_raytracing.trace.traverse import pack_bvh as jpack_bvh  # noqa: E402
from tpu_raytracing.trace.traverse import pack_pairs as jpack_pairs  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import lbvh, wide  # noqa: E402
from tpu_raytracing_torch.bvh.types import CHILD_BOX, CHILD_TRI  # noqa: E402
from tpu_raytracing_torch.trace.traverse import pack_bvh, pack_pairs  # noqa: E402

torch.set_num_threads(2)
_jbuild = jax.jit(jlbvh.build_lbvh, static_argnames="enable_pairs")
_jwide = jax.jit(jwide.build_wide)
_jfat = jax.jit(jwide.build_wide_fat)


@pytest.fixture(scope="module")
def terrain():
    return procedural.terrain(8000)


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("name", ["cornell", "sphere", "soup", "terrain"])
def test_collapse_bit_equal(name, pairs, request):
    scene = request.getfixturevalue(name)
    jb, jp = _jbuild(jnp.asarray(scene.triangles), enable_pairs=pairs)
    tb, tp = lbvh.build_lbvh(torch.from_numpy(scene.triangles), pairs)
    jt = jpack_bvh(jb)
    tt = pack_bvh(tb)
    np.testing.assert_array_equal(np.asarray(jt.rows), tt.rows.numpy())
    assert int(jt.root) == int(tt.root) and int(jt.root_count) == int(tt.root_count)
    jw, tw = _jwide(jb), wide.build_wide(tb)
    np.testing.assert_array_equal(np.asarray(jw.rows), tw.rows.numpy())
    assert int(jw.num_nodes) == int(tw.num_nodes)
    jf = _jfat(jb, jpack_pairs(jp).rows)
    tf = wide.build_wide_fat(tb, pack_pairs(tp).rows)
    np.testing.assert_array_equal(np.asarray(jf.rows), tf.rows.numpy())
    assert int(jf.num_nodes) == int(tf.num_nodes)


def test_every_pair_reachable_once(soup):
    """Walking the wide rows from row 0 reaches every pair exactly once."""
    tb, _ = lbvh.build_lbvh(torch.from_numpy(soup.triangles), False)
    rows = wide.build_wide(tb).rows.numpy().reshape(-1, wide.WIDE, 8)
    seen, stack = [], [0]
    while stack:
        meta = rows[stack.pop(), :, 6]
        seen.extend((meta[(meta & 3) == CHILD_TRI] >> 5).tolist())
        stack.extend((meta[(meta & 3) == CHILD_BOX] >> 5).tolist())
    np.testing.assert_array_equal(np.sort(seen), np.arange(soup.num_triangles))


def test_expand_group_single_root(sphere):
    """A single-slot root group takes three expansions to fill a row."""
    tb, _ = lbvh.build_lbvh(torch.from_numpy(sphere.triangles), False)
    jb, _ = _jbuild(jnp.asarray(sphere.triangles), enable_pairs=False)
    entries = np.array([0] + [-1] * 7, np.int32)
    for levels in (1, 2, 3):
        ref = np.asarray(jwide._expand_group(jb, jnp.asarray(entries), levels=levels))
        got = wide._expand_group(tb, torch.from_numpy(entries).long(), levels=levels)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_jax_built_structures_convert(sphere):
    jb, jp = _jbuild(jnp.asarray(sphere.triangles), enable_pairs=True)
    jt = jpack_bvh(jb)
    trav = convert.traversal_from_numpy(np.asarray(jt.rows), np.asarray(jt.root),
                                        np.asarray(jt.root_count), "cpu")
    jw = _jwide(jb)
    tw = convert.wide_from_numpy(np.asarray(jw.rows), np.asarray(jw.num_nodes), "cpu")
    jf = _jfat(jb, jpack_pairs(jp).rows)
    tf = convert.fat_from_numpy(np.asarray(jf.rows), np.asarray(jf.num_nodes), "cpu")
    tb, tp = lbvh.build_lbvh(torch.from_numpy(sphere.triangles), True)
    np.testing.assert_array_equal(trav.rows.numpy(), pack_bvh(tb).rows.numpy())
    np.testing.assert_array_equal(tw.rows.numpy(), wide.build_wide(tb).rows.numpy())
    own = wide.build_wide_fat(tb, pack_pairs(tp).rows)
    np.testing.assert_array_equal(tf.rows.numpy(), own.rows.numpy())
    assert int(tf.num_nodes) == int(own.num_nodes) == int(tw.num_nodes)
