"""PyTorch port's binary packing and 8-wide collapse vs the JAX reference:
``pack_bvh``, ``build_wide`` and ``build_wide_fat`` rows (int32, float bits
cast in) and ``num_nodes``, bit for bit, on trees both packages build; and
``collapse_fat``, the app's collapse, on CPU tensors: bit-equal to the
reference's ``build_wide_fat`` on a single-root tree, a one-leaf and a
two-leaf tree and a deep caterpillar, the stack-depth error on a deeper one,
its operand checks. On the card it launches ``csrc/wide_collapse.cu``,
which ``chip_smoke.py`` phase 20 holds to ``build_wide_fat``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import lbvh as jlbvh  # noqa: E402
from tpu_raytracing.bvh import types as jtypes  # noqa: E402
from tpu_raytracing.bvh import wide as jwide  # noqa: E402
from tpu_raytracing.scene import procedural  # noqa: E402
from tpu_raytracing.trace.traverse import pack_bvh as jpack_bvh  # noqa: E402
from tpu_raytracing.trace.traverse import pack_pairs as jpack_pairs  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import lbvh, sah, wide  # noqa: E402
from tpu_raytracing_torch.bvh.types import BVH, CHILD_BOX, CHILD_NONE, CHILD_TRI  # noqa: E402
from tpu_raytracing_torch.ops import fat_traverse as ft  # noqa: E402
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


_BVH_FIELDS = ("node_min", "node_max", "child", "count", "type", "parent", "root", "root_count")


def _caterpillar(depth: int, seed: int = 0):
    """A Karras-style tree (root pair at slots 0-1) of ``depth + 1`` slot
    pairs, each pair's first slot a Box over the next pair and its second a
    leaf, the last pair two leaves: ``depth`` binary levels deep. Returns
    (BVH, pair rows) with random boxes and pair words."""
    gen = torch.Generator().manual_seed(seed)
    n = 2 * (depth + 1)
    slot = torch.arange(n, dtype=torch.int32)
    pair = slot // 2
    box = (slot % 2 == 0) & (pair < depth)
    leaf_index = torch.cumsum((~box).to(torch.int32), 0, dtype=torch.int32) - 1
    lo = torch.rand((n, 3), generator=gen) - 1.0
    bvh = BVH(node_min=lo, node_max=lo + torch.rand((n, 3), generator=gen),
              child=torch.where(box, 2 * pair + 2, leaf_index),
              count=torch.where(box, 2, 1).to(torch.int32),
              type=torch.where(box, CHILD_BOX, CHILD_TRI).to(torch.int32),
              parent=torch.where(pair == 0, slot, 2 * pair - 2).to(torch.int32),
              root=torch.tensor(0, dtype=torch.int32),
              root_count=torch.tensor(2, dtype=torch.int32))
    rows = torch.randint(-2**31, 2**31 - 1, (depth + 2, 16), generator=gen, dtype=torch.int32)
    return bvh, rows


def _collapse_case(name):
    """(BVH, pair rows) of the ``collapse_fat`` fixtures."""
    if name == "single root":  # the binned-SAH tree: root slot 0, root_count 1
        tb, tp = sah.build_sah(torch.from_numpy(procedural.cornell_box().triangles), True)
        return tb, pack_pairs(tp).rows
    if name == "one leaf":  # a root pair whose slot 1 is empty
        f = torch.tensor([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]])
        bvh = BVH(node_min=f - 1.0, node_max=f + 1.0, child=torch.tensor([0, 0], dtype=torch.int32),
                  count=torch.tensor([1, 0], dtype=torch.int32),
                  type=torch.tensor([CHILD_TRI, CHILD_NONE], dtype=torch.int32),
                  parent=torch.tensor([0, 1], dtype=torch.int32),
                  root=torch.tensor(0, dtype=torch.int32),
                  root_count=torch.tensor(2, dtype=torch.int32))
        return bvh, torch.arange(16, dtype=torch.int32)[None] + 100
    if name == "two leaves":
        tb, tp = lbvh.build_lbvh(
            torch.from_numpy(procedural.random_triangle_soup(2, seed=3).triangles), False)
        return tb, pack_pairs(tp).rows
    return _caterpillar(30)


@pytest.mark.parametrize("name", ["single root", "one leaf", "two leaves", "caterpillar"])
def test_collapse_fat_on_cpu_bit_equal(name):
    """``collapse_fat`` on CPU tensors equals the reference's
    ``build_wide_fat`` of the same tree, bit for bit."""
    tb, rows = _collapse_case(name)
    jb = jtypes.BVH(**{f: jnp.asarray(getattr(tb, f).numpy()) for f in _BVH_FIELDS})
    jf = _jfat(jb, jnp.asarray(rows.numpy()))
    before = wide.launch_count
    tf = wide.collapse_fat(tb, rows)
    assert wide.launch_count == before
    np.testing.assert_array_equal(tf.rows.numpy(), np.asarray(jf.rows))
    assert int(tf.num_nodes) == int(jf.num_nodes)


@pytest.mark.parametrize("depth", [70, 5000])
def test_collapse_fat_stack_depth_error(depth):
    """A tree deeper than K6's stack covers raises ``check_stack_depth``'s
    error, with its message."""
    tb, rows = _caterpillar(depth)
    with pytest.raises(ValueError, match="binary levels deep") as want:
        ft.check_stack_depth(tb)
    assert f"the tree is {depth} binary levels deep" in str(want.value)
    with pytest.raises(ValueError) as got:
        wide.collapse_fat(tb, rows)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", ["int64", "non-contiguous", "15 words", "no rows"])
def test_collapse_fat_checks_pair_rows(bad):
    tb, rows = _caterpillar(4)
    rows = {"int64": rows.to(torch.int64),
            "non-contiguous": torch.cat([rows, rows], dim=1)[:, ::2],
            "15 words": rows[:, :15].contiguous(),
            "no rows": rows[:0]}[bad]
    with pytest.raises(ValueError, match="pair_rows"):
        wide.collapse_fat(tb, rows)
