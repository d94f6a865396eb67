"""PyTorch port's treelet BVH vs the JAX reference: the build is bit-equal on
the same scene, the classification-only pair -> treelet map equals the
build's, capacity overflows raise the dedicated error, a JAX-built
structure carries into the port unchanged, and the kernel's column-major
copy of the tables holds the same words."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import bucket as jbucket  # noqa: E402
from tpu_raytracing.bvh import treelet as jtreelet  # noqa: E402
from tpu_raytracing.scene import procedural  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import bucket as tbucket  # noqa: E402
from tpu_raytracing_torch.bvh import treelet as ttreelet  # noqa: E402
from tpu_raytracing_torch.trace.brute import brute_force_trace  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402

torch.set_num_threads(2)

# (scene, pairs, leaf width, ecap): ecap 16 with 8-pair windows forces the
# multi-round cut and many portals at soup size (tests/test_treelet.py:95).
CASES = {
    "cornell": ("cornell", False, 16, 128),
    "sphere_pairs": ("sphere", True, 16, 128),
    "soup_multi_round": ("soup", True, 8, 16),
    "tiny_window_root": ("tiny", True, 16, 128),
}


@functools.lru_cache(maxsize=None)
def _triangles(name):
    if name == "tiny":  # fewer pairs than one window: the root is a window
        return procedural.cornell_box().triangles[:12]
    return {"cornell": procedural.cornell_box, "sphere": lambda: procedural.sphere_scene(3),
            "soup": lambda: procedural.random_triangle_soup(2000, seed=1)}[name]().triangles


@functools.lru_cache(maxsize=None)
def _jax_build(case):
    name, pairs, lw, ecap = CASES[case]
    front = jax.jit(lambda t: jbucket.split_front(t, enable_pairs=pairs))(
        jnp.asarray(_triangles(name)))
    tcap = jtreelet.treelet_capacity(front, lw, ecap=ecap) + 8
    tb, packed = jax.jit(lambda f: jtreelet.build_treelet(f, tcap, leaf_width=lw, ecap=ecap))(front)
    return tcap, jax.tree.map(np.asarray, tb), np.asarray(packed.rows)


def _port_front(case):
    name, pairs, _, _ = CASES[case]
    return tbucket.split_front(torch.from_numpy(_triangles(name)), pairs)


@pytest.mark.parametrize("case", list(CASES))
def test_build_bit_equal_to_jax(case):
    _, _, lw, ecap = CASES[case]
    tcap, jtb, jrows = _jax_build(case)
    front = _port_front(case)
    assert ttreelet.treelet_capacity(front, lw, ecap) + 8 == tcap
    tb, packed = ttreelet.build_treelet(front, tcap, leaf_width=lw, ecap=ecap)
    ttreelet.check_treelet_capacity(tb)
    np.testing.assert_array_equal(tb.tables.numpy().view(np.int32), jtb.tables.view(np.int32))
    np.testing.assert_array_equal(tb.pair_tid.numpy(), jtb.pair_tid)
    for field in ("num_treelets", "root_tid", "max_col", "num_leaves"):
        assert int(getattr(tb, field)) == int(getattr(jtb, field)), field
    np.testing.assert_array_equal(packed.rows.numpy(), jrows)
    assert tb.wh == ttreelet.table_words(lw) and tb.leaf_width == lw
    # the classification-only map is the build's
    np.testing.assert_array_equal(ttreelet.build_pair_tid(front, lw, ecap).numpy(),
                                  tb.pair_tid.numpy())


def test_capacity_errors():
    front = _port_front("soup_multi_round")
    need = ttreelet.treelet_capacity(front, 8, 16)
    assert need > 8
    tb, _ = ttreelet.build_treelet(front, need - 1, leaf_width=8, ecap=16)
    with pytest.raises(ttreelet.TreeletCapacityError) as err:
        ttreelet.check_treelet_capacity(tb)
    assert not err.value.column_overflow  # a bigger tcap helps: retryable
    # an element budget too small for the tree's inner rows cannot be
    # cured by a bigger tcap
    tb, _ = ttreelet.build_treelet(front, 4 * need, leaf_width=8, ecap=2)
    with pytest.raises(ttreelet.TreeletCapacityError) as err:
        ttreelet.check_treelet_capacity(tb)
    assert err.value.column_overflow


def test_auto_build_and_walk_match_brute(sphere, rng):
    """build_treelet_auto sizes tcap from the pair count; the numpy walk over
    its tables matches brute force on rays from inside the sphere's box."""
    front = tbucket.split_front(torch.from_numpy(sphere.triangles), True)
    tb, packed = ttreelet.build_treelet_auto(front)
    assert tb.tables.shape[0] >= int(tb.num_treelets)
    lo, hi = sphere.aabb_min, sphere.aabb_max
    o = (lo + (hi - lo) * rng.random((256, 3))).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin, tmax = np.zeros(256, np.float32), np.full(256, 1e6, np.float32)
    t, tri = ttreelet.reference_walk(tb, o, d, tmin, tmax)
    ref = brute_force_trace(torch.from_numpy(sphere.triangles),
                            Rays(*(torch.from_numpy(a) for a in (o, d, tmin, tmax))))
    hit = ref.hit.numpy()
    assert hit.sum() > 64
    np.testing.assert_array_equal(tri >= 0, hit)
    np.testing.assert_allclose(np.where(hit, t, 0), np.where(hit, ref.t.numpy(), 0), rtol=1e-5)
    rows = packed.rows.numpy()
    prow = rows[np.clip(tri >> 1, 0, None)]
    prim = np.where(tri & 1, prow[:, 13], prow[:, 12])
    np.testing.assert_array_equal(np.where(hit, prim, 0), np.where(hit, ref.prim_id.numpy(), 0))


@pytest.mark.parametrize("case", ["sphere_pairs", "soup_multi_round"])
def test_treelet_from_numpy(case):
    """A JAX-built structure carries over bit for bit; the port's own
    structure round-trips through numpy."""
    _, _, lw, _ = CASES[case]
    _, jtb, _ = _jax_build(case)
    fields = dict(tables=jtb.tables, num_treelets=jtb.num_treelets, root_tid=jtb.root_tid,
                  max_col=jtb.max_col, num_leaves=jtb.num_leaves, pair_tid=jtb.pair_tid,
                  leaf_width=jtb.leaf_width)
    tb = convert.treelet_from_numpy(fields, "cpu")
    assert tb.leaf_width == lw and tb.tables.dtype == torch.float32
    np.testing.assert_array_equal(tb.tables.numpy().view(np.int32), jtb.tables.view(np.int32))
    back = convert.treelet_from_numpy(
        {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in vars(tb).items()}, "cpu")
    for key, val in vars(tb).items():
        other = getattr(back, key)
        if isinstance(val, torch.Tensor):
            assert val.dtype == other.dtype, key
            np.testing.assert_array_equal(val.numpy(), other.numpy())
        else:
            assert val == other


@pytest.mark.parametrize("case", list(CASES))
def test_columns_are_the_tables_transposed(case):
    """``columns`` (the layout K5 reads) is ``tables.transpose(1, 2)``, word
    for word and contiguous, from the port's build and from a JAX-built
    structure through ``convert``."""
    _, _, lw, ecap = CASES[case]
    tcap, jtb, _ = _jax_build(case)
    tb, _ = ttreelet.build_treelet(_port_front(case), tcap, leaf_width=lw, ecap=ecap)
    fields = dict(tables=jtb.tables, num_treelets=jtb.num_treelets, root_tid=jtb.root_tid,
                  max_col=jtb.max_col, num_leaves=jtb.num_leaves, pair_tid=jtb.pair_tid,
                  leaf_width=jtb.leaf_width)
    for tree in (tb, convert.treelet_from_numpy(fields, "cpu")):
        assert tree.columns.shape == (tcap, ecap, ttreelet.table_words(lw))
        assert tree.columns.is_contiguous() and tree.columns.dtype == torch.float32
        np.testing.assert_array_equal(tree.columns.numpy().view(np.int32),
                                      tree.tables.transpose(1, 2).numpy().view(np.int32))
