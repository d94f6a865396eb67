"""PyTorch port vs JAX reference: Morton codes, pairing, sorted pair rows,
the split-BVH emit and its refit — all bit-equal on the same inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import bucket as jbucket  # noqa: E402
from tpu_raytracing.bvh import lbvh as jlbvh  # noqa: E402
from tpu_raytracing.bvh import pairing as jpairing  # noqa: E402
from tpu_raytracing.ops import morton as jmorton  # noqa: E402
from tpu_raytracing.scene import procedural  # noqa: E402
from tpu_raytracing.trace import split_pallas as jsplit_pallas  # noqa: E402
from tpu_raytracing.trace.traverse import PackedPairs as JPackedPairs  # noqa: E402
from tpu_raytracing_torch.bvh import bucket as tbucket  # noqa: E402
from tpu_raytracing_torch.bvh import lbvh as tlbvh  # noqa: E402
from tpu_raytracing_torch.bvh import pairing as tpairing  # noqa: E402
from tpu_raytracing_torch.ops import morton as tmorton  # noqa: E402
from tpu_raytracing_torch.trace.traverse import PackedPairs  # noqa: E402

torch.set_num_threads(2)
LEAFW = 64


@functools.lru_cache(maxsize=None)
def _scene_tris(name):
    return {
        "cornell": lambda: procedural.cornell_box(),
        "sphere": lambda: procedural.sphere_scene(3),
        "soup": lambda: procedural.random_triangle_soup(2000, seed=1),
        "terrain": lambda: procedural.terrain(8000),
    }[name]().triangles


@functools.lru_cache(maxsize=None)
def _jax_views(name):
    fn = jax.jit(lambda t: jbucket.emit_split_views(
        jbucket.split_front(t, enable_pairs=True), leaf_width=LEAFW))
    return jax.tree.map(np.asarray, fn(jnp.asarray(_scene_tris(name))))


def _port_views(name, debug=False):
    tris = torch.from_numpy(_scene_tris(name))
    return tbucket.emit_split_views(tbucket.split_front(tris, True), leaf_width=LEAFW,
                                    debug=debug)


def test_morton_codes_bit_equal():
    rng = np.random.default_rng(101)  # its own: the shared rng fixture depends on file order
    pts = rng.random((5000, 3)).astype(np.float32)
    # edges of the unit cube, out-of-range and the 1023/1024 boundary
    pts[:6] = [[0, 0, 0], [1, 1, 1], [-0.5, 2.0, 0.5],
               [1023 / 1024, 1023.5 / 1024, 1 - 1e-7], [1e-30, 0.5, 0.25], [0.999, 0.001, 0.5]]
    ref = np.asarray(jmorton.morton3d(jnp.asarray(pts))).astype(np.int64)
    out = tmorton.morton3d(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(ref, out)


def test_pairing_flags_bit_equal():
    tris = _scene_tris("terrain")
    a, b = tris[0::2], tris[1::2]
    ref = jpairing.can_form_pair(jnp.asarray(a), jnp.asarray(b))
    out = tpairing.can_form_pair(torch.from_numpy(a), torch.from_numpy(b))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(r), o.numpy())
    # a perturbed copy breaks some shared edges
    b2 = b.copy()
    b2[::3, 1] += np.float32(1e-3)
    ref = jpairing.can_form_pair(jnp.asarray(a), jnp.asarray(b2))
    out = tpairing.can_form_pair(torch.from_numpy(a), torch.from_numpy(b2))
    assert 0 < int(np.asarray(ref[0]).sum()) < a.shape[0]
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(r), o.numpy())

    def boxes(t):
        return t.min(axis=1), t.max(axis=1)

    (amin, amax), (bmin, bmax) = boxes(a), boxes(b2)
    cmin, cmax = np.minimum(amin, bmin), np.maximum(amax, bmax)
    args = (amin, amax, bmin, bmax, cmin, cmax)
    np.testing.assert_array_equal(
        np.asarray(jpairing.should_form_pair(*map(jnp.asarray, args))),
        tpairing.should_form_pair(*map(torch.from_numpy, args)).numpy())


@pytest.mark.parametrize("scene,pairs", [("terrain", True), ("terrain", False),
                                         ("soup", True), ("sphere", True)])
def test_fused_sorted_pairs_bit_equal(scene, pairs):
    tris = _scene_tris(scene)
    jt = jnp.asarray(tris)
    lo, hi = jlbvh.scene_aabb(jt)
    ref = jax.jit(functools.partial(jlbvh.fused_sorted_pairs, enable_pairs=pairs))(jt, lo, hi)
    tt = torch.from_numpy(tris)
    out = tlbvh.fused_sorted_pairs(tt, *tlbvh.scene_aabb(tt), pairs)
    for r, o in zip(ref[:3], out[:3]):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64), o.numpy().astype(np.int64))
    assert int(ref[3]) == int(out[3])


@pytest.mark.parametrize("scene", ["cornell", "sphere", "soup", "terrain"])
def test_emit_split_views_bit_equal(scene):
    (inner_i, inner_v, pairs_f), jpacked, jsplit = _jax_views(scene)
    (inner, pairs, stack_cap), packed, split = _port_views(scene, debug=True)
    w = inner.shape[1]
    assert stack_cap == jsplit_pallas._stack_cap(w, pairs.shape[0])
    np.testing.assert_array_equal(jsplit.inner, split.inner.numpy())
    assert int(jsplit.num_inner) == int(split.num_inner)
    assert int(jsplit.num_leaves) == int(split.num_leaves)
    np.testing.assert_array_equal(jsplit.e_ranges, split.e_ranges.numpy())
    assert int(jsplit.max_slot) == int(split.max_slot)
    np.testing.assert_array_equal(jpacked.rows, packed.rows.numpy())
    # the kernel views equal the reference's with the 128-lane padding stripped
    np.testing.assert_array_equal(inner_i[:, :w * 8].reshape(-1, w, 8), inner.numpy())
    np.testing.assert_array_equal(inner_v.view(np.int32)[:, :, :8], inner.numpy())
    p = pairs.shape[0]
    assert p >= max(packed.rows.shape[0], LEAFW)
    np.testing.assert_array_equal(pairs_f.view(np.int32)[:p, :16], pairs.numpy())
    tbucket.check_split_capacity(split, _scene_tris(scene).shape[0])


def test_refit_split_bit_equal():
    rng = np.random.default_rng(102)  # its own: the shared rng fixture depends on file order
    _, jpacked, jsplit = _jax_views("terrain")
    _, packed, split = _port_views("terrain")
    v = jpacked.rows[:, :12].view(np.float32)
    moved = v + np.float32(0.05) * np.sin(v * np.float32(1.7)).astype(np.float32)
    rows = np.concatenate([moved.view(np.int32), jpacked.rows[:, 12:]], axis=1)
    jsplit = jax.tree.map(jnp.asarray, jsplit)
    ref = jax.jit(jbucket.refit_split)(jsplit, JPackedPairs(rows=jnp.asarray(rows)))
    out = tbucket.refit_split(split, PackedPairs(rows=torch.from_numpy(rows)))
    np.testing.assert_array_equal(np.asarray(ref.inner), out.inner.numpy())
    assert not np.array_equal(np.asarray(ref.inner), split.inner.numpy())  # boxes moved


def test_capacity_checks_raise():
    _, _, split = _port_views("sphere")
    n = _scene_tris("sphere").shape[0]
    tbucket.check_split_capacity(split, n)
    import dataclasses

    too_many = dataclasses.replace(split, num_inner=torch.tensor(10 ** 6))
    with pytest.raises(RuntimeError, match="inner overflow"):
        tbucket.check_split_capacity(too_many, n)
    bad_slot = dataclasses.replace(split, max_slot=torch.tensor(8))
    with pytest.raises(RuntimeError, match="row-slot overflow"):
        tbucket.check_split_capacity(bad_slot, n)
