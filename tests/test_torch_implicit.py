"""The implicit (complete-heap) builds of the PyTorch port against the JAX
reference: ``bvh/implicit.py:build_implicit`` and
``build_implicit_wide_fat`` bit-equal to the reference's (every BVH field,
the pairs and the fat rows, float32 as int32 words) for the cases of
``tests/test_implicit.py`` (2, 3, 33 and 1,000 random triangles), the
port's ``verify_hierarchy`` and leaf order on them, and their hits: the
heap traced by ``trace_rays`` against the Karras tree and brute force (hit
exact, t to rtol 1e-6), and the fat rows by K6's plain version against
``trace_rays`` on the same heap (hit exact, t to rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import implicit as jimplicit  # noqa: E402
from tpu_raytracing_torch.bvh import implicit, lbvh  # noqa: E402
from tpu_raytracing_torch.bvh.types import CHILD_NONE, CHILD_TRI  # noqa: E402
from tpu_raytracing_torch.bvh.verify import leaf_primitive_ids, verify_hierarchy  # noqa: E402
from tpu_raytracing_torch.scene import camera as cam  # noqa: E402
from tpu_raytracing_torch.trace import wide_fat  # noqa: E402
from tpu_raytracing_torch.trace.brute import brute_force_trace  # noqa: E402
from tpu_raytracing_torch.trace.packet import tile_reorder  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays, generate_primary_rays  # noqa: E402
from tpu_raytracing_torch.trace.traverse import pack_bvh, pack_pairs, trace_rays  # noqa: E402

torch.set_num_threads(2)
_jbuild_wide = jax.jit(jimplicit.build_implicit_wide_fat)
BVH_FIELDS = ("node_min", "node_max", "child", "count", "type", "parent", "root", "root_count")
PAIR_FIELDS = ("v0", "v1", "v2", "v3", "prim_id_0", "prim_id_1", "rot_0", "rot_1")


def _tris(num):
    rng = np.random.default_rng(num)
    return (rng.random((num, 3, 3), np.float32) * 10).astype(np.float32)


def same(ref, out, name=""):
    ref = np.asarray(ref)
    out = out.numpy()
    if ref.dtype == np.float32:
        ref, out = ref.view(np.int32), out.astype(np.float32).view(np.int32)
    assert ref.shape == out.shape, (name, ref.shape, out.shape)
    np.testing.assert_array_equal(ref, out.astype(ref.dtype), err_msg=name)


@pytest.mark.parametrize("num", [2, 3, 33, 1000])
def test_implicit_builds_match_jax(num):
    jfat, jpairs, jbvh = _jbuild_wide(jnp.asarray(_tris(num)))
    fat, pairs, bvh = implicit.build_implicit_wide_fat(torch.from_numpy(_tris(num)))
    for f in BVH_FIELDS:
        same(getattr(jbvh, f), getattr(bvh, f), f)
    for f in PAIR_FIELDS:
        same(getattr(jpairs, f), getattr(pairs, f), f)
    same(jfat.rows, fat.rows, "rows")
    same(jfat.num_nodes, fat.num_nodes, "num_nodes")
    # build_implicit alone is the same heap
    bvh2, _ = implicit.build_implicit(torch.from_numpy(_tris(num)))
    for f in BVH_FIELDS:
        assert torch.equal(getattr(bvh, f), getattr(bvh2, f)), f


@pytest.mark.parametrize("num", [2, 3, 33, 1000])
def test_implicit_valid_tree(num):
    bvh, pairs = implicit.build_implicit(torch.from_numpy(_tris(num)))
    assert verify_hierarchy(bvh) == []
    np.testing.assert_array_equal(leaf_primitive_ids(bvh, pairs), np.arange(num))
    cap = 1 << max((num - 1).bit_length(), 1)
    ntype = bvh.type.numpy()
    assert (ntype[cap:cap + num] == CHILD_TRI).all() and (ntype[cap + num:] == CHILD_NONE).all()


def test_implicit_hits(sphere):
    """The heap against the Karras tree and brute force under
    ``trace_rays``, and its fat rows under K6's plain version."""
    tris = torch.from_numpy(sphere.triangles)
    c = cam.camera_to_device(cam.initialise_camera(sphere.aabb_min, sphere.aabb_max), "cpu")
    rays = generate_primary_rays(c, 32, 32)
    fat, pairs, bvh = implicit.build_implicit_wide_fat(tris)
    packed = pack_pairs(pairs)
    rec, _ = trace_rays(pack_bvh(bvh), packed, rays)
    kb, kp = lbvh.build_lbvh(tris)
    krec, _ = trace_rays(pack_bvh(kb), pack_pairs(kp), rays)
    ref = brute_force_trace(tris, rays)
    hit = ref.hit.numpy()
    assert hit.sum() > 0
    for other in (krec, ref):
        np.testing.assert_array_equal(rec.hit.numpy(), other.hit.numpy())
        np.testing.assert_allclose(rec.t.numpy()[hit], other.t.numpy()[hit], rtol=1e-6)
    tiled = Rays(*(tile_reorder(getattr(rays, f), 32, 32, 16, 8)
                   for f in ("origin", "direction", "tmin", "tmax")))
    frec, stats = wide_fat.trace_rays_wide_fat(fat, packed, tiled)
    # ``trace_rays`` walks each ray on its own: its record of the tiled rays
    # is ``rec`` in tile order
    s_hit, s_t = (tile_reorder(a, 32, 32, 16, 8) for a in (rec.hit, rec.t))
    np.testing.assert_array_equal(frec.hit.numpy(), s_hit.numpy())
    h = s_hit.numpy()
    np.testing.assert_allclose(frec.t.numpy()[h], s_t.numpy()[h], rtol=1e-6)
    assert int(stats.overflow) == 0
