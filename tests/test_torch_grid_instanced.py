"""Instancing over the uniform grid (``trace/grid_instanced.py``) in the
PyTorch port against the JAX reference, on the scenes of
``tests/test_tlas.py``'s instanced-grid tests: 12 instances of
``icosphere(1)`` under random rotations, scales and shifts, and 12 nearly
coincident ones that overflow a work list of ``work_factor=1``.

The reference's own structure (``build_instanced_grid``) is carried over by
``convert.instanced_grid_from_numpy`` and traced by both packages: hit,
t, tri_id, prim_id, the instance id, the per-ray tests and the overflow
count are equal exactly (the grid tracer's Möller-Trumbore rounds as XLA's
CPU code does, ``grid_trace._mt_cols``, and ``instanced.transform_rays``
sums as the reference's einsum). The port's own build meets the flattened
brute force (hit exactly, t to rtol 2e-4 as tests/test_tlas.py: the
object-space t of a transformed ray).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import lbvh as jlbvh  # noqa: E402
from tpu_raytracing.scene.procedural import icosphere  # noqa: E402
from tpu_raytracing.trace import grid_instanced as jgi  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing.trace.traverse import pack_pairs as jpack_pairs  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.trace import grid_instanced, split_trace  # noqa: E402
from tpu_raytracing_torch.trace.brute import brute_force_trace  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402

torch.set_num_threads(2)
GRID_FIELDS = ("cell_start", "cell_count", "refs", "big", "num_big", "overflow", "grid_min",
               "grid_max", "cell_size", "cell_word", "res")


def transforms(num, rng):
    """tests/test_tlas.py:_transforms."""
    out = np.zeros((num, 3, 4), np.float32)
    for i in range(num):
        angle = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(angle), np.sin(angle)
        out[i, :, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32) * rng.uniform(
            0.5, 1.5)
        out[i, :, 3] = rng.uniform(-5, 5, 3)
    return out


def ray_grid(extent, res=32):
    """tests/test_tlas.py:_rays_grid about the origin."""
    xs = np.linspace(-extent, extent, res, dtype=np.float32)
    ox, oy = np.meshgrid(xs, xs)
    n = res * res
    o = np.stack([ox.ravel(), oy.ravel(), np.full(n, -3 * extent, np.float32)], -1)
    d = np.tile(np.array([[0, 0, 1]], np.float32), (n, 1))
    return [np.asarray(a, np.float32) for a in (o, d, np.full(n, 1e-5), np.full(n, 100.0))]


def both(arrays):
    return (JRays(*(jnp.asarray(a) for a in arrays)),
            Rays(*(torch.from_numpy(np.array(a)) for a in arrays)))


def reference_structure(mesh, tf):
    _, pairs = jax.jit(jlbvh.build_lbvh)(jnp.asarray(mesh))
    jpacked = jpack_pairs(pairs)
    ias = jax.jit(jgi.build_instanced_grid)(jpacked, jnp.asarray(tf))
    fields = dict(blas_grid={k: np.asarray(getattr(ias.blas_grid, k)) for k in GRID_FIELDS},
                  inst_min=np.asarray(ias.inst_min), inst_max=np.asarray(ias.inst_max),
                  inv_transforms=np.asarray(ias.inv_transforms))
    return ias, jpacked, convert.instanced_grid_from_numpy(fields, "cpu"), \
        convert.packed_from_numpy(np.asarray(jpacked.rows), "cpu")


def assert_same(rec, inst, stats, ov, ref):
    jrec, jinst, jstats, jov = ref
    for f in ("hit", "t", "tri_id", "prim_id"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(), np.asarray(getattr(jrec, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(inst.numpy(), np.asarray(jinst))
    np.testing.assert_array_equal(stats.box_tests.numpy(), np.asarray(jstats.box_tests))
    np.testing.assert_array_equal(stats.tri_tests.numpy(), np.asarray(jstats.tri_tests))
    assert int(ov) == int(jov)


def test_instanced_grid_matches_reference():
    rng = np.random.default_rng(7)
    mesh = icosphere(subdivisions=1, radius=0.8)
    tf = transforms(12, rng)
    ias_j, jpacked, ias, packed = reference_structure(mesh, tf)
    jr, tr = both(ray_grid(6.0))
    for any_hit in (False, True):
        ref = jax.jit(lambda i, p, r: jgi.trace_rays_instanced_grid(
            i, p, r, m_cand=16, any_hit=any_hit))(ias_j, jpacked, jr)
        rec, inst, stats, ov = grid_instanced.trace_rays_instanced_grid(
            ias, packed, tr, any_hit=any_hit)
        assert_same(rec, inst, stats, ov, ref)
        assert int(stats.overflow) == 0 and int(rec.hit.sum()) > 50
        grid_instanced.check_instanced_grid_capacity(ov)

    # the port's own build: the same boxes, and brute force over the
    # flattened world triangles
    own = grid_instanced.build_instanced_grid(packed, torch.from_numpy(tf))
    np.testing.assert_array_equal(own.inst_min.numpy(), np.asarray(ias_j.inst_min))
    np.testing.assert_array_equal(own.inst_max.numpy(), np.asarray(ias_j.inst_max))
    np.testing.assert_allclose(own.inv_transforms.numpy(), np.asarray(ias_j.inv_transforms),
                               rtol=1e-5, atol=1e-6)
    rec, inst, _, _ = grid_instanced.trace_rays_instanced_grid(own, packed, tr)
    world = (np.einsum("ijk,tvk->itvj", tf[:, :, :3], mesh) + tf[:, None, None, :, 3]).reshape(
        -1, 3, 3).astype(np.float32)
    ref = brute_force_trace(torch.from_numpy(world), tr)
    hit = rec.hit.numpy()
    np.testing.assert_array_equal(hit, ref.hit.numpy())
    np.testing.assert_allclose(rec.t.numpy()[hit], ref.t.numpy()[hit], rtol=2e-4, atol=1e-5)
    same_t = np.isclose(rec.t.numpy(), ref.t.numpy(), rtol=1e-4)
    ref_inst = ref.prim_id.numpy() // mesh.shape[0]
    np.testing.assert_array_equal(inst.numpy()[hit & same_t], ref_inst[hit & same_t])


def test_instanced_grid_overflow_count():
    """Nearly coincident instances and work_factor=1: both packages count
    the same items past the cap and keep the same ones; the port also sets
    TraceStats.overflow, and both checks raise. The mesh and the instance
    count are the first test's, so the reference's build compiles once for
    both."""
    mesh = icosphere(subdivisions=1, radius=0.8)
    tf = np.zeros((12, 3, 4), np.float32)
    for i in range(12):
        tf[i, :, :3] = np.eye(3, dtype=np.float32)
        tf[i, 2, 3] = i * 0.1
    ias_j, jpacked, ias, packed = reference_structure(mesh, tf)
    jr, tr = both(ray_grid(0.5))
    ref = jax.jit(lambda i, p, r: jgi.trace_rays_instanced_grid(i, p, r, work_factor=1))(
        ias_j, jpacked, jr)
    rec, inst, stats, ov = grid_instanced.trace_rays_instanced_grid(ias, packed, tr,
                                                                    work_factor=1)
    assert_same(rec, inst, stats, ov, ref)
    assert int(ov) > 0 and int(stats.overflow) == 1
    with pytest.raises(RuntimeError, match="instanced-grid overflow"):
        grid_instanced.check_instanced_grid_capacity(ov)
    with pytest.raises(RuntimeError, match="work list"):
        split_trace.check_overflow(stats.overflow)
