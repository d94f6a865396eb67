"""PyTorch port's instancing vs the JAX reference: the TLAS build
(``bvh/tlas.py``, ``lbvh.build_lbvh_from_aabbs``), the two-level tracer
(``trace/instanced.py``), the split-kernel instanced tracer
(``trace/instanced_split.py``) and K1's raw output.

The TLAS is bit-equal (world boxes, the Karras tree over them, the packed
rows); the inverse transforms, from LAPACK here and XLA's LU there, agree
to float tolerance, so the tracers are held to the reference on the
reference's own structures, carried over by ``convert.py``: hit, tri_id,
prim_id and the instance exactly, and for the two-level tracer its per-ray
box and triangle tests too; t to rtol 1e-6 and the barycentrics to rtol
1e-6 / atol 1e-5. Both tracers also meet brute force over the flattened
world triangles (as tests/test_tlas.py). The reference's split kernel runs
in Pallas interpret mode at 128 rays with ``c_slots=1``. K1's statistics
are per ray and the TPU kernel's per packet, so they are not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import bucket as jbucket  # noqa: E402
from tpu_raytracing.bvh import lbvh as jlbvh  # noqa: E402
from tpu_raytracing.bvh import tlas as jtlas  # noqa: E402
from tpu_raytracing.bvh.types import CHILD_INST  # noqa: E402
from tpu_raytracing.scene.procedural import icosphere  # noqa: E402
from tpu_raytracing.trace import instanced_split as jis  # noqa: E402
from tpu_raytracing.trace import split_pallas as jsp  # noqa: E402
from tpu_raytracing.trace.instanced import trace_rays_instanced as jtrace_instanced  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing.trace.traverse import pack_pairs as jpack_pairs  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import bucket, lbvh, tlas  # noqa: E402
from tpu_raytracing_torch.trace import instanced, instanced_split, split_trace  # noqa: E402
from tpu_raytracing_torch.trace.brute import brute_force_trace  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402
from tpu_raytracing_torch.trace.traverse import pack_pairs  # noqa: E402

torch.set_num_threads(2)
F32_MAX = float(np.finfo(np.float32).max)
BVH_FIELDS = ("node_min", "node_max", "child", "count", "type", "parent", "root", "root_count")


def transforms(num, rng):
    """Random rotations about z with a scale and a translation: [I, 3, 4]."""
    out = np.zeros((num, 3, 4), np.float32)
    for i in range(num):
        a = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(a), np.sin(a)
        out[i, :, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32) * rng.uniform(
            0.5, 1.5)
        out[i, :, 3] = rng.uniform(-5, 5, 3)
    return out


def flatten(tris, tf):
    """Every instance's triangles in world space (the oracle's geometry)."""
    return (np.einsum("ijk,tvk->itvj", tf[:, :, :3], tris) + tf[:, None, None, :, 3]).reshape(
        -1, 3, 3).astype(np.float32)


def ray_grid(num_side, rng, tmax=100.0):
    """Rays along +z over the instances' x-y spread, slightly tilted."""
    xs = np.linspace(-6.0, 6.0, num_side, dtype=np.float32)
    ox, oy = np.meshgrid(xs, xs)
    n = num_side * num_side
    o = np.stack([ox.ravel(), oy.ravel(), np.full(n, -18.0)], -1).astype(np.float32)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    d[:, :2] += rng.normal(scale=0.05, size=(n, 2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o, d.astype(np.float32), np.full(n, 1e-5, np.float32), np.full(n, tmax, np.float32))


def both(arrays):
    return (JRays(*(jnp.asarray(a) for a in arrays)),
            Rays(*(torch.from_numpy(np.array(a)) for a in arrays)))


def assert_records(rec, ref, uv=True):
    for f in ("hit", "tri_id", "prim_id"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    hit = rec.hit.numpy()
    np.testing.assert_allclose(rec.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-6)
    for f in ("bary_u", "bary_v") if uv else ():
        np.testing.assert_allclose(getattr(rec, f).numpy()[hit], np.asarray(getattr(ref, f))[hit],
                                   rtol=1e-6, atol=1e-5, err_msg=f)


@pytest.fixture(scope="module")
def setup():
    """The icosphere BLAS (80 triangles) and 12 instances, both sides."""
    rng = np.random.default_rng(7)
    mesh = icosphere(subdivisions=1, radius=0.8)
    tf = transforms(12, rng)
    jblas, jpairs = jax.jit(jlbvh.build_lbvh)(jnp.asarray(mesh))
    tblas, tpairs = lbvh.build_lbvh(torch.from_numpy(mesh))
    return dict(mesh=mesh, tf=tf, jblas=jblas, jpairs=jpairs, tblas=tblas, tpairs=tpairs,
                jias=jax.jit(jtlas.build_instanced)(jblas, jnp.asarray(tf)),
                tias=tlas.build_instanced(tblas, torch.from_numpy(tf)))


def test_instance_world_aabbs_and_invert_affine(setup):
    tf = setup["tf"]
    rng = np.random.default_rng(3)
    bmin = rng.uniform(-2, -0.5, 3).astype(np.float32)
    bmax = rng.uniform(0.5, 2, 3).astype(np.float32)
    jw = jax.jit(jtlas.instance_world_aabbs)(jnp.asarray(bmin), jnp.asarray(bmax), jnp.asarray(tf))
    tw = tlas.instance_world_aabbs(torch.from_numpy(bmin), torch.from_numpy(bmax),
                                   torch.from_numpy(tf))
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    inv = tlas.invert_affine(torch.from_numpy(tf)).numpy()
    np.testing.assert_allclose(inv, np.asarray(jtlas.invert_affine(jnp.asarray(tf))), rtol=1e-5,
                               atol=1e-6)
    p = rng.random((12, 3)).astype(np.float32)
    world = np.einsum("ijk,ik->ij", tf[:, :, :3], p) + tf[:, :, 3]
    back = np.einsum("ijk,ik->ij", inv[:, :, :3], world) + inv[:, :, 3]
    np.testing.assert_allclose(back, p, atol=1e-5)


@pytest.mark.parametrize("num", [1, 2, 37], ids=["one-leaf", "two", "many"])
def test_build_lbvh_from_aabbs_matches_jax(num):
    rng = np.random.default_rng(num)
    lo = rng.uniform(-10, 10, (num, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2, (num, 3)).astype(np.float32)
    payload = rng.permutation(num).astype(np.int32)
    ref = jlbvh.build_lbvh_from_aabbs(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(payload),
                                      leaf_type=CHILD_INST, leaf_count=1)
    got = lbvh.build_lbvh_from_aabbs(torch.from_numpy(lo), torch.from_numpy(hi),
                                     torch.from_numpy(payload), leaf_type=CHILD_INST,
                                     leaf_count=1)
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f).numpy()),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    leaves = got.type.numpy() == CHILD_INST
    assert sorted(got.child.numpy()[leaves].tolist()) == list(range(num))
    with pytest.raises(ValueError, match="at least one leaf"):
        lbvh.build_lbvh_from_aabbs(torch.zeros((0, 3)), torch.zeros((0, 3)),
                                   torch.zeros((0,), dtype=torch.int32))


def test_build_instanced_matches_jax(setup):
    jias, tias = setup["jias"], setup["tias"]
    np.testing.assert_array_equal(tias.trav.rows.numpy(), np.asarray(jias.trav.rows))
    assert int(tias.trav.root) == int(jias.trav.root)
    assert int(tias.trav.root_count) == int(jias.trav.root_count)
    assert int(tias.blas_entry) == int(jias.blas_entry)
    np.testing.assert_allclose(tias.inv_transforms.numpy(), np.asarray(jias.inv_transforms),
                               rtol=1e-5, atol=1e-6)


def _carried(setup):
    jias = setup["jias"]
    return convert.instanced_from_numpy(dict(
        rows=np.asarray(jias.trav.rows), root=np.asarray(jias.trav.root),
        root_count=np.asarray(jias.trav.root_count),
        inv_transforms=np.asarray(jias.inv_transforms),
        blas_entry=np.asarray(jias.blas_entry)), "cpu")


def test_trace_rays_instanced_matches_jax_and_brute_force(setup):
    rng = np.random.default_rng(11)
    jr, tr = both(ray_grid(32, rng))
    jpacked = jpack_pairs(setup["jpairs"])
    ref, jinst, jstats = jax.jit(jtrace_instanced)(setup["jias"], jpacked, jr)
    rec, inst, stats = instanced.trace_rays_instanced(
        _carried(setup), convert.packed_from_numpy(np.asarray(jpacked.rows), "cpu"), tr)
    assert_records(rec, ref)
    np.testing.assert_array_equal(inst.numpy(), np.asarray(jinst))
    np.testing.assert_array_equal(stats.box_tests.numpy(), np.asarray(jstats.box_tests))
    np.testing.assert_array_equal(stats.tri_tests.numpy(), np.asarray(jstats.tri_tests))
    assert int(stats.overflow) == 0 and rec.hit.sum() > 64
    # the port's own structure: the same hits and instances
    own, own_inst, _ = instanced.trace_rays_instanced(setup["tias"],
                                                      pack_pairs(setup["tpairs"]), tr)
    np.testing.assert_array_equal(own.hit.numpy(), rec.hit.numpy())
    np.testing.assert_array_equal(own_inst.numpy(), inst.numpy())
    np.testing.assert_allclose(own.t.numpy(), rec.t.numpy(), rtol=1e-5)
    # brute force over the flattened world triangles
    mesh = setup["mesh"]
    oracle = brute_force_trace(torch.from_numpy(flatten(mesh, setup["tf"])), tr)
    hit = own.hit.numpy()
    np.testing.assert_array_equal(hit, oracle.hit.numpy())
    np.testing.assert_allclose(own.t.numpy()[hit], oracle.t.numpy()[hit], rtol=2e-4, atol=1e-5)
    same = np.isclose(own.t.numpy(), oracle.t.numpy(), rtol=1e-4) & hit
    np.testing.assert_array_equal(own_inst.numpy()[same],
                                  oracle.prim_id.numpy()[same] // mesh.shape[0])


def test_instanced_overflow_flag_with_a_small_stack(setup, monkeypatch):
    """A push past the stack sets the overflow flag and stops the ray
    (the reference clamps it onto the top slot); the check raises."""
    _, tr = both(ray_grid(16, np.random.default_rng(2)))
    packed = pack_pairs(setup["tpairs"])
    _, _, stats = instanced.trace_rays_instanced(setup["tias"], packed, tr)
    split_trace.check_overflow(stats.overflow)
    monkeypatch.setattr(instanced, "STACK_DEPTH", 2)
    _, _, small = instanced.trace_rays_instanced(setup["tias"], packed, tr)
    assert int(small.overflow) == 1
    with pytest.raises(RuntimeError, match="stack overflow"):
        split_trace.check_overflow(small.overflow)


@pytest.fixture(scope="module")
def split_setup(setup):
    """The BLAS as a bucket split tree (K1's views) and the split-kernel
    instance structures, the reference's and the port's."""
    mesh = jnp.asarray(setup["mesh"])
    split_b, packed_s = jax.jit(lambda t: jbucket.emit_split(
        jbucket.split_front(t, enable_pairs=True), leaf_width=jsp.LEAFW))(mesh)
    jviews = jax.jit(jsp.prep_split_views)(split_b, packed_s)
    lo, hi = jnp.min(mesh.reshape(-1, 3), axis=0), jnp.max(mesh.reshape(-1, 3), axis=0)
    jias = jax.jit(jis.build_instanced_split)(jviews, packed_s, lo, hi, jnp.asarray(setup["tf"]))
    carried = convert.instanced_split_from_numpy(dict(
        views=tuple(np.asarray(v) for v in jviews), rows=np.asarray(packed_s.rows),
        wmin=np.asarray(jias.wmin), wmax=np.asarray(jias.wmax),
        inv_transforms=np.asarray(jias.inv_transforms)), "cpu")
    tviews, tpacked, _ = bucket.emit_split_views(
        bucket.split_front(torch.from_numpy(setup["mesh"]), True), leaf_width=split_trace.LEAFW)
    tias = instanced_split.build_instanced_split(
        tviews, tpacked, torch.from_numpy(np.array(lo)), torch.from_numpy(np.array(hi)),
        torch.from_numpy(setup["tf"]))
    return dict(jias=jias, carried=carried, tias=tias, jviews=jviews, jpacked=packed_s)


def _rays128(rng, tmax=100.0):
    arrays = ray_grid(32, rng, tmax)
    pick = np.arange(0, 1024, 8)
    return tuple(a[pick] for a in arrays)


def test_candidates_match_jax(split_setup):
    jias, tias = split_setup["jias"], split_setup["tias"]
    np.testing.assert_array_equal(tias.wmin.numpy(), np.asarray(jias.wmin))
    np.testing.assert_array_equal(tias.wmax.numpy(), np.asarray(jias.wmax))
    rng = np.random.default_rng(4)
    jr, tr = both(ray_grid(32, rng))
    active = rng.random(1024) < 0.8
    jw, jn = jis.candidate_masks(jias.wmin, jias.wmax, jr, active=jnp.asarray(active))
    tw, tn = instanced_split.candidate_masks(tias.wmin, tias.wmax, tr,
                                             active=torch.from_numpy(active))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn.max()) >= 2 and not tn.numpy()[~active].any()
    for k in (1, 3, 8):
        np.testing.assert_array_equal(instanced_split.peel_candidates(tw, k).numpy(),
                                      np.asarray(jis.peel_candidates(jw, k)))
    _, jn_all = jis.candidate_masks(jias.wmin, jias.wmax, jr)
    assert instanced_split.max_overlap(tias, tr) == int(np.asarray(jn_all).max())


@pytest.mark.parametrize("budget", [None, 256], ids=["full", "item-budget"])
def test_trace_rays_instanced_split_matches_jax(split_setup, setup, budget):
    jr, tr = both(_rays128(np.random.default_rng(13)))
    ref, jinst, _, jguard = jax.jit(lambda i, r: jis.trace_rays_instanced_split(
        i, r, k_slots=4, c_slots=1, item_budget=budget))(split_setup["jias"], jr)
    rec, inst, stats, guard = instanced_split.trace_rays_instanced_split(
        split_setup["carried"], tr, k_slots=4, item_budget=budget)
    assert_records(rec, ref)
    np.testing.assert_array_equal(inst.numpy(), np.asarray(jinst))
    np.testing.assert_array_equal(guard.numpy(), np.asarray(jguard))
    instanced_split.check_candidate_capacity(guard, 4, budget)
    assert rec.hit.sum() > 8 and int(stats.overflow) == 0
    # the port's own structure, and brute force over the world triangles
    own, own_inst, _, _ = instanced_split.trace_rays_instanced_split(
        split_setup["tias"], tr, k_slots=4, item_budget=budget)
    np.testing.assert_array_equal(own.hit.numpy(), rec.hit.numpy())
    np.testing.assert_array_equal(own_inst.numpy(), inst.numpy())
    mesh = setup["mesh"]
    oracle = brute_force_trace(torch.from_numpy(flatten(mesh, setup["tf"])), tr)
    hit = own.hit.numpy()
    np.testing.assert_array_equal(hit, oracle.hit.numpy())
    np.testing.assert_allclose(own.t.numpy()[hit], oracle.t.numpy()[hit], rtol=2e-4, atol=1e-5)
    same = np.isclose(own.t.numpy(), oracle.t.numpy(), rtol=1e-4) & hit
    np.testing.assert_array_equal(own_inst.numpy()[same],
                                  oracle.prim_id.numpy()[same] // mesh.shape[0])


def test_candidate_overflow_raises(split_setup):
    _, tr = both(_rays128(np.random.default_rng(13)))
    _, _, _, guard = instanced_split.trace_rays_instanced_split(split_setup["tias"], tr,
                                                                k_slots=1)
    assert int(guard[0]) >= 2
    with pytest.raises(instanced_split.InstancedCandidateOverflow, match="k_slots"):
        instanced_split.check_candidate_capacity(guard, 1)
    with pytest.raises(instanced_split.InstancedCandidateOverflow, match="item_budget"):
        instanced_split.check_candidate_capacity(guard, 8, item_budget=int(guard[1]) - 1)
    instanced_split.check_candidate_capacity(guard, int(guard[0]), int(guard[1]))


def test_dead_items_leave_ray_0_alone(split_setup):
    """Ray 0 misses every instance; with an item budget its slots and the
    padding are dead items, whose K1 pops the reference adds to ray 0
    (instanced_split.py:299-302). Here only live items count."""
    arrays = list(_rays128(np.random.default_rng(13)))
    arrays[1] = arrays[1].copy()
    arrays[1][0] = [0.0, 0.0, -1.0]  # away from every instance
    _, tr = both(tuple(arrays))
    for budget in (None, 512):
        rec, _, stats, guard = instanced_split.trace_rays_instanced_split(
            split_setup["tias"], tr, k_slots=4, item_budget=budget)
        assert not bool(rec.hit[0]) and int(guard[1]) < (budget or 4 * 128)
        assert int(stats.box_tests[0]) == 0 and int(stats.tri_tests[0]) == 0
        assert int(stats.box_tests.sum()) > 0


def test_trace_rays_split_raw_matches_jax(split_setup):
    """K1's raw (t, tri) against the reference's raw output, every ray:
    tri exactly, t to rtol 1e-6 where a triangle won."""
    jviews, jpacked = split_setup["jviews"], split_setup["jpacked"]
    rng = np.random.default_rng(17)
    o = rng.uniform(-2, 2, (128, 3)).astype(np.float32)
    o[:, 2] = -3.0
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (128, 1))
    d[:, :2] += rng.normal(scale=0.1, size=(128, 2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    arrays = (o, d, np.zeros(128, np.float32), np.full(128, 10.0, np.float32))
    jr, tr = both(arrays)
    (jt, jtri), _ = jsp.trace_rays_split_pallas(jviews, jpacked, jr, raw=True, c_slots=1)
    views = split_setup["tias"].views
    (t, tri), stats = split_trace.trace_rays_split(views, split_setup["tias"].packed, tr, raw=True)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
    won = tri.numpy() >= 0
    assert won.sum() > 16
    np.testing.assert_allclose(t.numpy()[won], np.asarray(jt)[won], rtol=1e-6)
    np.testing.assert_array_equal(t.numpy()[~won], np.asarray(jt)[~won])
    assert int(stats.overflow) == 0


def test_no_phantom_hit_at_f32_max(split_setup):
    """Rays with tmax = F32_MAX that enter a leaf window and miss every one
    of its triangles: K1 keeps the window's all-miss slot (its raw tri),
    as the reference kernel does, and the reference's record calls that a
    hit at t = F32_MAX; the port's record calls it a miss, which brute
    force confirms. Rays that do hit keep their hits."""
    from tpu_raytracing.trace import wide_fat as jwide_fat

    mesh = icosphere(subdivisions=1, radius=0.8)
    lo, hi = mesh.reshape(-1, 3).min(axis=0), mesh.reshape(-1, 3).max(axis=0)
    rng = np.random.default_rng(23)
    n = 128
    # start inside the sphere's box near a corner, outside the sphere, and
    # point out through the corner: the rays pass the boxes and miss
    corner = np.where(rng.random((n, 3)) < 0.5, lo, hi)
    o = (corner * 0.97).astype(np.float32)
    d = (corner / np.linalg.norm(corner, axis=1, keepdims=True)).astype(np.float32)
    o[:32] = np.array([0.0, 0.0, -3.0], np.float32)
    d[:32] = np.array([0.0, 0.0, 1.0], np.float32)  # these hit the sphere
    arrays = (o, d, np.zeros(n, np.float32), np.full(n, F32_MAX, np.float32))
    jr, tr = both(arrays)
    views, packed = split_setup["tias"].views, split_setup["tias"].packed
    (t, tri), _ = split_trace.trace_rays_split(views, packed, tr, raw=True)
    rec, _ = split_trace.trace_rays_split(views, packed, tr)
    phantom = (tri.numpy() >= 0) & (t.numpy() == F32_MAX)
    assert phantom.sum() > 16, "no ray reached an all-miss window"
    ref = jwide_fat._reconstruct(jpack_pairs_rows(packed), jr, jnp.asarray(t.numpy()),
                                 jnp.asarray(tri.numpy()))
    assert np.asarray(ref.hit)[phantom].all()  # the reference's phantom hits
    oracle = brute_force_trace(torch.from_numpy(mesh), tr)
    np.testing.assert_array_equal(rec.hit.numpy(), oracle.hit.numpy())
    assert not rec.hit.numpy()[phantom].any() and rec.hit.numpy()[:32].all()
    np.testing.assert_array_equal(rec.t.numpy()[phantom], F32_MAX)


def jpack_pairs_rows(packed):
    from tpu_raytracing.trace.traverse import PackedPairs as JPackedPairs

    return JPackedPairs(rows=jnp.asarray(packed.rows.numpy()))
