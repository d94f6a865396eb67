"""K1 on 16-wide inner rows in the PyTorch port against the JAX reference.

The reference's split kernels take 8- and 16-wide rows
(``split_pallas.py:129``); the port's K1 has one instantiation per width
and its plain version walks [Ri, w, 8] rows. Held here: the plain version
on JAX-built 16-wide bucket trees (leaf windows of 16 and 32 pairs, as
``tests/test_split_pallas.py:161``) against ``trace_rays_split_pallas`` in
Pallas interpret mode (128 rays, ``c_slots=1``), closest-hit and any-hit:
t to rtol 1e-6 and tri equal but for ties within that distance (XLA
contracts the interpreted kernel's multiply-adds, K1 keeps its plain
order); the port-built 16-wide tree against brute force; rows whose
entries tie on distance over windows of identical triangles (7 and 15,
where the entry-id tie rule's 4 bits at width 16 decide the winning
triangle; 0 and 8, and 7 and 8, which meet at different steps of the
card's half-warp reduction; all 16 at distance 0); the wrapper's width and
window checks; and the cycle diagnostic's refusal off the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import bucket as jbucket  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jprimary  # noqa: E402
from tpu_raytracing.trace.traverse import PackedPairs as JPackedPairs  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import bucket  # noqa: E402
from tpu_raytracing_torch.trace import split_trace as st  # noqa: E402
from tpu_raytracing_torch.trace.brute import brute_force_trace  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402
from tpu_raytracing_torch.trace.traverse import reconstruct  # noqa: E402

torch.set_num_threads(2)
F32_MAX = float(np.finfo(np.float32).max)
K = 128


@pytest.fixture(scope="module")
def pallas_sp():
    from jax.experimental import pallas as pl

    from tpu_raytracing.trace import split_pallas as sp_mod

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    yield sp_mod
    pl.pallas_call = orig


def _rays(scene, width=16, height=8, seed=0):
    c = jcam.camera_to_device(jcam.update_camera(
        jcam.initialise_camera(scene.aabb_min, scene.aabb_max)))
    r = jprimary(c, width, height)
    arrays = [np.array(a, np.float32) for a in (r.origin, r.direction, r.tmin, r.tmax)]
    rng = np.random.default_rng(seed)
    arrays[1] = (arrays[1] + rng.normal(0, 0.05, arrays[1].shape)).astype(np.float32)
    return arrays


def _both(arrays):
    return (JRays(*(jnp.asarray(a) for a in arrays)),
            Rays(*(torch.from_numpy(np.array(a)) for a in arrays)))


def _traverse(views, rays, leafw, any_hit=False):
    """K1 (its plain version on the CPU) over windows of ``leafw`` pairs:
    (t, tri, inner pops, leaf pops, overflow). ``trace_rays_split`` takes
    the port's ``LEAFW`` windows only."""
    inner, pairs, cap = views
    return st.split_traverse(inner, pairs, *st.kernel_operands(rays), leafw=leafw,
                             any_hit=any_hit, stack_cap=cap)


def _assert_raw_equal(t, tri, jt, jtri):
    t, tri = t.numpy(), tri.numpy()
    jt, jtri = np.asarray(jt), np.asarray(jtri)
    np.testing.assert_array_equal(tri >= 0, jtri >= 0)
    np.testing.assert_allclose(t, jt, rtol=1e-6)
    tie = (tri != jtri) & np.isclose(t, jt, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.where(tie, 0, tri), np.where(tie, 0, jtri))
    assert tie.sum() <= 2


@pytest.mark.parametrize("leafw", [16, 32])
def test_wide16_matches_pallas(sphere, pallas_sp, leafw):
    fn = jax.jit(lambda t: jbucket.emit_split_views(
        jbucket.split_front(t, enable_pairs=True), leaf_width=leafw, inner_width=16))
    jviews, jpacked, _ = fn(jnp.asarray(sphere.triangles))
    views = convert.split_views_from_numpy(*(np.asarray(a) for a in jviews), "cpu")
    assert views[0].shape[1:] == (16, 8)
    jr, tr = _both(_rays(sphere))
    for any_hit in (False, True):
        (jt, jtri), _ = pallas_sp.trace_rays_split_pallas(
            jviews, jpacked, jr, leafw=leafw, any_hit=any_hit, raw=True, k=K, c_slots=1)
        t, tri, ipops, _, overflow = _traverse(views, tr, leafw, any_hit)
        assert int((tri >= 0).sum()) > 0
        if any_hit:  # the first window taken ends the ray: which one is the order's
            np.testing.assert_array_equal(tri.numpy() >= 0, np.asarray(jtri) >= 0)
        else:
            _assert_raw_equal(t, tri, jt, jtri)
        assert int(overflow) == 0 and int(ipops.min()) >= 1


@pytest.mark.parametrize("leafw", [16, 32])
def test_wide16_port_tree_matches_brute(sphere, leafw):
    tris = torch.from_numpy(sphere.triangles)
    views, packed, split = bucket.emit_split_views(bucket.split_front(tris, True),
                                                   leaf_width=leafw, inner_width=16)
    bucket.check_split_capacity(split, tris.shape[0])
    assert views[0].shape[1] == 16 and views[2] == bucket.stack_cap(16, views[1].shape[0])
    _, tr = _both(_rays(sphere, 32, 16, seed=1))
    t, tri, _, _, overflow = _traverse(views, tr, leafw)
    rec = reconstruct(packed, tr, t, tri)
    ref = brute_force_trace(tris, tr)
    np.testing.assert_array_equal(rec.hit.numpy(), ref.hit.numpy())
    hit = ref.hit.numpy()
    np.testing.assert_allclose(rec.t.numpy()[hit], ref.t.numpy()[hit], rtol=1e-5)
    _, occ, _, _, _ = _traverse(views, tr, leafw, any_hit=True)
    np.testing.assert_array_equal(occ.numpy() >= 0, hit)
    assert int(overflow) == 0 and hit.sum() > 0


# Entry ties on a 16-wide row: the tied Tri entries, and whether the ray
# origins lie inside every box (distance 0). Entries 7 and 15 differ only
# above a 3-bit id; 0 and 8, and 7 and 8, meet at different steps of the
# card's half-warp reduction (xor offsets 8, 4, 2, 1); all 16 tie
# everywhere.
_TIES = [((7, 15), False, ""), ((0, 8), False, "0_8-"), ((7, 8), False, "7_8-"),
         (tuple(range(16)), True, "all16-")]


def _tie_row(entries, inside):
    """Row 0 of a 16-wide tree whose ``entries`` (ascending) share one box
    (the others empty), entry i of the tuple over the 16-pair window from
    pair 16 i; with ``inside`` the box holds the ray origins."""
    lo = np.array([-1.0, -1.0, -3.0 if inside else -0.5], np.float32)
    hi = np.array([1.0, 1.0, 0.5], np.float32)
    empty = np.concatenate([np.full(3, F32_MAX, np.float32).view(np.int32),
                            np.full(3, -F32_MAX, np.float32).view(np.int32), [0, 0]])
    row = np.tile(empty, (16, 1)).astype(np.int32)
    for i, e in enumerate(entries):
        row[e, 0:3] = lo.view(np.int32)
        row[e, 3:6] = hi.view(np.int32)
        row[e, 6] = ((16 * i) << 5) | 2
    inner = np.tile(empty, (8, 16)).astype(np.int32)
    inner[0] = row.reshape(-1)
    return inner


@pytest.mark.parametrize("entries,inside,any_hit", [
    pytest.param(e, inside, a, id=f"{pre}{'any' if a else 'closest'}")
    for e, inside, pre in _TIES for a in (False, True)])
def test_wide16_entry_tie_rule(pallas_sp, entries, inside, any_hit):
    """Row 0 holds Tri ``entries`` with one box (the other entries are
    empty); each entry's 16-pair window is one triangle repeated, so all
    windows meet every ray at the same t. The entries tie on distance, so
    the highest id is nearest and pops first, and the others follow in
    falling id: an any-hit ray ends in the highest entry's window, and a
    closest-hit ray takes the lowest entry's, popped last, on the exact t
    tie. Each window's winner is its last slot (the larger 2 * slot +
    second; the pair's second triangle is degenerate). An entry id kept in
    3 bits would tie 7 with 15 and could pick either; the card's half-warp
    reduction meets 0 and 8 at its first step and 7 and 8 at its last."""
    inner = _tie_row(entries, inside)
    n = len(entries)
    tri = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    pair = np.concatenate([tri.reshape(-1), tri[2], [0, 0, 0, 0]]).astype(np.float32)
    prows = np.tile(pair.view(np.int32)[None, :], (16 * n, 1))
    prows[:, 12:] = 0
    split = jbucket.SplitBVH(inner=jnp.asarray(inner), num_inner=jnp.int32(1),
                             num_leaves=jnp.int32(16 * n), leaf_width=16)
    jviews = pallas_sp.prep_split_views(split, JPackedPairs(rows=jnp.asarray(prows)))
    views = convert.split_views_from_numpy(*(np.asarray(a) for a in jviews), "cpu")
    rng = np.random.default_rng(3)
    xy = rng.uniform(-0.3, 0.3, (K, 2)).astype(np.float32)
    arrays = [np.concatenate([xy, np.full((K, 1), -2.0, np.float32)], axis=1),
              np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (K, 1)),
              np.zeros(K, np.float32), np.full(K, 10.0, np.float32)]
    jr, tr = _both(arrays)
    (jt, jtri), _ = pallas_sp.trace_rays_split_pallas(
        jviews, JPackedPairs(rows=jnp.asarray(prows)), jr, leafw=16, any_hit=any_hit,
        raw=True, k=K, c_slots=1)
    t, tri_out, ipops, lpops, _ = _traverse(views, tr, 16, any_hit)
    want = 2 * 16 * (n - 1) + 2 * 15 if any_hit else 2 * 15
    np.testing.assert_array_equal(tri_out.numpy(), np.full(K, want))
    np.testing.assert_array_equal(np.asarray(jtri), tri_out.numpy())
    np.testing.assert_array_equal(ipops.numpy(), np.full(K, 1))
    np.testing.assert_array_equal(lpops.numpy(), np.full(K, 1 if any_hit else n))
    if not any_hit:
        np.testing.assert_allclose(t.numpy(), 2.0, rtol=1e-6)


def test_cycles_diagnostic_refuses_cpu():
    """``split_traverse_cycles`` exists only on the card: CPU tensors raise
    a clear error (nothing falls back to the plain version), at either row
    width and either inner-row design, and no K1 launch is counted."""
    ops = st.kernel_operands(Rays(torch.zeros((4, 3)), torch.ones((4, 3)), torch.zeros(4),
                                  torch.ones(4)))
    pairs = torch.zeros((64, 16), dtype=torch.int32)
    before = st.launch_count
    for w in st.WIDTHS:
        for per_lane in (False, True):
            with pytest.raises(ValueError, match="only on the card"):
                st.split_traverse_cycles(torch.zeros((2, w, 8), dtype=torch.int32), pairs, *ops,
                                         leafw=16, any_hit=False, stack_cap=64,
                                         per_lane=per_lane)
    assert st.launch_count == before


def test_wrapper_width_check():
    """The CUDA wrapper's operand check takes [ICAP, 8 or 16, 8] rows and
    refuses any other width, and a window longer than the pair rows (the CPU path runs the plain version, which
    reaches it only through this check on the card)."""
    ops = [torch.zeros((4, 3)), torch.ones((4, 3)), torch.zeros(4), torch.ones(4)]
    pairs = torch.zeros((64, 16), dtype=torch.int32)
    for w in (8, 16):
        st._check_operands(torch.zeros((2, w, 8), dtype=torch.int32), pairs, *ops, 16, 64)
    for w in (4, 12, 32):
        with pytest.raises(ValueError, match="8 or 16"):
            st._check_operands(torch.zeros((2, w, 8), dtype=torch.int32), pairs, *ops, 16, 64)
    # a window wider than the pair rows would read past their end
    with pytest.raises(ValueError, match="pair rows"):
        st._check_operands(torch.zeros((2, 16, 8), dtype=torch.int32), pairs[:31], *ops, 32, 64)
    split = bucket.SplitBVH(inner=torch.zeros((2, 96), dtype=torch.int32),
                            num_inner=torch.tensor(1), num_leaves=torch.tensor(1))
    with pytest.raises(ValueError, match="8- or 16-wide"):
        bucket.split_views(split, bucket.PackedPairs(rows=pairs))
    with pytest.raises(ValueError, match="inner_width"):
        bucket.emit_split(bucket.split_front(torch.rand(8, 3, 3)), inner_width=32)
