"""K1's start tags (``packet_tags``) in the PyTorch port against the JAX
reference.

The plain version of K1 (the port's kernel on the CPU) starts each packet
at its tag, held to ``split_pallas.trace_rays_split_pallas(packet_tags=...,
raw=True)`` in Pallas interpret mode (one 128-ray packet a call,
``c_slots=1``) on a JAX-built bucket tree: from the root, from one of the
root's inner children and from a leaf window: t to rtol 1e-6 and tri
equal but for ties within that distance (``_assert_raw_equal`` says why).
All-root tags must trace as no tags, bit for bit, and dead items (tmin =
F32_MAX, tmax = -F32_MAX, as ``trace/binned.py`` pads its packets) must hit
nothing from any tag.
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
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.trace import split_trace as st  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402

torch.set_num_threads(2)
F32_MAX = float(np.finfo(np.float32).max)
K = 128  # one packet of the reference's test packet size (TPURT_SPLIT_K)


@pytest.fixture(scope="module")
def pallas_sp():
    from jax.experimental import pallas as pl

    from tpu_raytracing.trace import split_pallas as sp_mod

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    yield sp_mod
    pl.pallas_call = orig


@pytest.fixture(scope="module")
def tree(sphere):
    fn = jax.jit(lambda t: jbucket.emit_split_views(
        jbucket.split_front(t, enable_pairs=True), leaf_width=st.LEAFW))
    jviews, jpacked, _ = fn(jnp.asarray(sphere.triangles))
    views = convert.split_views_from_numpy(*(np.asarray(a) for a in jviews), "cpu")
    packed = convert.packed_from_numpy(np.asarray(jpacked.rows), "cpu")
    return jviews, jpacked, views, packed


def _rays(sphere, width=16, height=8):
    c = jcam.camera_to_device(jcam.update_camera(
        jcam.initialise_camera(sphere.aabb_min, sphere.aabb_max)))
    r = jprimary(c, width, height)
    return [np.asarray(a, np.float32) for a in (r.origin, r.direction, r.tmin, r.tmax)]


def _both(arrays):
    return (JRays(*(jnp.asarray(a) for a in arrays)),
            Rays(*(torch.from_numpy(np.array(a)) for a in arrays)))


def _tags(views, packed, tr):
    """An inner-row tag (the root's Box child on the centre ray's path) and
    a leaf-window tag (the Tri entry whose window holds its hit pair)."""
    inner = views[0]
    meta = inner[..., 6]
    (t, tri), _ = st.trace_rays_split(views, packed, tr, raw=True)
    centre = int(tri[tr.origin.shape[0] // 2 + 8])
    assert centre >= 0
    pair = centre >> 1
    is_tri = (meta & 3) == 2
    start = meta >> 5
    rows, ents = torch.nonzero(is_tri & (start <= pair) & (pair < start + st.LEAFW),
                               as_tuple=True)
    leaf_tag = (int(start[rows[0], ents[0]]) << 1) | 1
    # the root's Box child whose subtree holds that row (row 0 is a copy of
    # the effective root's own row, so walk up until a child of row 0)
    root_children = {int(m) >> 5 for m in meta[0] if int(m) & 3 == 1}
    parent = {int(m) >> 5: r for r in range(1, inner.shape[0]) for m in meta[r]
              if int(m) & 3 == 1}
    row = int(rows[0])
    while row not in root_children:
        row = parent[row]
    return row << 1, leaf_tag


def _assert_raw_equal(t, tri, jt, jtri):
    """t to rtol 1e-6 (a few ulps), tri exactly but for exact ties. XLA's
    CPU compiler fuses multiply-adds in the interpreted kernel's
    Möller-Trumbore and K1 does not (it keeps its plain version's order,
    bit-equal on the card), so t moves by up to a few ulps; a ray whose t
    moved may name the other triangle of a tie within that distance."""
    t, tri = t.numpy(), tri.numpy()
    jt, jtri = np.asarray(jt), np.asarray(jtri)
    np.testing.assert_array_equal(tri >= 0, jtri >= 0)
    np.testing.assert_allclose(t, jt, rtol=1e-6)
    tie = (tri != jtri) & np.isclose(t, jt, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.where(tie, 0, tri), np.where(tie, 0, jtri))
    assert tie.sum() <= 2


@pytest.mark.parametrize("which", ["root", "inner", "leaf"])
def test_start_tags_match_pallas(sphere, tree, pallas_sp, which):
    """Tolerance: ``_assert_raw_equal``, on every ray from the root and from
    a leaf window (every ray of the packet tests that one window on both
    sides). From an inner row the reference's packet walks the union of its
    rays' paths, and a leaf window overlaps the next bucket's pairs
    (windows start at each bucket, 64 pairs long): a ray can meet a
    triangle outside the boxes it enters itself. So from an inner row every
    port hit is a reference hit, the reference's t is at most the port's,
    the rays with equal t follow ``_assert_raw_equal``, and each ray where
    the reference is nearer holds a genuine hit: its triangle, tested alone,
    gives the same t to rtol 1e-6."""
    jviews, jpacked, views, packed = tree
    arrays = _rays(sphere)
    jr, tr = _both(arrays)
    inner_tag, leaf_tag = _tags(views, packed, tr)
    tag = {"root": 0, "inner": inner_tag, "leaf": leaf_tag}[which]
    if which == "leaf":
        # half the packet dead, as binned.py pads its packets
        dead = np.arange(K) % 2 == 1
        arrays[2] = np.where(dead, F32_MAX, arrays[2]).astype(np.float32)
        arrays[3] = np.where(dead, -F32_MAX, arrays[3]).astype(np.float32)
        jr, tr = _both(arrays)
    (jt, jtri), _ = pallas_sp.trace_rays_split_pallas(
        jviews, jpacked, jr, packet_tags=jnp.asarray([tag], jnp.int32), raw=True, k=K,
        c_slots=1)
    (t, tri), stats = st.trace_rays_split(views, packed, tr, raw=True, k=K,
                                          packet_tags=torch.tensor([tag], dtype=torch.int32))
    assert int((tri >= 0).sum()) > 0
    if which != "inner":
        _assert_raw_equal(t, tri, jt, jtri)
    else:
        jt, jtri = np.asarray(jt), np.asarray(jtri)
        hit = tri.numpy() >= 0
        assert (jtri[hit] >= 0).all()
        assert (jt <= t.numpy() * (1 + 1e-6)).all()
        same = np.isclose(jt, t.numpy(), rtol=1e-6, atol=0)
        _assert_raw_equal(t[same], tri[same], jt[same], jtri[same])
        nearer = np.nonzero(~same)[0]
        assert len(nearer) < K // 4
        if len(nearer):
            # a one-row tree whose only entry is a 1-pair window over the
            # reference's triangle, with a box around everything
            ops = st.kernel_operands(tr.take(torch.from_numpy(nearer)))
            for i, ray in enumerate(nearer):
                row = torch.zeros((1, 8, 8), dtype=torch.int32)
                row[0, 0, 0:3] = torch.full((3,), -1e30).view(torch.int32)
                row[0, 0, 3:6] = torch.full((3,), 1e30).view(torch.int32)
                row[0, 0, 6] = (int(jtri[ray]) >> 1 << 5) | 2
                one = st.trace_split_plain(row, packed.rows, *(o[i:i + 1] for o in ops), leafw=1,
                                           any_hit=False, stack_cap=4)
                np.testing.assert_allclose(float(one[0][0]), jt[ray], rtol=1e-6)
    if which == "leaf":
        assert not (tri[1::2] >= 0).any()
        # a leaf start pops its window first: no inner row at all
        assert int(stats.box_tests.max()) == 0 and (stats.tri_tests == 2 * st.LEAFW).all()


def test_inner_tag_is_subtree_root(sphere, tree):
    """From inner row r every ray traces as in the tree whose root row is a
    copy of row r, bit for bit (t, tri, pops), closest-hit and any-hit."""
    _, _, views, packed = tree
    _, tr = _both(_rays(sphere, 32, 16))
    inner_tag, _ = _tags(views, packed, tr)
    sub = views[0].clone()
    sub[0] = sub[inner_tag >> 1]
    for any_hit in (False, True):
        (t0, tri0), s0 = st.trace_rays_split((sub, *views[1:]), packed, tr, raw=True,
                                             any_hit=any_hit)
        (t1, tri1), s1 = st.trace_rays_split(views, packed, tr, raw=True, any_hit=any_hit, k=K,
                                             packet_tags=torch.full((4,), inner_tag,
                                                                    dtype=torch.int32))
        for a, b in ((t0, t1), (tri0, tri1), (s0.box_tests, s1.box_tests),
                     (s0.tri_tests, s1.tri_tests)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert int((tri1 >= 0).sum()) > 0


def test_root_tags_equal_no_tags(sphere, tree):
    _, _, views, packed = tree
    _, tr = _both(_rays(sphere, 32, 16))
    for any_hit in (False, True):
        (t0, tri0), s0 = st.trace_rays_split(views, packed, tr, raw=True, any_hit=any_hit)
        (t1, tri1), s1 = st.trace_rays_split(views, packed, tr, raw=True, any_hit=any_hit, k=K,
                                             packet_tags=torch.zeros(4, dtype=torch.int32))
        for a, b in ((t0, t1), (tri0, tri1), (s0.box_tests, s1.box_tests),
                     (s0.tri_tests, s1.tri_tests), (s0.overflow, s1.overflow)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_dead_items_and_per_ray_start(sphere, tree):
    """Dead items hit nothing from any tag, pop their start once, and
    split_traverse's per-ray tags give each ray its own start."""
    _, _, views, packed = tree
    arrays = _rays(sphere)
    _, tr = _both(arrays)
    inner_tag, leaf_tag = _tags(views, packed, tr)
    ops = st.kernel_operands(tr)
    kw = dict(leafw=st.LEAFW, stack_cap=views[2])
    num = ops[0].shape[0]
    dead_min = torch.full((num,), F32_MAX)
    dead_max = torch.full((num,), -F32_MAX)
    for tag in (0, inner_tag, leaf_tag):
        start = torch.full((num,), tag, dtype=torch.int32)
        for any_hit in (False, True):
            t, tri, ip, lp, ov = st.split_traverse(*views[:2], ops[0], ops[1], dead_min,
                                                   dead_max, start=start, any_hit=any_hit, **kw)
            assert not (tri >= 0).any() and int(ov) == 0
            assert ((ip + lp) == 1).all()
            np.testing.assert_array_equal(t.numpy(), dead_max.numpy())
    # mixed per-ray tags: each ray as if its packet had its tag
    start = torch.tensor([(0, inner_tag, leaf_tag)[i % 3] for i in range(num)],
                         dtype=torch.int32)
    mixed = st.split_traverse(*views[:2], *ops, start=start, any_hit=False, **kw)
    for j, tag in enumerate((0, inner_tag, leaf_tag)):
        one = st.split_traverse(*views[:2], *ops, start=torch.full((num,), tag, dtype=torch.int32),
                                any_hit=False, **kw)
        for a, b in zip(mixed[:4], one[:4]):
            np.testing.assert_array_equal(a.numpy()[j::3], b.numpy()[j::3])
