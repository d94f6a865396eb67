"""PyTorch port's binned-SAH builds (``ops/rangemin.py``, ``bvh/sah.py``,
``bvh/split_convert.py``) against the JAX reference, bit for bit on the
same inputs; a JAX-built SAH tree traced by the port against the Pallas
K1 in interpret mode; the SAH-tree frame against the reference's frame;
the SAH tree's own stack bound; and the app's ``--type sah``.

Spatial splits (``bvh/splits.py``) have their own file,
``tests/test_torch_sah_splits.py``. Tolerance is exact unless stated.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import sah as jsah  # noqa: E402
from tpu_raytracing.bvh import split_convert as jsc  # noqa: E402
from tpu_raytracing.bvh import verify as jverify  # noqa: E402
from tpu_raytracing.ops import rangemin as jrangemin  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.scene import procedural  # noqa: E402
from tpu_raytracing.scene.types import scene_to_device as jscene_to_device  # noqa: E402
from tpu_raytracing.trace import pathtrace as jpt  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jprimary  # noqa: E402
from tpu_raytracing.trace.traverse import pack_bvh as jpack_bvh  # noqa: E402
from tpu_raytracing.trace.traverse import pack_pairs as jpack_pairs  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import bucket as tbucket  # noqa: E402
from tpu_raytracing_torch.bvh import sah as tsah  # noqa: E402
from tpu_raytracing_torch.bvh import split_convert as tsc  # noqa: E402
from tpu_raytracing_torch.bvh.verify import leaf_primitive_ids, verify_hierarchy  # noqa: E402
from tpu_raytracing_torch.ops import rangemin as trangemin  # noqa: E402
from tpu_raytracing_torch.scene import camera as tcam  # noqa: E402
from tpu_raytracing_torch.scene import procedural as tproc  # noqa: E402
from tpu_raytracing_torch.scene.types import scene_to_device  # noqa: E402
from tpu_raytracing_torch.trace import pathtrace as tpt  # noqa: E402
from tpu_raytracing_torch.trace import split_trace as st  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402

torch.set_num_threads(2)
W, H = 32, 32


def beam_triangles():
    """tests/test_sah_split.py's beam scene: a floor of small quads and
    eight long thin diagonal beams whose unsplit boxes are huge."""
    tris = []
    for i in range(10):
        for j in range(10):
            x, z = i * 0.1, j * 0.1
            tris.append([[x, 0.0, z], [x + 0.09, 0.0, z], [x, 0.0, z + 0.09]])
            tris.append([[x + 0.09, 0.0, z], [x + 0.09, 0.0, z + 0.09], [x, 0.0, z + 0.09]])
    for b in range(8):
        y = 0.3 + 0.02 * b
        tris.append([[0.0, y, 0.0], [1.0, y + 0.004, 1.0], [0.0, y + 0.004, 0.0]])
    return np.asarray(tris, np.float32)


@functools.lru_cache(maxsize=None)
def scene_tris(name):
    return {
        "cornell": lambda: procedural.cornell_box().triangles,
        "sphere": lambda: procedural.sphere_scene(3).triangles,
        "soup": lambda: procedural.random_triangle_soup(2000, seed=1).triangles,
        "terrain": lambda: procedural.terrain(8000).triangles,
        "beam": beam_triangles,
        # every triangle the same: degenerate centroid bounds, the midpoint fallback
        "duplicate": lambda: np.tile(np.eye(3, dtype=np.float32)[None], (37, 1, 1)),
    }[name]()


def same(ref, out, name=""):
    """Bit-equal: float32 compared as int32 words."""
    ref = np.asarray(ref)
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    if ref.dtype == np.float32:
        ref, out = ref.view(np.int32), out.astype(np.float32).view(np.int32)
    assert ref.shape == out.shape, (name, ref.shape, out.shape)
    np.testing.assert_array_equal(ref, out.astype(ref.dtype), err_msg=name)


@functools.lru_cache(maxsize=None)
def jax_sah(name, pairs, splits=False):
    fn = jax.jit(jsah.build_sah, static_argnums=(1, 2))
    return jax.tree.map(np.asarray, fn(jnp.asarray(scene_tris(name)), pairs, splits))


@functools.lru_cache(maxsize=None)
def jax_sah_split(name, pairs, lw, splits=False):
    fn = jax.jit(functools.partial(jsc.build_sah_split, enable_pairs=pairs, leaf_width=lw,
                                   enable_splits=splits))
    split, packed = fn(jnp.asarray(scene_tris(name)))
    return split, jax.tree.map(np.asarray, packed)


def assert_split_equal(jsplit, jpacked, split, packed):
    for f in ("inner", "e_ranges", "num_inner", "num_leaves"):
        same(getattr(jsplit, f), getattr(split, f), f)
    assert split.leaf_width == jsplit.leaf_width
    same(jpacked.rows, packed.rows, "sorted pair rows")


@pytest.mark.parametrize("n", [7, 1000, 5000])
def test_range_min_matches_jax(n):
    """Both tiers (5,000 reaches the coarse one), empty and whole ranges.
    Its own generator: drawing from the session's ``rng`` would change the
    rays of later test files on the same worker."""
    rng = np.random.default_rng(n)
    vals = rng.normal(size=(n, 12)).astype(np.float32)
    vals[::5, 3] = 0.0
    vals[1::5, 3] = -0.0
    start = rng.integers(0, n + 1, 400)
    count = np.minimum(rng.integers(-2, n + 1, 400), n - start)
    start[:2], count[:2] = 0, n
    ref = jrangemin.range_min_query(jrangemin.build_range_min(jnp.asarray(vals)),
                                    jnp.asarray(start, jnp.int32), jnp.asarray(count, jnp.int32))
    out = trangemin.range_min_query(trangemin.build_range_min(torch.from_numpy(vals)),
                                    torch.from_numpy(start), torch.from_numpy(count))
    same(ref, out)
    assert (out[torch.from_numpy(count <= 0)] == float(np.finfo(np.float32).max)).all()


@pytest.mark.parametrize("name", ["cornell", "sphere", "soup", "terrain", "beam"])
@pytest.mark.parametrize("pairs", [False, True])
def test_setup_leaves_matches_jax(name, pairs):
    ref_leaves, ref_pairs = jax.jit(jsah.setup_leaves, static_argnums=1)(
        jnp.asarray(scene_tris(name)), pairs)
    leaves, tpairs = tsah.setup_leaves(torch.from_numpy(scene_tris(name)), pairs)
    for f in ("aabb_min", "aabb_max", "child", "count", "type", "num_leaves"):
        same(getattr(ref_leaves, f), getattr(leaves, f), f)
    for f in ("v0", "v1", "v2", "v3", "prim_id_0", "prim_id_1", "rot_0", "rot_1"):
        same(getattr(ref_pairs, f), getattr(tpairs, f), f)


@pytest.mark.parametrize("name,pairs", [("cornell", False), ("sphere", True),
                                        ("terrain", True), ("duplicate", False)])
def test_build_sah_matches_jax(name, pairs):
    ref, ref_pairs = jax_sah(name, pairs)
    bvh, tpairs = tsah.build_sah(torch.from_numpy(scene_tris(name)), pairs)
    for f in ("node_min", "node_max", "child", "count", "type", "parent", "root", "root_count"):
        same(getattr(ref, f), getattr(bvh, f), f)
    assert verify_hierarchy(bvh) == []
    np.testing.assert_array_equal(leaf_primitive_ids(bvh, tpairs),
                                  np.arange(scene_tris(name).shape[0]))


@pytest.mark.parametrize("name,pairs,lw", [
    ("sphere", False, 16), ("terrain", True, 64), ("soup", True, 16),
    ("duplicate", False, 16),  # the midpoint fallback
    ("cornell", True, 64),  # the root fits one window: the single-Tri root row
])
def test_build_sah_split_matches_jax(name, pairs, lw):
    jsplit, jpacked = jax_sah_split(name, pairs, lw)
    split, packed = tsc.build_sah_split(torch.from_numpy(scene_tris(name)), pairs, lw)
    assert_split_equal(jsplit, jpacked, split, packed)
    tsc.check_sah_split_capacity(split)
    if name == "cornell":
        assert int(split.num_inner) == 1 and (split.inner[0, 6] & 3) == 2  # CHILD_TRI
    # Tri entries' windows tile the leaves: every live pair in one subtree
    er = split.e_ranges[:int(split.num_inner)].reshape(-1, 2)
    meta = split.inner[:int(split.num_inner)].reshape(-1, 8)[:, 6]
    tri = er[(meta & 3) == 2]
    order = torch.argsort(tri[:, 0])
    starts, counts = tri[order, 0], tri[order, 1]
    assert int(starts[0]) == 0 and (starts[1:] == (starts + counts)[:-1]).all()
    assert int((starts + counts)[-1]) == int(split.num_leaves)


def _jax_midpoint_arena(tris):
    """build_sah_split's frontier over setup_leaves with max_levels=1: every
    split past the root's is a midpoint split."""
    leaves, _ = jsah.setup_leaves(tris, False)
    cap = leaves.aabb_min.shape[0]
    arena = jsah.make_arena(2 * cap + 2, track_segments=True).replace(wptr=jnp.int32(1))
    zero = jnp.zeros((1,), jnp.int32)
    return jsah.frontier_build(leaves, arena, zero, leaves.num_leaves[None].astype(jnp.int32),
                               zero, jnp.int32(1), max_levels=1, return_ids=True)


def test_frontier_edges():
    """A small max_levels gives JAX's midpoint tree; a past deadline raises;
    the debug checks pass on the fixtures."""
    tris = scene_tris("soup")
    ref_arena, ref_ids = jax.jit(_jax_midpoint_arena)(jnp.asarray(tris))
    leaves, _ = tsah.setup_leaves(torch.from_numpy(tris), False)
    cap = leaves.aabb_min.shape[0]
    arena = tsah.make_arena(2 * cap + 2, track_segments=True)
    arena.wptr = arena.wptr + 1
    zero = torch.zeros((1,), dtype=torch.int32)
    arena, ids = tsah.frontier_build(leaves, arena, zero, leaves.num_leaves.reshape(1), zero, 1,
                                     max_levels=1, return_ids=True)
    n = arena.num_slots
    for f in ("node_min", "node_max", "child", "count", "type", "parent", "seg_start",
              "seg_count", "depth"):
        same(getattr(ref_arena, f), getattr(arena, f)[:n], f)
    same(ref_arena.wptr, arena.wptr, "wptr")
    same(ref_ids, ids, "ids")

    with pytest.raises(tsah.SahDeadlineExceeded):
        tsc.build_sah_split(torch.from_numpy(tris), True, 64, deadline=time.monotonic() - 1.0)
    for name, pairs in (("cornell", True), ("sphere", False), ("duplicate", False)):
        t = torch.from_numpy(scene_tris(name))
        plain, _ = tsc.build_sah_split(t, pairs, 16)
        checked, _ = tsc.build_sah_split(t, pairs, 16, debug=True)
        same(plain.inner.numpy(), checked.inner)
        tsah.build_sah(t, pairs, debug=True)


def test_split_capacity_check_raises(monkeypatch):
    monkeypatch.setattr(tsc, "_split_cap", lambda n, lw: 2)
    split, _ = tsc.build_sah_split(torch.from_numpy(scene_tris("sphere")), False, 16)
    assert int(split.num_inner) > split.inner.shape[0] == 2
    with pytest.raises(RuntimeError, match="SAH split emit overflow"):
        tsc.check_sah_split_capacity(split)


@pytest.fixture(scope="module")
def pallas_sp():
    """The reference split kernels in Pallas interpret mode, as
    tests/test_split_pallas.py runs them off the TPU."""
    from jax.experimental import pallas as pl

    from tpu_raytracing.trace import split_pallas as sp_mod

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    yield sp_mod
    pl.pallas_call = orig


def test_jax_tree_traced_by_port_matches_pallas(pallas_sp):
    """The strongest check: the JAX-built SAH tree, carried into the port,
    traced by the port's K1 (its plain version here) against the
    reference's K1 on the same 128 rays."""
    jsplit, jpacked = jax_sah_split("terrain", True, st.LEAFW)
    split, packed = convert.sah_split_from_numpy(
        {f: np.asarray(getattr(jsplit, f)) for f in ("inner", "num_inner", "num_leaves",
                                                     "e_ranges", "leaf_width")},
        jpacked.rows, "cpu")
    views, packed, _ = tsc.sah_split_views(split, packed)
    scene = procedural.terrain(8000)
    camera = jcam.camera_to_device(jcam.update_camera(
        jcam.initialise_camera(scene.aabb_min, scene.aabb_max)))
    jr = jprimary(camera, 16, 8)
    fields = [np.asarray(getattr(jr, f)) for f in ("origin", "direction", "tmin", "tmax")]
    ref, _ = pallas_sp.trace_rays_split_pallas(
        pallas_sp.prep_split_views(jsplit, jax.tree.map(jnp.asarray, jpacked)),
        jax.tree.map(jnp.asarray, jpacked), jr, c_slots=1)
    rays = Rays(*(torch.from_numpy(a.copy()) for a in fields))
    rec, stats = st.trace_rays_split(views, packed, rays)
    assert int(stats.overflow.sum()) == 0
    hit = np.asarray(ref.hit)
    assert hit.sum() > 64
    np.testing.assert_array_equal(rec.hit.numpy(), hit)
    np.testing.assert_array_equal(rec.tri_id.numpy()[hit], np.asarray(ref.tri_id)[hit])
    np.testing.assert_allclose(rec.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-5)


def _psnr(a, b):
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def test_sah_frame_matches_jax(monkeypatch):
    """The slice as a whole: the port's SAH split tree traced by K1 on all
    four passes with the leaf bounce sort, against the reference's frame
    over its SAH tree, with the reference's uniforms fed to the port."""
    scene = tproc.cornell_box()
    host_cam = tcam.update_camera(tcam.initialise_camera(scene.aabb_min, scene.aabb_max))
    jb, jp = jax_sah("cornell", True)
    ref_img, ref_rays = jpt.path_trace(
        jpack_bvh(jax.tree.map(jnp.asarray, jb)), jpack_pairs(jax.tree.map(jnp.asarray, jp)),
        jscene_to_device(scene), jcam.camera_to_device(host_cam), W, H, num_bounces=1,
        key=jax.random.PRNGKey(0))
    key, uniforms = jax.random.PRNGKey(0), []
    for _ in range(2):  # pathtrace.py: one split and one draw per bounce
        key, k_dir = jax.random.split(key)
        uniforms.append(np.asarray(jax.random.uniform(k_dir, (W * H, 2))))
    draws = iter(uniforms)
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.from_numpy(np.array(next(draws))))
    views, packed, _ = tsc.sah_split_views(
        *tsc.build_sah_split(torch.from_numpy(scene.triangles), True, st.LEAFW))
    img, rays_traced = tpt.path_trace(views, packed, scene_to_device(scene, "cpu"),
                                      tcam.camera_to_device(host_cam, "cpu"), W, H,
                                      num_bounces=1, sort_kind="leaf",
                                      **st.make_frame_tracers(W, H))
    assert int(rays_traced) == int(ref_rays)
    assert _psnr(np.asarray(ref_img), img.numpy()) >= 40.0


def _slivers(n, ratio):
    """Nested slivers along x, lengths ratio^k, the smaller ones nearer a
    ray from +z: the SAH peels the longest off level after level."""
    tris = np.zeros((n, 3, 3), np.float32)
    tris[:, 1, 0] = ratio ** np.arange(n)
    tris[:, 2, 1] = 0.01
    tris[:, :, 2] = (-np.arange(n) * 1e-6)[:, None]
    return tris


def test_deep_sah_tree_carries_its_stack_bound(monkeypatch):
    """The SAH views carry a stack bound from the tree's own depth in rows:
    a deep tree traces without overflow under it, and a lower bound makes
    the frame raise."""
    views, packed, split = tsc.sah_split_views(
        *tsc.build_sah_split(torch.from_numpy(_slivers(3000, 1.03)), False, st.LEAFW))
    levels = tsc.row_depth(split.inner, int(split.num_inner))
    assert levels >= 12
    assert views[2] == 7 * (levels - 1) + 8
    m = 64
    o = torch.zeros((m, 3))
    o[:, 0] = torch.linspace(1e-4, 0.5, m)
    o[:, 1] = 1e-3
    o[:, 2] = 1.0
    d = torch.zeros((m, 3))
    d[:, 2] = -1.0
    rays = Rays(o, d, torch.zeros(m), torch.full((m,), 10.0))
    rec, stats = st.trace_rays_split(views, packed, rays)
    st.check_overflow(stats.overflow)
    assert bool(rec.hit.all())
    # the rays need more than half the bound
    low = (views[0], views[1], views[2] // 2)
    _, low_stats = st.trace_rays_split(low, packed, rays)
    with pytest.raises(RuntimeError, match="stack overflow"):
        st.check_overflow(low_stats.overflow)
    monkeypatch.setattr(tsc, "sah_stack_cap", lambda levels, w=8: 8)
    views8, _, _ = tsc.sah_split_views(split, packed)
    assert views8[2] == 8
    with pytest.raises(RuntimeError, match="stack overflow"):
        st.check_overflow(st.trace_rays_split(views8, packed, rays)[1].overflow)


def _comb(nbulk=20000, seed=0):
    """A bulk of thin triangles near x = 0 and a comb of outliers at
    x = 2^-22 .. 2^116, all facing +x: each SAH level peels the outliers
    above an eighth of the range, so the chain outlasts the SAH levels and
    the midpoint levels split the bulk below it."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(0, 2.0 ** -25, nbulk), 2.0 ** np.arange(-22, 117)])
    tris = np.zeros((x.size, 3, 3))
    tris[:, :, 0] = x[:, None]
    tris[:, 1, 1] = 2.0 ** -10
    tris[:, 2, 2] = 2.0 ** -10
    tris[:, :, 1:] += rng.uniform(0, 2.0 ** -30, (x.size, 1, 2))
    return tris.astype(np.float32)


def test_sah_tree_deeper_than_the_bucket_bound():
    """An SAH tree whose depth in rows gives a stack bound above the bucket
    tree's bound for the same pair count (which K1 took for every tree
    before); ``stats`` reports the build's levels and deepest anchor, and
    rays through the whole comb trace without overflow."""
    tris = torch.from_numpy(_comb())
    stats = {}
    split, packed = tsc.build_sah_split(tris, False, st.LEAFW, stats=stats)
    plain, _ = tsc.build_sah_split(tris, False, st.LEAFW)
    same(plain.inner.numpy(), split.inner)
    views, packed, split = tsc.sah_split_views(split, packed)
    levels = tsc.row_depth(split.inner, int(split.num_inner))
    assert levels == stats["deepest_anchor"] // 3 + 1
    assert stats["levels"] == stats["tree_depth"] > 2 * 15 + 16
    assert all(stats[k] >= 0.0 for k in ("setup_s", "frontier_s", "emit_s"))
    assert views[2] == 7 * (levels - 1) + 8 > tbucket.stack_cap(8, views[1].shape[0])
    assert (int(split.num_leaves), levels, views[2]) == (20139, 19, 134)
    m = 64
    o = torch.zeros((m, 3))
    o[:, 0] = -1.0
    o[:, 1] = torch.linspace(0.05, 0.45, m) * 2.0 ** -10
    o[:, 2] = torch.linspace(0.45, 0.05, m) * 2.0 ** -10
    d = torch.zeros((m, 3))
    d[:, 0] = 1.0
    rec, trace_stats = st.trace_rays_split(views, packed, Rays(o, d, torch.zeros(m),
                                                               torch.full((m,), 3e38)))
    st.check_overflow(trace_stats.overflow)
    assert bool(rec.hit.all())


def assert_app_sah(out, ref, split_rows=None):
    """The app's output holds the reference's hierarchy stats for ``ref``
    and, for ``--tracer split``, the SAH split tree's row count."""
    stats = jverify.count_nodes(jax.tree.map(jnp.asarray, ref))
    assert (f"Hierarchy stats\n  num nodes:      {stats.num_nodes}\n"
            f"  num tree nodes: {stats.num_tree_nodes}\n"
            f"  num leaf nodes: {stats.num_leaf_nodes}\n") in out.out
    assert "Error: Invalid hierarchy" not in out.err
    if split_rows is not None:
        assert f"Split BVH\n  inner rows:     {split_rows}\n" in out.out


@pytest.mark.parametrize("tracer", ["scalar", "split", "lane"])
def test_app_type_sah(tmp_path, capsys, tracer):
    """``--type sah`` builds the SAH tree on frame 0 and prints the
    reference app's hierarchy stats for it; ``--tracer split`` traces the
    SAH split tree, ``scalar`` the SAH binary tree, ``lane`` the bucket
    front's treelets."""
    from tpu_raytracing_torch.app import main as app

    app.main(["--scene", "cornell", "--type", "sah", "--tracer", tracer, "--bounces", "1",
              "--width", "16", "--height", "8", "--device", "cpu", "--debug-checks",
              "--output", str(tmp_path)])
    rows = None
    if tracer == "split":
        rows = int(tsc.build_sah_split(torch.from_numpy(scene_tris("cornell")), False,
                                       st.LEAFW)[0].num_inner)
    assert_app_sah(capsys.readouterr(), jax_sah("cornell", False)[0], rows)
    assert (tmp_path / "frame0000_pt.png").is_file()
