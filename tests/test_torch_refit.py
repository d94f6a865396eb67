"""PyTorch port vs the JAX reference: the split emit with its refit ranges
(``bvh/bucket.py:emit_split``, ``build_bucket_split``, ``split_views``),
``refit_split`` on bucket and SAH trees, the refit schedule
(``bvh/refit_schedule.py``) and the app's row deformation.

Integer structures and refitted words are bit-equal; the entry surface
area agrees to rtol 1e-5 (the float32 sums run in another order); the
deformation to atol 1e-6 or one float32 step (sin and cos of another
library). A refitted tree
is traced by the port's K1 (its plain version here) against brute force
and against the reference's K1 in Pallas interpret mode on 128 rays.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import bucket as jbucket  # noqa: E402
from tpu_raytracing.bvh import refit_schedule as jrs  # noqa: E402
from tpu_raytracing.bvh import split_convert as jsc  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.scene import procedural  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jprimary  # noqa: E402
from tpu_raytracing.trace.traverse import PackedPairs as JPackedPairs  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.app import main as tmain  # noqa: E402
from tpu_raytracing_torch.bvh import bucket as tbucket  # noqa: E402
from tpu_raytracing_torch.bvh import refit_schedule as trs  # noqa: E402
from tpu_raytracing_torch.bvh import split_convert as tsc  # noqa: E402
from tpu_raytracing_torch.scene import procedural as tproc  # noqa: E402
from tpu_raytracing_torch.trace import split_trace as st  # noqa: E402
from tpu_raytracing_torch.trace.brute import brute_force_trace as tbrute  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402
from tpu_raytracing_torch.trace.traverse import PackedPairs  # noqa: E402
from tpu_raytracing_torch.utils import timing  # noqa: E402

torch.set_num_threads(2)
LEAFW = st.LEAFW
SCENES = {
    "cornell": procedural.cornell_box,
    "sphere": lambda: procedural.sphere_scene(3),
    "soup": lambda: procedural.random_triangle_soup(2000, seed=1),
    "terrain": lambda: procedural.terrain(8000),
}


@functools.lru_cache(maxsize=None)
def scene(name):
    return SCENES[name]()


def same(ref, out, name=""):
    """Bit-equal: float32 compared as int32 words."""
    ref = np.asarray(ref)
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    if ref.dtype == np.float32:
        ref, out = ref.view(np.int32), out.astype(np.float32).view(np.int32)
    assert ref.shape == out.shape, (name, ref.shape, out.shape)
    np.testing.assert_array_equal(ref, out.astype(ref.dtype), err_msg=name)


@functools.lru_cache(maxsize=None)
def jax_bucket(name, pairs):
    fn = jax.jit(functools.partial(jbucket.build_bucket_split, enable_pairs=pairs,
                                   leaf_width=LEAFW))
    return jax.tree.map(np.asarray, fn(jnp.asarray(scene(name).triangles)))


@functools.lru_cache(maxsize=None)
def jax_sah_split(name):
    fn = jax.jit(functools.partial(jsc.build_sah_split, enable_pairs=True, leaf_width=LEAFW))
    return jax.tree.map(np.asarray, fn(jnp.asarray(scene(name).triangles)))


def port_tree(jsplit, jpacked):
    """A JAX-built split tree carried into the port."""
    return convert.sah_split_from_numpy(
        {f: np.asarray(getattr(jsplit, f)) for f in ("inner", "num_inner", "num_leaves",
                                                     "e_ranges", "leaf_width")},
        jpacked.rows, "cpu")


def jax_wobble(rows, t):
    """The reference's ``procedural.animate_triangles`` on the rows' four
    vertices, in numpy: what the reference app's ``_deform_rows`` does."""
    v = rows[:, :12].view(np.float32).reshape(-1, 4, 3)
    moved = procedural.animate_triangles(v, t).astype(np.float32)
    return np.concatenate([moved.reshape(-1, 12).view(np.int32), rows[:, 12:]], axis=1)


@pytest.mark.parametrize("pairs", [False, True], ids=["tris", "pairs"])
@pytest.mark.parametrize("name", list(SCENES))
def test_emit_split_bit_equal(name, pairs):
    """``build_bucket_split`` (``emit_split`` over ``split_front``) against
    the reference's: every word, ``e_ranges``, ``max_slot`` and the sorted
    pair rows with their zeroed tail; ``split_views`` of it against
    ``emit_split_views``."""
    jsplit, jpacked = jax_bucket(name, pairs)
    tris = torch.from_numpy(scene(name).triangles)
    split, packed = tbucket.build_bucket_split(tris, pairs, LEAFW)
    for f in ("inner", "e_ranges", "num_inner", "num_leaves", "max_slot"):
        same(getattr(jsplit, f), getattr(split, f), f)
    same(jpacked.rows, packed.rows, "sorted pair rows")
    live = np.arange(jpacked.rows.shape[0]) < int(jsplit.num_leaves)
    assert not jpacked.rows[~live].any()
    views = tbucket.split_views(split, packed)
    ref_views, ref_packed, _ = tbucket.emit_split_views(tbucket.split_front(tris, pairs),
                                                        leaf_width=LEAFW)
    for a, b in zip(views[:2], ref_views[:2]):
        same(b, a)
    assert views[2] == ref_views[2]
    same(ref_packed.rows, packed.rows)


@pytest.mark.parametrize("kind", ["bucket", "sah"])
def test_refit_split_bit_equal(kind):
    """``refit_split`` of the same tree over the same deformed numpy rows,
    the reference's and the port's: every word bit for bit. The SAH split
    tree's ``e_ranges`` come from its emit, as the bucket tree's do."""
    jsplit, jpacked = jax_bucket("terrain", True) if kind == "bucket" else jax_sah_split("terrain")
    rows_t = jax_wobble(jpacked.rows, 0.7)
    # and a deformation that inflates boxes far beyond the wobble
    rows_x = rows_t.copy()
    rows_x[:, :12] = (rows_x[:, :12].view(np.float32)
                      + (np.arange(rows_x.shape[0]) % 7)[:, None].astype(np.float32)
                      ).view(np.int32)
    split, _ = port_tree(jsplit, jpacked)
    jtree = jax.tree.map(jnp.asarray, jsplit)
    for rows in (rows_t, rows_x):
        ref = jax.jit(jbucket.refit_split)(jtree, JPackedPairs(rows=jnp.asarray(rows)))
        out = tbucket.refit_split(split, PackedPairs(rows=torch.from_numpy(rows)))
        same(ref.inner, out.inner, "refit inner")
        same(jsplit.e_ranges, out.e_ranges, "e_ranges unchanged")
        assert not np.array_equal(np.asarray(ref.inner), jsplit.inner)
        np.testing.assert_allclose(
            float(trs.entry_surface_area(out.inner)),
            float(jrs.entry_surface_area(ref.inner)), rtol=1e-5)


@pytest.mark.parametrize("name", ["sphere", "terrain"])
def test_deform_rows_matches_reference_wobble(name):
    """The app's ``deform_rows`` and the port's ``animate_triangles`` (on
    tensors) against the
    reference's ``procedural.animate_triangles`` on the same vertices:
    within 1e-6, or one float32 step of the coordinate where that is
    larger (the terrain's coordinates reach 45, a step of 3.8e-6, which a
    last-bit difference of sin or cos can flip)."""
    _, jpacked = jax_bucket(name, True)
    rows = jpacked.rows.copy()
    tris = scene(name).triangles
    for t in (0.1, 0.5, 2.3):
        ref = jax_wobble(rows, t)
        out = tmain.deform_rows(torch.from_numpy(rows), t).numpy()
        np.testing.assert_array_equal(out[:, 12:], ref[:, 12:])
        moved = tproc.animate_triangles(torch.from_numpy(tris), t).numpy()
        pairs = [(out[:, :12].view(np.float32), ref[:, :12].view(np.float32)),
                 (moved, procedural.animate_triangles(tris, t))]
        for a, b in pairs:
            np.testing.assert_allclose(a, b, rtol=2.0**-23, atol=1e-6)
    # a zeroed sentinel row stays degenerate: its four vertices move alike
    zero = tmain.deform_rows(torch.zeros((1, 16), dtype=torch.int32), 0.3)
    v = zero[:, :12].view(torch.float32).reshape(4, 3)
    assert bool((v == v[0]).all())


@pytest.mark.parametrize("pairs", [False, True], ids=["tris", "pairs"])
def test_rest_rows_give_the_rebuilt_geometry(pairs):
    """A refit after a rebuild deforms the rest pose of the rebuild's rows
    (``rest_rows``): for a tree built over the wobble at t = 0.4, the rest
    rows are the rows of the undeformed triangles (frame 0's tree gives its
    own rows back), and the wobble at 0.4 gives the rebuild's rows back bit
    for bit. Deforming the rebuild's rows themselves, as the reference's
    app does, moves each vertex twice."""
    tris = torch.from_numpy(scene("terrain").triangles)
    split0, packed0 = tbucket.build_bucket_split(tris, pairs, LEAFW)
    assert torch.equal(tmain.rest_rows(packed0.rows, tris, split0.num_leaves), packed0.rows)
    split, packed = tbucket.build_bucket_split(tproc.animate_triangles(tris, 0.4), pairs, LEAFW)
    n = int(split.num_leaves)
    rest = tmain.rest_rows(packed.rows, tris, split.num_leaves)
    assert not rest[n:].any() and torch.equal(rest[:n, 12:], packed.rows[:n, 12:])
    assert torch.equal(tmain.deform_rows(rest, 0.4)[:n], packed.rows[:n])
    twice = tmain.deform_rows(packed.rows, 0.4)[:n, :12].view(torch.float32)
    assert float((twice - packed.rows[:n, :12].view(torch.float32)).abs().max()) > 1e-2


def _explode(rows0, scale):
    """tests/test_refit_guard.py's deformation: each pair moved by a large
    pair-dependent offset, so a refit inflates every ancestor box."""
    v = rows0[:, :12].view(np.float32)
    off = (np.arange(rows0.shape[0], dtype=np.float32)[:, None] % 7.0) * np.float32(scale)
    return np.concatenate([(v + off).view(np.int32), rows0[:, 12:]], axis=1)


@functools.lru_cache(maxsize=None)
def _jax_rebuild_fn():
    return jax.jit(lambda t: jbucket.build_bucket_split(t, leaf_width=16))


def _schedules(**kw):
    tris = scene("sphere").triangles
    jsched = jrs.GuardedRefit(_jax_rebuild_fn(), **kw)
    tsched = trs.GuardedRefit(lambda t: tbucket.build_bucket_split(t, leaf_width=16), **kw)
    return (jsched, jnp.asarray(tris)), (tsched, torch.from_numpy(tris))


def _run(scheds, plan):
    """Step both schedules through ``plan`` (None: rebuild request, "same":
    the last rebuild's rows, "explode": exploded rows); the rebuild flags of
    each."""
    flags = []
    for sched, tris in scheds:
        out = []
        for step in plan:
            rows0 = None if sched.rows0 is None else np.asarray(sched.rows0)
            rows = {None: None, "same": rows0,
                    "explode": None if rows0 is None else _explode(rows0, 10.0)}[step]
            if rows is not None:
                rows = jnp.asarray(rows) if isinstance(tris, jnp.ndarray) else torch.from_numpy(
                    rows)
            out.append(bool(sched.step(tris, rows)[2]))
        flags.append((out, sched.rebuild_count))
    return flags


@pytest.mark.parametrize("case", ["stable", "inflation", "periodic", "seed", "interval3"])
def test_guarded_refit_decisions_match_reference(case):
    """The four cases of tests/test_refit_guard.py and a rebuild every
    fourth frame (``max_interval=3``), the reference's schedule and the
    port's side by side: the same rebuild/refit sequence. Under the
    profiler the port counts its frames and each rebuild under its reason
    (``utils/timing.py``)."""
    if case == "stable":
        scheds = _schedules(quality_bound=1.3)
        plan = [None, "same", "same", "same", "same"]
    elif case == "inflation":
        # frame 1 refits the exploded rows (the monitor lags a frame), frame
        # 2 rebuilds, and frame 3 refits against the new baseline
        scheds = _schedules(quality_bound=1.3)
        plan = [None, "explode", "same", "same"]
    elif case == "periodic":
        scheds = _schedules(quality_bound=0.0, max_interval=2)
        plan = [None] + ["same"] * 6
    elif case == "interval3":
        scheds = _schedules(quality_bound=0.0, max_interval=3)
        plan = [None] + ["same"] * 8
    else:
        scheds = _schedules()
        (jsched, jtris), (tsched, ttris) = scheds
        jsched.seed(*_jax_rebuild_fn()(jtris))
        tsched.seed(*tbucket.build_bucket_split(ttris, leaf_width=16))
        plan = ["same", "same"]
    timing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        ref, out = _run(scheds, plan)
    assert out == ref
    expect = {"stable": [True, False, False, False, False],
              "inflation": [True, False, True, False],
              "periodic": [True, False, False, True, False, False, True],
              "seed": [False, False],
              "interval3": [True, False, False, False, True, False, False, False, True]}[case]
    assert out[0] == expect
    rebuilds = {"stable": {"forced": 1}, "inflation": {"forced": 1, "monitor": 1},
                "periodic": {"forced": 1, "interval": 2}, "seed": {},
                "interval3": {"forced": 1, "interval": 2}}[case]
    assert timing.recorded()["counters"] == {
        "refit.frames": len(plan), **{f"refit.rebuild.{k}": n for k, n in rebuilds.items()}}


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


@pytest.mark.parametrize("kind", ["bucket", "sah"])
def test_refitted_tree_traced(kind, pallas_sp):
    """A tree refitted to the wobble at t = 0.9, traced by the port's K1
    (plain) on camera rays: against brute force over the deformed
    triangles, and against the reference's K1 (interpret mode, 128 rays)
    over the reference's refit of the same rows. The refitted tree keeps
    the stack bound of the tree it was built as."""
    jsplit, jpacked = jax_bucket("sphere", True) if kind == "bucket" else jax_sah_split("sphere")
    split, packed = port_tree(jsplit, jpacked)
    if kind == "bucket":
        views0 = tbucket.split_views(split, packed)
    else:
        views0 = tsc.sah_split_views(split, packed)[0]
    rows_t = jax_wobble(jpacked.rows, 0.9)
    ptr = PackedPairs(rows=torch.from_numpy(rows_t))
    views = tbucket.split_views(tbucket.refit_split(split, ptr), ptr, views0[2])
    sc = scene("sphere")
    camera = jcam.camera_to_device(jcam.update_camera(
        jcam.initialise_camera(sc.aabb_min, sc.aabb_max)))
    jr = jprimary(camera, 16, 8)
    fields = [np.asarray(getattr(jr, f)) for f in ("origin", "direction", "tmin", "tmax")]
    rays = Rays(*(torch.from_numpy(a.copy()) for a in fields))
    rec, stats = st.trace_rays_split(views, ptr, rays)
    assert int(stats.overflow.sum()) == 0
    moved = tproc.animate_triangles(torch.from_numpy(sc.triangles), 0.9)
    ref = tbrute(moved, rays)
    hit = ref.hit.numpy()
    assert hit.sum() > 64
    np.testing.assert_array_equal(rec.hit.numpy(), hit)
    np.testing.assert_allclose(rec.t.numpy()[hit], ref.t.numpy()[hit], rtol=1e-5)
    # the reference's K1 on the reference's refit of the same rows
    jrows = JPackedPairs(rows=jnp.asarray(rows_t))
    jref = jax.jit(jbucket.refit_split)(jax.tree.map(jnp.asarray, jsplit), jrows)
    kref, _ = pallas_sp.trace_rays_split_pallas(pallas_sp.prep_split_views(jref, jrows), jrows,
                                                jr, c_slots=1)
    khit = np.asarray(kref.hit)
    np.testing.assert_array_equal(rec.hit.numpy(), khit)
    np.testing.assert_array_equal(rec.tri_id.numpy()[khit], np.asarray(kref.tri_id)[khit])
    np.testing.assert_allclose(rec.t.numpy()[khit], np.asarray(kref.t)[khit], rtol=1e-5)
