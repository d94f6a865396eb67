"""PyTorch port's per-ray treelet tracer (K5's plain version on the CPU) vs
the JAX reference: the Pallas lane kernel in interpret mode (also on a
window of exact ties), brute force, the numpy walk over the tables, and a
JAX-built TreeletBVH traced by the port; the drivers' packet-layout state
shuffle against the per-ray one it replaced; the wrapper's routing and
operand checks.

Against the lane kernel the comparison is on hit, tri id and box/tri test
counts, with t within rtol 1e-5: an unbudgeted launch visits the same
elements per ray in both. Against brute force and the float64 walk it is
on hit, t (rtol 1e-5) and prim id, as tests/test_lane_pallas.py holds the
reference, except that a ray may miss or hit by float32 rounding at a
triangle edge on up to 0.5% of the rays: the tracer tests a pair's second
triangle as (v2, v1, v3), in another vertex order than the source triangle
that brute force tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import bucket as jbucket  # noqa: E402
from tpu_raytracing.bvh import treelet as jtreelet  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.trace import lane_pallas  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jprimary  # noqa: E402
from tpu_raytracing.trace.wide_fat import _reconstruct as jreconstruct  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import bucket as tbucket  # noqa: E402
from tpu_raytracing_torch.bvh import treelet as ttreelet  # noqa: E402
from tpu_raytracing_torch.trace import lane_trace as lt  # noqa: E402
from tpu_raytracing_torch.trace.brute import brute_force_trace  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402
from tpu_raytracing_torch.trace.split_trace import check_overflow  # noqa: E402

torch.set_num_threads(2)


def _camera_rays(scene, width, height):
    c = jcam.camera_to_device(jcam.update_camera(
        jcam.initialise_camera(scene.aabb_min, scene.aabb_max)))
    r = jprimary(c, width, height)
    return tuple(np.asarray(getattr(r, f), np.float32)
                 for f in ("origin", "direction", "tmin", "tmax"))


def _interior_rays(scene, n, seed):
    """Incoherent rays from inside the scene's box (the bounce regime)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(scene.aabb_min), np.asarray(scene.aabb_max)
    o = ((lo + hi) / 2 + (rng.random((n, 3)) - 0.5) * (hi - lo) * 0.5).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, np.zeros(n, np.float32), np.full(n, 1e30, np.float32)


def _aimed_rays(scene, n, seed):
    """Rays shot at random triangles along their normals from 0.5-3 units
    away, from all over the scene (the camera sees few soup triangles)."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, scene.num_triangles, n)
    nrm = scene.normals[pick, 0]
    o = (scene.triangles[pick].mean(axis=1) + nrm * rng.uniform(0.5, 3.0, (n, 1)))
    d = -nrm + rng.normal(scale=0.05, size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32), np.zeros(n, np.float32),
            np.full(n, 1e30, np.float32))


def _port_rays(o, d, lo, hi):
    return Rays(*(torch.from_numpy(np.array(a)) for a in (o, d, lo, hi)))


@functools.lru_cache(maxsize=None)
def _port_tree(name, lw=16, ecap=128):
    from tpu_raytracing.scene import procedural
    scene = {"cornell": procedural.cornell_box, "sphere": lambda: procedural.sphere_scene(3),
             "soup": lambda: procedural.random_triangle_soup(2000, seed=1)}[name]()
    front = tbucket.split_front(torch.from_numpy(scene.triangles), name != "cornell")
    tcap = ttreelet.treelet_capacity(front, lw, ecap) + 8
    tb, packed = ttreelet.build_treelet(front, tcap, leaf_width=lw, ecap=ecap)
    ttreelet.check_treelet_capacity(tb)
    return scene, tb, packed


def _assert_hits_agree(hit, ref_hit):
    """Equal hit sets up to edge rounding on at most 0.5% of the rays."""
    bad = int((hit != ref_hit).sum())
    assert bad <= max(1, hit.shape[0] // 200), f"{bad} of {hit.shape[0]} rays differ in hit"
    return hit & ref_hit


def _assert_matches(rec, ref, live=None):
    ref_hit = ref.hit.numpy() if live is None else ref.hit.numpy() & live
    both = _assert_hits_agree(rec.hit.numpy(), ref_hit)
    np.testing.assert_allclose(np.where(both, rec.t.numpy(), 0.0),
                               np.where(both, ref.t.numpy(), 0.0), rtol=1e-5)
    np.testing.assert_array_equal(np.where(both, rec.prim_id.numpy(), 0),
                                  np.where(both, ref.prim_id.numpy(), 0))


@functools.lru_cache(maxsize=None)
def _jax_cornell_treelet():
    """The reference's treelet BVH over cornell's unpaired bucket front,
    built once for both cases."""
    from tpu_raytracing.scene import procedural

    front = jax.jit(lambda t: jbucket.split_front(t, enable_pairs=False))(
        jnp.asarray(procedural.cornell_box().triangles))
    tcap = jtreelet.treelet_capacity(front, 16) + 8
    return jax.jit(lambda f: jtreelet.build_treelet(f, tcap, leaf_width=16))(front)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_matches_pallas_lane_kernel(cornell, any_hit):
    """One 128-ray packet through the reference kernel in interpret mode, on
    one packet slot (``c_slots=1`` keeps interpret mode short)."""
    jtb, jpacked = _jax_cornell_treelet()
    o, d, lo, hi = _camera_rays(cornell, 16, 8)
    jrays = JRays(*(jnp.asarray(a) for a in (o, d, lo, hi)))
    (jt, jtri), _, jout, _ = lane_pallas.trace_rays_lane_pallas(
        jtb, jpacked, jrays, any_hit=any_hit, c_slots=1, raw=True)
    jrec = jreconstruct(jpacked, jrays, jt, jtri)

    _, tb, packed = _port_tree("cornell")
    rays = _port_rays(o, d, lo, hi)
    rec, stats = lt.trace_rays_lane(tb, packed, rays, any_hit=any_hit)
    (_, tri), _, out, _ = lt.trace_rays_lane(tb, packed, rays, any_hit=any_hit, raw=True)
    jout = np.asarray(jout)
    assert int(np.asarray(jrec.hit).sum()) > 64
    np.testing.assert_array_equal(rec.hit.numpy(), np.asarray(jrec.hit))
    np.testing.assert_array_equal(rec.tri_id.numpy(), np.asarray(jrec.tri_id))
    np.testing.assert_allclose(rec.t.numpy(), np.asarray(jrec.t), rtol=1e-5)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
    np.testing.assert_allclose(out[:, 0].numpy(), jout[:, 0], rtol=1e-5)
    for row in (1, 2, 3):  # tri bits, box tests, tri tests
        np.testing.assert_array_equal(out[:, row].numpy().view(np.int32),
                                      jout[:, row].view(np.int32))
    np.testing.assert_array_equal(stats.box_tests.numpy(), jout[:, 2].reshape(-1).astype(np.int32))
    assert int(stats.overflow) == 0


# (tree, ray set, stack depth): half-dead camera rays, a ray count that is
# not a multiple of 128, an ecap 16 tree (multi-round cut, portals) under
# rays aimed from all over the soup, and incoherent rays with a 12-deep
# stack, where some rays pass the overflow flag (watermark > stack - 8) and
# the recovery rounds re-run them.
RECOVERY_STACK = 12
CASES = {
    "half_dead": (("sphere", 16, 128), "camera_half_dead", lt.STACK),
    "ragged": (("sphere", 16, 128), "camera_ragged", lt.STACK),
    "ecap16": (("soup", 8, 16), "aimed", lt.STACK),
    "recovery": (("sphere", 16, 128), "interior", RECOVERY_STACK),
}


def _case_rays(scene, kind):
    if kind == "camera_half_dead":
        o, d, lo, hi = _camera_rays(scene, 32, 16)
        live = np.arange(o.shape[0]) % 2 == 0
        return (o, d, lo, hi), live
    if kind == "camera_ragged":
        # 280 rays; an even height keeps the middle row off the sphere's
        # equator edges, where neighbours tie on t
        return _camera_rays(scene, 20, 14), None
    if kind == "aimed":
        return _aimed_rays(scene, 384, seed=3), None
    return _interior_rays(scene, 384, seed=11), None


@functools.lru_cache(maxsize=None)
def _case_oracles(case):
    """A case's rays and the two oracles' answers on them (brute force and
    the numpy treelet walk), worked out once, not once a schedule."""
    tree, kind, _ = CASES[case]
    scene, tb, _ = _port_tree(*tree)
    (o, d, lo, hi), live = _case_rays(scene, kind)
    ref = brute_force_trace(torch.from_numpy(scene.triangles), _port_rays(o, d, lo, hi))
    return (o, d, lo, hi), live, ref, ttreelet.reference_walk(tb, o, d, lo, hi)


@pytest.mark.parametrize("driver", lt.DRIVERS)
@pytest.mark.parametrize("case", list(CASES))
def test_drivers_match_brute_and_walk(driver, case):
    tree, _, stack = CASES[case]
    _, tb, packed = _port_tree(*tree)
    (o, d, lo, hi), live, ref, (wt, wtri) = _case_oracles(case)
    rays = _port_rays(o, d, lo, hi)
    active = None if live is None else torch.from_numpy(live)
    tracer = lt.make_lane_tracer(driver=driver, budgets=(3, 5) if driver != "single" else None,
                                 phases=3, stack=stack)
    rec, stats = tracer(tb, packed, rays, active=active)
    assert rec.hit.shape == (o.shape[0],) and stats.box_tests.shape == (o.shape[0],)
    check_overflow(stats.overflow)
    assert int(ref.hit.sum()) > 8
    _assert_matches(rec, ref, live)
    whit = wtri >= 0 if live is None else (wtri >= 0) & live
    both = _assert_hits_agree(rec.hit.numpy(), whit)
    np.testing.assert_allclose(np.where(both, rec.t.numpy(), 0), np.where(both, wt, 0), rtol=1e-5)
    # any-hit finds the same occluded set
    arec, astats = lt.make_lane_tracer(any_hit=True, driver=driver, stack=stack)(
        tb, packed, rays, active=active)
    check_overflow(astats.overflow)
    np.testing.assert_array_equal(arec.hit.numpy(), rec.hit.numpy())


def test_recovery_rounds_and_unfinished_flag():
    """With a 12-deep stack some rays pass the overflow watermark in an
    unbudgeted launch; the recovery rounds finish them. With an 8-deep stack
    every ray that pushes is flagged in every round, and the tracer reports
    the unfinished rays instead of dropping their hits."""
    scene, tb, packed = _port_tree("sphere")
    rays = _port_rays(*_interior_rays(scene, 384, seed=11))
    (_, _), _, out, _ = lt.trace_rays_lane(tb, packed, rays, raw=True, stack=RECOVERY_STACK)
    assert int((out[:, 7] > 0).sum()) > 0
    (_, _), stats, want = lt.trace_rays_lane_restart(tb, packed, rays, raw=True, budgets=(),
                                                     stack=RECOVERY_STACK)
    assert int((want > 0).sum()) == 0 and int(stats.overflow) == 0
    _, stats = lt.make_lane_tracer(stack=8)(tb, packed, rays)
    assert int(stats.overflow) == 1
    with pytest.raises(RuntimeError, match="stack overflow"):
        check_overflow(stats.overflow)


def test_budgeted_launch_resumes_to_the_same_state():
    """Budgeted launches resumed from their own state end where one
    unbudgeted launch ends (rows 0-3 of out and the whole state)."""
    scene, tb, packed = _port_tree("soup", 8, 16)
    rays = _port_rays(*_interior_rays(scene, 256, seed=5))
    (_, _), _, full, full_state = lt.trace_rays_lane(tb, packed, rays, raw=True)
    state, box = None, 0
    for _ in range(200):
        (_, _), st, out, state = lt.trace_rays_lane(tb, packed, rays, raw=True, budget=4,
                                                    state=state)
        box = box + st.box_tests
        if not bool((out[:, 7] > 0).any()):
            break
    assert bool((out[:, 4] <= 4).all())
    np.testing.assert_array_equal(state.numpy(), full_state.numpy())
    for row in (0, 1):
        np.testing.assert_array_equal(out[:, row].numpy().view(np.int32),
                                      full[:, row].numpy().view(np.int32))
    np.testing.assert_array_equal(box.numpy(), full[:, 2].reshape(-1).numpy().astype(np.int32))


def test_jax_built_treelet_traced_by_port(sphere):
    front = jax.jit(lambda t: jbucket.split_front(t, enable_pairs=True))(
        jnp.asarray(sphere.triangles))
    tcap = jtreelet.treelet_capacity(front, 16) + 8
    jtb, jpacked = jax.jit(lambda f: jtreelet.build_treelet(f, tcap, leaf_width=16))(front)
    fields = {k: np.asarray(getattr(jtb, k)) for k in (
        "tables", "num_treelets", "root_tid", "max_col", "num_leaves", "pair_tid")}
    tb = convert.treelet_from_numpy(dict(fields, leaf_width=jtb.leaf_width), "cpu")
    packed = convert.packed_from_numpy(np.asarray(jpacked.rows), "cpu")
    o, d, lo, hi = _camera_rays(sphere, 32, 16)
    rays = _port_rays(o, d, lo, hi)
    rec, stats = lt.make_lane_tracer()(tb, packed, rays)
    _assert_matches(rec, brute_force_trace(torch.from_numpy(sphere.triangles), rays))
    # the port's own structure is bit-equal, so the traversal is identical
    _, own_tb, own_packed = _port_tree("sphere")
    own, own_stats = lt.make_lane_tracer()(own_tb, own_packed, rays)
    for a, b in ((rec.tri_id, own.tri_id), (rec.t, own.t),
                 (stats.box_tests, own_stats.box_tests)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_routes_by_device():
    """CPU tensors take the plain version and never count a launch; other
    devices raise instead of falling back."""
    scene, tb, packed = _port_tree("sphere")
    rays = _port_rays(*_camera_rays(scene, 16, 8))
    r8 = lt.rays8_of(rays)
    state = lt.init_state(int(tb.root_tid), rays.tmax)
    before = lt.launch_count
    out, st = lt.lane_traverse(tb.tables, tb.columns, r8, state, int(tb.root_tid), lw=16,
                               any_hit=False)
    ref, ref_st = lt.trace_lane_plain(tb.tables, r8, state, int(tb.root_tid), lw=16,
                                      any_hit=False)
    np.testing.assert_array_equal(out.numpy().view(np.int32), ref.numpy().view(np.int32))
    np.testing.assert_array_equal(st.numpy(), ref_st.numpy())
    assert lt.launch_count == before
    meta = [x.to("meta") for x in (tb.tables, tb.columns, r8, state)]
    with pytest.raises(ValueError, match="unsupported device"):
        lt.lane_traverse(*meta, int(tb.root_tid), lw=16, any_hit=False)


def _misshapen_columns(tb, kind):
    cols = tb.columns
    if kind == "reference_layout":
        return tb.tables
    if kind == "not_contiguous":
        return tb.tables.transpose(1, 2)
    # the right shape, 4 bytes off a 16-byte boundary
    return torch.empty(cols.numel() + 1, dtype=cols.dtype)[1:].view(cols.shape)


@pytest.mark.parametrize("kind", ["reference_layout", "not_contiguous", "misaligned", "leafw"])
def test_check_operands_refuses(kind):
    """The kernel reads ``columns`` [T, ecap, wh] as 16-byte vectors and
    takes leaf widths up to 128 (8 triangles a lane); the wrapper refuses
    anything else before a launch."""
    _, tb, _ = _port_tree("sphere")
    rays = _port_rays(*_camera_rays(_port_tree("sphere")[0], 16, 8))
    r8, state = lt.rays8_of(rays), lt.init_state(int(tb.root_tid), rays.tmax)
    lt._check_operands(tb.tables, tb.columns, r8, state, 16)
    cols, lw = tb.columns, 16
    if kind == "leafw":
        lw = lt.MAX_LEAFW + 1
    else:
        cols = _misshapen_columns(tb, kind)
    with pytest.raises(ValueError, match="columns|leaf width"):
        lt._check_operands(tb.tables, cols, r8, state, lw)


def _tie_scene():
    """terrain(8) with every triangle twice: 16 unpaired pair rows (each
    row's second triangle repeats its first), the copies on neighbouring
    rows, all in one 16-pair window, the tiny-scene root."""
    from tpu_raytracing.scene import procedural
    scene = procedural.terrain(8)
    return scene, np.repeat(scene.triangles, 2, axis=0)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_matches_pallas_lane_kernel_on_exact_ties(any_hit):
    """The window winner's tie rule against the Pallas lane kernel: the
    smallest t and, on an equal t, the larger 2 * p + second, which K5's
    warp reduction reproduces. One window, so the TPU's packet order cannot
    matter; one packet of 128 rays on one packet slot (``c_slots=1`` keeps
    interpret mode short). 96 camera rays hit copies; 32 rays start on the
    box's top face, point up and have tmax = F32_MAX, so they enter the
    window, miss every triangle and still take its all-miss index,
    2 * lw - 1, as the reference does."""
    scene, tris = _tie_scene()
    jfront = jax.jit(lambda t: jbucket.split_front(t, enable_pairs=True))(jnp.asarray(tris))
    tcap = jtreelet.treelet_capacity(jfront, 16) + 8
    jtb, jpacked = jax.jit(lambda f: jtreelet.build_treelet(f, tcap, leaf_width=16))(jfront)
    tb, packed = ttreelet.build_treelet(tbucket.split_front(torch.from_numpy(tris), True), tcap,
                                        leaf_width=16)
    assert int(tb.num_treelets) == 1 and int(tb.num_leaves) == 16
    o, d, lo, hi = _camera_rays(scene, 16, 6)
    rng = np.random.default_rng(5)
    bmin, bmax = scene.aabb_min, scene.aabb_max
    up_o = np.stack([rng.uniform(bmin[0], bmax[0], 32), np.full(32, bmax[1]),
                     rng.uniform(bmin[2], bmax[2], 32)], 1)
    up_d = np.tile([0.0, 1.0, 0.0], (32, 1)) + rng.normal(scale=0.05, size=(32, 3))
    up_d /= np.linalg.norm(up_d, axis=1, keepdims=True)
    f32_max = np.finfo(np.float32).max
    o, d = (np.concatenate(a).astype(np.float32) for a in ((o, up_o), (d, up_d)))
    lo = np.concatenate([lo, np.zeros(32)]).astype(np.float32)
    hi = np.concatenate([hi, np.full(32, f32_max)]).astype(np.float32)
    jrays = JRays(*(jnp.asarray(a) for a in (o, d, lo, hi)))
    (_, jtri), _, jout, _ = lane_pallas.trace_rays_lane_pallas(
        jtb, jpacked, jrays, any_hit=any_hit, c_slots=1, raw=True)
    (_, tri), _, out, _ = lt.trace_rays_lane(tb, packed, _port_rays(o, d, lo, hi),
                                             any_hit=any_hit, raw=True)
    jtri, jout = np.asarray(jtri), np.asarray(jout)
    np.testing.assert_array_equal(tri.numpy(), jtri)
    for row in (1, 2, 3):  # tri bits, box tests, tri tests
        np.testing.assert_array_equal(out[:, row].numpy().view(np.int32),
                                      jout[:, row].view(np.int32))
    # XLA's CPU compiler contracts Möller-Trumbore differently: t agrees to
    # a few ulps here (bit for bit on the card, K5 to plain)
    np.testing.assert_allclose(out[:, 0].numpy(), jout[:, 0], rtol=1e-5)
    # every camera hit ties with its copy: the later copy (an odd pair) wins
    cam_hit = jtri[:96] >= 0
    assert cam_hit.sum() > 16
    assert (jtri[:96][cam_hit] >> 1 & 1 == 1).all()
    assert (jtri[96:] == 2 * 16 - 1).all()


def _resume_rounds_per_ray(tb, rays, any_hit, rounds, stack):
    """The wave and phase drivers' rounds with the state shuffled per ray
    (transposed to [num, rows], reset by a where over every ray, gathered,
    transposed back): the reference for ``lt._resume_rounds``, which keeps
    the state in packet layout. Returns (t, tri, box, tri tests, want) in
    the rays' order."""
    num = rays.origin.shape[0]
    root = int(tb.root_tid)
    orig = torch.arange(num)
    cur_rays, state = rays, None
    box = torch.zeros((num,), dtype=torch.int32)
    trit = torch.zeros((num,), dtype=torch.int32)
    row = torch.arange(5 + stack)[None, :]
    for i, (b, ns) in enumerate(rounds):
        (t, tri), st2, out, state = lt.trace_rays_lane(
            tb, None, cur_rays, any_hit=any_hit, raw=True, budget=b, state=state, no_switch=ns,
            stack=stack)
        box = box + st2.box_tests
        trit = trit + st2.tri_tests
        want = out[:, 7, :].to(torch.int32).reshape(num)
        if i == len(rounds) - 1:
            break
        ovf = (want > 0) & (out[:, 6, :].to(torch.int32).reshape(num) > stack - 8)
        pst = lt._per_ray(state)
        reset = torch.where(row == 0, (root << 9) | 1, torch.where(row < 3, pst, 0))
        pst = torch.where(ovf[:, None], reset, pst).to(torch.int32)
        want = torch.where(ovf, root + 1, want)
        perm = torch.sort(torch.where(want > 0, want, lt._BIG), stable=True).indices
        state = lt._per_packet(pst[perm])
        cur_rays = cur_rays.take(perm)
        box, trit, orig = box[perm], trit[perm], orig[perm]
    inv = torch.argsort(orig)
    return t[inv], tri[inv], box[inv], trit[inv], want[inv]


@pytest.mark.parametrize("driver", ["wave", "phase"])
@pytest.mark.parametrize("case", ["ecap16", "recovery"])
def test_packet_layout_shuffle_matches_per_ray_shuffle(driver, case):
    """The drivers' rounds give bit-equal t, tri, test counts and wanted
    treelets whether the state is shuffled in packet layout or per ray; the
    recovery case's 12-deep stack flags rays for the reset between
    rounds."""
    tree, kind, stack = CASES[case]
    scene, tb, packed = _port_tree(*tree)
    rays = _port_rays(*_case_rays(scene, kind)[0])
    rounds = ([(3, False), (5, False)] + [(0, False)] * (1 + lt.RECOVER) if driver == "wave"
              else [(0, True)] * 3 + [(0, False)] * (1 + lt.RECOVER))
    for any_hit in (False, True):
        (t, tri), stats, want = lt._resume_rounds(tb, packed, rays, None, any_hit, True, rounds,
                                                  stack)
        ref = _resume_rounds_per_ray(tb, rays, any_hit, rounds, stack)
        for a, b in zip((t, tri, stats.box_tests, stats.tri_tests, want), ref):
            np.testing.assert_array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))
    if case == "recovery":
        (_, _), _, out, _ = lt.trace_rays_lane(tb, packed, rays, raw=True, stack=stack)
        assert int((out[:, 6] > stack - 8).sum()) > 0
