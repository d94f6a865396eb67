"""The split tracer's call glue around K1 on the CPU: ``split_trace.kernel_operands``
and ``traverse.reconstruct``, whose CUDA kernels (``csrc/split_front.cu``)
run only on the card, where ``chip_smoke.py`` phase 21 holds them to their
plain versions bit for bit.

Here CPU tensors take the plain versions and launch nothing; the plain
versions agree with a float32 numpy model of the kernels' arithmetic, in
the kernels' order, on rays with dead rays, misses, ``t == F32_MAX`` with a
triangle named, second triangles and direction components at +-0.0,
+-1e-31, +-1e-30 and NaN; the operand checks that guard the kernels refuse
what they do not take; and every tracer the app runs through these
functions hands them operands the kernels take.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing_torch.bvh import bucket  # noqa: E402
from tpu_raytracing_torch.scene import camera as tcam  # noqa: E402
from tpu_raytracing_torch.scene import procedural as tproc  # noqa: E402
from tpu_raytracing_torch.trace import binned  # noqa: E402
from tpu_raytracing_torch.trace import split_trace as st  # noqa: E402
from tpu_raytracing_torch.trace import traverse as tv  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays, generate_primary_rays  # noqa: E402
from tpu_raytracing_torch.trace.traverse import PackedPairs  # noqa: E402

torch.set_num_threads(2)
F32_MAX = np.float32(np.finfo(np.float32).max)
NUM_RAYS, NUM_PAIRS = 640, 37
# direction components the clamp must treat exactly: zeros of both signs,
# values either side of 1e-30 in float32, NaN and ordinary values
TINY = np.float32(1e-30)
SPECIAL = np.array([0.0, -0.0, 1e-31, -1e-31, TINY, -TINY, np.nextafter(TINY, np.float32(0)),
                    -np.nextafter(TINY, np.float32(0)), np.nextafter(TINY, np.float32(1)),
                    np.nan, 0.5, -0.25], dtype=np.float32)
REC_FIELDS = ("hit", "t", "prim_id", "tri_id", "bary_u", "bary_v")


@pytest.fixture(scope="module")
def glue():
    """Seeded rays, an active mask, pair rows and K1-like (t, tri) results
    covering every case of the record kernel."""
    rng = np.random.default_rng(2207)
    n, p = NUM_RAYS, NUM_PAIRS
    origin = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    direction = rng.normal(size=(n, 3)).astype(np.float32)
    # one special value in one component of every other ray
    rows = np.arange(0, n, 2)
    direction[rows, rng.integers(0, 3, rows.size)] = rng.choice(SPECIAL, rows.size)
    direction[:len(SPECIAL), 1] = SPECIAL
    tmin = rng.uniform(0.0, 1e-3, n).astype(np.float32)
    tmax = rng.uniform(1.0, 20.0, n).astype(np.float32)
    tmax[rng.random(n) < 0.1] = F32_MAX
    active = rng.random(n) < 0.7
    verts = rng.uniform(-1.0, 1.0, (p, 12)).astype(np.float32)
    ints = np.stack([rng.integers(0, 5000, p), rng.integers(0, 5000, p),
                     rng.integers(0, 3, p), rng.integers(0, 3, p)], axis=1).astype(np.int32)
    pair_rows = np.concatenate([verts.view(np.int32), ints], axis=1)
    tri = rng.integers(0, 2 * p, n).astype(np.int32)
    tri[rng.random(n) < 0.25] = -1
    t = rng.uniform(0.1, 15.0, n).astype(np.float32)
    # a window none of whose triangles hit names its last slot at F32_MAX
    t[rng.random(n) < 0.15] = F32_MAX
    assert ((tri >= 0) & (t == F32_MAX)).any() and ((tri >= 0) & (tri % 2 == 1)).any()
    tt = {k: torch.from_numpy(v) for k, v in dict(
        origin=origin, direction=direction, tmin=tmin, tmax=tmax, active=active, t=t,
        tri=tri).items()}
    return dict(rays=Rays(tt["origin"], tt["direction"], tt["tmin"], tt["tmax"]),
                active=tt["active"], t=tt["t"], tri=tt["tri"],
                pairs=PackedPairs(rows=torch.from_numpy(pair_rows)))


def _same(a, b):
    """Equal dtype, shape and bits (floats compared as their int32 words)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _operands_model(rays, active):
    """split_operands_kernel in float32 numpy."""
    d = rays.direction.numpy()
    clamped = np.where(np.abs(d) < TINY, np.where(d < 0, -TINY, TINY), d).astype(np.float32)
    live = np.ones(d.shape[0], bool) if active is None else active.numpy()
    return (clamped, np.where(live, rays.tmin.numpy(), F32_MAX).astype(np.float32),
            np.where(live, rays.tmax.numpy(), -F32_MAX).astype(np.float32))


def _cross(a, b):
    return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1], a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)


def _dot(a, b):
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


def _record_model(pairs, rays, t, tri, any_hit):
    """split_record_kernel in float32 numpy, in the kernel's order."""
    t, tri = t.numpy(), tri.numpy()
    hit = (tri >= 0) & (any_hit | (t < F32_MAX))
    row = pairs.rows.numpy()[np.minimum(np.maximum(tri, 0) >> 1, pairs.rows.shape[0] - 1)]
    v = row[:, :12].copy().view(np.float32).reshape(-1, 4, 3)
    second = (tri & 1) == 1
    a = np.where(second[:, None], v[:, 2], v[:, 0])
    c = np.where(second[:, None], v[:, 3], v[:, 2])
    d, o = rays.direction.numpy(), rays.origin.numpy()
    e1, e2, s = v[:, 1] - a, c - a, o - a
    h = _cross(d, e2)
    with np.errstate(all="ignore"):
        f = np.float32(1.0) / _dot(e1, h)
        u, w = f * _dot(s, h), f * _dot(d, _cross(s, e1))
    zero = np.float32(0.0)
    return dict(hit=hit, t=np.where(hit, t, rays.tmax.numpy()),
                prim_id=np.where(hit, np.where(second, row[:, 13], row[:, 12]), 0),
                tri_id=np.where(hit, tri, 0), bary_u=np.where(hit, u, zero),
                bary_v=np.where(hit, w, zero))


@pytest.mark.parametrize("masked", [False, True])
def test_operands_cpu_takes_the_plain_version(glue, masked):
    rays, active = glue["rays"], glue["active"] if masked else None
    before = st.operands_launch_count
    out = st.kernel_operands(rays, active)
    ref = st.kernel_operands_plain(rays, active)
    assert st.operands_launch_count == before == 0
    assert out[0] is rays.origin
    assert all(_same(a, b) for a, b in zip(out, ref))
    for got, want in zip(out[1:], _operands_model(rays, active)):
        assert np.array_equal(got.numpy(), want, equal_nan=True)
    # +-0.0 become +1e-30, +-1e-31 and the floats just below 1e-30 become
    # +-1e-30, 1e-30 itself, larger values and NaN stay
    want = np.array([TINY, TINY, TINY, -TINY, TINY, -TINY, TINY, -TINY, SPECIAL[8], np.nan,
                     0.5, -0.25], dtype=np.float32)
    np.testing.assert_array_equal(out[1].numpy()[:len(SPECIAL), 1].view(np.int32),
                                  want.view(np.int32))
    if masked:
        dead = ~active.numpy()
        assert (out[2].numpy()[dead] == F32_MAX).all() and (out[3].numpy()[dead] == -F32_MAX).all()


@pytest.mark.parametrize("any_hit", [False, True])
def test_record_cpu_takes_the_plain_version(glue, any_hit):
    g = glue
    before = tv.launch_count
    rec = tv.reconstruct(g["pairs"], g["rays"], g["t"], g["tri"], any_hit=any_hit)
    ref = tv.reconstruct_plain(g["pairs"], g["rays"], g["t"], g["tri"], any_hit=any_hit)
    assert tv.launch_count == before == 0
    for name in REC_FIELDS:
        assert _same(getattr(rec, name), getattr(ref, name)), name
    assert [getattr(rec, k).dtype for k in REC_FIELDS] == [
        torch.bool, torch.float32, torch.int32, torch.int32, torch.float32, torch.float32]
    model = _record_model(g["pairs"], g["rays"], g["t"], g["tri"], any_hit)
    for name in REC_FIELDS:
        got = getattr(rec, name).numpy()
        assert got.dtype == model[name].dtype or name in ("prim_id", "tri_id"), name
        assert np.array_equal(got, model[name], equal_nan=name.startswith("bary")), name
    hit = rec.hit.numpy()
    named_at_max = (g["tri"].numpy() >= 0) & (g["t"].numpy() == F32_MAX)
    # closest hit: a named triangle at F32_MAX is a miss; any hit: a hit
    assert hit[named_at_max].all() == any_hit and hit[named_at_max].any() == any_hit
    miss = ~hit
    assert (rec.prim_id.numpy()[miss] == 0).all() and (rec.tri_id.numpy()[miss] == 0).all()
    np.testing.assert_array_equal(rec.bary_u.numpy()[miss].view(np.int32), 0)
    np.testing.assert_array_equal(rec.t.numpy()[miss], g["rays"].tmax.numpy()[miss])


def _operand_inputs(g):
    r = g["rays"]
    return dict(origin=r.origin, direction=r.direction, tmin=r.tmin, tmax=r.tmax,
                active=g["active"])


def _record_inputs(g):
    r = g["rays"]
    return dict(origin=r.origin, direction=r.direction, tmax=r.tmax, t=g["t"], tri=g["tri"],
                rows=g["pairs"].rows)


def _check_operands(s):
    st.check_operand_inputs(Rays(s["origin"], s["direction"], s["tmin"], s["tmax"]),
                            s["active"])


def _check_record(s):
    rays = Rays(s["origin"], s["direction"], s["origin"][:, 0].contiguous(), s["tmax"])
    tv.check_record_operands(PackedPairs(rows=s["rows"]), rays, s["t"], s["tri"])


def _noncontig(x):
    return x.t().contiguous().t() if x.dim() == 2 else x.repeat_interleave(2)[::2]


def _misaligned(x):
    """The same values, 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


BAD = {
    "operands": {
        "direction_noncontig": ("direction", _noncontig),
        "tmin_noncontig": ("tmin", _noncontig),
        "tmax_misaligned": ("tmax", _misaligned),
        "origin_misaligned": ("origin", _misaligned),
        "direction_f64": ("direction", lambda x: x.double()),
        "active_uint8": ("active", lambda x: x.to(torch.uint8)),
        "tmin_shape": ("tmin", lambda x: x[:, None]),
        "active_short": ("active", lambda x: x[:-1]),
        "tmax_meta": ("tmax", lambda x: x.to("meta")),
    },
    "record": {
        "direction_noncontig": ("direction", _noncontig),
        "t_noncontig": ("t", _noncontig),
        "rows_misaligned": ("rows", _misaligned),
        "t_misaligned": ("t", _misaligned),
        "tri_int64": ("tri", lambda x: x.long()),
        "t_f64": ("t", lambda x: x.double()),
        "rows_width": ("rows", lambda x: x[:, :12].contiguous()),
        "tri_short": ("tri", lambda x: x[:-1]),
        "tmax_meta": ("tmax", lambda x: x.to("meta")),
    },
}
CHECKS = {"operands": (_operand_inputs, _check_operands),
          "record": (_record_inputs, _check_record)}


@pytest.mark.parametrize("kernel", sorted(CHECKS))
def test_checks_take_the_fixtures_operands(glue, kernel):
    inputs, check = CHECKS[kernel]
    check(inputs(glue))


@pytest.mark.parametrize("kernel,case", [(k, c) for k in sorted(BAD) for c in sorted(BAD[k])])
def test_checks_refuse(glue, kernel, case):
    inputs, check = CHECKS[kernel]
    s = inputs(glue)
    name, bad = BAD[kernel][case]
    s[name] = bad(s[name])
    with pytest.raises(ValueError, match=r"^(kernel_operands|reconstruct): "):
        check(s)


def test_other_devices_raise(glue):
    r = glue["rays"]
    meta = Rays(*(x.to("meta") for x in (r.origin, r.direction, r.tmin, r.tmax)))
    with pytest.raises(ValueError, match="unsupported device"):
        st.kernel_operands(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tv.reconstruct(glue["pairs"], meta, glue["t"].to("meta"), glue["tri"].to("meta"))


@pytest.fixture()
def checked(monkeypatch):
    """Runs both kernels' operand checks on every CPU call of the plain
    versions; returns the calls seen, by kernel."""
    calls = {"operands": 0, "record": 0}
    real_ops, real_rec = st.kernel_operands_plain, tv.reconstruct_plain

    def ops(rays, active=None):
        st.check_operand_inputs(rays, active)
        calls["operands"] += 1
        return real_ops(rays, active)

    def rec(pairs, rays, t, tri, any_hit=False):
        tv.check_record_operands(pairs, rays, t, tri)
        calls["record"] += 1
        return real_rec(pairs, rays, t, tri, any_hit=any_hit)

    monkeypatch.setattr(st, "kernel_operands_plain", ops)
    monkeypatch.setattr(tv, "reconstruct_plain", rec)
    return calls


@pytest.mark.parametrize("tracer", ["split", "lane", "grid"])
def test_every_app_tracer_hands_the_kernels_their_operands(tmp_path, checked, tracer):
    """The app's 1-bounce path traced by each tracer that rebuilds hit
    records with ``reconstruct``: every call's operands pass the kernels'
    checks, so on the card none of them makes a wrapper raise."""
    from tpu_raytracing_torch.app import main as app

    app.main(["--scene", "cornell", "--type", "bottom-up", "--pairs", "--tracer", tracer,
              "--bounces", "1", "--width", "16", "--height", "8", "--device", "cpu",
              "--output", str(tmp_path)])
    # primary, primary shadow, bounce, bounce shadow: at least one record each
    assert checked["record"] >= 4
    assert checked["operands"] == (checked["record"] if tracer == "split" else 0)
    assert st.operands_launch_count == 0 and tv.launch_count == 0


@pytest.fixture(scope="module")
def cornell_split():
    scene = tproc.cornell_box()
    views, packed, _ = bucket.emit_split_views(
        bucket.split_front(torch.from_numpy(scene.triangles), True), leaf_width=st.LEAFW)
    camera = tcam.camera_to_device(
        tcam.update_camera(tcam.initialise_camera(scene.aabb_min, scene.aabb_max)), "cpu")
    return views, packed, generate_primary_rays(camera, 16, 16)


@pytest.mark.parametrize("any_hit", [False, True])
def test_split_tracers_hand_the_kernels_their_operands(checked, cornell_split, any_hit):
    """trace_rays_split with a mask and with start tags, and the binned
    tracer over it."""
    views, packed, rays = cornell_split
    active = torch.from_numpy(np.random.default_rng(5).random(256) < 0.6)
    rec, _ = st.trace_rays_split(views, packed, rays, active=active, any_hit=any_hit)
    assert bool(rec.hit.any()) and not bool((rec.hit & ~active).any())
    tags = torch.zeros((256 // st.K,), dtype=torch.int32)
    st.trace_rays_split(views, packed, rays, any_hit=any_hit, packet_tags=tags)
    binned.trace_rays_binned(views, packed, rays, active=active, any_hit=any_hit)
    assert checked["operands"] >= 3 and checked["record"] == 3
