"""``trace_rays_wide_fat(with_trips=True)`` in the PyTorch port against
the JAX reference: the reference's lockstep packet loop, ported as
PyTorch ops, on the same fat rows and 16 x 8 tiled rays. Trip counts and
the per-packet box and triangle counts are exact; hit, tri_id and t are
exact too (the loop rounds Möller-Trumbore as XLA's CPU compiler
contracts it), the barycentrics to atol 1e-5, as
``tests/test_torch_fat_traverse.py`` holds them (the hit record is rebuilt
by ``traverse.reconstruct``, which XLA contracts otherwise in this loop;
the soup's small triangles amplify that to 4.5e-6). Fat rows: the
reference's ``build_bucket_fat`` (sphere(3) with pairs; also a half-dead
frame) and ``build_implicit_wide_fat`` (soup(600)). A hand-made chain of
rows deep enough to fill the 48 stack registers holds the reference's
drop of the farthest pending subtree (the same trips) and the port's
overflow flag on it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import bucket as jbucket  # noqa: E402
from tpu_raytracing.bvh import implicit as jimplicit  # noqa: E402
from tpu_raytracing.bvh.wide import FatWideBVH as JFat  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.scene import procedural as jproc  # noqa: E402
from tpu_raytracing.trace import wide_fat as jwide_fat  # noqa: E402
from tpu_raytracing.trace.packet import tile_reorder as jtile  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jprimary  # noqa: E402
from tpu_raytracing.trace.traverse import PackedPairs as JPackedPairs  # noqa: E402
from tpu_raytracing.trace.traverse import pack_pairs as jpack_pairs  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.ops import fat_traverse  # noqa: E402
from tpu_raytracing_torch.trace import wide_fat  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402
from tpu_raytracing_torch.trace.traverse import PackedPairs  # noqa: E402

torch.set_num_threads(2)
W, H = 32, 32
_jtrips = jax.jit(functools.partial(jwide_fat.trace_rays_wide_fat, with_trips=True))
# every case's fat rows and pair rows are padded with zero rows to ROWS and
# its rays counted W * H with an explicit mask, so the reference's loop
# compiles once for the file
ROWS = 2048


def _pad(a) -> np.ndarray:
    a = np.asarray(a)
    return np.concatenate([a, np.zeros((ROWS - a.shape[0],) + a.shape[1:], a.dtype)])


def jax_trips(rows, prows, arrays, active):
    """The reference's trips loop on padded rows: (HitRecord, stats, trips)."""
    return _jtrips(JFat(rows=jnp.asarray(_pad(rows)), num_nodes=jnp.int32(ROWS)),
                   JPackedPairs(rows=jnp.asarray(_pad(prows))),
                   JRays(*(jnp.asarray(a) for a in arrays)), active=jnp.asarray(active))


@functools.lru_cache(maxsize=None)
def case(name):
    """(scene, JAX fat, JAX packed rows) of a fixture."""
    if name == "bucket":
        scene = jproc.sphere_scene(3)
        fat, packed = jax.jit(functools.partial(jbucket.build_bucket_fat, enable_pairs=True))(
            jnp.asarray(scene.triangles))
        rows = packed.rows
    else:
        scene = jproc.random_triangle_soup(600, seed=2)
        fat, pairs, _ = jax.jit(jimplicit.build_implicit_wide_fat)(jnp.asarray(scene.triangles))
        rows = jpack_pairs(pairs).rows
    return scene, fat, rows


@pytest.mark.parametrize("name,half_dead", [("bucket", False), ("bucket", True),
                                            ("implicit", False)])
def test_trips_match_jax(name, half_dead):
    scene, jfat, jrows = case(name)
    c = jcam.camera_to_device(jcam.update_camera(jcam.initialise_camera(scene.aabb_min,
                                                                        scene.aabb_max)))
    r = jax.tree.map(lambda a: jtile(a, W, H, 16, 8), jprimary(c, W, H))
    arrays = [np.array(a) for a in (r.origin, r.direction, r.tmin, r.tmax)]
    active = (np.arange(W * H) % 2 == 0) if half_dead else None
    ref, rstats, rtrips = jax_trips(jfat.rows, jrows, arrays,
                                    np.ones(W * H, bool) if active is None else active)
    fat = convert.fat_from_numpy(np.asarray(jfat.rows), np.asarray(jfat.num_nodes), "cpu")
    rays = Rays(*(torch.from_numpy(a) for a in arrays))
    before = fat_traverse.launch_count
    rec, stats, trips = wide_fat.trace_rays_wide_fat(
        fat, PackedPairs(rows=torch.from_numpy(np.array(jrows))), rays,
        active=None if active is None else torch.from_numpy(active), with_trips=True)
    assert fat_traverse.launch_count == before
    assert trips.dtype == torch.int32 and trips.shape == (W * H // 128,)
    np.testing.assert_array_equal(trips.numpy(), np.asarray(rtrips))
    np.testing.assert_array_equal(stats.box_tests.numpy(), np.asarray(rstats.box_tests))
    np.testing.assert_array_equal(stats.tri_tests.numpy(), np.asarray(rstats.tri_tests))
    for f in ("hit", "tri_id", "prim_id"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(), np.asarray(getattr(ref, f)), f)
    np.testing.assert_array_equal(rec.t.numpy().view(np.int32), np.asarray(ref.t).view(np.int32))
    for f in ("bary_u", "bary_v"):
        np.testing.assert_allclose(getattr(rec, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-5)
    assert int(rec.hit.sum()) > 0 and int(trips.min()) > 0
    assert int(stats.overflow) == 0
    if half_dead:
        assert not rec.hit.numpy()[1::2].any()


def _f2i(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _entry(lo, hi, child, ctype):
    """One fat-row entry's 8 node words: box, meta (child, count 0, type)."""
    meta = (child << 5) | ctype
    return np.concatenate([_f2i(lo), _f2i(hi), [meta, 0]]).astype(np.int32)


def chain_rows(depth: int):
    """A fat tree whose root walks a chain of ``depth`` rows to one
    triangle at z = 0: each chain row holds the next chain row (box
    [-2, 2]^3, nearest) and 7 Box entries ([-1, 1]^3) of an empty row, so
    a packet looking down +z keeps 7 more pending subtrees a level, and
    past level 6 a push drops the farthest of them. Row 0 the root, row 1
    the empty row. Returns (rows [depth + 2, 192], pair rows [1, 16])."""
    rows = np.zeros((depth + 2, 192), np.int32)
    tri = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0], [0, 1, 0]], np.float32)
    for lv in range(depth):
        r = 0 if lv == 0 else lv + 1
        if lv == depth - 1:
            rows[r, 0:8] = _entry([-1, -1, -0.1], [1, 1, 0.1], 0, 2)
            rows[r, 64:76] = _f2i(tri.reshape(-1))
            continue
        rows[r, 0:8] = _entry([-2] * 3, [2] * 3, lv + 2, 1)
        for e in range(1, 8):
            rows[r, e * 8:e * 8 + 8] = _entry([-1] * 3, [1] * 3, 1, 1)
    pair = np.zeros((1, 16), np.int32)
    pair[0, :12] = _f2i(tri.reshape(-1))
    return rows, pair


@pytest.mark.parametrize("depth,dropped", [(6, False), (10, True)])
def test_trips_stack_drop_sets_overflow(depth, dropped):
    """The port keeps the reference's drop, so trips, counts and hits are
    the reference's; it sets ``overflow`` only when a subtree was dropped."""
    rows, pair = chain_rows(depth)
    rng = np.random.default_rng(5)
    num = W * H
    origin = np.concatenate([rng.uniform(-0.2, 0.2, (num, 2)), np.full((num, 1), -5.0)],
                            axis=1).astype(np.float32)
    direction = np.tile(np.float32([0, 0, 1]), (num, 1))
    direction[num // 2:] = [0, 0, -1]  # the second half's packets look away
    tmin, tmax = np.zeros(num, np.float32), np.full(num, 1e30, np.float32)
    ref, rstats, rtrips = jax_trips(rows, pair, (origin, direction, tmin, tmax),
                                    np.ones(num, bool))
    fat = convert.fat_from_numpy(rows, np.int32(depth + 2), "cpu")
    rays = Rays(*(torch.from_numpy(a) for a in (origin, direction, tmin, tmax)))
    rec, stats, trips = wide_fat.trace_rays_wide_fat(
        fat, PackedPairs(rows=torch.from_numpy(pair)), rays, with_trips=True)
    np.testing.assert_array_equal(trips.numpy(), np.asarray(rtrips))
    np.testing.assert_array_equal(stats.box_tests.numpy(), np.asarray(rstats.box_tests))
    np.testing.assert_array_equal(rec.hit.numpy(), np.asarray(ref.hit))
    assert rec.hit.numpy()[:num // 2].all() and not rec.hit.numpy()[num // 2:].any()
    # every row of the chain and every empty row once, less the dropped ones
    half = trips.numpy().reshape(2, -1)
    assert ((half[0] < depth + 7 * (depth - 1)) == dropped).all() and (half[1] == 1).all()
    assert int(stats.overflow) == int(dropped)


def test_without_trips_is_k6():
    """``with_trips=False`` is K6's counting instantiation (its plain
    version here): hits equal to the trips loop's, per-ray counts."""
    scene, jfat, jrows = case("bucket")
    c = jcam.camera_to_device(jcam.update_camera(jcam.initialise_camera(scene.aabb_min,
                                                                        scene.aabb_max)))
    r = jax.tree.map(lambda a: jtile(a, W, H, 16, 8), jprimary(c, W, H))
    fat = convert.fat_from_numpy(np.asarray(jfat.rows), np.asarray(jfat.num_nodes), "cpu")
    rays = Rays(*(torch.from_numpy(np.array(a)) for a in (r.origin, r.direction, r.tmin, r.tmax)))
    packed = PackedPairs(rows=torch.from_numpy(np.array(jrows)))
    rec, stats = wide_fat.trace_rays_wide_fat(fat, packed, rays)
    trec, _, _ = wide_fat.trace_rays_wide_fat(fat, packed, rays, with_trips=True)
    np.testing.assert_array_equal(rec.hit.numpy(), trec.hit.numpy())
    np.testing.assert_allclose(rec.t.numpy(), trec.t.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="packets"):
        wide_fat.trace_rays_wide_fat(fat, packed, rays, packet_size=100, with_trips=True)
