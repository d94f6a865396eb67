"""The bucket-major builds of the PyTorch port against the JAX reference:
``ops/scan.py:segmented_scan``, ``bvh/bucket.py``'s ``_segment_totals``,
``_bucket_tables``, ``_bucket_aabbs`` and ``build_bucket_fat``, and the
fat tree traced by K6's plain version against the reference's
``trace_rays_wide_fat``.

Everything is bit-equal (float32 compared as int32 words). The fixtures
are cornell, sphere(3), soup(2000) and terrain(2000), each padded to 2,048
triangles with zero-area triangles at its box's low corner, so one XLA
compile per build and pairs flag serves all four (the padding is a run of
equal Morton codes, which the chunk levels split). K6's hits are held to
the reference's with hit exact, t to rtol 1e-5 and tri equal but for ties
at that t: the reference's loop and K6 round Möller-Trumbore differently,
and the terrain's 100-unit coordinates make that up to ~10 ulps (one ray
in 512 at 1.2e-6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import bucket as jbucket  # noqa: E402
from tpu_raytracing.ops.scan import segmented_scan as jscan  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.scene import procedural as jproc  # noqa: E402
from tpu_raytracing.trace import wide_fat as jwide_fat  # noqa: E402
from tpu_raytracing.trace.packet import tile_reorder as jtile  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jprimary  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import bucket  # noqa: E402
from tpu_raytracing_torch.ops.scan import segmented_scan  # noqa: E402
from tpu_raytracing_torch.trace import wide_fat  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402
from tpu_raytracing_torch.trace.traverse import PackedPairs  # noqa: E402

torch.set_num_threads(2)
N = 2048
SCENES = {
    "cornell": jproc.cornell_box,
    "sphere": lambda: jproc.sphere_scene(3),
    "soup": lambda: jproc.random_triangle_soup(2000, seed=1),
    "terrain": lambda: jproc.terrain(2000),
}


@functools.lru_cache(maxsize=None)
def scene(name):
    return SCENES[name]()


@functools.lru_cache(maxsize=None)
def padded(name) -> np.ndarray:
    """The scene's triangles and N - n zero-area ones at its low corner."""
    s = scene(name)
    pad = np.broadcast_to(s.aabb_min.astype(np.float32), (N - s.triangles.shape[0], 3, 3))
    return np.concatenate([s.triangles, pad]).astype(np.float32)


def same(ref, out, name=""):
    """Bit-equal: float32 compared as int32 words."""
    ref = np.asarray(ref)
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    if ref.dtype == np.float32:
        ref, out = ref.view(np.int32), out.astype(np.float32).view(np.int32)
    assert ref.shape == out.shape, (name, ref.shape, out.shape)
    np.testing.assert_array_equal(ref, out.astype(ref.dtype), err_msg=name)


COMBINES = {"min": (jnp.minimum, torch.minimum), "max": (jnp.maximum, torch.maximum),
            "add": (jnp.add, torch.add)}


@pytest.mark.parametrize("shape", [(37,), (64, 3)], ids=["1d", "2d"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("combine", list(COMBINES))
def test_segmented_scan_matches_jax(combine, reverse, shape):
    """Signed zeros included: the reference's interleave turns -0.0 into
    +0.0, and its add sums in the associative scan's tree order."""
    rng = np.random.default_rng(7)
    v = rng.standard_normal(shape).astype(np.float32)
    v[rng.random(shape) < 0.2] = 0.0
    v[rng.random(shape) < 0.2] = -0.0
    f = rng.random(shape[0]) < 0.3
    jc, tc = COMBINES[combine]
    ref = jax.jit(lambda a, b: jscan(a, b, jc, reverse))(v, f)
    out = segmented_scan(torch.from_numpy(v), torch.from_numpy(f), tc, reverse)
    same(ref, out)


def test_bucket_tables_and_aabbs_match_jax():
    """``_bucket_tables`` and ``_bucket_aabbs`` (over ``_segment_totals``)
    on the soup with pairs, from the same front, at the fat build's 3
    Morton bits a level."""
    tris = padded("soup")

    def jfn(t):
        codes, _, lo, hi, _, num_leaves = jbucket._sorted_leaves(t, True)
        tables = jbucket._bucket_tables(codes, num_leaves, N, bits=3)
        levels, caps, _, poss, counts, cs, cc = tables
        return tables, jbucket._bucket_aabbs(levels, caps, poss, counts, cs, cc, lo, hi, N,
                                             width=8)

    jtables, (jlos, jhis) = jax.jit(jfn)(jnp.asarray(tris))
    codes, _, lo, hi, _, num_leaves = bucket._sorted_leaves(torch.from_numpy(tris), True)
    tables = bucket._bucket_tables(codes, num_leaves, N)
    levels, caps, _, poss, counts, cs, cc = tables
    los, his = bucket._bucket_aabbs(levels, caps, poss, counts, cs, cc, lo, hi, N)
    assert caps == list(jtables[1])
    for name, i in (("levels", 0), ("bids", 2), ("poss", 3), ("counts", 4),
                    ("child_starts", 5), ("child_counts", 6)):
        for lv, (a, b) in enumerate(zip(jtables[i], tables[i])):
            same(a, b, f"{name}[{lv}]")
    for lv in range(len(los)):
        same(jlos[lv], los[lv], f"a_lo[{lv}]")
        same(jhis[lv], his[lv], f"a_hi[{lv}]")


@functools.lru_cache(maxsize=None)
def _jfat(pairs):
    """The reference's fat build, one XLA compile for every padded scene."""
    return jax.jit(functools.partial(jbucket.build_bucket_fat, enable_pairs=pairs))


@functools.lru_cache(maxsize=None)
def jax_fat(name, pairs):
    return jax.tree.map(np.asarray, _jfat(pairs)(jnp.asarray(padded(name))))


_jtrace = jax.jit(jwide_fat.trace_rays_wide_fat)


@pytest.mark.parametrize("pairs", [False, True], ids=["pairs_off", "pairs_on"])
@pytest.mark.parametrize("name", list(SCENES))
def test_build_bucket_fat_matches_jax(name, pairs):
    jfat, jpacked = jax_fat(name, pairs)
    fat, packed = bucket.build_bucket_fat(torch.from_numpy(padded(name)), pairs)
    same(jfat.rows, fat.rows, "rows")
    same(jfat.num_nodes, fat.num_nodes, "num_nodes")
    same(jpacked.rows, packed.rows, "pairs")
    assert 1 < int(fat.num_nodes) < N


@pytest.mark.parametrize("name", ["sphere", "terrain"])
def test_bucket_fat_traced_by_k6(name):
    """The reference's fat tree traced by K6's plain version (through the
    port's ``trace_rays_wide_fat``) and by the reference's
    ``trace_rays_wide_fat``, on 16 x 8 tiles of a 32 x 16 frame."""
    jfat, jpacked = jax_fat(name, True)
    s = scene(name)
    c = jcam.camera_to_device(jcam.update_camera(jcam.initialise_camera(s.aabb_min,
                                                                        s.aabb_max)))
    r = jax.tree.map(lambda a: jtile(a, 32, 16, 16, 8), jprimary(c, 32, 16))
    ref, _ = _jtrace(
        jax.tree.map(jnp.asarray, jfat), jax.tree.map(jnp.asarray, jpacked), r)
    fat = convert.fat_from_numpy(jfat.rows, jfat.num_nodes, "cpu")
    rays = Rays(*(torch.from_numpy(np.array(a)) for a in (r.origin, r.direction, r.tmin, r.tmax)))
    rec, stats = wide_fat.trace_rays_wide_fat(fat, PackedPairs(rows=torch.from_numpy(
        np.array(jpacked.rows))), rays)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(rec.hit.numpy(), hit)
    np.testing.assert_allclose(rec.t.numpy(), np.asarray(ref.t), rtol=1e-5)
    tie = np.isclose(rec.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=0)
    differ = rec.tri_id.numpy() != np.asarray(ref.tri_id)
    assert (differ & ~tie).sum() == 0 and differ.sum() <= 2
    assert hit.sum() > 0 and int(stats.overflow) == 0
