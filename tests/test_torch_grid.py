"""PyTorch port's uniform-grid build (``bvh/grid.py``) vs the JAX
reference, bit for bit in every field.

The reference's ``build_grid_from_triangles`` is ``setup_leaves``,
``pack_pairs``, the rows past the live leaves zeroed, then ``build_grid``;
its jitted ``build_grid`` is compiled once per row count here and fed the
reference's own rows, and the port's ``build_grid_from_triangles`` and
``build_grid`` are held to that. The soup has as many triangles as the
terrain, so the two scenes share that compile. Bit-equality needs what
the port's grid module does on purpose: the reciprocal-multiply XLA
makes of the division by the constant cell counts, one rounding where
XLA's CPU compiler fuses a multiply into the add that consumes it (the
cell centres and the separating-axis sums), and a stable cell-key sort. A JAX-built grid,
carried over by ``convert.grid_from_numpy``, traces in the port as the
port's own grid does. The fixtures with the cornell box's big list, an
explicit resolution and the tier overrides are in
``tests/test_torch_grid_tiers.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import grid as jgrid  # noqa: E402
from tpu_raytracing.bvh import sah as jsah  # noqa: E402
from tpu_raytracing.scene import procedural as jproc  # noqa: E402
from tpu_raytracing.trace import traverse as jtraverse  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.bvh import grid  # noqa: E402
from tpu_raytracing_torch.trace import grid_trace  # noqa: E402
from tpu_raytracing_torch.trace.ray import Rays  # noqa: E402

torch.set_num_threads(2)
FIELDS = ("cell_start", "cell_count", "refs", "big", "num_big", "overflow", "grid_min",
          "grid_max", "cell_size", "cell_word")


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_grid_equal(ref, got) -> None:
    assert tuple(ref.res) == tuple(got.res)
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(getattr(got, f).numpy()), _bits(getattr(ref, f)),
                                      err_msg=f)


def _jrows_fn(tris, enable_pairs):
    """The reference's rows of ``build_grid_from_triangles`` (grid.py:404-409)."""
    leaves, pairs = jsah.setup_leaves(tris, enable_pairs)
    rows = jtraverse.pack_pairs(pairs).rows
    iota = jnp.arange(rows.shape[0], dtype=jnp.int32)
    return jnp.where((iota < leaves.num_leaves)[:, None], rows, 0), leaves.num_leaves


_jrows = jax.jit(_jrows_fn, static_argnums=1)
_jbuild = jax.jit(jgrid.build_grid, static_argnames=("res", "k", "k2", "med_frac",
                                                      "compact_cap"))


def jax_grid(tris: np.ndarray, enable_pairs: bool, **kw):
    """(the reference's grid, its rows, its live row count) for ``tris``."""
    rows, num_live = _jrows(jnp.asarray(tris), enable_pairs)
    return _jbuild(rows, num_live, **kw), rows, num_live


# terrain(2000) has 1,922 triangles; a soup of as many gives the reference's
# build the same row count, so one compile of it serves both scenes
SOUP_TRIS = 1922


@pytest.fixture(scope="module")
def scenes():
    scenes = {"soup": jproc.random_triangle_soup(SOUP_TRIS, seed=5),
              "terrain": jproc.terrain(2000)}
    assert scenes["terrain"].num_triangles == SOUP_TRIS
    return scenes


@pytest.mark.parametrize("pairs", [False, True], ids=["pairs-off", "pairs-on"])
@pytest.mark.parametrize("name", ["soup", "terrain"])
def test_build_grid_matches_jax(name, pairs, scenes):
    scene = scenes[name]
    ref, jrows, num_live = jax_grid(scene.triangles, pairs)
    got, packed = grid.build_grid_from_triangles(torch.from_numpy(scene.triangles), pairs)
    np.testing.assert_array_equal(packed.rows.numpy(), np.asarray(jrows))
    assert_grid_equal(ref, got)
    # build_grid alone on the reference's rows
    assert_grid_equal(ref, grid.build_grid(torch.from_numpy(np.array(jrows)), int(num_live)))
    live = int(num_live)
    assert int(got.overflow) == 0 and live > 0
    grid.check_grid_capacity(got)
    # every live row is referenced by some cell or by the big list
    refd = set(got.refs[:int(got.cell_count.sum())].tolist()) | set(
        got.big[:int(got.num_big)].tolist())
    assert len(refd) == live


def test_jax_built_grid_traces_in_the_port(scenes):
    """``convert.grid_from_numpy`` carries the reference's grid over; the
    port's tracer gives the same records and counts on it as on its own."""
    scene = scenes["terrain"]
    ref, jrows, _ = jax_grid(scene.triangles, True)
    fields = {f: np.asarray(getattr(ref, f)) for f in FIELDS}
    fields["res"] = ref.res
    carried = convert.grid_from_numpy(fields, "cpu")
    own, packed = grid.build_grid_from_triangles(torch.from_numpy(scene.triangles), True)
    rng = np.random.default_rng(21)
    n = 512
    span = scene.aabb_max - scene.aabb_min
    o = (scene.aabb_min + rng.uniform(0.05, 0.95, (n, 3)) * span).astype(np.float32)
    o[:, 1] = scene.aabb_max[1] + 1.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d), torch.zeros(n), torch.full((n,), 1e6))
    for any_hit in (False, True):
        a, sa = grid_trace.trace_rays_grid(carried, convert.packed_from_numpy(jrows, "cpu"),
                                           rays, any_hit=any_hit)
        b, sb = grid_trace.trace_rays_grid(own, packed, rays, any_hit=any_hit)
        for f in ("hit", "t", "prim_id", "tri_id", "bary_u", "bary_v"):
            np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(sa.box_tests.numpy(), sb.box_tests.numpy())
        np.testing.assert_array_equal(sa.tri_tests.numpy(), sb.tri_tests.numpy())
        assert a.hit.sum() > n // 4


def test_dist_transform_matches_jax():
    """The capped L-inf distance transform, exactly, on sparse and dense
    occupancies of an anisotropic grid, and the all-empty cap."""
    rng = np.random.default_rng(4)
    fn = jax.jit(jgrid._dist_transform)
    for density in (0.0, 0.002, 0.05, 0.5):
        occ = rng.random((7, 19, 33)) < density
        np.testing.assert_array_equal(grid._dist_transform(torch.from_numpy(occ)).numpy(),
                                      np.asarray(fn(jnp.asarray(occ))))
    assert (grid._dist_transform(torch.zeros((4, 5, 6), dtype=torch.bool)) == grid.DCAP).all()


def test_host_helpers_match_jax():
    """``tier_params``, ``auto_res3``, ``_grid_res`` and ``_big_cap``."""
    for scale in (0.25, 0.5, 0.75, 1.0, 2.0):
        assert grid.tier_params(scale) == jgrid.tier_params(scale)
    for span, rows in (((100.0, 3.0, 80.0), 1_000_000), ((1.0, 1.0, 1.0), 10),
                       ((5.0, 0.0, 2.0), 4000)):
        for scale in (0.5, 1.0):
            assert grid.auto_res3(span, rows, scale) == jgrid.auto_res3(span, rows, scale)
    for rows in (1, 600, 2000, 1 << 20):
        assert grid._grid_res(rows) == jgrid._grid_res(rows)
        assert grid._big_cap(rows) == jgrid._big_cap(rows)
