"""PyTorch port's uniform-grid build vs the JAX reference on the fixtures
that reach its other tiers and options, bit for bit in every field: the
cornell box (whose walls and floor join the big list), an explicit
resolution (``res=8``) on a five-triangle soup, and a per-axis resolution
with ``compact_cap`` and ``tier_params(0.5)`` overrides (the finer cells of
``--grid-scale 0.5``) on terrain(2000). Each needs its own compile of the
reference's build, which is most of this file's time.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_grid import assert_grid_equal, jax_grid  # noqa: E402
from tpu_raytracing.bvh import grid as jgrid  # noqa: E402
from tpu_raytracing.scene import procedural as jproc  # noqa: E402
from tpu_raytracing_torch.bvh import grid  # noqa: E402

torch.set_num_threads(2)

CASES = {
    "cornell-big-list": (lambda: jproc.cornell_box(), False, {}),
    "soup5-res8": (lambda: jproc.random_triangle_soup(5, seed=5), False, dict(res=8)),
    "terrain-res3-tiers": (lambda: jproc.terrain(2000), True,
                           dict(res=(16, 8, 16), compact_cap=5000, **jgrid.tier_params(0.5))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_grid_matches_jax(case):
    make, pairs, kw = CASES[case]
    scene = make()
    ref, jrows, _ = jax_grid(scene.triangles, pairs, **kw)
    got, packed = grid.build_grid_from_triangles(torch.from_numpy(scene.triangles), pairs, **kw)
    np.testing.assert_array_equal(packed.rows.numpy(), np.asarray(jrows))
    assert_grid_equal(ref, got)
    grid.check_grid_capacity(got)
    if case == "cornell-big-list":
        assert int(got.num_big) > 0
    if case == "terrain-res3-tiers":
        assert got.res == (16, 8, 16) and got.refs.shape[0] == 5000
