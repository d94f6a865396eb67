"""The harness's own inputs and reference agree with the program's
generators, so both sides are handed the scene the configurations name."""

import numpy as np
import torch

from rtbench import reference


def test_terrain_is_the_programs_terrain():
    """The program's terrain with each triangle wound the other way: the
    same vertices, every flat normal facing up, the pairs' shared
    diagonals kept."""
    from tpu_raytracing_torch.scene import procedural

    for seed in (0, 2**31 + 5):
        mine = reference.terrain_triangles(2000, 100.0, 8.0, seed)
        theirs = procedural.terrain(2000, seed=seed)
        np.testing.assert_array_equal(mine, theirs.triangles[:, [0, 2, 1]])
        normals = reference.flat_normals(torch.as_tensor(mine)).numpy()
        np.testing.assert_allclose(normals, -theirs.normals[:, 0], atol=1e-6)
        assert (normals[:, 1] > 0).all()


def test_wobble_is_the_programs_animation():
    from tpu_raytracing_torch.scene import procedural

    tris = torch.as_tensor(reference.terrain_triangles(2000, 100.0, 8.0, 3))
    for t in (0.0, 0.1, 6.3):
        assert torch.equal(reference.wobble(tris, t), procedural.animate_triangles(tris, t))


def test_brute_force_closest_and_any_hit():
    tri = torch.tensor([[[0.0, 0.0, 5.0], [1.0, 0.0, 5.0], [0.0, 1.0, 5.0]],
                        [[0.0, 0.0, 2.0], [1.0, 0.0, 2.0], [0.0, 1.0, 2.0]]])
    caster = reference.Caster(tri)
    o = torch.tensor([[0.2, 0.2, 0.0], [0.9, 0.9, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    tmin = torch.full((2,), 1e-5)
    hit, t, idx, _, _ = caster.closest(o, d, tmin, torch.full((2,), 10.0))
    assert hit.tolist() == [True, False] and idx[0] == 1 and abs(float(t[0]) - 2.0) < 1e-6
    occ = caster.occluded(o, d, tmin, torch.full((2,), 1.5))
    assert occ.tolist() == [False, False]
