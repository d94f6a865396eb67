"""PyTorch port vs JAX reference: procedural scenes, camera, device scene.

Inputs are the same numpy arrays for both packages; the port must be
byte-equal where it copies numpy code and float-close where it recomputes
with torch.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.scene import procedural as jproc  # noqa: E402
from tpu_raytracing.scene.types import scene_to_device as jscene_to_device  # noqa: E402
from tpu_raytracing.trace.ray import generate_primary_rays as jrays  # noqa: E402
from tpu_raytracing_torch import convert  # noqa: E402
from tpu_raytracing_torch.scene import camera as tcam  # noqa: E402
from tpu_raytracing_torch.scene import procedural as tproc  # noqa: E402
from tpu_raytracing_torch.scene.types import scene_to_device as tscene_to_device  # noqa: E402
from tpu_raytracing_torch.trace.ray import generate_primary_rays as trays  # noqa: E402

torch.set_num_threads(2)

_SCENES = {
    "cornell": lambda m: m.cornell_box(),
    "sphere": lambda m: m.sphere_scene(3),
    "soup": lambda m: m.random_triangle_soup(2000, seed=1),
    "terrain": lambda m: m.terrain(8000),
}


def _as_numpy(obj):
    """A flax/port dataclass tree as nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _as_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    return np.asarray(obj)


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)
        assert a.dtype == b.dtype or a.ndim == 0, path


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_procedural_byte_equal(name):
    ref = _SCENES[name](jproc)
    out = _SCENES[name](tproc)
    for field in ("triangles", "normals", "uvs", "material_ids", "aabb_min", "aabb_max",
                  "light"):
        a, b = getattr(ref, field), getattr(out, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field
    assert [m.name for m in ref.library.materials] == [m.name for m in out.library.materials]


def test_scene_to_device_matches(cornell):
    ref = _as_numpy(jscene_to_device(cornell))
    port_scene = tproc.cornell_box()
    out = _as_numpy(tscene_to_device(port_scene, "cpu"))
    _assert_tree_equal(ref, out)
    # convert.scene_from_numpy carries the JAX structure across unchanged
    _assert_tree_equal(ref, _as_numpy(convert.scene_from_numpy(ref, "cpu")))


@pytest.mark.parametrize("pitch,yaw", [(0.0, 1.5707963), (0.7, 0.0), (-0.4, 2.5)])
def test_camera_and_primary_rays(cornell, pitch, yaw):
    jc = jcam.initialise_camera(cornell.aabb_min, cornell.aabb_max)
    tc = tcam.initialise_camera(cornell.aabb_min, cornell.aabb_max)
    for c in (jc, tc):
        c.pitch, c.yaw = pitch, yaw
        c.position = c.position + np.float32(0.1)
    jc, tc = jcam.update_camera(jc), tcam.update_camera(tc)
    for field in ("position", "w", "u", "v"):
        np.testing.assert_array_equal(getattr(jc, field), getattr(tc, field))
    assert (jc.max_depth, jc.scale) == (tc.max_depth, tc.scale)

    jd = jcam.camera_to_device(jc)
    td = tcam.camera_to_device(tc, "cpu")
    for k in jd:
        np.testing.assert_array_equal(np.asarray(jd[k]), td[k].numpy(), err_msg=k)
    ref = jrays(jd, 24, 10)
    out = trays(td, 24, 10)
    np.testing.assert_array_equal(np.asarray(ref.origin), out.origin.numpy())
    np.testing.assert_allclose(np.asarray(ref.direction), out.direction.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(ref.tmin), out.tmin.numpy())
    np.testing.assert_array_equal(np.asarray(ref.tmax), out.tmax.numpy())


def test_tile_helpers_match(rng):
    from tpu_raytracing.trace import packet as jp
    from tpu_raytracing_torch.trace import packet as tp

    a = rng.random((24 * 10, 3)).astype(np.float32)
    jperm, jinv = jp.tile_permutation(32, 16, 16, 8)
    tperm, tinv = tp.tile_permutation(32, 16, 16, 8)
    np.testing.assert_array_equal(np.asarray(jperm), tperm)
    np.testing.assert_array_equal(np.asarray(jinv), tinv)
    ja = jp.pad_frame(jnp.asarray(a), 24, 10, 32, 16)
    ta = tp.pad_frame(torch.from_numpy(a), 24, 10, 32, 16)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jp.pad_live_mask(24, 10, 32, 16)),
                                  tp.pad_live_mask(24, 10, 32, 16).numpy())
    np.testing.assert_array_equal(np.asarray(jp.tile_reorder(ja, 32, 16, 16, 8)),
                                  tp.tile_reorder(ta, 32, 16, 16, 8).numpy())
    back = tp.crop_frame(tp.tile_restore(tp.tile_reorder(ta, 32, 16, 16, 8), 32, 16, 16, 8),
                         24, 10, 32, 16)
    np.testing.assert_array_equal(back.numpy(), a)
