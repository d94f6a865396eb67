"""PyTorch port's bounded spatial splits (``bvh/splits.py``) and the SAH
builds over them against the JAX reference, bit for bit on the same
inputs, and the app's ``--splits``.

The reference's clipper and cell bounds compile, on the CPU, to fused
multiply-adds; the port rounds them once too (``bvh/sah.py:_fma``), so
the clipped boxes, and the trees over them, are bit-equal.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_sah import (  # noqa: E402
    assert_app_sah,
    assert_split_equal,
    jax_sah,
    jax_sah_split,
    same,
    scene_tris,
)

from tpu_raytracing.bvh import splits as jsplits  # noqa: E402
from tpu_raytracing_torch.bvh import sah as tsah  # noqa: E402
from tpu_raytracing_torch.bvh import split_convert as tsc  # noqa: E402
from tpu_raytracing_torch.bvh import splits as tsplits  # noqa: E402
from tpu_raytracing_torch.bvh.verify import verify_hierarchy  # noqa: E402
from tpu_raytracing_torch.trace import split_trace as st  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("name,pairs", [("cornell", True), ("sphere", False), ("soup", True),
                                        ("terrain", False), ("beam", True)])
def test_setup_split_leaves_matches_jax(name, pairs):
    ref_leaves, ref_pairs = jax.jit(jsplits.setup_split_leaves, static_argnums=1)(
        jnp.asarray(scene_tris(name)), pairs)
    leaves, tpairs = tsplits.setup_split_leaves(torch.from_numpy(scene_tris(name)), pairs)
    for f in ("aabb_min", "aabb_max", "child", "count", "type", "num_leaves"):
        same(getattr(ref_leaves, f), getattr(leaves, f), f)
    for f in ("v0", "v1", "v2", "v3", "prim_id_0", "prim_id_1", "rot_0", "rot_1"):
        same(getattr(ref_pairs, f), getattr(tpairs, f), f)
    assert int(leaves.num_leaves) >= int(tsah.setup_leaves(
        torch.from_numpy(scene_tris(name)), pairs)[0].num_leaves)


def test_build_sah_with_splits_matches_jax():
    ref, _ = jax_sah("cornell", True, True)
    bvh, _ = tsah.build_sah(torch.from_numpy(scene_tris("cornell")), True, True, debug=True)
    for f in ("node_min", "node_max", "child", "count", "type", "parent"):
        same(getattr(ref, f), getattr(bvh, f), f)
    assert verify_hierarchy(bvh) == []


@pytest.mark.parametrize("name,pairs,lw", [("beam", True, 16), ("terrain", False, 64)])
def test_build_sah_split_with_splits_matches_jax(name, pairs, lw):
    jsplit, jpacked = jax_sah_split(name, pairs, lw, True)
    split, packed = tsc.build_sah_split(torch.from_numpy(scene_tris(name)), pairs, lw,
                                        enable_splits=True, debug=True)
    assert_split_equal(jsplit, jpacked, split, packed)
    tsc.check_sah_split_capacity(split)


def test_app_splits(tmp_path, capsys):
    """``--splits`` leaves the unported flags and reaches both SAH builds:
    the frame-0 tree and the split tree K1 traces."""
    from tpu_raytracing_torch.app import main as app

    app.main(["--scene", "cornell", "--type", "sah", "--pairs", "--splits", "--tracer", "split",
              "--bounces", "1", "--width", "16", "--height", "8", "--device", "cpu",
              "--output", str(tmp_path)])
    out = capsys.readouterr()
    assert "  splits:  true" in out.out
    rows = int(tsc.build_sah_split(torch.from_numpy(scene_tris("cornell")), True, st.LEAFW,
                                   enable_splits=True)[0].num_inner)
    assert_app_sah(out, jax_sah("cornell", True, True)[0], rows)
    assert (tmp_path / "frame0000_pt.png").is_file()
