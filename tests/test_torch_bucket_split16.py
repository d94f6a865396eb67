"""The split builds' 16-wide rows and the bucket-major v1 build in the
PyTorch port against the JAX reference: ``emit_split(inner_width=16)``
and ``build_bucket_split_v1`` at widths 8 and 16, each bit-equal to the
reference's (float32 compared as int32 words), and v1 equal to the port's
``build_bucket_split`` (the reference's docstring: both emit the same
``SplitBVH``). Fixtures as ``tests/test_torch_bucket_builds.py``: cornell,
sphere(3), soup(2000) and terrain(2000) padded to 2,048 triangles, so one
XLA compile per build, width and pairs flag serves all four.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import bucket as jbucket  # noqa: E402
from tpu_raytracing_torch.bvh import bucket  # noqa: E402

from test_torch_bucket_builds import SCENES, padded, same  # noqa: E402

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _jsplit16(pairs):
    return jax.jit(lambda t: jbucket.emit_split(jbucket.split_front(t, pairs), leaf_width=16,
                                                inner_width=16))


@functools.lru_cache(maxsize=None)
def _jv1(pairs, width):
    return jax.jit(lambda t: jbucket.build_bucket_split_v1(t, pairs, leaf_width=16,
                                                           inner_width=width))


def _run(fn, name):
    """A jitted reference build on a padded scene (one XLA compile serves
    all four), as numpy."""
    return jax.tree.map(np.asarray, fn(jnp.asarray(padded(name))))


@pytest.mark.parametrize("pairs", [False, True], ids=["pairs_off", "pairs_on"])
@pytest.mark.parametrize("name", list(SCENES))
def test_emit_split16_matches_jax(name, pairs):
    jsplit, jpacked = _run(_jsplit16(pairs), name)
    split, packed = bucket.emit_split(bucket.split_front(torch.from_numpy(padded(name)), pairs),
                                      leaf_width=16, inner_width=16, debug=True)
    assert split.inner.shape[1] == 16 * 8
    for f in ("inner", "num_inner", "num_leaves", "e_ranges", "max_slot"):
        same(getattr(jsplit, f), getattr(split, f), f)
    same(jpacked.rows, packed.rows, "pairs")
    bucket.check_split_capacity(split, padded(name).shape[0])


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("pairs", [False, True], ids=["pairs_off", "pairs_on"])
@pytest.mark.parametrize("name", list(SCENES))
def test_v1_matches_jax_and_split(name, pairs, width):
    jsplit, jpacked = _run(_jv1(pairs, width), name)
    tris = torch.from_numpy(padded(name))
    v1, packed = bucket.build_bucket_split_v1(tris, pairs, leaf_width=16, inner_width=width)
    for f in ("inner", "num_inner", "num_leaves"):
        same(getattr(jsplit, f), getattr(v1, f), f)
    same(jpacked.rows, packed.rows, "pairs")
    assert v1.e_ranges is None
    split, spacked = bucket.build_bucket_split(tris, pairs, leaf_width=16, inner_width=width)
    for f in ("inner", "num_inner", "num_leaves"):
        assert torch.equal(getattr(v1, f), getattr(split, f)), f
    assert torch.equal(packed.rows, spacked.rows)
