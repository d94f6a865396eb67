"""The port's multi-device renderers (``tpu_raytracing_torch/parallel``)
on spawned gloo worlds of 2 and 4 CPU ranks.

One world of each size runs every sharded function on the legs of
``__graft_entry__.dryrun_multichip`` at its shapes (soup(512), 32 x 32
pixels, 4 instances), plus ``render_frame_auto_sharded`` and
``trace_instanced_sharded``, in ``tests/torch_parallel_worker.py``; each
rank saves what it returned. The parent holds:

* every rank of both worlds bit-equal to a world of one run in this
  process (images, counters, hit records); the instanced split tracer's
  guard is the bands' maximum instead;
* the legs whose reference is XLA to JAX's sharded functions (each
  jitted once: run op by op, the lit frame compiles for minutes), the
  port's structures handed to the reference: ``render_frame_sharded``
  lit and in DEPTH on a mesh of 2, bit for bit with the box tests equal,
  ``path_trace_sharded(tracer_kind="grid")`` on a mesh of 4 with the
  reference's uniforms to 40 dB with rays traced equal, and
  ``trace_instanced_sharded`` on a mesh of 2 with hits and instances
  equal and t to rtol 1e-6;
* the K1 legs to the port's single-device functions, which the earlier
  port tests hold to JAX: ``render_frame_sharded_split`` and
  ``trace_instanced_split_sharded`` bit for bit, the split
  ``path_trace_sharded`` to 40 dB. JAX's sharded split-Pallas functions
  are not called (interpret mode on a mesh takes minutes).
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import grid as jgrid  # noqa: E402
from tpu_raytracing.bvh.tlas import build_instanced as jbuild_instanced  # noqa: E402
from tpu_raytracing.bvh.types import BVH as JBVH  # noqa: E402
from tpu_raytracing.parallel import flagship as jflagship  # noqa: E402
from tpu_raytracing.parallel import render as jrender  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.scene import procedural as jproc  # noqa: E402
from tpu_raytracing.scene.types import scene_to_device as jscene_to_device  # noqa: E402
from tpu_raytracing.trace.modes import RenderType as JRenderType  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing.trace.traverse import PackedPairs as JPackedPairs  # noqa: E402
from tpu_raytracing.trace.traverse import pack_bvh as jpack_bvh  # noqa: E402
from tpu_raytracing_torch.bvh import lbvh as tlbvh  # noqa: E402
from tpu_raytracing_torch.parallel.render import Mesh  # noqa: E402
from tpu_raytracing_torch.trace import pathtrace, render, split_trace  # noqa: E402
from tpu_raytracing_torch.trace.instanced_split import trace_rays_instanced_split  # noqa: E402
from tpu_raytracing_torch.utils.compare import psnr  # noqa: E402

import torch_parallel_worker as worker  # noqa: E402

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
W, H = worker.W, worker.H
GRID_FIELDS = ("cell_start", "cell_count", "refs", "big", "num_big", "overflow", "grid_min",
               "grid_max", "cell_size", "cell_word")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs (the dryrun's animated soup, the reference's bounce
    uniforms for key 0), a world of one in this process, and every rank's
    results from one world of 2 and one of 4, spawned together."""
    tmp = tmp_path_factory.mktemp("parallel")
    scene = jproc.random_triangle_soup(512, seed=3)
    triangles = np.asarray(jproc.animate_triangles(scene.triangles, time=0.5), np.float32)
    key, uniforms = jax.random.PRNGKey(0), []
    for _ in range(2):  # flagship.py: one split and one draw a bounce
        key, k_dir = jax.random.split(key)
        uniforms.append(np.asarray(jax.random.uniform(k_dir, (W * H, 2))))
    inputs = tmp / "inputs.npz"
    np.savez(inputs, triangles=triangles, u0=uniforms[0], u1=uniforms[1])
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = []
    for world in WORLDS:
        out = tmp / f"world{world}"
        out.mkdir()
        port = _free_port()
        procs += [(world, subprocess.Popen(
            [sys.executable, str(Path(__file__).with_name("torch_parallel_worker.py")),
             str(rank), str(world), str(port), str(inputs), str(out)],
            env=env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            for rank in range(world)]
    one = worker.run_legs(Mesh(rank=0, size=1, device=torch.device("cpu")), triangles, uniforms)
    for world, p in procs:
        log, _ = p.communicate(timeout=240)
        assert p.returncode == 0, f"world {world}: {log.decode()[-3000:]}"
    ranks = {world: [torch.load(tmp / f"world{world}" / f"rank{r}.pt", weights_only=False)
                     for r in range(world)] for world in WORLDS}
    return dict(scene=scene, triangles=triangles, uniforms=uniforms, one=one, ranks=ranks)


def _flat(x):
    """Every tensor in a result (tuples and dataclasses walked in order)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return [t for v in vars(x).values() for t in _flat(v)]


LEGS = ("megakernel", "auto", "split_render", "split_path", "grid_path", "inst_split", "inst")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("leg", LEGS)
def test_every_rank_bit_equal_to_a_world_of_one(case, world, leg):
    """The guard of the instanced split tracer is the bands' maximum, not
    the world's: ``test_instanced_split_guard_is_the_band_maximum``."""
    ref = _flat(case["one"][leg][:3] if leg == "inst_split" else case["one"][leg])
    for rank, res in enumerate(case["ranks"][world]):
        got = _flat(res[leg][:3] if leg == "inst_split" else res[leg])
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape, (rank, leg)
            assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b), (rank, leg)


def _jax_bvh(bvh):
    """The port's Karras tree (bit-equal to the reference's build,
    ``tests/test_torch_lbvh.py``) as the reference's ``BVH``."""
    return JBVH(**{f.name: jnp.asarray(getattr(bvh, f.name).numpy())
                   for f in dataclasses.fields(bvh)})


@pytest.fixture(scope="module")
def handed_over(case):
    """The port's structures handed to the reference (no JAX builds)."""
    s = worker.inputs(case["triangles"])
    scene = case["scene"]
    bvh, _ = tlbvh.build_lbvh(torch.from_numpy(case["triangles"]))
    g = s["grid"]
    return dict(
        s=s, scene=jscene_to_device(scene), trav=jpack_bvh(_jax_bvh(bvh)),
        camera=jcam.camera_to_device(jcam.initialise_camera(scene.aabb_min, scene.aabb_max)),
        pairs=JPackedPairs(rows=jnp.asarray(s["pairs"].rows.numpy())),
        packed=JPackedPairs(rows=jnp.asarray(s["packed"].rows.numpy())),
        grid=jgrid.UniformGrid(res=g.res, **{f: jnp.asarray(getattr(g, f).numpy())
                                             for f in GRID_FIELDS}),
        inst=jax.jit(jbuild_instanced)(_jax_bvh(bvh), jnp.asarray(s["inst_tf"].numpy())),
    )


def test_megakernel_matches_jax_sharded(case, handed_over):
    """``render_frame_sharded`` on a mesh of 2 against the world of 2, lit
    (TEXTURE_LIT_SHADOWS, the ``megakernel`` leg) and in DEPTH (the
    ``auto`` leg, ``render_frame_auto_sharded``), bit for bit with the box
    tests equal."""
    h = handed_over
    mesh = jrender.make_mesh(jax.devices()[:2])
    for leg, mode in (("megakernel", JRenderType.TEXTURE_LIT_SHADOWS),
                      ("auto", JRenderType.DEPTH)):
        ref, ref_tests = jax.jit(functools.partial(
            jrender.render_frame_sharded, mesh, width=W, height=H,
            render_type=mode))(h["trav"], h["pairs"], h["scene"], h["camera"])
        img, tests = case["ranks"][2][0][leg]
        np.testing.assert_array_equal(img.numpy(), np.asarray(ref), err_msg=leg)
        assert int(tests) == int(ref_tests), leg


def test_grid_path_trace_matches_jax_sharded(case, handed_over):
    """``path_trace_sharded(tracer_kind="grid")`` on a mesh of 4 against
    the world of 4, with the reference's uniforms."""
    h = handed_over
    mesh = jrender.make_mesh(jax.devices()[:4])
    ref, ref_rays = jax.jit(functools.partial(
        jflagship.path_trace_sharded, mesh, width=W, height=H, num_bounces=1, k=128,
        tracer_kind="grid"))(h["grid"], h["packed"], h["scene"], h["camera"],
                             key=jax.random.PRNGKey(0))
    img, rays = case["ranks"][4][0]["grid_path"]
    assert int(rays) == int(ref_rays)
    assert psnr(np.clip(np.asarray(ref), 0, 1), img.clamp(0, 1).numpy(), peak=1.0) >= 40.0


def test_instanced_matches_jax_sharded(case, handed_over):
    """``trace_instanced_sharded`` on a mesh of 2 against the world of 2."""
    h = handed_over
    mesh = jrender.make_mesh(jax.devices()[:2])
    r = h["s"]["inst_as_rays"]
    jrays = JRays(*(jnp.asarray(getattr(r, f).numpy())
                    for f in ("origin", "direction", "tmin", "tmax")))
    rec_r, inst_r, _ = jax.jit(functools.partial(jflagship.trace_instanced_sharded, mesh))(
        h["inst"], h["pairs"], jrays)
    rec, inst, _ = case["ranks"][2][0]["inst"]
    np.testing.assert_array_equal(rec.hit.numpy(), np.asarray(rec_r.hit))
    np.testing.assert_allclose(rec.t.numpy(), np.asarray(rec_r.t), rtol=1e-6)
    np.testing.assert_array_equal(inst.numpy(), np.asarray(inst_r))
    assert int(rec.hit.sum()) > 0


def test_k1_legs_match_single_device(case):
    one = case["one"]
    s = worker.inputs(case["triangles"])
    img, tests = render.render_frame(s["views"], s["packed"], s["scene"], s["camera"], W, H,
                                     worker.TLS, tracer=split_trace.make_split_tracer(W, H))
    sh_img, sh_tests = one["split_render"]
    assert torch.equal(sh_img, img) and int(sh_tests) == int(tests)

    ref, _ = worker.with_uniforms(case["uniforms"], pathtrace.path_trace, s["views"],
                                  s["packed"], s["scene"], s["camera"], W, H, num_bounces=1,
                                  **split_trace.make_frame_tracers(W, H))
    sh_img, rays = one["split_path"]
    assert psnr(ref.clamp(0, 1).numpy(), sh_img.clamp(0, 1).numpy(), peak=1.0) >= 40.0
    assert bool(torch.isfinite(sh_img).all()) and int(rays) > 0

    rec, inst, stats, guard = trace_rays_instanced_split(s["ias"], s["inst_rays"], k_slots=4)
    srec, sinst, sstats, sguard = one["inst_split"]
    for a, b in zip(_flat((rec, inst, stats, guard)), _flat((srec, sinst, sstats, sguard))):
        assert torch.equal(a, b)
    assert int(srec.hit.sum()) > 0


@pytest.mark.parametrize("world", WORLDS)
def test_instanced_split_guard_is_the_band_maximum(case, world):
    """Each band is checked against per-band capacities (k_slots, an
    item budget), so the guard is reduced with max: the largest overlap
    and the most live items of any band, on every rank."""
    s = worker.inputs(case["triangles"])
    rays = s["inst_rays"]
    per = rays.origin.shape[0] // world
    bands = [trace_rays_instanced_split(
        s["ias"], type(rays)(*(getattr(rays, f)[b * per:(b + 1) * per]
                               for f in ("origin", "direction", "tmin", "tmax"))),
        k_slots=4)[3] for b in range(world)]
    want = torch.stack(bands).amax(dim=0)
    for res in case["ranks"][world]:
        assert torch.equal(res["inst_split"][3], want)
    assert int(want[1]) < int(case["one"]["inst_split"][3][1])
