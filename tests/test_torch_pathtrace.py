"""PyTorch port's path tracer vs the JAX reference.

jax.random and torch draw different numbers, so the bounce stage is held to
the reference with the same ``u_frame`` injected into both, and the whole
frame at ``num_bounces=0`` (primary + NEE, deterministic), or at one bounce
with the reference's uniforms fed to the port in place of ``torch.rand``.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import lbvh as jlbvh  # noqa: E402
from tpu_raytracing.bvh.pairing import identity_pairs  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.scene.types import scene_to_device as jscene_to_device  # noqa: E402
from tpu_raytracing.trace import pathtrace as jpt  # noqa: E402
from tpu_raytracing.trace.brute import HitRecord as JHitRecord  # noqa: E402
from tpu_raytracing.trace.brute import brute_force_trace as jbrute  # noqa: E402
from tpu_raytracing.trace.ray import Rays as JRays  # noqa: E402
from tpu_raytracing.trace.traverse import PackedPairs as JPackedPairs  # noqa: E402
from tpu_raytracing.trace.traverse import TraceStats as JTraceStats  # noqa: E402
from tpu_raytracing.trace.traverse import pack_bvh as jpack_bvh  # noqa: E402
from tpu_raytracing.trace.traverse import pack_pairs as jpack_pairs  # noqa: E402
from tpu_raytracing_torch.bvh import bucket, lbvh, treelet, wide  # noqa: E402
from tpu_raytracing_torch.ops import fat_traverse  # noqa: E402
from tpu_raytracing_torch.scene import camera as tcam  # noqa: E402
from tpu_raytracing_torch.scene import procedural as tproc  # noqa: E402
from tpu_raytracing_torch.scene.types import scene_to_device  # noqa: E402
from tpu_raytracing_torch.trace import pathtrace as tpt  # noqa: E402
from tpu_raytracing_torch.trace import split_trace as st  # noqa: E402
from tpu_raytracing_torch.trace.render import _shadow_rays  # noqa: E402
from tpu_raytracing_torch.trace.traverse import pack_bvh, pack_pairs  # noqa: E402
from tpu_raytracing_torch.trace.ray import generate_primary_rays  # noqa: E402

torch.set_num_threads(2)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 32, 32


@pytest.fixture(scope="module")
def cornell_state():
    """Port-side cornell tree, scene, camera and a traced primary pass."""
    scene = tproc.cornell_box()
    views, packed, _ = bucket.emit_split_views(
        bucket.split_front(torch.from_numpy(scene.triangles), True), leaf_width=st.LEAFW)
    host_cam = tcam.update_camera(tcam.initialise_camera(scene.aabb_min, scene.aabb_max))
    camera = tcam.camera_to_device(host_cam, "cpu")
    tscene = scene_to_device(scene, "cpu")
    rays = generate_primary_rays(camera, W, H)
    rec, _ = st.trace_rays_split(views, packed, rays)
    srec, _ = st.trace_rays_split(views, packed, _shadow_rays(tscene, rays, rec), any_hit=True)
    return dict(scene=scene, views=views, packed=packed, camera=camera, host_cam=host_cam,
                tscene=tscene, rays=rays, rec=rec, srec_hit=srec.hit)


def _jax_rays(r):
    return JRays(*(jnp.asarray(getattr(r, f).numpy()) for f in ("origin", "direction", "tmin",
                                                                 "tmax")))


def _jax_rec(rec):
    return JHitRecord(*(jnp.asarray(getattr(rec, f).numpy()) for f in (
        "hit", "t", "prim_id", "tri_id", "bary_u", "bary_v")))


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("sort_kind,sample_next", [("leaf", True), ("cell", True),
                                                   ("leaf", False), ("tid", True),
                                                   ("tid_cell", True)])
def test_bounce_stage_matches_jax(cornell_state, sort_kind, sample_next):
    rng = np.random.default_rng(103)  # its own: the shared rng fixture depends on file order
    s = cornell_state
    num = W * H
    # the tid kinds read a treelet id per pair; ids above 0xFFF check that
    # tid_cell keeps 12 bits of it
    pair_loc = rng.integers(0, 5000, s["packed"].rows.shape[0]).astype(np.int32)
    throughput = rng.uniform(0.2, 1.0, (num, 3)).astype(np.float32)
    radiance = rng.uniform(0.0, 0.5, (num, 3)).astype(np.float32)
    alive = rng.random(num) < 0.8
    pixel = rng.permutation(num).astype(np.int32)
    u_frame = rng.random((num, 2)).astype(np.float32)
    max_t = np.float32(s["host_cam"].max_depth)
    srec_hit = s["srec_hit"].numpy()

    ref = jpt._bounce_stage(
        jscene_to_device(s["scene"]), JPackedPairs(rows=jnp.asarray(s["packed"].rows.numpy())),
        _jax_rays(s["rays"]), _jax_rec(s["rec"]), jnp.asarray(srec_hit),
        jnp.asarray(throughput), jnp.asarray(radiance), jnp.asarray(alive),
        jnp.asarray(pixel), jnp.asarray(u_frame), jnp.float32(max_t), jnp.asarray(pair_loc),
        compaction=True, sort_cells=True, sample_next=sample_next, sort_kind=sort_kind)
    out = tpt._bounce_stage(
        s["tscene"], s["packed"], s["rays"], s["rec"], torch.from_numpy(srec_hit),
        torch.from_numpy(throughput), torch.from_numpy(radiance), torch.from_numpy(alive),
        torch.from_numpy(pixel).to(torch.int64), torch.from_numpy(u_frame),
        torch.tensor(max_t), pair_loc=torch.from_numpy(pair_loc), sample_next=sample_next,
        sort_kind=sort_kind)
    j_rad, j_thr, j_alive, j_pix, j_rays = ref
    t_rad, t_thr, t_alive, t_pix, t_rays = out
    np.testing.assert_array_equal(np.asarray(j_alive), t_alive.numpy())
    np.testing.assert_array_equal(np.asarray(j_pix), t_pix.numpy())
    _close(j_rad, t_rad, "radiance")
    _close(j_thr, t_thr, "throughput")
    for f in ("origin", "direction", "tmin", "tmax"):
        _close(getattr(j_rays, f), getattr(t_rays, f), f)


def test_shadow_pair_matches_jax(cornell_state):
    rng = np.random.default_rng(104)  # its own: the shared rng fixture depends on file order
    s = cornell_state
    alive = rng.random(W * H) < 0.7
    jr, ja, jinv = jpt._jit_shadow_pair(jscene_to_device(s["scene"]), _jax_rays(s["rays"]),
                                        _jax_rec(s["rec"]), jnp.asarray(alive))
    tr, ta, tinv = tpt._shadow_pair(s["tscene"], s["rays"], s["rec"], torch.from_numpy(alive))
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jinv), tinv.numpy())
    for f in ("origin", "direction", "tmin", "tmax"):
        _close(getattr(jr, f), getattr(tr, f), f)


def _psnr(a, b):
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def test_path_trace_zero_bounces_psnr(cornell_state):
    """Primary + NEE frame against the reference renderer with its
    brute-force oracle as tracer (identity pairs)."""
    s = cornell_state
    jtris = jnp.asarray(s["scene"].triangles)

    def brute_tracer(trav, pairs, rays, active=None):
        rec = jbrute(jtris, rays)
        if active is not None:
            rec = rec.replace(hit=rec.hit & active)
        zeros = jnp.zeros_like(rec.prim_id)
        return rec, JTraceStats(box_tests=zeros, tri_tests=zeros)

    ref_img, ref_rays = jpt.path_trace(
        None, jpack_pairs(identity_pairs(jtris)), jscene_to_device(s["scene"]),
        jcam.camera_to_device(s["host_cam"]), W, H, num_bounces=0,
        key=jax.random.PRNGKey(0), tracer=brute_tracer)
    img, rays_traced = tpt.path_trace(s["views"], s["packed"], s["tscene"], s["camera"], W, H,
                                      num_bounces=0, **st.make_frame_tracers(W, H))
    assert int(rays_traced) == int(ref_rays)
    assert _psnr(np.asarray(ref_img), img.numpy()) >= 40.0


@pytest.fixture(scope="module")
def binary_reference(cornell_state):
    """The reference frame at one bounce with its default (scalar) tracer
    over the JAX Karras tree, and the uniforms it drew per bounce."""
    s = cornell_state
    jb, jp = jax.jit(jlbvh.build_lbvh, static_argnames="enable_pairs")(
        jnp.asarray(s["scene"].triangles), enable_pairs=True)
    img, rays_traced = jpt.path_trace(jpack_bvh(jb), jpack_pairs(jp), jscene_to_device(s["scene"]),
                                      jcam.camera_to_device(s["host_cam"]), W, H, num_bounces=1,
                                      key=jax.random.PRNGKey(0))
    key, uniforms = jax.random.PRNGKey(0), []
    for _ in range(2):  # pathtrace.py: one split and one draw per bounce
        key, k_dir = jax.random.split(key)
        uniforms.append(np.asarray(jax.random.uniform(k_dir, (W * H, 2))))
    return np.asarray(img), int(rays_traced), uniforms


@pytest.mark.parametrize("tracer", ["default", "fat"])
def test_path_trace_binary_tracers_match_jax(cornell_state, binary_reference, monkeypatch,
                                             tracer):
    """The port's Karras tree traced by the default tracer (trace_rays) or
    by make_fat_tracer on every pass, against the reference's frame."""
    s = cornell_state
    ref_img, ref_rays, uniforms = binary_reference
    bvh, tp = lbvh.build_lbvh(torch.from_numpy(s["scene"].triangles), True)
    packed = pack_pairs(tp)
    draws = iter(uniforms)
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.from_numpy(np.array(next(draws))))
    if tracer == "default":
        img, rays_traced = tpt.path_trace(pack_bvh(bvh), packed, s["tscene"], s["camera"], W, H,
                                          num_bounces=1)
    else:
        rows = fat_traverse.pad_rows_256(wide.build_wide_fat(bvh, packed.rows).rows)
        before = fat_traverse.launch_count
        img, rays_traced = tpt.path_trace(rows, packed, s["tscene"], s["camera"], W, H,
                                          num_bounces=1,
                                          tracer=fat_traverse.make_fat_tracer(None, W, H))
        assert fat_traverse.launch_count == before  # CPU: the plain version
    assert int(rays_traced) == ref_rays
    assert _psnr(ref_img, img.numpy()) >= 40.0


def test_path_trace_bounce_frame_and_overflow(cornell_state):
    s = cornell_state
    args = (s["views"], s["packed"], s["tscene"], s["camera"], 24, 10)
    img, rays_traced = tpt.path_trace(*args, num_bounces=1, **st.make_frame_tracers(24, 10))
    assert img.shape == (10, 24, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0.0 and int(rays_traced) > 240
    cell, _ = tpt.path_trace(*args, num_bounces=1, sort_kind="cell",
                             **st.make_frame_tracers(24, 10))
    # the bounce order changes, the image (keyed by pixel) does not
    np.testing.assert_allclose(cell.numpy(), img.numpy(), rtol=1e-5, atol=1e-6)
    # the cornell tree is one row; the sphere's root row pushes several
    sphere = tproc.sphere_scene(3)
    sviews, spacked, _ = bucket.emit_split_views(
        bucket.split_front(torch.from_numpy(sphere.triangles), True), leaf_width=st.LEAFW)
    scam = tcam.camera_to_device(
        tcam.update_camera(tcam.initialise_camera(sphere.aabb_min, sphere.aabb_max)), "cpu")
    with pytest.raises(RuntimeError, match="stack overflow"):
        tpt.path_trace((*sviews[:2], 1), spacked, scene_to_device(sphere, "cpu"), scam, 24, 10,
                       num_bounces=1, tracer=st.make_split_tracer(24, 10))
    # the tid sort needs a treelet id per pair; with one, the image stands
    with pytest.raises(ValueError, match="needs pair_loc"):
        tpt.path_trace(*args, num_bounces=1, sort_kind="tid", **st.make_frame_tracers(24, 10))
    pair_loc = treelet.build_pair_tid(bucket.split_front(torch.from_numpy(s["scene"].triangles),
                                                         True))
    tid, _ = tpt.path_trace(*args, num_bounces=1, pair_loc=pair_loc,
                            **st.make_frame_tracers(24, 10))
    np.testing.assert_allclose(tid.numpy(), img.numpy(), rtol=1e-5, atol=1e-6)


def test_app_renders_and_refuses_unported_flags(tmp_path):
    from tpu_raytracing_torch.app import main as app
    from tpu_raytracing_torch.utils.png import read_png

    app.main(["--scene", "cornell", "--type", "bottom-up", "--pairs", "--tracer", "split",
              "--bounces", "1", "--width", "24", "--height", "10", "--device", "cpu",
              "--debug-checks", "--output", str(tmp_path)])
    img = read_png(str(tmp_path / "frame0000_pt.png"))
    assert img.shape == (10, 24, 4) and img[..., :3].max() > 0
    # the flags the app once refused now render
    assert not hasattr(app, "_require_ported")
    for extra in (["--tracer", "packet"], ["--tracer", "grid"],
                  ["--tracer", "grid", "--grid-scale", "2"]):
        out = tmp_path / extra[-1]
        argv = ["--scene", "cornell", "--type", "bottom-up", "--tracer", "split", "--bounces",
                "1", "--width", "16", "--height", "8", "--device", "cpu",
                "--output", str(out)] + extra
        app.main(argv)
        img = read_png(str(out / "frame0000_pt.png"))
        assert img.shape == (8, 16, 4) and img[..., :3].max() > 0


@pytest.mark.parametrize("build_type,tracer", [
    ("bottom-up", "scalar"), ("bottom-up", "split"), ("bottom-up", "lane"),
    ("sah", "scalar"), ("sah", "split"), ("sah", "lane")],
    ids=["scalar", "split", "lane", "sah-scalar", "sah-split", "sah-lane"])
def test_app_prints_hierarchy_stats(tmp_path, capsys, build_type, tracer):
    """Frame 0 builds the ``--type`` tree (Karras or binned SAH) for every
    tracer and prints the reference app's block
    (tpu_raytracing/app/main.py:223-234)."""
    from tpu_raytracing.bvh import sah as jsah
    from tpu_raytracing.bvh import verify as jverify
    from tpu_raytracing_torch.app import main as app

    app.main(["--scene", "cornell", "--type", build_type, "--tracer", tracer, "--bounces", "1",
              "--width", "16", "--height", "8", "--device", "cpu", "--output", str(tmp_path)])
    out = capsys.readouterr()
    build = jsah.build_sah if build_type == "sah" else jlbvh.build_lbvh
    jb, _ = jax.jit(build)(jnp.asarray(tproc.cornell_box().triangles))
    ref = jverify.count_nodes(jb)
    assert (f"Hierarchy stats\n  num nodes:      {ref.num_nodes}\n"
            f"  num tree nodes: {ref.num_tree_nodes}\n"
            f"  num leaf nodes: {ref.num_leaf_nodes}\n") in out.out
    assert "Error: Invalid hierarchy" not in out.err
    assert (tmp_path / "frame0000_pt.png").is_file()


def test_port_imports_and_renders_without_jax(tmp_path):
    """In a process where jax and flax cannot be imported, every port
    module imports and the app renders a tiny frame."""
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import tpu_raytracing_torch
        names = [m.name for m in pkgutil.walk_packages(
            tpu_raytracing_torch.__path__, "tpu_raytracing_torch.")]
        for name in names:
            importlib.import_module(name)
        assert not any(k.startswith("tpu_raytracing.") for k in sys.modules)
        from tpu_raytracing_torch.app.main import main
        for build_type, tracer in (("bottom-up", "split"), ("bottom-up", "lane"),
                                   ("sah", "split")):
            main(["--scene", "cornell", "--type", build_type, "--pairs", "--tracer", tracer,
                  "--bounces", "1", "--width", "16", "--height", "16", "--device", "cpu",
                  "--output", {str(tmp_path)!r} + "/" + build_type + "-" + tracer])
        print("modules", len(names))
    """)
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=str(tmp_path), env=env, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "modules" in proc.stdout
    from tpu_raytracing_torch.utils.png import read_png
    split, lane, sah = (read_png(str(tmp_path / t / "frame0000_pt.png"))
                        for t in ("bottom-up-split", "bottom-up-lane", "sah-split"))
    # the tracers find the same closest hits, and the bounce samples are
    # drawn per pixel, so the frames agree
    assert split.shape == (16, 16, 4) and split[..., :3].max() > 0
    np.testing.assert_array_equal(lane, split)
    np.testing.assert_array_equal(sah, split)
