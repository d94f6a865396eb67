"""PyTorch port's render modes and shading stack vs the JAX reference.

``render_frame`` in all nine modes, with the scalar ``trace_rays`` on both
sides, on the cornell box and on a rock from ``generate_rock(subdivisions=3,
tex_size=64)`` (textured, with its own light), at 64x64. The two tracers
give the same hits and per-ray statistics (tests/test_torch_traverse.py),
so the image differences come from the shading arithmetic alone. What is
measured, per image: BOX_TESTS, TRIANGLE_TESTS and MATERIAL_ID are held bit
for bit (integer counts and exact float steps); every other mode to at
least 99% of pixels within 1 LSB in every channel and at least 40 dB PSNR,
because XLA's CPU compiler may fuse a multiply into the add that consumes
it, so a colour can differ by an ulp before its truncating cast and by one
step of 255 after (LODS, which floors a log2 and multiplies by 20, by 20 on
such a pixel). The frame's box-test total is held exactly.

The shading functions are held to the reference's on seeded inputs:
``_trunc_u8`` and the float -> int32 cast exactly, NaN, negatives and
values past the type's range included (XLA saturates them; torch leaves
them undefined); ``hsv_to_rgb``, ``sample_point`` and the texel indexing
of ``_tex_table`` exactly; the quantized bilinear and trilinear samples to
within 1 (the trunc after a float mix); LOD (its floor exactly), tangent
frames, bump normals and the Phong shader to the tolerances stated at each
check, all from ulps of the same arithmetic in another order, grown by the
function's own conditioning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.bvh import lbvh as jlbvh  # noqa: E402
from tpu_raytracing.scene import camera as jcam  # noqa: E402
from tpu_raytracing.scene import genasset as jgenasset  # noqa: E402
from tpu_raytracing.scene import objio as jobjio  # noqa: E402
from tpu_raytracing.scene import procedural as jproc  # noqa: E402
from tpu_raytracing.scene.types import scene_to_device as jscene_to_device  # noqa: E402
from tpu_raytracing.trace import render as jrender  # noqa: E402
from tpu_raytracing.trace import shade as jshade  # noqa: E402
from tpu_raytracing.trace import traverse as jtraverse  # noqa: E402
from tpu_raytracing.trace.modes import RenderType as JRenderType  # noqa: E402
from tpu_raytracing_torch.bvh import lbvh  # noqa: E402
from tpu_raytracing_torch.scene import camera as cam  # noqa: E402
from tpu_raytracing_torch.scene import objio, procedural  # noqa: E402
from tpu_raytracing_torch.scene.types import scene_to_device  # noqa: E402
from tpu_raytracing_torch.trace import render, shade, traverse  # noqa: E402
from tpu_raytracing_torch.trace.modes import RenderType  # noqa: E402
from tpu_raytracing_torch.utils.compare import pixel_match_fraction, psnr  # noqa: E402

torch.set_num_threads(2)
RES = 64
EXACT_MODES = (RenderType.BOX_TESTS, RenderType.TRIANGLE_TESTS, RenderType.MATERIAL_ID)
_jbuild = jax.jit(jlbvh.build_lbvh, static_argnames="enable_pairs")


@pytest.fixture(scope="module")
def rock_path(tmp_path_factory):
    return jgenasset.generate_rock(str(tmp_path_factory.mktemp("rock")), subdivisions=3,
                                   tex_size=64)


@pytest.fixture(scope="module")
def scenes(rock_path):
    """name -> (JAX state, port state): (trav, packed, device scene,
    camera) built from the same numpy scene."""
    out = {}
    for name, jscene, tscene in (
            ("cornell", jproc.cornell_box(), procedural.cornell_box()),
            ("rock", jobjio.load_obj(rock_path), objio.load_obj(rock_path))):
        jb, jp = _jbuild(jnp.asarray(jscene.triangles), enable_pairs=True)
        tb, tp = lbvh.build_lbvh(torch.from_numpy(tscene.triangles), True)
        jcamera = jcam.camera_to_device(
            jcam.initialise_camera(jscene.aabb_min, jscene.aabb_max))
        tcamera = cam.camera_to_device(
            cam.initialise_camera(tscene.aabb_min, tscene.aabb_max), "cpu")
        out[name] = ((jtraverse.pack_bvh(jb), jtraverse.pack_pairs(jp),
                      jscene_to_device(jscene), jcamera),
                     (traverse.pack_bvh(tb), traverse.pack_pairs(tp),
                      scene_to_device(tscene, "cpu"), tcamera))
    return out


@pytest.mark.parametrize("mode", list(RenderType)[:-1], ids=lambda m: m.name)
@pytest.mark.parametrize("name", ["cornell", "rock"])
def test_render_frame_matches_jax(name, mode, scenes):
    (jtrav, jpacked, jscene, jcamera), (trav, packed, tscene, tcamera) = scenes[name]
    ref, ref_tests = jrender.render_frame(jtrav, jpacked, jscene, jcamera, RES, RES,
                                          JRenderType(int(mode)))
    ref = np.asarray(ref)
    img, tests = render.render_frame(trav, packed, tscene, tcamera, RES, RES, mode)
    img = img.numpy()
    assert img.shape == ref.shape == (RES, RES, 4) and img.dtype == np.uint8
    assert int(tests) == int(ref_tests)
    if mode in EXACT_MODES:
        np.testing.assert_array_equal(img, ref)
    else:
        assert pixel_match_fraction(img, ref, tol=1) >= 0.99
        assert psnr(img, ref) >= 40.0
    if mode != RenderType.LODS:
        assert (img[..., 3] == 255).all()
    if mode == RenderType.DEPTH:
        assert len(np.unique(img.reshape(-1, 4), axis=0)) > 1


def test_textured_modes_read_the_texture(scenes):
    """The rock's textured modes show many texel colours where its flat
    Kd would give one."""
    _, (trav, packed, tscene, tcamera) = scenes["rock"]
    img, _ = render.render_frame(trav, packed, tscene, tcamera, RES, RES, RenderType.TEXTURE)
    assert len(np.unique(img.numpy().reshape(-1, 4), axis=0)) > 16


def test_cast_edge_cases_match_xla():
    x = np.array([np.nan, -np.inf, -1e10, -1.0, -0.5, -0.0, 0.0, 0.7, 1.0, 254.99, 255.0,
                  255.9, 256.0, 300.0, 1e10, np.inf, 2.0 ** 31, -2.0 ** 31 - 512.0,
                  2147483520.0], np.float32)
    np.testing.assert_array_equal(shade._trunc_u8(torch.from_numpy(x)).numpy(),
                                  np.asarray(jshade._trunc_u8(jnp.asarray(x))))
    np.testing.assert_array_equal(shade._to_i32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(lambda a: a.astype(jnp.int32))(x)))
    # LODS wraps int32 * 20 to uint8
    i = np.array([0, 1, 12, 13, 100, -3, 2 ** 31 - 1], np.int32)
    np.testing.assert_array_equal(
        render._u8_mod(torch.from_numpy(i) * 20).numpy(),
        np.asarray(jax.jit(lambda a: (a * 20).astype(jnp.uint8))(i)))


def test_hsv_to_rgb_matches_jax():
    rng = np.random.default_rng(11)
    h, s, v = (rng.uniform(-0.2, 1.2, 4096).astype(np.float32) for _ in range(3))
    h[:9] = np.arange(9) / 8.0
    h[9] = np.nan
    ref = np.asarray(jshade.hsv_to_rgb(*(jnp.asarray(a) for a in (h, s, v))))
    got = shade.hsv_to_rgb(*(torch.from_numpy(a) for a in (h, s, v))).numpy()
    np.testing.assert_array_equal(got[10:], ref[10:])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(shade._trunc_u8(torch.from_numpy(got)).numpy(),
                                  np.asarray(jshade._trunc_u8(jnp.asarray(ref))))


@pytest.fixture(scope="module")
def pools(rock_path):
    """The rock's texture pool (one 64x64 texture and its mips, plus a
    second, non-square one) in both packages."""
    jscene = jobjio.load_obj(rock_path)
    tscene = objio.load_obj(rock_path)
    rng = np.random.default_rng(12)
    extra = rng.integers(0, 256, (24, 40, 4), dtype=np.uint8)
    jscene.library.add_texture("extra", extra)
    tscene.library.add_texture("extra", extra)
    return jscene_to_device(jscene).textures, scene_to_device(tscene, "cpu").textures


def _sample_inputs(n=2048):
    rng = np.random.default_rng(13)
    tex = rng.integers(-1, 3, n).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    uv[:4] = [[np.nan, 0.5], [np.inf, 0.2], [0.3, -np.inf], [1.0, 1.0]]
    lod = rng.uniform(-1.0, 9.0, n).astype(np.float32)
    return tex, uv, lod


def test_texture_sampling_matches_jax(pools):
    jpool, tpool = pools
    tex, uv, lod = _sample_inputs()
    ilod = np.floor(lod).astype(np.int32)
    jt, ju, jl, jil = (jnp.asarray(a) for a in (tex, uv, lod, ilod))
    tt, tu, tl, til = (torch.from_numpy(a) for a in (tex, uv, lod, ilod))
    for a, b in zip(shade._tex_table(tpool, tt, til), jshade._tex_table(jpool, jt, jil)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(shade.sample_point(tpool, tt, tu, til).numpy(),
                                  np.asarray(jshade.sample_point(jpool, jt, ju, jil)))
    for got, ref in ((shade.bilinear_sample(tpool, tt, tu, til),
                      jshade.bilinear_sample(jpool, jt, ju, jil)),
                     (shade.trilinear_sample(tpool, tt, tu, tl),
                      jshade.trilinear_sample(jpool, jt, ju, jl))):
        got, ref = got.numpy(), np.asarray(ref)
        nan = np.isnan(ref)
        np.testing.assert_array_equal(np.isnan(got), nan)  # the NaN and inf uvs
        assert np.abs(got - ref)[~nan].max() <= 1.0
        assert (got == ref)[~nan].mean() >= 0.99


def _triangle_inputs(n=1024):
    """Rays hitting well-shaped random triangles (unit edges at 60-120
    degrees), with barycentrics inside them, from 1-5 units away."""
    rng = np.random.default_rng(14)
    v0 = rng.uniform(-1.0, 1.0, (n, 3))
    e1 = rng.normal(size=(n, 3))
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    w = np.cross(e1, rng.normal(size=(n, 3)))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    ang = rng.uniform(np.pi / 3, 2 * np.pi / 3, (n, 1))
    e2 = e1 * np.cos(ang) + np.cross(w, e1) * np.sin(ang)
    v0, v1, v2 = (x.astype(np.float32) for x in (v0, v0 + e1, v0 + e2))
    uvs3 = rng.uniform(0.0, 2.0, (n, 3, 2)).astype(np.float32)
    normals3 = rng.normal(size=(n, 3, 3)).astype(np.float32)
    normals3 /= np.linalg.norm(normals3, axis=-1, keepdims=True)
    bu = rng.uniform(0.0, 0.5, n).astype(np.float32)
    bv = rng.uniform(0.0, 0.5, n).astype(np.float32)
    p = v0 * (1 - bu - bv)[:, None] + v1 * bu[:, None] + v2 * bv[:, None]
    away = rng.normal(size=(n, 3))
    away /= np.linalg.norm(away, axis=1, keepdims=True)
    origin = (p + away * rng.uniform(1.0, 5.0, (n, 1))).astype(np.float32)
    d = p - origin
    t = np.linalg.norm(d, axis=1).astype(np.float32)
    direction = (d / t[:, None]).astype(np.float32)
    return dict(v0=v0, v1=v1, v2=v2, uvs3=uvs3, normals3=normals3, bu=bu, bv=bv,
                origin=origin, direction=direction, t=t)


def test_lod_tangents_and_bump_match_jax(pools):
    jpool, tpool = pools
    a = _triangle_inputs()
    tex = np.random.default_rng(15).integers(-1, 3, a["t"].shape[0]).astype(np.int32)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    spread = 2.0 / 64
    args = ("v0", "v1", "v2", "origin", "direction", "t")
    # the offset rays' barycentrics divide by their determinant, which a
    # grazing offset ray makes small: ulps of it reach 1e-3 relative
    for got, ref in zip(shade.ray_triangle_gradients(*(t[k] for k in args), spread),
                        jshade.ray_triangle_gradients(*(j[k] for k in args), spread)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-3, atol=1e-5)
    largs = ("v0", "v1", "v2", "uvs3", "bu", "bv", "origin", "direction", "t")
    lod = shade.compute_lod(tpool, torch.from_numpy(tex), *(t[k] for k in largs), spread)
    jlod = jshade.compute_lod(jpool, jnp.asarray(tex), *(j[k] for k in largs), spread)
    np.testing.assert_allclose(lod.numpy(), np.asarray(jlod), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.floor(lod.numpy()), np.floor(np.asarray(jlod)))
    tbn = shade.tangent_matrix(t["v0"], t["v1"], t["v2"], t["uvs3"])
    jtbn = jshade.tangent_matrix(j["v0"], j["v1"], j["v2"], j["uvs3"])
    np.testing.assert_allclose(tbn.numpy(), np.asarray(jtbn), rtol=1e-5, atol=1e-5)
    bump = shade.bump_to_normal(tpool, torch.from_numpy(tex), tbn,
                                shade.interpolate(t["uvs3"], t["bu"], t["bv"]), lod)
    jbump = jshade.bump_to_normal(jpool, jnp.asarray(tex), jtbn,
                                  jshade.interpolate(j["uvs3"], j["bu"], j["bv"]), jlod)
    # a quantized tap of the height gradient may differ by one step
    d = np.abs(bump.numpy() - np.asarray(jbump))
    assert d.max() <= 1e-2 and (d <= 1e-5).mean() >= 0.95


@pytest.mark.parametrize("textures,shadows,bump", [(False, False, False), (True, False, True),
                                                   (True, True, True)])
def test_ambient_shader_matches_jax(scenes, textures, shadows, bump):
    """The Phong shader on the rock's materials (textured) with random
    hits; the shadow mask from seeded bits."""
    (_, _, jscene, _), (_, _, tscene, _) = scenes["rock"]
    a = _triangle_inputs()
    n = a["t"].shape[0]
    rng = np.random.default_rng(16)
    mats = dict(
        mat_ambient=rng.uniform(0, 0.3, (n, 3)), mat_diffuse=rng.uniform(0, 1, (n, 3)),
        mat_specular=rng.uniform(0, 0.5, (n, 3)), mat_specular_exp=rng.uniform(0, 64, n),
        mat_texture=rng.integers(-1, 1, n), mat_bump=rng.integers(-1, 1, n),
        mat_disp=rng.integers(-1, 1, n))
    mats = {k: v.astype(np.int32 if v.dtype.kind == "i" else np.float32)
            for k, v in mats.items()}
    shadow = rng.random(n) < 0.5
    keys = ("origin", "direction", "t", "bu", "bv", "normals3", "uvs3", "v0", "v1", "v2")
    mkeys = ("mat_ambient", "mat_diffuse", "mat_specular", "mat_specular_exp", "mat_texture",
             "mat_bump", "mat_disp")
    ref = jshade.ambient_shader(jscene, *(jnp.asarray(a[k]) for k in keys),
                                *(jnp.asarray(mats[k]) for k in mkeys), 2.0 / 64, textures,
                                shadows, bump, jnp.asarray(shadow))
    got = shade.ambient_shader(tscene, *(torch.from_numpy(a[k]) for k in keys),
                               *(torch.from_numpy(mats[k]) for k in mkeys), 2.0 / 64,
                               textures, shadows, bump, torch.from_numpy(shadow))
    # colours in [0, 255]: pow(spec, exp) and the normals carry the ulps, and
    # a bump normal whose quantized tap differs moves a colour by < 1
    got, ref = got.numpy(), np.asarray(ref)
    d = np.abs(got - ref)
    assert d.max() < 1.0 and (d <= 0.05 + 2e-4 * np.abs(ref)).mean() >= 0.99
