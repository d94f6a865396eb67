"""PyTorch port's asset pipeline and app front end vs the JAX reference.

``scene/genasset.py:generate_rock`` writes the reference's bytes;
``scene/objio.py:load_obj`` (the native parser, ``scene/native_loader.py``
over the port's ``csrc/objloader.cpp``, and the Python parser) gives the
reference's scene field by field, materials, textures and every mip
included, exactly; ``utils/compare.py`` and ``utils/timing.py`` behave as
the reference's. The app runs its default path (the reference's defaults:
``--type sah --tracer wide --bounces 0 --render-mode 0``), ``--cycle-modes``
on the rock, and downgrades a frame that is not 8-divisible to the scalar
tracer with the reference's warning.
"""

import filecmp
import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.scene import genasset as jgenasset  # noqa: E402
from tpu_raytracing.scene import objio as jobjio  # noqa: E402
from tpu_raytracing.utils import compare as jcompare  # noqa: E402
from tpu_raytracing_torch.scene import genasset, native_loader, objio  # noqa: E402
from tpu_raytracing_torch.utils import compare, timing  # noqa: E402
from tpu_raytracing_torch.utils.png import read_png, write_png  # noqa: E402

torch.set_num_threads(2)
SCENE_FIELDS = ("triangles", "normals", "uvs", "material_ids", "aabb_min", "aabb_max", "light")


@pytest.mark.parametrize("kw", [dict(subdivisions=3, tex_size=64),
                                dict(subdivisions=4, seed=3, tex_size=48, name="boulder")])
def test_generate_rock_bytes_equal_reference(tmp_path, kw):
    ref = jgenasset.generate_rock(str(tmp_path / "jax"), **kw)
    got = genasset.generate_rock(str(tmp_path / "port"), **kw)
    assert os.path.basename(ref) == os.path.basename(got)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for name in names:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name, shallow=False), name
    # a second call finds the files and writes nothing
    assert genasset.generate_rock(str(tmp_path / "port"), **kw) == got


def assert_scenes_equal(got, ref):
    for f in SCENE_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    glib, rlib = got.library, ref.library
    assert glib.name_to_mat == rlib.name_to_mat
    assert len(glib.materials) == len(rlib.materials)
    for gm, rm in zip(glib.materials, rlib.materials):
        for f in ("name", "specular_exp", "texture", "bump", "disp"):
            assert getattr(gm, f) == getattr(rm, f), f
        for f in ("ambient", "diffuse", "specular"):
            np.testing.assert_array_equal(getattr(gm, f), getattr(rm, f), err_msg=f)
    assert len(glib.textures) == len(rlib.textures)
    for gt, rt in zip(glib.textures, rlib.textures):
        assert gt.max_lod == rt.max_lod and len(gt.mips) == len(rt.mips)
        for gmip, rmip in zip(gt.mips, rt.mips):
            np.testing.assert_array_equal(gmip, rmip)


def _write(path, content):
    with open(path, "w") as fp:
        fp.write(textwrap.dedent(content))
    return str(path)


@pytest.fixture
def mixed_obj(tmp_path):
    """Quads and a pentagon, negative and absolute indices, corners without
    vt or vn, an unknown usemtl, two materials with 1- and 3-component
    colours, a PNG texture, a bump map, a missing texture and a light.txt."""
    rng = np.random.default_rng(21)
    write_png(str(tmp_path / "kd.png"), rng.integers(0, 256, (20, 12, 3), dtype=np.uint8))
    write_png(str(tmp_path / "bump.png"), rng.integers(0, 256, (9, 16, 4), dtype=np.uint8))
    _write(tmp_path / "mixed.mtl", """\
        newmtl red
        Ka 0.1
        Kd 1 0 0
        Ks 0.5 0.25 0.125
        Ns 16
        map_Kd kd.png
        bump bump.png
        newmtl blue
        Kd 0 0 1
        map_Kd missing.png
        """)
    _write(tmp_path / "light.txt", "1.5 2.5 -3.5\n")
    return _write(tmp_path / "mixed.obj", """\
        # a comment
        mtllib mixed.mtl
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        v 0.5 1.5 0.25
        vt 0 0
        vt 1 0
        vt 1 1
        vt 0.25 0.75
        vn 0 0 1
        vn 0 1 0
        usemtl red
        f 1/1/1 2/2/1 3/3/1 4/4/1
        f -5/-4 -4/-3/-2 -1/-1/-1 -2 -3//2
        usemtl unknown
        f 1 3 5
        usemtl blue
        f 2//2 3//2 5//2
        """)


def python_parse(path, monkeypatch):
    """``load_obj`` forced onto the Python parser, as the reference's own
    test forces it (tests/test_native_loader.py:62-67)."""
    with monkeypatch.context() as m:
        m.setattr(objio, "_try_native_parse", lambda f: None)
        return objio.load_obj(path)


def test_load_obj_matches_reference(mixed_obj, capsys, monkeypatch):
    ref = jobjio.load_obj(mixed_obj)
    native = objio.load_obj(mixed_obj)
    assert "OBJ parser: native" in capsys.readouterr().out
    python = python_parse(mixed_obj, monkeypatch)
    out = capsys.readouterr()
    assert "OBJ parser: Python" in out.out
    assert "missing.png" in out.err and "substituting 1x1 magenta" in out.err
    for got in (native, python):
        assert_scenes_equal(got, ref)
    assert ref.num_triangles == 2 + 3 + 1 + 1
    np.testing.assert_array_equal(native.light, [1.5, 2.5, -3.5])
    assert native.material_ids.tolist() == [0, 0, 0, 0, 0, -1, 1]


def test_load_rock_matches_reference(tmp_path, monkeypatch):
    path = jgenasset.generate_rock(str(tmp_path), subdivisions=3, tex_size=64)
    ref = jobjio.load_obj(path)
    assert_scenes_equal(objio.load_obj(path), ref)
    assert_scenes_equal(python_parse(path, monkeypatch), ref)
    assert ref.num_triangles == 20 * 4 ** 3 + 2 and len(ref.library.textures) == 1


def test_native_parser_matches_reference_parser(mixed_obj, capsys):
    """The port's parser, built from its own copy of the source, gives the
    reference's native arrays; a parse failure falls back loudly."""
    from tpu_raytracing.scene import native_loader as jnative

    jnative._load_lib()
    got, ref = native_loader.parse_obj(mixed_obj), jnative.parse_obj(mixed_obj)
    for a, b in zip(got[:5], ref[:5]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[5].name_to_mat == ref[5].name_to_mat
    with pytest.raises(FileNotFoundError):
        native_loader.parse_obj(mixed_obj + ".absent")
    assert objio._try_native_parse(mixed_obj + ".absent") is None
    assert "the native parser failed (FileNotFoundError" in capsys.readouterr().out
    assert str(native_loader.SRC).endswith("tpu_raytracing_torch/csrc/objloader.cpp")


def test_texture_decode_without_pil(tmp_path, monkeypatch, capsys):
    """With PIL unavailable a PNG still decodes (utils/png.read_png), as in
    the reference; an undecodable file gives None and a warning."""
    import sys

    img = np.random.default_rng(22).integers(0, 256, (5, 7, 4), dtype=np.uint8)
    write_png(str(tmp_path / "t.png"), img)
    (tmp_path / "bad.png").write_bytes(b"not an image")
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(objio._load_image_rgba(str(tmp_path / "t.png")), img)
    assert objio._load_image_rgba(str(tmp_path / "bad.png")) is None
    assert "substituting 1x1 magenta" in capsys.readouterr().err
    assert objio._resolve_index("", 5) == -1 and objio._resolve_index("-1", 5) == 4
    assert objio._resolve_index("3", 5) == 2


def test_compare_and_timing():
    rng = np.random.default_rng(23)
    a = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-2, 3, a.shape), 0, 255).astype(np.uint8)
    assert compare.psnr(a, b) == jcompare.psnr(a, b)
    assert compare.psnr(a, a) == float("inf")
    for tol in (0, 1, 2):
        assert compare.pixel_match_fraction(a, b, tol) == jcompare.pixel_match_fraction(a, b, tol)
    timer = timing.StageTimer()
    out = timer.run("stage", lambda x: (x + 1, {"y": [x * 2]}), torch.ones(3))
    assert float(out[1]["y"][0].sum()) == 6.0
    with timer.stage("block") as st:
        st["value"] = torch.zeros(2)
    assert [n for n, _ in timer.stages] == ["stage", "block"]
    assert set(timer.totals()) == {"stage", "block"}
    fps = timing.FPSCounter()
    assert fps.tick() is not None and fps.fps_limit >= 1


def test_app_default_run(tmp_path, monkeypatch, capsys):
    """No flags but the CPU, a small frame and the output directory: the
    reference's defaults, cornell through the SAH tree, the fat collapse
    and the wide tracer, one depth image."""
    from tpu_raytracing_torch.app import main as app

    monkeypatch.chdir(tmp_path)
    res = app.main(["--device", "cpu", "--width", "32", "--height", "24"])
    out = capsys.readouterr().out
    img = read_png(str(tmp_path / "out" / "frame0000_mode0.png"))
    assert img.shape == (24, 32, 4) and (img[..., 3] == 255).all()
    assert len(np.unique(img[..., 0])) > 1
    for line in ("  type:    sah", "SharedTaskBuild      time elapsed:",
                 "WideFatCollapse      time elapsed:", "Hierarchy stats", "fps:"):
        assert line in out, line
    tests = int(out.split("Total number of box tests: ")[1].split()[0])
    assert tests > 32 * 24
    assert [f[:2] for f in res["frames"]] == [(0, 0)]


def test_app_cycle_modes_on_rock_obj(tmp_path, capsys):
    """A positional OBJ path (the rock) with --cycle-modes writes the nine
    images; the frame loop names them as the reference's."""
    from tpu_raytracing_torch.app import main as app

    path = genasset.generate_rock(str(tmp_path / "asset"), subdivisions=2, tex_size=32)
    app.main([path, "--pairs", "--cycle-modes", "--device", "cpu", "--width", "24",
              "--height", "16", "--output", str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert "OBJ parser: native" in out and "  faces:        322" in out
    assert out.count("Total number of box tests:") == 9
    images = [read_png(str(tmp_path / "out" / f"frame0000_mode{m}.png")) for m in range(9)]
    assert all(im.shape == (16, 24, 4) for im in images)
    assert len(np.unique(images[6].reshape(-1, 4), axis=0)) > 2  # textured
    assert "Wrote 9 frame(s)" in out


def test_app_downgrades_frames_not_8_divisible(tmp_path, capsys):
    """A 20x12 frame cannot tile by 8: as the reference, the wide tracer
    warns and the scalar tracer renders, to the same image the scalar
    tracer gives asked for directly."""
    from tpu_raytracing_torch.app import main as app

    app.main(["--device", "cpu", "--width", "20", "--height", "12", "--output",
              str(tmp_path / "wide")])
    err = capsys.readouterr().err
    assert "WARNING: 20x12 is not 8-divisible; downgrading --tracer wide -> scalar" in err
    app.main(["--device", "cpu", "--width", "20", "--height", "12", "--tracer", "scalar",
              "--output", str(tmp_path / "scalar")])
    assert "WARNING" not in capsys.readouterr().err
    np.testing.assert_array_equal(read_png(str(tmp_path / "wide" / "frame0000_mode0.png")),
                                  read_png(str(tmp_path / "scalar" / "frame0000_mode0.png")))
