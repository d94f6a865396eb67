"""The PyTorch port's animated app run vs the JAX reference's app.

Both apps run in this process with the same flags on cornell, ``--animate
--frames 3``: every frame moves the geometry and rebuilds what the tracer
traces, or, with ``--tracer split --refit``, refits it on the
quality-guarded schedule. Each frame's PNG of the port must be within 40
dB PSNR of the reference's (render mode 0, which draws no random numbers),
and the schedule's printed rebuild lines must be the reference's. The split
and lane runs are 16x8, so the reference's Pallas kernels, in interpret
mode, see one packet of 128 rays a pass.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.app import main as jmain  # noqa: E402
from tpu_raytracing_torch.app import main as tmain  # noqa: E402
from tpu_raytracing_torch.utils.compare import psnr  # noqa: E402
from tpu_raytracing_torch.utils.png import read_png  # noqa: E402

torch.set_num_threads(2)
FRAMES = 3
MIN_PSNR = 40.0


@pytest.fixture(scope="module")
def pallas_interpret():
    """The reference's Pallas kernels in interpret mode, as its own tests
    run them off the TPU, with one packet slot (the reference's default
    ``C`` set to 1): a frame here is one packet, and one slot keeps
    interpret mode short, as the other port tests' ``c_slots=1`` does."""
    import functools

    from jax.experimental import pallas as pl

    from tpu_raytracing.trace import lane_pallas, split_pallas

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(split_pallas, "C", 1)
        mp.setattr(lane_pallas, "C", 1)
        yield
    pl.pallas_call = orig


def run_both(tmp_path, capsys, flags, frames=FRAMES):
    """The reference app and the port's with ``flags``; returns (the
    reference's stdout, the port's stdout, the port's result)."""
    base = ["--scene", "cornell", "--animate", "--frames", str(frames)] + list(flags)
    jmain.main(base + ["--output", str(tmp_path / "jax")])
    jout = capsys.readouterr().out
    res = tmain.main(base + ["--device", "cpu", "--output", str(tmp_path / "port")])
    tout = capsys.readouterr().out
    return jout, tout, res


def assert_frames_close(tmp_path, res, frames=FRAMES):
    """Each frame's PNG of the port within MIN_PSNR of the reference's."""
    assert len(res["frames"]) == frames
    for frame, _mode, _ms, path in res["frames"]:
        name = os.path.basename(path)
        ref = read_png(str(tmp_path / "jax" / name))
        out = read_png(path)
        assert ref.shape == out.shape and out[..., :3].any(), name
        db = psnr(ref, out)
        assert db >= MIN_PSNR, f"{name}: {db:.2f} dB"
    # the geometry moved: the last frame is not frame 0
    first = read_png(res["frames"][0][3])
    assert not np.array_equal(first, read_png(res["frames"][-1][3]))


@pytest.mark.parametrize("tracer", ["scalar", "wide"])
@pytest.mark.parametrize("build_type", ["sah", "bottom-up", "hybrid"])
def test_animated_rebuild_matches_reference(tmp_path, capsys, build_type, tracer):
    """Per-frame rebuilds of the ``--type`` tree (and, for ``wide``, its fat
    collapse), traced by ``trace_rays`` or K6's counting instantiation."""
    _, tout, res = run_both(tmp_path, capsys, ["--type", build_type, "--tracer", tracer,
                                               "--width", "16", "--height", "16"])
    assert_frames_close(tmp_path, res)
    stage = tmain.BUILD_STAGES[tmain.BuildType(build_type)]
    assert [r["frame"] for r in res["animated"]] == [1, 2]
    for rec in res["animated"]:
        names = [name for name, _ in rec["stages"]]
        assert rec["kind"] == "rebuild" and stage in names, names
    if build_type == "hybrid":
        assert "HybridBuild          time elapsed" in tout
        assert int(res["bvh"].root_count) == 1


def test_animated_refit_schedule_matches_reference(tmp_path, capsys, pallas_interpret):
    """``--tracer split --refit`` on the bucket tree: frame 0's tree seeds
    the schedule, frame 1 refits, and the periodic cap rebuilds at frame 2:
    the same printed rebuild lines as the reference's, and the frames."""
    jout, tout, res = run_both(tmp_path, capsys, [
        "--type", "bottom-up", "--tracer", "split", "--refit", "--refit-interval", "1",
        "--width", "16", "--height", "8"])
    assert_frames_close(tmp_path, res)

    def lines(out):
        return [ln for ln in out.splitlines() if ln.startswith("refit schedule:")]

    assert lines(tout) == lines(jout) == ["refit schedule: full rebuild at t=0.20 (#1)"]
    assert [r["kind"] for r in res["animated"]] == ["refit", "rebuild"]
    ratio = float(res["animated"][0]["sa_ratio"])
    assert 0.5 < ratio < 1.3
    assert res["sched"].rebuild_count == 1


def test_animated_lane_matches_reference(tmp_path, capsys, pallas_interpret):
    """``--tracer lane``: the treelet BVH rebuilt on the animated frame,
    traced by K5's plain version against the reference's lane kernel (two
    frames: each costs the reference several seconds in interpret mode)."""
    _, _, res = run_both(tmp_path, capsys, ["--tracer", "lane", "--type", "bottom-up",
                                            "--width", "16", "--height", "8"], frames=2)
    assert_frames_close(tmp_path, res, frames=2)
    assert [r["stages"][-1][0].strip() for r in res["animated"]] == ["TreeletBuild"]


def test_refit_warning_and_profile_build(tmp_path, capsys):
    """``--refit`` with another tracer than ``split`` warns as the
    reference does; ``--profile-build`` prints the reference's stage names
    for each ``--type`` and the split build's six stages (then the port's
    own line for the split tree it traces)."""
    tmain.main(["--scene", "cornell", "--type", "bottom-up", "--tracer", "wide", "--refit",
                "--animate", "--frames", "2", "--width", "16", "--height", "16", "--device",
                "cpu", "--output", str(tmp_path)])
    assert ("WARNING: --refit needs --tracer split; animated frames will run the full "
            "rebuild path.") in capsys.readouterr().err
    names = {
        ("sah", "scalar"): ["triangle pairing", "grid partition", "SharedTaskBuild"],
        ("sah", "scalar", "--splits"): ["setup+splits", "grid partition", "SharedTaskBuild"],
        ("bottom-up", "scalar"): ["SceneAabb", "GenerateMortonCodes", "RadixSort",
                                  "BottomUpBuild"],
        ("hybrid", "scalar"): ["HybridBuild"],
        ("bottom-up", "split"): ["SceneAabb", "GenerateMortonCodes", "RadixSort",
                                 "BottomUpBuild", "MortonSortFront", "BucketTables",
                                 "Classification", "RangeMinAabbTable", "EmitScatter",
                                 "KernelViewPrep", "SplitBuildTotal", "SplitBuild"],
    }
    for key, expect in names.items():
        build_type, tracer, *extra = key
        tmain.main(["--scene", "cornell", "--type", build_type, "--tracer", tracer,
                    "--profile-build", "--width", "8", "--height", "8", "--device", "cpu",
                    "--output", str(tmp_path)] + extra)
        out = capsys.readouterr().out
        got = [ln.split(" time elapsed")[0].strip() for ln in out.splitlines()
               if " time elapsed: " in ln]
        assert got == expect, (key, got)
        if tracer == "split":
            assert "Split-build stage profile (cumulative-delta, 2 warm iters)" in out
