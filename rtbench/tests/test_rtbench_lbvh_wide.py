"""The Karras-rebuild cell with K6 (``terrain1m-lbvh-wide.animate-rebuild``)
at ``conftest.small`` size on the CPU: the sound run is correct with its
shadow verdicts read from any-hit calls, and read traced it reports the
cell's new per-layer metrics; the control (the reference in bfloat16)
fails; the animated step handing back the rest pose's tree fails on
``hit_miss``."""

import torch

from conftest import small

from rtbench import faults, harness, judge

SEED = 2**33 + 19
WORKLOAD = "terrain1m-lbvh-wide.animate-rebuild"
NEW_METRICS = ("lbvh_stage_ms.morton", "lbvh_stage_ms.sort", "lbvh_stage_ms.hierarchy",
               "lbvh_stage_ms.boxes", "lbvh_stage_ms.wide_collapse", "k6_pass_ms.bounce",
               "k6_pass_ms.bounce_shadow")


def _run(control_dtype=None, trace=False):
    return harness.run_cell(WORKLOAD, SEED, 0.5, trace, device="cpu", overrides=small(WORKLOAD),
                            control_dtype=control_dtype)


def test_sound_run_correct_and_control_fails():
    r = _run(torch.bfloat16)
    limits = harness.resolve(WORKLOAD)["limits"]
    assert r["correct"], r["checks"]
    program = r["_readings"]["program"]
    assert program["shadow_miss"] == 0 and program["hit_miss"] == 0, program
    control = r["_readings"]["control"]
    assert not judge.verdict(control, limits), control
    assert control["hit_miss"] > 3 * max(limits["hit_miss"], program["hit_miss"])


def test_traced_run_reports_the_build_and_pass_spans():
    r = _run(trace=True)
    assert r["correct"], r["checks"]
    for name in NEW_METRICS:
        assert r["metrics"][name]["value"] > 0, name
    # the any-hit kernel's share is read from the card's trace only
    assert "k6_any_roofline_pct" not in r["metrics"]
    assert "build_ms" not in r["metrics"]  # listed for the split cells only


def test_rest_pose_tree_fails_on_hit_miss(monkeypatch):
    faults.install("build_unchanged", monkeypatch.setattr)
    r = _run()
    assert not r["correct"], r["checks"]
    check = r["checks"]["hit_miss"]
    assert check["value"] > check["limit"], r["checks"]
