"""The comparison fails what it should: the control (the plain reference
in bfloat16 put in the program's place) and, with the timed path broken
underneath, each fault a cell can have. The harness's look for a card is
skipped: every run here is on the CPU, with the program's plain kernels,
at the size ``conftest.small`` sets."""

import pytest
import torch

from conftest import small

from rtbench import faults, harness, judge

SEED = 2**32 + 3


def _run(workload, control_dtype=None, seconds=0.5, light=None):
    overrides = small(workload)
    if light is not None:
        overrides["config"]["scene"] = dict(overrides["config"]["scene"], light=light)
    return harness.run_cell(workload, SEED, seconds, False, device="cpu",
                            overrides=overrides, control_dtype=control_dtype)


@pytest.mark.parametrize("workload", ["terrain1m-split.orbit", "terrain1m-sah-wide.modes",
                                      "terrain1m-split.animate-refit"])
def test_sound_run_correct_and_control_fails(workload):
    r = _run(workload, torch.bfloat16, seconds=3.0 if "modes" in workload else 0.5)
    limits = harness.resolve(workload)["limits"]
    assert r["correct"], r["checks"]
    control = r["_readings"]["control"]
    assert not judge.verdict(control, limits), control
    assert control["hit_miss"] > 3 * max(limits["hit_miss"], r["_readings"]["program"]["hit_miss"])


@pytest.mark.parametrize("workload,fault", [
    # half of each traversal batch left out; every hit's distance altered
    # where K1's result is produced; the radiance altered where the image is
    ("terrain1m-split.orbit", "split_half"),
    ("terrain1m-split.orbit", "split_altered"),
    ("terrain1m-split.orbit", "image_altered"),
    # the animated step hands back the rest pose's tree
    ("terrain1m-split.animate-rebuild", "build_unchanged"),
    ("terrain1m-split.animate-refit", "build_unchanged"),
    # K6's batch half left out; its hits' distances altered; every mode's
    # colour altered; the shadow mask dropped; the light moved
    ("terrain1m-sah-wide.modes", "modes_half"),
    ("terrain1m-sah-wide.modes", "modes_altered"),
    ("terrain1m-sah-wide.modes", "colour_altered"),
    ("terrain1m-sah-wide.modes", "shadow_dropped"),
    ("terrain1m-sah-wide.modes", "light_moved"),
])
def test_fault_fails(monkeypatch, workload, fault):
    faults.install(fault, monkeypatch.setattr)
    r = _run(workload, seconds=3.0 if "modes" in workload else 0.5,
             light=LOW_LIGHT if fault == "shadow_dropped" else None)
    assert not r["correct"], r["checks"]
    if fault in MUST_FAIL:
        check = r["checks"][MUST_FAIL[fault]]
        assert check["value"] > check["limit"], r["checks"]


# the small terrain's hills cast no shadow under the configurations' light
# high above: the dropped shadow mask is planted under a low light (the
# card's readings at the cell's own size are in PERF.md)
LOW_LIGHT = [60.0, 40.0, 0.0]
# the number that a fault has to fail, where one is the fault's own
MUST_FAIL = {"image_altered": "pixel_miss", "build_unchanged": "hit_miss",
             "colour_altered": "pixel_miss", "shadow_dropped": "pixel_miss",
             "light_moved": "pixel_miss"}


@pytest.mark.card
def test_a_cell_on_the_card(card):
    """One short run of the orbit cell on the card: correct, with every
    end-to-end metric."""
    r = harness.run_cell("terrain1m-split.orbit", SEED, 3.0, False, device="cuda")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"setup_s", "frame_ms", "frame_ms_p95", "peak_mem_gib"}
