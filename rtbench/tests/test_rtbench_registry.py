"""Configurations, traffic mixes, limits and per-layer metrics are found
by name; a new cell needs only new files and new entries."""

import json
import shutil

from conftest import REPO, SMALL_SCENE

from rtbench import harness


def test_every_cell_resolves_with_its_files():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell in spec["workloads"]:
        r = harness.resolve(cell["name"])
        assert r["config"]["scene"]["triangles"] == 1_000_000
        assert r["traffic"]["period"] >= r["traffic"]["capture_span"]
        assert set(r["limits"]) <= set(("hit_miss", "shadow_miss", "pixel_miss", "count_form"))
        names = {m["name"] for m in r["end_to_end"]}
        assert {"setup_s", "frame_ms", "frame_ms_p95", "peak_mem_gib"} <= names
        for m in r["per_layer"]:
            assert hasattr(harness.load_reader(m["name"]), "read")
        assert r["per_layer"], cell["name"]


def test_new_config_traffic_and_metric_as_new_files_only(tmp_path):
    """A copy of the benchmark with a new configuration, traffic mix,
    limits file and per-layer metric added as files and entries, and no
    file of the benchmark edited: the new cell runs (on the CPU) and
    reports the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "rtbench", root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".tmp"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "rtbench").rglob("*") if p.is_file()}

    cfg = dict(json.loads((REPO / "rtbench/configs/terrain1m-split.json").read_text()),
               name="terrain2k-split", scene=SMALL_SCENE, width=32, height=32, bounces=1)
    (root / "rtbench/configs/terrain2k-split.json").write_text(json.dumps(cfg))
    (root / "rtbench/traffic/orbit-short.json").write_text(json.dumps(dict(
        camera="aerial_orbit", period=3, animate=None, warm_steps=1, profile_steps=2,
        captures=1, capture_span=3)))
    (root / "rtbench/limits/terrain2k-split.orbit-short.json").write_text(
        json.dumps({"hit_miss": 0.01, "shadow_miss": 0.01, "pixel_miss": 0.02}))
    (root / "rtbench/metrics/frames_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx['rays'])) or None\n")
    spec["configs"].append(dict(name="terrain2k-split", source="a test", reduced=[],
                                file="rtbench/configs/terrain2k-split.json", why="a test"))
    spec["workloads"].append(dict(name="terrain2k-split.orbit-short", config="terrain2k-split",
                                  traffic="orbit-short", chips=1, why="a test"))
    spec["per_layer"].append(dict(name="frames_seen", unit="frames", better="higher",
                                  source="program_counter", layer="frame loop",
                                  moves="frame_ms", workloads=["terrain2k-split.orbit-short"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    for p, data in before.items():
        assert p.read_bytes() == data
    r = harness.run_cell("terrain2k-split.orbit-short", 2**31 + 17, 0.5, True, device="cpu",
                         root=root)
    assert r["correct"], r["checks"]
    assert r["metrics"]["frames_seen"]["value"] >= 1
    assert "rays_per_frame" not in r["metrics"]  # listed for other cells only
    assert "k6_device_ms" not in r["metrics"]
    assert list(r)[-2:] == ["checks", "_readings"]
