"""The port's spans and counters (``utils/timing.py``): nothing recorded
and the same image without a profiler; under one, the path tracer's and
the render modes' span trees, one ``k1`` or ``k6`` span per tracer call,
K1's pops as its plain version counts them, and the spans in the
profiler's trace as host ranges alone. The refit schedule's counters are
checked in ``tests/test_torch_refit.py``."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing_torch.app import main as app  # noqa: E402
from tpu_raytracing_torch.scene import camera as tcam  # noqa: E402
from tpu_raytracing_torch.scene import procedural  # noqa: E402
from tpu_raytracing_torch.scene.types import scene_to_device  # noqa: E402
from tpu_raytracing_torch.trace import pathtrace, render  # noqa: E402
from tpu_raytracing_torch.trace import split_trace as st  # noqa: E402
from tpu_raytracing_torch.trace.modes import RenderType  # noqa: E402
from tpu_raytracing_torch.utils import timing  # noqa: E402

torch.set_num_threads(2)
W = H = 32
BOUNCES = 2
PASSES = ("primary", "primary_shadow", "bounce", "bounce_shadow")


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def terrain():
    scene = procedural.terrain(2000)
    cam = tcam.update_camera(tcam.Camera(position=np.array([0.0, 40.0, -90.0], np.float32),
                                         pitch=0.5, max_depth=400.0))
    return dict(tris=torch.from_numpy(scene.triangles), scene=scene_to_device(scene, "cpu"),
                camera=tcam.camera_to_device(cam, "cpu"))


def _trav(terrain, tracer, build_type):
    args = app.parse_cmd(["--tracer", tracer, "--type", build_type, "--pairs", "--width",
                          str(W), "--height", str(H), "--device", "cpu"])
    bvh = pairs = None
    if tracer != "split":
        bvh, pairs = app.build_accel(terrain["tris"], args, timing.StageTimer())
    return app.build_trav(args, terrain["tris"], bvh, pairs, timing.StageTimer())


@pytest.fixture(scope="module")
def path_frame(terrain, tmp_path_factory):
    """One 2-bounce frame without the profiler and one under it, with the
    plain K1's own pops and live rays summed beside the counters."""
    trav, packed, tracers = _trav(terrain, "split", "bottom-up")

    def frame():
        return pathtrace.path_trace(trav, packed, terrain["scene"], terrain["camera"], W, H,
                                    num_bounces=BOUNCES,
                                    generator=torch.Generator().manual_seed(5), **tracers)

    timing.clear()
    off = frame()
    off_record = timing.recorded()
    plain = dict(pops=0, rays=0)
    orig = st.trace_split_plain

    def counted(inner, pairs, origin, direction, tmin, tmax, **kw):
        out = orig(inner, pairs, origin, direction, tmin, tmax, **kw)
        plain["pops"] += int(out[2].sum() + out[3].sum())
        plain["rays"] += int((tmin <= tmax).sum())
        return out

    st.trace_split_plain = counted
    try:
        with _profiled() as prof:
            on = frame()
    finally:
        st.trace_split_plain = orig
    trace = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(trace))
    return dict(off=off, off_record=off_record, on=on, record=timing.recorded(), plain=plain,
                trace=json.loads(trace.read_text()))


def _names(record):
    spans = record["spans"]
    return [(s["name"], None if s["parent"] is None else spans[s["parent"]]["name"])
            for s in spans]


def test_spans_off_without_profiler(path_frame):
    assert path_frame["off_record"] == dict(spans=[], counters={}, dropped=0)
    assert not timing.tracing()
    assert torch.equal(path_frame["off"][0], path_frame["on"][0])
    assert int(path_frame["off"][1]) == int(path_frame["on"][1])


def test_path_trace_span_tree_and_k1_counters(path_frame):
    record = path_frame["record"]
    names = _names(record)
    tracer_spans = [f"path_trace.{p}" for p in PASSES]
    assert names[0] == ("path_trace", None)
    assert all(p == "path_trace" for n, p in names if n.startswith("path_trace."))
    count = {n: sum(1 for m, _ in names if m == n) for n, _ in names}
    assert count["path_trace"] == 1
    assert [count[n] for n in tracer_spans] == [1, 1, BOUNCES, BOUNCES]
    assert count["path_trace.shade"] == BOUNCES + 1
    assert count["path_trace.compact"] == BOUNCES
    assert count["path_trace.shadow_sort"] == 2 * BOUNCES
    # one K1 launch (here its plain version) inside each tracer call
    spans = record["spans"]
    k1_parents = [spans[s["parent"]]["name"] for s in spans if s["name"] == "k1"]
    assert sorted(k1_parents) == sorted(n for n, _ in names if n in tracer_spans)
    assert all(s["host_ms"] >= 0 and s["device_ms"] is None for s in spans)
    assert record["counters"] == {"k1.pops": path_frame["plain"]["pops"],
                                  "k1.rays": path_frame["plain"]["rays"]}
    assert 0 < path_frame["plain"]["rays"] < path_frame["plain"]["pops"]


def test_spans_are_host_ranges_in_the_profiler_trace(path_frame):
    cats = {}
    for e in path_frame["trace"]["traceEvents"]:
        cats.setdefault(e.get("name"), set()).add(e.get("cat"))
    for name, _ in _names(path_frame["record"]):
        assert cats.get(name) == {"cpu_op"}, (name, cats.get(name))


@pytest.mark.parametrize("tracer,build_type,kernel", [("split", "bottom-up", "k1"),
                                                      ("wide", "sah", "k6")])
def test_render_frame_span_tree(terrain, tracer, build_type, kernel):
    trav, packed, tracers = _trav(terrain, tracer, build_type)
    timing.clear()
    with _profiled():
        render.render_frame(trav, packed, terrain["scene"], terrain["camera"], W, H,
                            RenderType.TEXTURE_LIT_SHADOWS, tracer=tracers["tracer"])
    assert _names(timing.recorded()) == [
        ("render_frame", None), ("render_frame.trace", "render_frame"),
        (kernel, "render_frame.trace"), ("render_frame.shade", "render_frame"),
        ("render_frame.shadow_trace", "render_frame.shade"),
        (kernel, "render_frame.shadow_trace")]
    counters = timing.recorded()["counters"]
    if kernel == "k6":
        assert counters == {}
    else:
        assert sorted(counters) == ["k1.pops", "k1.rays"] and counters["k1.rays"] > 0


def test_record_bound_drops_and_counts(monkeypatch):
    monkeypatch.setattr(timing, "MAX_SPANS", 2)
    timing.clear()
    with _profiled():
        with timing.span("a"):
            with timing.span("b"):
                with timing.span("c"):
                    timing.count("n", 2)
                    timing.count("n", torch.tensor(3))
            with timing.span("d"):
                pass
    record = timing.recorded()
    assert _names(record) == [("a", None), ("b", "a")]
    assert record["dropped"] == 2 and record["counters"] == {"n": 5}
    timing.clear()
    assert timing.recorded()["spans"] == []
