"""``rtbench/spans.py`` over a hand-made record: self times by name and
parent, per profiled frame, device time before host time, counters by
prefix, and None where the program recorded nothing."""

import pytest

from rtbench import spans


def _span(name, parent, host_ms, device_ms=None):
    return dict(name=name, parent=parent, host_ms=host_ms, device_ms=device_ms)


RECORD = dict(spans=[
    _span("path_trace", None, 50.0, 40.0),
    _span("path_trace.primary", 0, 9.0, 8.0),
    _span("k1", 1, 3.0, 2.5),
    _span("path_trace.bounce", 0, 12.0, 10.0),
    _span("k1", 3, 7.0, 6.0),
    _span("path_trace.shade", 0, 5.0),       # host time only
    _span("path_trace.compact", 0, None),    # still open when recorded
], counters={"k1.pops": 90, "k1.rays": 30, "refit.frames": 8, "refit.rebuild.interval": 2},
    dropped=0)
CTX = {"folded": {"frames": 2}}


def test_self_times_by_name_and_parent():
    table = spans.self_ms(RECORD)
    assert table[("path_trace", None)] == pytest.approx(40.0 - 8.0 - 10.0 - 5.0)
    assert table[("path_trace.primary", "path_trace")] == pytest.approx(5.5)
    assert table[("path_trace.bounce", "path_trace")] == pytest.approx(4.0)
    assert table[("k1", "path_trace.bounce")] == pytest.approx(6.0)
    assert table[("path_trace.shade", "path_trace")] == pytest.approx(5.0)
    assert ("path_trace.compact", "path_trace") not in table


def test_per_frame_and_absent():
    assert spans.stage_ms(CTX, ["k1"], rec=RECORD) == pytest.approx(4.25)
    assert spans.stage_ms(CTX, ["k1"], parents=["path_trace.primary"],
                          rec=RECORD) == pytest.approx(1.25)
    assert spans.stage_ms(CTX, ["path_trace.primary", "path_trace.bounce"],
                          rec=RECORD) == pytest.approx(4.75)
    assert spans.stage_ms(CTX, ["build.refit"], rec=RECORD) is None
    assert spans.stage_ms({"folded": {}}, ["k1"], rec=RECORD) is None
    assert spans.counters("refit.", rec=RECORD) == {"refit.frames": 8,
                                                    "refit.rebuild.interval": 2}


def test_readers_none_without_a_record(monkeypatch):
    from rtbench import harness

    monkeypatch.setattr(spans, "record", lambda: None)
    for name in ("k1_pass_ms.primary", "k1_pops_per_ray", "pt_stage_ms.trace_front",
                 "build_stage_ms.emit_scatter", "refit_rebuild_pct", "modes_stage_ms.shade"):
        assert harness.load_reader(name).read(CTX) is None
    monkeypatch.setattr(spans, "record", lambda: RECORD)
    assert harness.load_reader("k1_pops_per_ray").read(CTX) == 3.0
    assert harness.load_reader("refit_rebuild_pct").read(CTX) == 25.0
    assert harness.load_reader("k1_pass_ms.bounce").read(CTX) == pytest.approx(3.0)
