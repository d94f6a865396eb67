"""Frame and p95 arithmetic, the device idle union, span attribution and
the roofline's byte count."""

import numpy as np
import pytest

from rtbench import harness, roofline, tracefold


def test_frame_ms_and_p95_over_all_frames():
    times = [0.010] * 95 + [0.050] * 5
    s = harness.frame_stats(times, window_s=sum(times))
    assert s["frame_ms"] == pytest.approx(12.0)
    # numpy's linear percentile over every frame: rank 94.05 of 0..99
    assert s["frame_ms_p95"] == pytest.approx(10.0 + 0.05 * 40.0)
    assert s["frame_ms_p95"] == pytest.approx(np.percentile(np.asarray(times) * 1e3, 95))


def test_union_of_overlapping_intervals():
    iv = [(0, 10), (5, 12), (20, 30), (30, 31), (40, 41)]
    assert tracefold.union_us(iv) == [(0, 12), (20, 31), (40, 41)]
    assert tracefold.busy_us(iv) == 12 + 11 + 1


def _events():
    # two frames of 100 us; kernels overlap inside frame 1
    return [
        ("rtbench.frame", "span", 0.0, 100.0),
        ("rtbench.path_trace", "span", 0.0, 80.0),
        ("rtbench.readback", "span", 80.0, 100.0),
        ("rtbench.frame", "span", 100.0, 200.0),
        ("rtbench.path_trace", "span", 100.0, 180.0),
        ("rtbench.readback", "span", 180.0, 200.0),
        ("aten::sort", "host", 40.0, 60.0),
        ("split_trace_kernel<8>", "device", 10.0, 30.0),
        ("sort_kernel", "device", 25.0, 35.0),
        ("Memcpy DtoH", "device", 85.0, 90.0),
        ("split_trace_kernel<8>", "device", 110.0, 150.0),
        ("rtbench.frame", "device", 0.0, 100.0),  # a gpu_user_annotation
    ]


def test_fold_busy_idle_launches_and_spans():
    f = tracefold.fold(_events())
    assert f["frames"] == 2 and f["window_us"] == 200.0
    assert f["busy_us"] == 25.0 + 5.0 + 40.0
    assert f["launches"] == 3  # the copy is no kernel, the annotation no operation
    assert f["span_device_us"]["rtbench.path_trace"] == 20 + 10 + 40
    assert f["span_device_us"]["rtbench.readback"] == 5.0
    assert tracefold.device_us_matching(f, "split_trace_kernel") == 60.0
    assert tracefold.device_us_matching(f, "split_trace_kernel", span="path_trace") == 60.0
    gaps = dict(f["idle_gaps"])
    # 35..85 lies in path_trace, with aten::sort open at its midpoint (60)
    assert gaps["path_trace/aten::sort"] == 50.0
    assert sum(gaps.values()) == pytest.approx(200.0 - f["busy_us"])


def test_roofline_bytes_count_live_rays_and_triangles():
    # two calls of 1,000 and 250 live rays, 100 triangles
    nbytes = roofline.frame_bytes([1000, 250], 100)
    assert nbytes == 1250 * 40 + 100 * 36 == 53600
    # the 1M-triangle terrain and a 1024x1024 frame's four coherent passes
    frame = roofline.frame_bytes([1 << 20] * 4, 999_698)
    assert frame == 4 * (1 << 20) * 40 + 999_698 * 36 == 203_761_288
    ms = roofline.least_ms(frame)
    assert ms == pytest.approx(0.0608243, rel=1e-5)
    assert roofline.roofline_pct(frame, 6.08243) == \
        pytest.approx(1.0, rel=1e-4)
    assert roofline.roofline_pct(frame, 0.0) is None
