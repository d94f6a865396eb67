"""The instance sweep's least time: bytes only, at the card's published
bandwidth (``roofline.py``'s peak).

The count reads the same work whatever implements the sweep. Per
instanced traversal call every live ray's 32 bytes are read (origin,
direction, tmin, tmax), every overlap of a ray with an instance's world box
written once as a 4-byte instance id, and the instances' world boxes (24
bytes each) and inverse transforms (48 bytes each) read once. Operations
are not counted: the slab tests a sweep makes depend on how it culls.

The CPU test's readings (``tests/test_torch_instanced_app.py``): 18 calls of
1,048,576 live rays with 2,000,000 overlaps over 1,000 instances need
613,275,776 bytes, 0.183067 ms at 3.35 TB/s.
"""

from __future__ import annotations

from rtbench import roofline

RAY_READ_BYTES = 32
OVERLAP_WRITE_BYTES = 4
INSTANCE_BYTES = 24 + 48


def sweep_bytes(live_rays: int, overlaps: int, calls: int, num_instances: int) -> int:
    """Bytes the sweeps of ``calls`` instanced calls need, given their live
    rays and overlaps in all."""
    return (int(live_rays) * RAY_READ_BYTES + int(overlaps) * OVERLAP_WRITE_BYTES
            + int(calls) * int(num_instances) * INSTANCE_BYTES)


def sweep_roofline_pct(live_rays: int, overlaps: int, calls: int, num_instances: int,
                       frames: int, kernel_ms_per_frame: float):
    """The sweep kernel's share of its roofline, in %: the least time of a
    frame's sweep bytes over the kernel's device time per frame. None where
    the kernel did not run."""
    if not frames:
        return None
    nbytes = sweep_bytes(live_rays, overlaps, calls, num_instances) / frames
    return roofline.roofline_pct(nbytes, kernel_ms_per_frame)
