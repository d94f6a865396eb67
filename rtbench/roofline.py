"""The traversal kernels' least time: bytes only, at the card's published
bandwidth.

The count reads the same work whatever implements it. Per traversal call
every live ray's 32 bytes are read (origin, direction, tmin, tmax) and its
8 bytes written (t, triangle id); once a frame the scene's triangles are
read, 36 bytes each. Operations are not counted: a traversal's operations
depend on the tree the program builds, so a better tree would lower the
bound.

The CPU test's readings (``tests/test_rtbench_arith.py``): four calls of
1,048,576 live rays over the 999,698-triangle terrain need 203,761,288
bytes, 0.0608243 ms at 3.35 TB/s; a kernel taking 6.08243 ms for them is
at 1% of its roofline.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet: HBM3 bandwidth, at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12

RAY_READ_BYTES = 32
RAY_WRITE_BYTES = 8
TRIANGLE_BYTES = 36


def frame_bytes(live_rays_per_call, num_triangles: int) -> int:
    """Bytes one frame's traversal calls need: each call's live rays read
    and written once, the triangles read once."""
    rays = sum(int(n) for n in live_rays_per_call)
    return rays * (RAY_READ_BYTES + RAY_WRITE_BYTES) + num_triangles * TRIANGLE_BYTES


def least_ms(nbytes: float) -> float:
    """Milliseconds to move ``nbytes`` at the card's peak bandwidth."""
    return nbytes / PEAK_BYTES_PER_S * 1e3


def roofline_pct(nbytes_per_frame: float, kernel_ms_per_frame: float):
    """The kernel's share of its roofline, in %: least time over kernel
    time. None where the kernel did not run."""
    if not kernel_ms_per_frame or kernel_ms_per_frame <= 0:
        return None
    return 100.0 * least_ms(nbytes_per_frame) / kernel_ms_per_frame
