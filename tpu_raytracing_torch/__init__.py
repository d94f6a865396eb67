"""tpu_raytracing_torch — the PyTorch / CUDA port of ``tpu_raytracing``.

The JAX package beside it is the reference and stays unchanged. This
package mirrors its sub-packages and module names (``scene``, ``bvh``,
``ops``, ``trace``, ``app``, ``utils``) so each counterpart is found at
once, imports ``torch`` and numpy only (never ``jax`` or ``flax``), and
replaces the Pallas traversal kernels with CUDA kernels written for
Hopper (``csrc/split_trace.cu``, ``csrc/lane_trace.cu``,
``csrc/fat_traverse.cu``), built with ``nvcc`` at first use.

The port currently covers the path-traced frame that ``bench.py`` times
(procedural scenes, the Morton-bucket split-BVH build and refit, the split
traversal and the wavefront path tracer), the treelet BVH and its per-ray
tracer, and the binary BVH: the Karras build, the scalar tracer and the
8-wide fat traversal (see ROADMAP.md for what is still to port).
"""

__version__ = "0.1.0"
