"""tpu_raytracing_torch — the PyTorch / CUDA port of ``tpu_raytracing``.

The JAX package beside it is the reference and stays unchanged. This
package mirrors its sub-packages and module names (``scene``, ``bvh``,
``ops``, ``trace``, ``app``, ``utils``) so each counterpart is found at
once, imports ``torch`` and numpy only (never ``jax`` or ``flax``), and
replaces the Pallas traversal kernels with CUDA kernels written for
Hopper (``csrc/split_trace.cu``, ``csrc/lane_trace.cu``,
``csrc/fat_traverse.cu``), built with ``nvcc`` at first use.

The port does all that the JAX package does: every scene, build, tracer,
render mode and app flag, and the multi-device renderers on
``torch.distributed``. What it leaves out on purpose is TPU-only code
(ROADMAP.md, "Not ported").
"""

__version__ = "0.1.0"
