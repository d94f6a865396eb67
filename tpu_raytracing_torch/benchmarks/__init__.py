"""Hopper counterparts of the repository's ``benchmarks/`` micro-probes.

The JAX scripts ``benchmarks/micro_pallas.py``, ``micro_control.py`` and
``probe_lane_machine{,2,3}.py`` each time a synthetic Pallas kernel that
isolates one component of a traversal pop on the TPU: a dependent row
copy, copies kept in flight, vector->scalar reductions, branches, the
scalar push loop, a per-lane gather from an on-chip table, the per-lane
stack shift. The modules here are the same probes written for the H100:

* ``micro_pallas`` and ``micro_control``: one CTA of 128 threads runs the
  scalar loop (``csrc/micro_probe.cu``);
* ``probe_lane_machine``, ``probe_lane_machine2`` and
  ``probe_lane_machine3``: one CTA of 128 threads, one thread per lane,
  the tables in shared memory (``csrc/lane_probe.cu``).

Every probe has a wrapper that launches its CUDA kernel for CUDA tensors
and runs its plain PyTorch version for CPU tensors, and counts its
launches. Each module's ``main`` is runnable as
``python -m tpu_raytracing_torch.benchmarks.<name>`` and prints the
reference script's lines with the card's name and power limit; it runs on
``cuda`` unless ``--device cpu`` is given (then the plain versions, at the
size in the ``N`` or ``ITERS`` environment variable).
"""
