"""The scalar control cost components of a traversal pop, on the H100.

Port of ``benchmarks/micro_control.py``: the bare loop of
``micro_pallas`` plus ONE component per probe, on one CTA
(``csrc/micro_probe.cu``):

  red1 / red2    1 / 2 reductions of an (8, 1) vector to a scalar min
  when4 / when12 4 / 12 uniform branches with scalar bodies
  push8          the 8-entry push loop of interior_pop: a meta read, shift
                 math and a dynamic conditional shared-memory write per entry
  read8          the 8 meta reads alone
  combo          a predicated pop: 2 reductions, the push loop, 4 branches,
                 4 row copies in flight
  batch4         combo with 4 slots' reductions batched into one (32, 1)
                 reduction per iteration; reported per pop

Outputs are int32 sums as in the reference. Scratch the reference reads
before writing (the vector, the meta words, scr, spp) is an input
(``fill``): interpret mode's NaN / INT32_MIN by default, seeded values in
``main``. The reference's TPU times describe the TPU only.

    python -m tpu_raytracing_torch.benchmarks.micro_control [--device cpu]

``N`` (environment, default 200,000) sets the loop length.
"""

from __future__ import annotations

import torch

from tpu_raytracing_torch.benchmarks import _common, _micro

KINDS = ("red1", "red2", "when4", "when12", "push8", "read8", "combo", "batch4")
N_DEFAULT = 200_000
REFERENCE = "benchmarks/micro_control.py"
SOURCE = "tpu_raytracing_torch/csrc/micro_probe.cu"
# The reference's kernels: file:line.
REPLACES = {"red1": 73, "red2": 73, "when4": 89, "when12": 89, "push8": 105, "read8": 125,
            "combo": 135, "batch4": 188}

# Launches of each probe's kernel since the count was last set to 0: the
# wrapper adds one where it launches the kernel and nowhere else.
launch_count = {k: 0 for k in KINDS}


def _ints(vec: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """vec * (i % 7 + 1) in float32, then XLA's conversion to int32: [n, len(vec)] int64."""
    m = (i % 7 + 1).to(torch.float32)
    return _common.f2i(vec[None, :] * m[:, None]).to(torch.int64)


def probe_plain(kind: str, rows, seed, n: int, fill: dict):
    """The plain PyTorch version: out [1] int32. Only the scratch words
    that reach the output are computed: the push stack is never read, so
    ``push8``, ``combo`` and ``batch4`` reduce to the stack pointer's chain
    (``_micro.sp_chain``), and the row words only feed the stack."""
    del rows, seed
    dev = fill["vec"].device
    i = _micro.loop_index(n, dev)
    vec = fill["vec"]
    spp0 = int(fill["spp"][0])
    if kind in ("red1", "red2"):
        x = _ints(vec[:8], i)
        mins = [_common.wrap32(x + r).min(dim=1).values for r in range(int(kind[-1]))]
        return _micro.sum32(torch.stack(mins))
    if kind in ("when4", "when12"):
        # scr[0] after iteration i: the fill plus every j <= i with j % 3 != 0
        scr0 = spp0 + torch.cumsum(torch.where(i % 3 != 0, i, 0), 0)
        return _micro.sum32(scr0)
    if kind == "push8":
        return _micro.sum32(_micro.sp_chain(spp0, _micro.push_count(i & 0xFF, i % 8)))
    if kind == "read8":
        return _micro.sum32(fill["meta"][6:64:8].to(torch.int64).sum() * n)
    if kind == "combo":
        x = _ints(vec[:8], i)
        kmin = x.min(dim=1).values
        vmask = (x & 1).sum(dim=1)
        return _micro.sum32(_micro.sp_chain(spp0, _micro.push_count(vmask, kmin % 8)))
    if kind == "batch4":
        i4 = _micro.loop_index(n // 4, dev)
        packed = _common.wrap32(_ints(vec, i4) + torch.arange(32, device=dev)).min(dim=1).values
        packed = packed.to(torch.int64)
        vmask = (packed[:, None] >> (8 * torch.arange(4, device=dev))) & 0xFF
        counts = _micro.push_count(vmask, (packed % 8)[:, None].expand(-1, 4))
        v = _micro.sp_chain(spp0, counts.reshape(-1)).reshape(-1, 4)
        return _micro.sum32(v[:, 3] % 200)
    raise ValueError(f"unknown probe {kind!r}; one of {KINDS}")


def probe(kind: str, rows, seed, n: int, fill: dict = None):
    """Probe ``kind`` for ``n`` iterations (``batch4``: n // 4 iterations
    of 4 pops) over ``rows`` [65536, 128] int32 with ``seed`` [1] int32;
    ``fill`` holds the scratch the kernel reads before writing (vec [32]
    f32, meta [128], spp [16] int32, acc; interpret mode's fill by
    default). Returns out [1] int32. CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
    fill = _micro.interpret_fills(rows.device) if fill is None else fill
    return _common.dispatch(KINDS, launch_count, kind, rows.device,
                            lambda: probe_plain(kind, rows, seed, n, fill),
                            lambda: _micro.launch(kind, rows, seed, n, fill)[0])


def work(kind: str, seed: int, n: int):
    """(float32 operations, bytes) the probe must do and move: the vector
    products, the scratch words it reads, the rows it copies (each distinct
    row once), the seed in and the result out."""
    if kind in ("red1", "red2"):
        return float(n) * 8, 8 + 8 * 4
    if kind in ("when4", "when12"):
        return 0.0, 8 + int(kind[4:]) * 4
    if kind in ("push8", "read8"):
        return 0.0, 8 + 8 * 4 + (4 if kind == "push8" else 0)
    pops = n if kind == "combo" else 4 * (n // 4)
    idx = _common.idx_of(_micro.loop_index(pops + 4, "cpu"), seed)
    nbytes = 8 + 4 + 512 * int(idx.unique().numel())
    if kind == "combo":
        return float(n) * 8, nbytes + 8 * 4
    return float(n // 4) * 32, nbytes + 32 * 4


def main(argv=None) -> dict:
    """Times every probe (median of 5 runs, seed and scratch varied per
    run) and prints ns/iter (ns/pop for batch4); returns
    ``_common.entry_point``'s results."""
    def line(kind, ms, ns, ok):
        return f"{kind:<6}: {ns:.1f} {'ns/pop' if kind == 'batch4' else 'ns/iter'} ({ms!r} ms)"
    return _common.entry_point(argv, "tpu_raytracing_torch.benchmarks.micro_control", "N",
                               N_DEFAULT, KINDS, probe, _micro.arg_sets, lambda kind, n: n, line)


if __name__ == "__main__":
    main()
