"""The scalar-loop probes' kernel (``csrc/micro_probe.cu``), its launch,
and the parts of their plain versions that micro_pallas and micro_control
share."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_raytracing_torch.benchmarks import _common

# The order of csrc/micro_probe.cu's Kind.
KINDS = ("loop", "dma1", "dma2", "comp", "pipe4", "red1", "red2", "when4", "when12", "push8",
         "read8", "combo", "batch4")
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 6


def make_rows(device) -> torch.Tensor:
    """The reference's table: arange(W * 128) as [W, 128] int32 (32 MiB)."""
    return torch.arange(_common.W * 128, dtype=torch.int32, device=device).reshape(_common.W, 128)


def make_fill(seed: int, device) -> dict:
    """Scratch contents for the probes that read scratch before writing it,
    from a numpy seed: vec [32] f32 (normal, sd 1e8, so some products
    saturate the int32 conversion), meta [128], spp [16] int32 (uniform
    over int32), acc [8, 128] f32 (normal). On the TPU these are undefined;
    interpret mode fills NaN / INT32_MIN (``interpret_fills``)."""
    rng = np.random.default_rng(seed)
    ints = lambda k: rng.integers(_common.INT32_MIN, _common.INT32_MAX, k, dtype=np.int64)  # noqa: E731
    return dict(
        vec=torch.as_tensor(rng.normal(0.0, 1e8, 32).astype(np.float32), device=device),
        meta=torch.as_tensor(ints(128).astype(np.int32), device=device),
        spp=torch.as_tensor(ints(16).astype(np.int32), device=device),
        acc=torch.as_tensor(rng.normal(size=(8, 128)).astype(np.float32), device=device))


def interpret_fills(device="cpu") -> dict:
    """``make_fill``'s keys holding what Pallas interpret mode leaves in
    scratch."""
    f = _common.interpret_fill
    return dict(vec=f((32,), torch.float32, device), meta=f((128,), torch.int32, device),
                spp=f((16,), torch.int32, device), acc=f((8, 128), torch.float32, device))


def launch(kind: str, rows, seed, n: int, fill: dict):
    """One launch of the probe kernel ``kind`` on CUDA tensors; returns
    (out [1] i32, acc [8, 128] f32 after the loop)."""
    dev = rows.device
    _common.require_cuda_operands(f"probe {kind}", {
        "rows": (rows, torch.int32, (_common.W, 128)), "seed": (seed, torch.int32, (1,)),
        "vec": (fill["vec"], torch.float32, (32,)), "meta": (fill["meta"], torch.int32, (128,)),
        "spp": (fill["spp"], torch.int32, (16,)), "acc": (fill["acc"], torch.float32, (8, 128))})
    if rows.data_ptr() % 16:
        raise ValueError("rows are not 16-byte aligned (the bulk copies need it)")
    if n < 0:
        raise ValueError(f"probe {kind}: n = {n} < 0")
    out = torch.empty((1,), dtype=torch.int32, device=dev)
    acc = fill["acc"].clone()
    fn = _common.kernel_fn("micro_probe", "micro_probe_launch", _ARGTYPES)
    err = fn(KINDS.index(kind), rows.data_ptr(), seed.data_ptr(), n, fill["vec"].data_ptr(),
             fill["meta"].data_ptr(), fill["spp"].data_ptr(), out.data_ptr(), acc.data_ptr(),
             _common.stream_of(rows))
    if err != 0:
        raise RuntimeError(f"micro_probe kernel {kind} launch failed: cudaError {err}")
    return out, acc


def arg_sets(kind: str, n: int, device) -> list:
    """The entry points' argument sets for ``probe(kind, ...)``: the table,
    then seed k and scratch filled from seed k, for k = 0 (warm-up) to
    REPS."""
    rows = make_rows(device)
    return [(rows, torch.tensor([k], dtype=torch.int32, device=device), n, make_fill(k, device))
            for k in range(_common.REPS + 1)]


def loop_index(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def sum32(x: torch.Tensor) -> torch.Tensor:
    """The int32 (wrapping) sum of an integer tensor, as [1] int32."""
    return _common.wrap32(x.to(torch.int64).sum()).reshape(1)


def push_count(vmask: torch.Tensor, emin: torch.Tensor) -> torch.Tensor:
    """Entries the push loop pushes: bit e of vmask set and e != emin."""
    e = torch.arange(8, device=vmask.device)
    ok = (((vmask[..., None] >> e) & 1) == 1) & (e != emin[..., None])
    return ok.to(torch.int64).sum(-1)


def sp_chain(sp0: int, counts: torch.Tensor) -> torch.Tensor:
    """The push loop's stack pointer over successive pushes: step k reads
    sp, pushes counts[k] entries and stores (sp + counts[k]) % 200 (floor
    modulo). Returns each step's sp + counts[k] before the modulo (int64
    holding int32 values). Step 0 starts from the scratch's sp0; after it
    sp stays in [0, 200), so later steps are a cumulative sum modulo 200."""
    v = torch.empty_like(counts)
    if counts.numel() == 0:
        return v
    v0 = _common.wrap32(counts[0] + sp0).to(torch.int64)
    v[0] = v0
    rest = counts[1:]
    sp = (v0 % 200 + torch.cumsum(rest, 0) - rest) % 200
    v[1:] = sp + rest
    return v
