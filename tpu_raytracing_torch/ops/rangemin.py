"""Two-tier sparse range-min tables (channel-major), and order-preserving
int32 keys for float32.

Port of ``tpu_raytracing/ops/rangemin.py`` (``RANGE_K0``,
``build_range_min``, ``range_min_query``): ~K0 dense shifted-min passes plus
a coarse block tier, and each range query a handful of gathers. Negate
channels to get a range-max.

The table holds ``ordered_key``s of the values, so every min is an integer
min. XLA's float min orders -0.0 below +0.0, and torch's float min picks
either; the integer min over the keys orders them as XLA does, in any
order of evaluation and on any device. Queries return floats.
"""

from __future__ import annotations

import math

import torch

_F32_MAX = float(torch.finfo(torch.float32).max)

# Fine-tier depth: ranges shorter than 2^(K0-1) resolve from the fine
# tier alone; longer ones combine two fine edges with the coarse tier.
RANGE_K0 = 10


def ordered_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 key with the float's order (-0.0 below +0.0; NaN is
    not ordered). The map is its own inverse on the bits: see ``from_key``."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def from_key(k: torch.Tensor) -> torch.Tensor:
    """Inverse of ``ordered_key``."""
    return torch.where(k < 0, k ^ 0x7FFFFFFF, k).contiguous().view(torch.float32)


def ilog2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for integer x >= 1 (the reference's ``31 - clz(x)``),
    exact through ``frexp`` on float64."""
    return torch.frexp(x.to(torch.float64))[1].to(torch.int64) - 1


def _levels(cur: torch.Tensor, count: int, width: int) -> torch.Tensor:
    """[count, C, width]: level k min-reduces [i, i + 2^k)."""
    pad = int(ordered_key(torch.tensor(_F32_MAX)))
    out = [cur]
    for kk in range(1, count):
        d = 1 << (kk - 1)
        if d < width:
            shifted = torch.cat(
                [cur[:, d:], torch.full((cur.shape[0], d), pad, dtype=torch.int32,
                                        device=cur.device)], dim=1)
            cur = torch.minimum(cur, shifted)
        out.append(cur)
    return torch.stack(out, dim=0)


def build_range_min(vals: torch.Tensor):
    """vals: [n, C] float32. Returns an opaque table for range_min_query:
    (fine [K0, C, n], coarse [Kc, C, nb] or None, block size) of keys."""
    n = vals.shape[0]
    base = ordered_key(vals).T.contiguous()  # [C, n]
    k_full = max(int(math.floor(math.log2(max(n, 1)))) + 1, 1)
    k0 = min(k_full, RANGE_K0)
    fine = _levels(base, k0, n)
    if k_full <= RANGE_K0:
        return fine, None, 0
    b = 1 << (k0 - 1)
    # fine[k0-1][:, i*b] min-reduces [i*b, i*b + b): exactly block i.
    blocks = fine[k0 - 1][:, ::b].contiguous()  # [C, nb]
    nb = blocks.shape[1]
    kc = max(int(math.floor(math.log2(max(nb, 1)))) + 1, 1)
    return fine, _levels(blocks, kc, nb), b


def range_min_query(tbl, start: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Per-query min over vals[start : start + count) -> [Q, C] float32.

    Empty (count <= 0) queries return +F32_MAX. Queries must lie within
    [0, n] (clipped defensively)."""
    fine, coarse, b = tbl
    k0, _, n = fine.shape
    start = start.to(torch.int64)
    count = count.to(torch.int64)
    ln = torch.clamp(count, min=1)
    klev = ilog2(ln)
    fine_k = torch.clamp(klev, max=k0 - 1)
    pa = start.clamp(0, n - 1)
    pb = (start + ln - (1 << fine_k)).clamp(0, n - 1)
    out = torch.minimum(fine[fine_k, :, pa], fine[fine_k, :, pb])  # [Q, C]
    if coarse is not None:
        kc, _, nb = coarse.shape
        pe = (start + ln - b).clamp(0, n - 1)
        ba = (start + b - 1) // b
        bb = (start + ln) // b
        lb = torch.clamp(bb - ba, min=1)
        kb = torch.clamp(ilog2(lb), max=kc - 1)
        ca = ba.clamp(0, nb - 1)
        cb = (bb - (1 << kb)).clamp(0, nb - 1)
        top = fine[k0 - 1].T  # [n, C]
        edge = torch.minimum(top[pa], top[pe])
        cmin = torch.minimum(coarse[kb, :, ca], coarse[kb, :, cb])
        use_fine = (klev <= (k0 - 1))[:, None]
        out = torch.where(use_fine, out, torch.minimum(edge, cmin))
    return torch.where((count > 0)[:, None], from_key(out), _F32_MAX)
