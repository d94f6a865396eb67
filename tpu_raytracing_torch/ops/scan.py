"""Segmented scan.

Port of ``tpu_raytracing/ops/scan.py:segmented_scan``. The reference runs
``lax.associative_scan``, a fixed recursion: combine adjacent pairs, scan
the halves, combine the odd results into the even elements, then
interleave the two halves by padding each with zeros and adding them. The
port runs the same recursion in the same order, so a float ``torch.add``
sums in the reference's order, and the interleave is a ``+ 0`` on every
element, which turns -0.0 into +0.0 as the reference's does. Flags
interleave by or.
"""

from __future__ import annotations

import torch


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a at the even positions, b at the odd ones; floats plus 0 as the
    reference's padded add."""
    out = torch.empty((a.shape[0] + b.shape[0],) + a.shape[1:], dtype=a.dtype, device=a.device)
    out[0::2] = a
    out[1::2] = b
    return out if out.dtype == torch.bool else out + 0


def _associative_scan(fn, elems):
    """``lax.associative_scan(fn, elems)`` along axis 0 for a tuple of
    tensors."""
    num = elems[0].shape[0]
    if num < 2:
        return elems
    odd = _associative_scan(fn, fn(tuple(e[0:-1:2] for e in elems),
                                   tuple(e[1::2] for e in elems)))
    if num % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def segmented_scan(values: torch.Tensor, seg_start: torch.Tensor, combine,
                   reverse: bool = False) -> torch.Tensor:
    """Inclusive segmented scan along axis 0.

    values [N, ...]; seg_start [N] bool, True where a segment begins (with
    ``reverse``, where a segment ends). ``combine`` is an associative
    elementwise op (``torch.minimum``, ``torch.maximum``, ``torch.add``).
    """
    if reverse:
        values, seg_start = values.flip(0), seg_start.flip(0)
    flags = seg_start.reshape(seg_start.shape[0], *([1] * (values.dim() - 1)))

    def op(a, b):
        af, av = a
        bf, bv = b
        return af | bf, torch.where(bf, bv, combine(av, bv))

    _, out = _associative_scan(op, (flags, values))
    return out.flip(0) if reverse else out
