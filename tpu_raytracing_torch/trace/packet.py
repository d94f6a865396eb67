"""Screen-tile ray orders and frame padding.

Port of the helpers of ``tpu_raytracing/trace/packet.py`` that the split
tracer uses: ``tile_permutation``, ``tile_reorder``, ``tile_restore``,
``pad_frame``, ``crop_frame`` and ``pad_live_mask``. The packet tracer
itself (``trace_rays_packet``) waits. On the card the split kernel runs one
thread per ray, so tile order keeps the rays of one warp on one compact
screen tile.
"""

from __future__ import annotations

import numpy as np
import torch


def tile_permutation(width: int, height: int, tile_w: int = 16, tile_h: int = 8):
    """(perm, inv_perm) numpy int32 arrays with rays_tiled = rays[perm],
    results_rowmajor = results_tiled[inv_perm]."""
    if width % tile_w or height % tile_h:
        raise ValueError(f"{width}x{height} does not tile by {tile_w}x{tile_h}")
    idx = np.arange(width * height, dtype=np.int32).reshape(height, width)
    tiles = idx.reshape(height // tile_h, tile_h, width // tile_w, tile_w)
    perm = tiles.transpose(0, 2, 1, 3).reshape(-1)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def tile_reorder(a: torch.Tensor, width: int, height: int, tile_w: int = 16,
                 tile_h: int = 8) -> torch.Tensor:
    """Row-major -> tile-major [H*W, ...]."""
    lead = a.shape[1:]
    x = a.reshape(height // tile_h, tile_h, width // tile_w, tile_w, *lead)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(lead)))
    return x.permute(*perm).reshape(width * height, *lead)


def tile_restore(a: torch.Tensor, width: int, height: int, tile_w: int = 16,
                 tile_h: int = 8) -> torch.Tensor:
    """Inverse of tile_reorder."""
    lead = a.shape[1:]
    x = a.reshape(height // tile_h, width // tile_w, tile_h, tile_w, *lead)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(lead)))
    return x.permute(*perm).reshape(width * height, *lead)


def pad_frame(a: torch.Tensor, width: int, height: int, pw: int, ph: int) -> torch.Tensor:
    """Row-major [H*W, ...] -> [ph*pw, ...] edge-replicated pad; pad rays
    stay geometrically valid and are masked dead by ``pad_live_mask``."""
    lead = a.shape[1:]
    x = a.reshape(height, width, *lead)
    rows = torch.arange(ph, device=a.device).clamp(max=height - 1)
    cols = torch.arange(pw, device=a.device).clamp(max=width - 1)
    return x[rows][:, cols].reshape(ph * pw, *lead)


def crop_frame(a: torch.Tensor, width: int, height: int, pw: int, ph: int) -> torch.Tensor:
    """Inverse of pad_frame: [ph*pw, ...] -> row-major [H*W, ...]."""
    lead = a.shape[1:]
    x = a.reshape(ph, pw, *lead)
    return x[:height, :width].reshape(height * width, *lead)


def pad_live_mask(width: int, height: int, pw: int, ph: int, device=None) -> torch.Tensor:
    """[ph*pw] bool: True on the live (unpadded) pixel region."""
    row = torch.arange(ph, device=device)[:, None] < height
    col = torch.arange(pw, device=device)[None, :] < width
    return (row & col).reshape(ph * pw)
