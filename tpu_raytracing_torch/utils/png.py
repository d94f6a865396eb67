"""PNG framebuffer dump/read (numpy only).

A verbatim copy of the JAX package's ``tpu_raytracing/utils/png.py``
(``write_png``, ``read_png``): the module imports no JAX, but its package
``__init__`` chain does, so the port keeps its own copy. Frames are read
back to host RGBA8 arrays and written as PNGs.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, image: np.ndarray) -> None:
    """Write [H, W, 3|4] uint8 as a PNG (pure zlib, no deps)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)
    h, w, c = image.shape
    color_type = {3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + image[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n")
        fp.write(chunk(b"IHDR", ihdr))
        fp.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fp.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG to [H, W, 4] uint8.

    Pure-Python decoder (zlib inflate + scanline unfilter) so textures
    decode with NO optional dependencies — the reference vendors
    stb_image (src/FileIO.cpp:167-184) and therefore can always decode;
    a PIL-only path would silently corrupt every texture on a box
    without PIL. Supports the baseline non-interlaced cases stb covers
    for PNGs: bit depth 8/16 (16 truncated to high byte), color types
    0/2/3/4/6, tRNS-extended palettes.
    """
    with open(path, "rb") as fp:
        data = fp.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    palette = trns = None
    w = h = depth = ctype = interlace = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if w is None:
        raise ValueError(f"{path}: missing IHDR")
    if interlace:
        raise ValueError(f"{path}: Adam7 interlacing not supported")
    if depth not in (8, 16) or ctype not in (0, 2, 3, 4, 6):
        raise ValueError(
            f"{path}: unsupported PNG (depth {depth}, color type {ctype})")
    nchan = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = nchan * (depth // 8)          # filter unit, bytes per pixel
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < (stride + 1) * h:
        raise ValueError(f"{path}: truncated PNG data")

    # unfilter scanline by scanline (filters reference the row above)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros((stride,), np.int32)
    for row in range(h):
        base = row * (stride + 1)
        ftype = raw[base]
        line = np.frombuffer(raw[base + 1:base + 1 + stride],
                             np.uint8).astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:                # Up
            cur = (line + prev) & 0xFF
        else:                           # Sub/Average/Paeth need left pixel
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if ftype == 1:
                    cur[i] = (cur[i] + a) & 0xFF
                elif ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                elif ftype == 4:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pr = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                    cur[i] = (cur[i] + pr) & 0xFF
                else:
                    raise ValueError(f"{path}: bad filter {ftype}")
        out[row] = cur.astype(np.uint8)
        prev = cur

    px = out.reshape(h, w, bpp)
    if depth == 16:
        px = px.reshape(h, w, nchan, 2)[:, :, :, 0]  # high byte
    else:
        px = px.reshape(h, w, nchan)
    rgba = np.empty((h, w, 4), np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        idx = px[:, :, 0]
        rgba[:, :, :3] = palette[idx]
        if trns is not None:
            alpha = np.full((palette.shape[0],), 255, np.uint8)
            alpha[:trns.shape[0]] = trns
            rgba[:, :, 3] = alpha[idx]
        else:
            rgba[:, :, 3] = 255
    elif ctype == 0:
        rgba[:, :, :3] = px
        rgba[:, :, 3] = 255
    elif ctype == 2:
        rgba[:, :, :3] = px
        rgba[:, :, 3] = 255
    elif ctype == 4:
        rgba[:, :, :3] = px[:, :, :1]
        rgba[:, :, 3] = px[:, :, 1]
    else:  # 6
        rgba[:] = px
    return rgba
