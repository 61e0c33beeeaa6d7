"""PNG writer and reader on the standard library (``zlib``, ``struct``) and
numpy.

The textured-mesh export writes its texture as a PNG and the metrics entry
point reads it back. The JAX package does both through Pillow
(``sugar_tpu/io/obj.py``); this module does the same without it, so the
export runs where Pillow is not installed. It adds no format: its files
decode to the same arrays as Pillow's, and it reads what Pillow writes.

- :func:`write_png`: 8-bit RGB (colour type 2) or RGBA (6), filter type
  0 on every row, one IDAT chunk.
- :func:`read_png`: 8-bit gray (colour type 0), RGB (2) and RGBA (6),
  non-interlaced, filter types 0-4, any number of IDAT chunks. Returns
  (H, W) for gray and (H, W, C) otherwise, uint8, as ``np.asarray`` of a
  Pillow image does.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W, 4) uint8 array as an 8-bit RGB or RGBA
    PNG."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"write_png takes an (H, W, 3) or (H, W, 4) uint8 array, got "
                         f"{img.dtype} {img.shape}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _row_sequential(line: np.ndarray, prev: np.ndarray, bpp: int, paeth: bool) -> np.ndarray:
    """Average (3) or Paeth (4) filter of one row: each byte depends on the
    decoded byte bpp to its left, so the row is walked byte by byte."""
    cur, up = bytearray(line.tobytes()), prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if paeth:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            pred = (a + b) >> 1
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG specification, section 9); raw is
    (h, 1 + stride)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(raw[y, 0]), raw[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum (mod 256) per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth
            cur = _row_sequential(line, prev, bpp, paeth=ftype == 4)
        else:
            raise ValueError(f"unknown PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit gray, RGB or RGBA PNG into a uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray, RGB or RGBA is read "
                         f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{path}: image data has {raw.size} bytes, expected {h * (1 + w * c)}")
    img = _unfilter(raw.reshape(h, 1 + w * c), h, w * c, c)
    return img.reshape(h, w) if c == 1 else img.reshape(h, w, c)
