"""A PNG writer over the standard library's ``zlib``: the port's counterpart of
``cv2.imwrite(".png")``, for a machine without OpenCV, PIL or libpng.

The files differ from OpenCV's in their bytes (other filter choices, another zlib level)
and decode to the same pixels (``data/dataset.py::decode_image``, ``cv2.imread``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["png_bytes", "rgb_png"]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def png_bytes(
    raw_rows: np.ndarray, color: int, palette: "bytes | None" = None, *, level: int = 6, filters: str = "cycle"
) -> bytes:
    """An 8-bit PNG of the unfiltered scanlines ``raw_rows`` ([H, W * channels] uint8) of
    color type ``color`` (0 gray, 2 RGB, 3 palette, 6 RGBA), deflated at ``level``.
    ``filters="cycle"`` filters row ``y`` with type ``y % 5``, so every filter type 0-4
    occurs; ``"sub"`` filters every row with type 1, the cheapest that compresses smooth
    images well."""
    h, n = raw_rows.shape
    bpp = {0: 1, 2: 3, 3: 1, 6: 4}[color]
    x = raw_rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    if filters == "sub":
        f = np.ones(h, np.int64)
        enc = ((x - a) % 256).astype(np.uint8)
    elif filters == "cycle":
        b, c = np.zeros_like(x), np.zeros_like(x)
        b[1:], c[1:, bpp:] = x[:-1], x[:-1, :-bpp]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        preds = np.stack([np.zeros_like(x), a, b, (a + b) // 2, paeth])
        f = np.arange(h) % 5
        enc = ((x - preds[f, np.arange(h)]) % 256).astype(np.uint8)
    else:
        raise ValueError(f"filters must be 'cycle' or 'sub', got {filters!r}")
    stream = np.concatenate([f[:, None].astype(np.uint8), enc], 1).tobytes()
    header = struct.pack(">IIBBBBB", n // bpp, h, 8, color, 0, 0, 0)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    return out + _chunk(b"IDAT", zlib.compress(stream, level)) + _chunk(b"IEND", b"")


def rgb_png(rgb: np.ndarray, *, level: int = 6, filters: str = "cycle") -> bytes:
    """An RGB uint8 HWC image as an 8-bit RGB PNG (color type 2)."""
    h, w, _ = rgb.shape
    return png_bytes(np.ascontiguousarray(rgb, np.uint8).reshape(h, w * 3), 2, level=level, filters=filters)
