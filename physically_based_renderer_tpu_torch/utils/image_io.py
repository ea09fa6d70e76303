"""PNG output — the counterpart of ``save_png`` in
``physically_based_renderer_tpu/utils/image_io.py``, written with NumPy and
the standard library's zlib so it needs no imaging package."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def save_png(path: str, img: np.ndarray) -> None:
    """Write an image to PNG. Accepts float [0,1] (H,W,3|4) or uint8."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]  # grey, RGB, RGBA

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
