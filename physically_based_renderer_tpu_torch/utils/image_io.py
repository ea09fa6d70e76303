"""Image IO — the counterpart of ``load_hdr`` and ``save_png`` in
``physically_based_renderer_tpu/utils/image_io.py``, written with NumPy and
the standard library's zlib so it needs no imaging package, and
``find_asset_root``. (LDR image decode, ``load_image``, needs a JPEG/PNG
decoder and waits for a later PR: ROADMAP item 9.)"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def load_hdr(path: str) -> np.ndarray:
    """Decode a Radiance RGBE (.hdr) file → (H, W, 3) float32 linear radiance
    (header, flat or adaptive-RLE scanlines; the sIBL ``*_Env.hdr`` format)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = 0
    exposure = 1.0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line.startswith(b"EXPOSURE="):
            exposure *= float(line.split(b"=", 1)[1])
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].split()
    pos = eol + 1
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {dims!r}")
    height, width = int(dims[1]), int(dims[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.zeros((height, width, 4), np.uint8)
    off = 0
    for y in range(height):
        if (8 <= width < 32768 and off + 4 <= len(buf) and buf[off] == 2 and buf[off + 1] == 2
                and ((int(buf[off + 2]) << 8) | int(buf[off + 3])) == width):
            off += 4  # adaptive RLE: the 4 components stored one after another
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[off])
                    off += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = buf[off]
                        off += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = buf[off : off + count]
                        off += count
                        x += count
        else:
            row = buf[off : off + width * 4].reshape(width, 4)
            if ((row[:, 0] == 1) & (row[:, 1] == 1) & (row[:, 2] == 1)).any():
                raise NotImplementedError("old-style RLE HDR not supported")
            rgbe[y] = row
            off += width * 4

    mant = rgbe[..., :3].astype(np.float32)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    out = mant * scale[..., None]
    # FreeImage writes a bogus EXPOSURE=0 header (Chelsea_Stairs_Env.hdr):
    # only a meaningful positive exposure rescales.
    if exposure > 0.0 and exposure != 1.0:
        out /= exposure
    return out


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


def find_asset_root() -> str | None:
    """The reference asset tree, if one is present: ``$PBR_ASSETS``, else an
    ``Assets`` directory at the repository root."""
    for cand in (
        os.environ.get("PBR_ASSETS", ""),
        os.path.join(os.path.dirname(__file__), "..", "..", "Assets"),
    ):
        if cand and os.path.isdir(cand):
            return os.path.abspath(cand)
    return None
