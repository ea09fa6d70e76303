"""PNG decoding with NumPy and the standard library's zlib — the PNG half of
``utils/image_io.load_image``.

Every color type (gray, RGB, palette, gray+alpha, RGBA), bit depths 1, 2, 4
and 8 (16 where PIL keeps the samples, see ``decode_png``), the five row
filters, Adam7 interlace and any number of IDAT chunks. Samples come out as
PIL's decoder gives them in the mode ``load_image`` converts to: gray stays
one channel, modes with alpha become RGBA, everything else RGB.

Filters: a row with filter None, Sub or Up is reconstructed with whole-row
array operations (Sub a cumulative sum per channel, mod 256). Average and
Paeth read the reconstructed pixel to their left, so an image that has such
rows is reconstructed along anti-diagonals: every pixel depends only on its
left, upper and upper-left neighbours, which lie on the two diagonals before
it, so one step reconstructs a whole diagonal of every row at once (W + H − 1
steps, the channels and rows vectorised).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type → samples a pixel
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes):
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if pos + 12 + length > len(data):
            raise ValueError("PNG ends inside a chunk")
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Reconstruct (height, row_bytes) bytes from the filtered rows (each led
    by its filter type byte); ``bpp`` is the filter's pixel stride."""
    rows = raw[: height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    ftype = rows[:, 0].astype(np.int64)
    filt = rows[:, 1:].astype(np.int64)
    if int(ftype.max(initial=0)) > 4:
        raise ValueError(f"PNG: unknown filter type {int(ftype.max())}")
    width = row_bytes // bpp  # whole pixels; bpp divides row_bytes (sub-byte depths filter bytewise)
    f = filt.reshape(height, width, bpp)
    if not ((ftype == 3) | (ftype == 4)).any():
        out = np.empty_like(f)
        prev = np.zeros((width, bpp), np.int64)
        for y in range(height):
            t = int(ftype[y])
            if t == 0:
                cur = f[y]
            elif t == 1:
                cur = np.cumsum(f[y], axis=0) & 0xFF
            else:
                cur = (f[y] + prev) & 0xFF
            out[y] = prev = cur
        return out.reshape(height, row_bytes).astype(np.uint8)
    # Anti-diagonal wavefront over a grid padded with a zero row above and a zero column at the left.
    rec = np.zeros((height + 1, width + 1, bpp), np.int64)
    for t in range(width + height - 1):
        y = np.arange(max(0, t - width + 1), min(height, t + 1))
        x = t - y
        a, b, c = rec[y + 1, x], rec[y, x + 1], rec[y, x]
        kind = ftype[y][:, None]
        pred = np.where(kind == 0, 0, np.where(kind == 1, a, np.where(kind == 2, b, np.where(
            kind == 3, (a + b) >> 1, _paeth(a, b, c)))))
        rec[y + 1, x + 1] = (f[y, x] + pred) & 0xFF
    return rec[1:, 1:].reshape(height, row_bytes).astype(np.uint8)


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """(h, row_bytes) reconstructed bytes → (h, width, channels) integer samples."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, : width * channels].reshape(h, width, channels)
    if depth == 16:
        be = rows[:, : width * channels * 2].reshape(h, width * channels, 2).astype(np.uint16)
        return ((be[..., 0] << 8) | be[..., 1]).reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    vals = np.zeros(bits.shape[:2], np.uint8)
    for i in range(depth):
        vals = (vals << 1) | bits[..., i]
    return vals[:, :width].reshape(h, width, 1)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, C) uint8 in ``load_image``'s modes: gray (C 1), RGB
    (C 3) or RGBA (C 4). As PIL: 1-bit gray becomes 0/255 RGB, 2- and 4-bit
    gray scale to 0-255 gray, a palette becomes RGB (its tRNS ignored, as
    PIL's conversion of mode P to RGB does), gray+alpha becomes RGBA; at 16
    bits RGB, RGBA and gray+alpha keep each sample's high byte and 16-bit
    gray is clipped to 255 (PIL's I;16 → RGB)."""
    ihdr, plte, idat = None, None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG has no IHDR")
    width, height, depth, ctype, comp, filt_method, interlace = ihdr
    if ctype not in CHANNELS or comp != 0 or filt_method != 0 or interlace not in (0, 1):
        raise ValueError(f"PNG: unsupported header {ihdr}")
    if depth not in ((1, 2, 4, 8, 16) if ctype == 0 else (1, 2, 4, 8) if ctype == 3 else (8, 16)):
        raise ValueError(f"PNG: bit depth {depth} is invalid for color type {ctype}")
    channels = CHANNELS[ctype]
    bits_pp = channels * depth
    bpp = max(1, bits_pp // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)

    def pass_image(w, h, offset):
        row_bytes = (w * bits_pp + 7) // 8
        rows = _unfilter(raw[offset:], h, row_bytes, bpp)
        return _samples(rows, w, channels, depth), offset + h * (row_bytes + 1)

    if interlace == 0:
        img, _ = pass_image(width, height, 0)
    else:
        img = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
        offset = 0
        for x0, y0, dx, dy in ADAM7:
            w = (width - x0 + dx - 1) // dx if width > x0 else 0
            h = (height - y0 + dy - 1) // dy if height > y0 else 0
            if w == 0 or h == 0:
                continue
            sub, offset = pass_image(w, h, offset)
            img[y0::dy, x0::dx] = sub
    return _to_mode(img, ctype, depth, plte)


def _to_mode(img: np.ndarray, ctype: int, depth: int, plte) -> np.ndarray:
    if ctype == 3:
        if plte is None:
            raise ValueError("PNG: palette image without PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[: len(plte)] = plte
        return pal[img[..., 0]]
    if depth == 16:
        if ctype == 0:  # PIL's I;16 → RGB clips
            g = np.minimum(img, 255).astype(np.uint8)
            return np.repeat(g, 3, axis=-1)
        img = (img >> 8).astype(np.uint8)
    if ctype == 0:
        if depth == 1:
            return np.repeat(img * np.uint8(255), 3, axis=-1)
        return img * np.uint8({2: 85, 4: 17, 8: 1}[depth])
    if ctype == 4:
        return np.concatenate([img[..., :1], img[..., :1], img[..., :1], img[..., 1:]], axis=-1)
    return img
