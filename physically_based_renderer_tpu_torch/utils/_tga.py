"""TGA (Truevision Targa) decoding with NumPy — the ``.tga`` part of
``utils/image_io.load_image``, bit for bit what PIL's ``TgaImagePlugin``
gives under the JAX package's mode rules.

Image types 1 (colour-mapped), 2 (true colour) and 3 (gray), raw or RLE (9,
10, 11); 1-, 8-, 16-, 24- and 32-bit pixels; colour maps of 16 and 24 bits;
bottom-up or top-down rows, and the right-to-left bit. PIL's rules are
kept where they are its own: a 16-bit true-colour pixel is 5-5-5 with
channel·255 // 31 and an inverted attribute bit for alpha (rawmode
``BGRA;15Z``); a colour map starts ``start`` zero entries in; an index past
the map is black; an RLE literal packet may run on into the next row, a run
packet may not. A gray image stays one channel, gray with alpha becomes
RGBA, colour-mapped and 1-bit images become RGB. Headers PIL refuses, and
files it opens but cannot decode (a 32-bit colour map, a colour map on a
1-bit or true-colour image, a 1-bit RLE image), raise ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

HEADER = 18
MAP_BYTES = {16: 2, 24: 3, 32: 4}
# (image type & 7, bits a pixel) → PIL's rawmode (TgaImagePlugin.MODES)
RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR",
            (2, 32): "BGRA"}


def looks_like_tga(data: bytes) -> bool:
    """The header checks of PIL's ``TgaImagePlugin._open`` (a TGA file has no
    signature): a colour-map type of 0 or 1, a known image type, a positive
    size, a pixel depth of 1, 8, 16, 24 or 32, and a known colour-map depth."""
    if len(data) < HEADER:
        return False
    cmap_type, image_type, depth = data[1], data[2], data[16]
    width, height = struct.unpack_from("<HH", data, 12)
    return (cmap_type in (0, 1) and image_type in (1, 2, 3, 9, 10, 11) and width > 0 and height > 0
            and depth in (1, 8, 16, 24, 32) and (not cmap_type or data[7] in MAP_BYTES))


def _rgb555(v: np.ndarray) -> np.ndarray:
    """16-bit little-endian 5-5-5 pixels → (…, 3) R, G, B as PIL scales them."""
    v = v.astype(np.int64)
    return (np.stack([(v >> 10) & 31, (v >> 5) & 31, v & 31], axis=-1) * 255 // 31).astype(np.uint8)


def _rle(data: bytes, pos: int, pixel_bytes: int, row_bytes: int, total: int) -> bytes:
    """``total`` bytes of RLE packets from ``pos`` (``TgaRleDecode.c``): a
    header byte with the top bit set repeats one pixel (count 1-128) and must
    end inside its row; otherwise it copies that many literal pixels, which
    may run into the next row."""
    out = bytearray()
    x = 0
    while len(out) < total:
        if pos >= len(data):
            raise ValueError("TGA: RLE data ends before the image does")
        head = data[pos]
        count = (head & 0x7F) + 1
        if head & 0x80:
            if x + count * pixel_bytes > row_bytes:
                raise ValueError("TGA: an RLE run crosses a row (PIL refuses it: buffer overrun)")
            pixel = data[pos + 1:pos + 1 + pixel_bytes]
            pos += 1 + pixel_bytes
            n = count * pixel_bytes
            out += pixel * count
        else:
            n = count * pixel_bytes
            out += data[pos + 1:pos + 1 + n]
            pos += 1 + n
        if pos > len(data):
            raise ValueError("TGA: RLE data ends before the image does")
        x = (x + n) % row_bytes
    return bytes(out[:total])


def decode_tga(data: bytes) -> np.ndarray:
    """TGA bytes → (H, W, 1) uint8 gray, (H, W, 3) RGB or (H, W, 4) RGBA."""
    if not looks_like_tga(data):
        raise ValueError("not a TGA file")
    id_len, cmap_type, image_type = data[0], data[1], data[2]
    map_start, map_len, map_depth = struct.unpack_from("<HHB", data, 3)
    width, height = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    kind = image_type & 7
    if kind == 3:
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif kind == 1:
        mode = "P" if cmap_type else "L"
    else:
        mode = "RGB" if depth == 24 else "RGBA"
    rawmode = RAWMODES.get((kind, depth))
    if rawmode is None or (kind == 1 and not cmap_type):
        raise ValueError(f"TGA: image type {image_type} at {depth} bits, which PIL cannot decode")
    pos = HEADER + id_len
    palette = None
    if cmap_type:
        size = MAP_BYTES[map_depth]
        raw = data[pos:pos + size * map_len]
        pos += size * map_len
        if map_depth == 32 or mode in ("1", "RGB", "RGBA"):
            raise ValueError(f"TGA: a {map_depth}-bit colour map on a {mode} image, which PIL cannot decode")
        if map_start + len(raw) // size > 256:
            raise ValueError("TGA: a colour map of more than 256 entries (PIL: invalid palette size)")
        entries = np.frombuffer(raw[:len(raw) // size * size], np.uint8).reshape(-1, size)
        if map_depth == 16:
            colours = _rgb555(entries[:, 0] | entries[:, 1].astype(np.uint16) << 8)
        else:
            colours = entries[:, 2::-1]
        palette = np.zeros((256, 3), np.uint8)  # entries before the start and past the map are black
        palette[map_start:map_start + len(colours)] = colours
    if depth == 1:
        row_bytes = (width + 7) // 8
    else:
        row_bytes = width * (depth // 8)
    total = row_bytes * height
    if image_type & 8:
        if depth == 1:
            raise ValueError("TGA: a 1-bit RLE image, which PIL cannot decode")
        raw = _rle(data, pos, depth // 8, row_bytes, total)
    else:
        raw = data[pos:pos + total]
        if len(raw) < total:
            raise ValueError("TGA: the pixel data is truncated")
    rows = np.frombuffer(raw, np.uint8).reshape(height, row_bytes)
    if not flags & 0x20:  # bottom-up
        rows = rows[::-1]
    if rawmode == "1":
        px = (np.unpackbits(rows, axis=1)[:, :width] * 255)[..., None]
    elif rawmode == "BGRA;15Z":
        v = rows.reshape(height, width, 2)
        v = v[..., 0] | v[..., 1].astype(np.uint16) << 8
        px = np.concatenate([_rgb555(v), np.where(v >> 15, 0, 255).astype(np.uint8)[..., None]], axis=-1)
    else:
        px = rows.reshape(height, width, -1)
        if rawmode == "BGR":
            px = px[..., ::-1]
        elif rawmode == "BGRA":
            px = px[..., [2, 1, 0, 3]]
    if flags & 0x10:  # right to left
        px = px[:, ::-1]
    if mode == "P":
        px = palette[px[..., 0]]
    elif mode == "1":
        px = np.repeat(px, 3, axis=-1)
    elif mode == "LA":  # PIL: gray + alpha → RGBA; a colour map, where there is one, maps the gray
        gray = palette[px[..., 0]] if palette is not None else np.repeat(px[..., :1], 3, axis=-1)
        px = np.concatenate([gray, px[..., 1:]], axis=-1)
    return np.ascontiguousarray(px, dtype=np.uint8)
