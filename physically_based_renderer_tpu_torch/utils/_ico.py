"""ICO (Windows icon) decoding with NumPy — the ``.ico`` part of
``utils/image_io.load_image``, bit for bit what PIL's ``IcoImagePlugin``
gives under the JAX package's mode rules.

The directory: 16-byte entries (width and height, 0 meaning 256; colour
count; planes; bits a pixel; byte size; offset). PIL's choice of entry: the
entries sorted by colour depth (the bits a pixel, else log2 of the colour
count rounded up, else 256), then — stably — by area, largest first; the
first one is read. An entry whose data starts with the PNG signature is a
PNG file (``utils/_png.py``), whatever its directory size says. Any other
entry is a DIB: a BMP without its 14-byte file header, whose height counts
the colour (XOR) bitmap and the 1-bit AND mask together. PIL reads the top
half of that height as the image (``utils/_bmp.py``: 1-, 4-, 8-, 16-, 24- and
32-bit, its palette and gray-palette rules), then its alpha:

  * where the directory says 32 bits, every fourth byte from the colour
    bitmap's start, rows bottom-up (PIL's DIB reader ignores that byte, so
    the icon code reads it again);
  * otherwise the AND mask, read from the END of the entry (its byte
    size minus the mask's rows padded to 32 bits), rows bottom-up, bit 1
    transparent (alpha 0), bit 0 opaque (255).

Such entries come out RGBA (C 4); PNG entries follow ``load_image``'s PNG
rules. Files PIL refuses raise ``ValueError``.
"""

from __future__ import annotations

import math
import struct

import numpy as np

SIGNATURE = b"\0\0\1\0"


def looks_like_ico(data: bytes) -> bool:
    """PIL's signature and a directory it can read: where its entries run
    past the end of the file, or there are none, PIL's ICO plugin fails with
    an error that makes ``Image.open`` try the next plugin (TGA)."""
    if not data.startswith(SIGNATURE) or len(data) < 6:
        return False
    (count,) = struct.unpack_from("<H", data, 4)
    return 0 < count and 6 + 16 * count <= len(data)


def _entries(data: bytes) -> list[dict]:
    (count,) = struct.unpack_from("<H", data, 4)
    entries = []
    for i in range(count):
        raw = data[6 + 16 * i:22 + 16 * i]
        w, h, colors = raw[0] or 256, raw[1] or 256, raw[2]
        bpp, size, offset = struct.unpack_from("<HII", raw, 6)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append(dict(width=w, height=h, bpp=bpp, size=size, offset=offset, depth=depth))
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["width"] * e["height"], reverse=True)
    return entries


def decode_ico(data: bytes) -> np.ndarray:
    """ICO bytes → the chosen entry as (H, W, C) uint8."""
    from ._bmp import decode_bmp
    from ._png import SIGNATURE as PNG_SIGNATURE, decode_png

    if not looks_like_ico(data):
        raise ValueError("not an ICO file")
    entry = _entries(data)[0]
    at = entry["offset"]
    if data[at:at + 8] == PNG_SIGNATURE:
        return decode_png(data[at:])
    dib = data[at:]
    if len(dib) < 16:
        raise ValueError("ICO: the entry's bitmap is truncated")
    (header_size,) = struct.unpack_from("<I", dib, 0)
    if header_size == 12:
        width, full, bits = struct.unpack_from("<HH2xH", dib, 4)
        y_flip, colors, pad, bitfields = False, 0, 3, False
    elif header_size in (40, 52, 56, 64, 108, 124):
        if len(dib) < 36:
            raise ValueError("ICO: the entry's bitmap header is truncated")
        width, full, bits, compression, colors = struct.unpack_from("<Ii2xHI12xI", dib, 4)
        y_flip = full < 0
        full = 2**32 + full if y_flip else full
        pad, bitfields = 4, compression == 3 and header_size == 40
    else:
        raise ValueError(f"ICO: unsupported bitmap header size {header_size}, which PIL does not read either")
    height = int(full / 2)
    if (bits == 4 and width > ((width * 4 + 31) >> 3 & ~3)
            and all(dib[header_size + pad * i:header_size + pad * i + 3] == bytes([i] * 3) for i in range(colors or 16))):
        # PIL reads a 4-bit gray palette's pixels as 8-bit gray, and from a file object (no memory map) its
        # raw decoder refuses rows longer than their stride
        raise ValueError("ICO: a 4-bit gray-palette bitmap wider than its row stride, which PIL does not read either "
                         "(codec configuration error)")
    # PIL's DIB reader: the pixels start where its reads end (the header, a
    # 40-byte header's three bitfield masks, the palette below 9 bits)
    pixels = header_size + 12 * bitfields + (pad * (colors or 1 << bits) if bits <= 8 else 0)
    half = struct.pack("<i", -height if y_flip else height)
    head = dib[:header_size]
    head = head[:4] + struct.pack("<HH", width, height) + head[8:] if header_size == 12 else head[:8] + half + head[12:]
    bmp = b"BM" + struct.pack("<IHHI", 14 + len(dib), 0, 0, 14 + pixels) + head + dib[header_size:]
    rgb = decode_bmp(bmp)
    if rgb.shape[-1] == 1:
        rgb = np.repeat(rgb, 3, -1)
    if entry["bpp"] == 32:  # PIL asks the directory, not the bitmap header
        alpha = np.frombuffer(dib, np.uint8, width * height * 4, pixels)[3::4] if len(dib) >= pixels + (
            width * height * 4) else None
    else:
        stride = -(-width // 32) * 4
        total = int(stride * 8 * height / 8)
        mask_at = at + entry["size"] - total
        mask = data[mask_at:mask_at + total] if mask_at >= 0 else b""
        if len(mask) < total:
            alpha = None
        else:
            bits_ = np.unpackbits(np.frombuffer(mask, np.uint8).reshape(height, stride), axis=1)[:, :width]
            alpha = np.where(bits_ == 0, 255, 0).astype(np.uint8)
    if alpha is None:
        raise ValueError("ICO: the alpha or AND mask runs past the end of the file (PIL: not enough data)")
    alpha = alpha.reshape(height, width)[::-1]
    return np.concatenate([rgb[..., :3], alpha[..., None]], -1)
