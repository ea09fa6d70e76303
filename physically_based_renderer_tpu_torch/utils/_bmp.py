"""BMP (Windows bitmap) decoding with NumPy — the ``.bmp`` part of
``utils/image_io.load_image``, bit for bit what PIL's ``BmpImagePlugin``
gives under the JAX package's mode rules.

OS/2 (12-byte) and Windows v3-v5 headers (40, 52, 56, 64, 108, 124 bytes);
1-, 4- and 8-bit palettes, 16-, 24- and 32-bit pixels; BI_RGB, BI_BITFIELDS
(the masks PIL knows: 5-6-5 and 5-5-5 at 16 bits, the byte orders it lists
at 32, alpha where the header carries an alpha mask), BI_RLE8 and BI_RLE4;
negative heights (top-down); rows padded to 4 bytes. PIL's rules are kept
where they are its own: a palette whose entries are exactly 0, 1, 2, … (or
0 and 255 for two colours) is dropped and the samples read as gray (or
1-bit), at 8 (or 1) bits a sample whatever the file's depth; a 16-bit
channel is c·255 // (2^bits − 1); BI_RGB at 32 bits ignores the fourth
byte, so an RGBA BMP reads back as RGB; an index past the palette is black;
the RLE decoder is ``BmpRleDecoder``'s, its reading of a delta escape
included. Gray stays one channel, 1-bit and palette images become RGB.
Files PIL refuses raise ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"BM"
HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)
# bits a pixel → PIL's mode and rawmode (BmpImagePlugin.BIT2MODE)
BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
            32: ("RGB", "BGRX")}
# BI_BITFIELDS: (bits, (r, g, b, a) masks) → rawmode; 16 and 24 bits match on r, g, b only
MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX", (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR", (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA", (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR", (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR", (16, (0xF800, 0x7E0, 0x1F)): "BGR;16", (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "L": 8, "P": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}


def _u16(data: bytes, at: int) -> int:
    return struct.unpack_from("<H", data, at)[0]


def _u32(data: bytes, at: int) -> int:
    return struct.unpack_from("<I", data, at)[0]


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool) -> bytes:
    """One byte a pixel from BI_RLE8 / BI_RLE4 data at ``pos``, as PIL's
    ``BmpRleDecoder`` reads it: (count, value) pairs clipped to the row;
    escapes 0 (end of row, zero-filled), 1 (end of bitmap), 2 (delta: PIL
    skips the two bytes after the escape and takes right, up from the next
    two) and n ≥ 3 (n literal pixels, RLE4 reading n // 2 bytes, then a skip
    to an even file offset)."""
    out = bytearray()
    x = 0
    dest = width * height
    while len(out) < dest:
        if pos + 2 > len(data):
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > width:
                count = max(0, width - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of row
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta, as PIL reads it
            if pos + 2 > len(data):
                break
            if pos + 4 > len(data):
                raise ValueError("BMP: RLE delta past the end of the data")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * width)
            x = len(out) % width
        else:  # absolute run of `byte` pixels
            n_bytes = byte // 2 if rle4 else byte
            chunk = data[pos:pos + n_bytes]
            pos += len(chunk)
            if rle4:
                out += bytes(np.stack([np.frombuffer(chunk, np.uint8) >> 4,
                                       np.frombuffer(chunk, np.uint8) & 15], axis=-1).ravel())
            else:
                out += chunk
            if len(chunk) < n_bytes:
                break
            x += byte
            if pos % 2:  # align to a 16-bit word of the file
                pos += 1
    if len(out) < dest:
        raise ValueError("BMP: RLE data ends before the image does (PIL: not enough image data)")
    return bytes(out[:dest])


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes → (H, W, 1) uint8 gray, (H, W, 3) RGB or (H, W, 4) RGBA."""
    if not data.startswith(SIGNATURE) or len(data) < 18:
        raise ValueError("not a BMP file")
    offset = _u32(data, 10)
    header_size = _u32(data, 14)
    if header_size not in HEADER_SIZES:
        raise ValueError(f"BMP: unsupported header size {header_size}, which PIL does not read either")
    head = data[18:14 + header_size]
    if len(head) < header_size - 4:
        raise ValueError("BMP: the header is truncated")
    pos = 14 + header_size  # where a palette (or a v3 header's masks) follows
    top_down = False
    if header_size == 12:
        width, height, bits = _u16(head, 0), _u16(head, 2), _u16(head, 6)
        compression, colors, entry = 0, 0, 3
    else:
        top_down = head[7] == 0xFF
        width = _u32(head, 0)
        height = 2**32 - _u32(head, 4) if top_down else _u32(head, 4)
        bits, compression, colors = _u16(head, 10), _u32(head, 12), _u32(head, 28)
        entry = 4
    if not (0 < width < 2**31 and 0 < height < 2**31):
        raise ValueError(f"BMP: a {width}x{height} image")
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in BIT2MODE:
        raise ValueError(f"BMP: unsupported pixel depth {bits}, which PIL does not read either")
    mode, rawmode = BIT2MODE[bits]
    rle = False
    if compression == 3:  # BI_BITFIELDS
        if len(head) >= 48:
            masks = struct.unpack_from("<III", head, 36) + ((_u32(head, 48),) if len(head) >= 52 else (0,))
        else:
            masks = struct.unpack_from("<III", data, pos) + (0,)
        key = (bits, masks) if bits == 32 else (bits, masks[:3])
        if key not in MASK_MODES:
            raise ValueError(f"BMP: bitfields {masks} at {bits} bits, which PIL does not read either")
        rawmode = MASK_MODES[key]
        if bits == 32 and "A" in rawmode:
            mode = "RGBA"
    elif compression in (1, 2):  # BI_RLE8, BI_RLE4
        rle = True
    elif compression != 0:
        raise ValueError(f"BMP: compression {compression}, which PIL does not read either")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP: a palette of {colors} colours")
        raw = data[pos:pos + entry * colors]
        levels = (0, 255) if colors == 2 else range(colors)
        if all(raw[i * entry:i * entry + 3] == bytes([v & 255] * 3) for i, v in enumerate(levels)):
            mode = rawmode = "1" if colors == 2 else "L"  # PIL drops a gray palette
        else:
            if len(raw) // entry > 256:
                raise ValueError("BMP: a palette of more than 256 colours (PIL: invalid palette size)")
            entries = np.frombuffer(raw[:len(raw) // entry * entry], np.uint8).reshape(-1, entry)
            palette = np.zeros((256, 3), np.uint8)
            palette[:len(entries)] = entries[:, 2::-1]
    if rle:
        if mode not in ("P", "L"):
            raise ValueError(f"BMP: RLE into a {mode} image, which PIL cannot decode")
        rows = np.frombuffer(_rle(data, offset, width, height, compression == 2), np.uint8).reshape(height, width)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        row_bytes = (width * RAW_BITS.get(rawmode, 32) + 7) // 8
        if row_bytes > stride:
            # A gray palette below 8 bits read as 8-bit gray. PIL maps the file
            # (ImageFile.load's mmap of a "raw" tile) and reads each row's
            # bytes from its stride-spaced start, as zeros past the file's end.
            if offset + stride * height > len(data):
                raise ValueError("BMP: the pixel data is truncated")
            raw = data[offset:] + bytes(row_bytes)
            rows = np.stack([np.frombuffer(raw, np.uint8, row_bytes, r * stride) for r in range(height)])
        else:
            need = stride * (height - 1) + row_bytes
            raw = data[offset:offset + need]
            if len(raw) < need:
                raise ValueError("BMP: the pixel data is truncated")
            rows = np.frombuffer(raw + bytes(stride - row_bytes), np.uint8).reshape(height, stride)[:, :row_bytes]
        if rawmode in ("1", "P;1", "P;4"):
            b = RAW_BITS[rawmode]
            rows = np.unpackbits(rows, axis=1).reshape(height, -1, b)[:, :width]
            rows = (rows << np.arange(b - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
    if not top_down:
        rows = rows[::-1]
    if mode == "P":
        return np.ascontiguousarray(palette[rows])
    if mode == "L":
        return np.ascontiguousarray(rows[..., None])
    if mode == "1":
        return np.repeat((rows * 255)[..., None], 3, axis=-1)
    if rawmode in ("BGR;15", "BGR;16"):
        v = rows.reshape(height, width, 2)
        v = v[..., 0].astype(np.int64) | v[..., 1].astype(np.int64) << 8
        if rawmode == "BGR;16":
            rgb = [((v >> 11) & 31) * 255 // 31, ((v >> 5) & 63) * 255 // 63, (v & 31) * 255 // 31]
        else:
            rgb = [((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31, (v & 31) * 255 // 31]
        return np.stack(rgb, axis=-1).astype(np.uint8)
    px = rows.reshape(height, width, -1)  # one byte a letter of the rawmode
    return np.ascontiguousarray(px[..., [rawmode.index(ch) for ch in mode]])
