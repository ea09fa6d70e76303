"""GIF decoding with NumPy — the ``.gif`` part of ``utils/image_io.load_image``:
the first frame, bit for bit what PIL's ``GifImagePlugin`` gives when it
opens a file, under the JAX package's mode rules.

The logical screen and its global colour table; extensions skipped but for
the graphic-control extension's transparency index; the first image
descriptor, its local colour table and its interlace flag; the LZW data
(code sizes 2-12 as PIL accepts them, clear and end codes, the table
frozen at 4096 entries until the next clear; sizes 0 and 1, which the
format does not allow, as PIL's decoder reads them: ``_narrow_codes``). PIL's rules are kept where
they are its own: a colour table whose entries are exactly 0, 1, 2, … gray
is no palette, and the frame is gray (L); a local table decides alone, even
a gray one under a colour global table; the screen grows to hold an image
that passes its edge; pixels outside the image are the transparency index
where there is one, else 0; a palette frame becomes RGB through its table,
the transparency dropped, an index past the table black. Bytes PIL does
not read as a GIF frame raise ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURES = (b"GIF87a", b"GIF89a")


def lzw_codes_lsb(data: bytes, min_bits: int):
    """Decode GIF LZW (codes packed least significant bit first, widths
    growing after entry 2^w − 1 is made) → the decoded bytes, stopping at
    the end code or when the data runs out."""
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    total = 8 * len(data)
    data = bytes(data) + bytes(3)  # a code (≤ 12 bits at any bit offset) lies in the 3 bytes from its first
    pos = 0
    out = []
    table = [bytes([i & 0xFF]) for i in range(clear)] + [b"", b""]
    width, prev = min_bits + 1, None
    while pos + width <= total:
        code = (int.from_bytes(data[pos >> 3:(pos >> 3) + 3], "little") >> (pos & 7)) & ((1 << width) - 1)
        pos += width
        if code == clear:
            del table[end + 1:]
            width, prev = min_bits + 1, None
            continue
        if code == end:
            break
        if prev is None:
            if code >= len(table):
                raise ValueError("GIF: an LZW code past the table")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError("GIF: an LZW code past the table")
            if len(table) < 4096:
                table.append(prev + entry[:1])
        out.append(entry)
        prev = entry
        if len(table) >= 1 << width and width < 12:
            width += 1
    return b"".join(out)


def _narrow_codes(data: bytes, min_bits: int) -> np.ndarray:
    """PIL's GIF decoder at an LZW code size of 0 or 1, which the format does
    not allow: its codes (1 or 2 bits, least significant first) never widen,
    as the table's first free entry already lies past their mask, so every
    code is a pixel, a clear (skipped) or, at size 1, the end."""
    width, clear = min_bits + 1, 1 << min_bits
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    codes = bits[:len(bits) // width * width].reshape(-1, width) @ (1 << np.arange(width))
    if min_bits == 1 and (codes == clear + 1).any():
        codes = codes[:np.argmax(codes == clear + 1)]
    return codes[codes < clear].astype(np.uint8)


def _sub_blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """The data sub-blocks from ``pos`` (a length byte, then that many
    bytes; a zero length ends them) → their bytes joined, and the position
    after the terminator."""
    parts = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if not n:
            break
        parts.append(data[pos:pos + n])
        pos += n
    return b"".join(parts), pos


def _palette(table: bytes) -> np.ndarray | None:
    """A colour table → (256, 3) uint8, or None when PIL drops it (its
    entries are exactly 0, 1, 2, … gray)."""
    n = len(table) // 3
    entries = np.frombuffer(table[:3 * n], np.uint8).reshape(n, 3)
    if (entries == np.arange(n)[:, None]).all():
        return None
    pal = np.zeros((256, 3), np.uint8)
    pal[:min(n, 256)] = entries[:256]
    return pal


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes → (H, W, 1) uint8 gray or (H, W, 3) RGB: the first frame."""
    if data[:6] not in SIGNATURES or len(data) < 13:
        raise ValueError("not a GIF file")
    width, height = struct.unpack_from("<HH", data, 6)
    flags = data[10]
    pos = 13
    global_palette = None
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        global_palette = _palette(data[pos:pos + size])
        pos += size
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:  # the trailer, or no image at all
            raise ValueError("GIF: no image in the file (PIL: image not found in GIF frame)")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # an extension: its label, then sub-blocks
            label = data[pos] if pos < len(data) else None
            pos += 1
            first = data[pos + 1:pos + 1 + data[pos]] if pos < len(data) and data[pos] else None
            if label == 0xF9 and first is not None:
                if len(first) < 4:
                    raise ValueError("GIF: a graphic-control extension of fewer than 4 bytes")
                if first[0] & 1:
                    transparency = first[3]
            _, pos = _sub_blocks(data, pos)
        elif kind == 0x2C:  # the image descriptor
            if pos + 9 > len(data):
                raise ValueError("GIF: the image descriptor is truncated")
            x0, y0, w, h, iflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            palette = global_palette
            if iflags & 0x80:
                size = 3 << ((iflags & 7) + 1)
                palette = _palette(data[pos:pos + size])
                pos += size
            break
        # any other byte is skipped, as PIL skips it
    if pos >= len(data):
        raise ValueError("GIF: the image data is missing")
    min_bits = data[pos]
    if min_bits >= 12:
        raise ValueError(f"GIF: an LZW code size of {min_bits}, whose codes pass 12 bits (PIL: broken data stream)")
    codes, _ = _sub_blocks(data, pos + 1)
    width, height = max(width, x0 + w), max(height, y0 + h)
    screen = np.full((height, width), 0 if transparency is None else transparency, np.uint8)
    pixels = (_narrow_codes(codes, min_bits) if min_bits < 2
              else np.frombuffer(lzw_codes_lsb(codes, min_bits), np.uint8))[:w * h]
    if len(pixels) < w * h or not (width and height):
        raise ValueError(f"GIF: {len(pixels)} pixels decoded for a {w}x{h} image (PIL: image file is truncated)")
    rows = np.arange(h)
    if iflags & 0x40:  # interlaced: rows 0, 8, …; 4, 12, …; 2, 6, …; 1, 3, …
        rows = np.concatenate([rows[0::8], rows[4::8], rows[2::4], rows[1::2]])
    full, rest = divmod(len(pixels), w) if w else (0, 0)
    if full:
        screen[y0 + rows[:full], x0:x0 + w] = pixels[:full * w].reshape(full, w)
    if rest:
        screen[y0 + rows[full], x0:x0 + rest] = pixels[full * w:]
    if palette is None:
        return screen[..., None]
    return np.ascontiguousarray(palette[screen])
