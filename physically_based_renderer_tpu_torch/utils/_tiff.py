"""TIFF decoding with NumPy and zlib — the ``.tif`` part of
``utils/image_io.load_image``, bit for bit what PIL's ``TiffImagePlugin``
gives for the first image of a file, under the JAX package's mode rules.

The container: both byte orders, classic and (little-endian, as PIL tells
them) BigTIFF headers, the first IFD; strips and tiles (edge tiles cropped); contiguous and separate planes;
fill order 2 (each byte's bits reversed). The sample layout is mapped to
PIL's (mode, rawmode) as ``TiffImagePlugin.OPEN_INFO`` maps it, and the
file decoded by PIL's own two paths:

  * uncompressed files by PIL's raw decoder: each strip or tile read from
    its offset (its byte count unused), the rows of an edge tile at the
    tile's stride; with separate planes, plane k read with the k-th letter
    of the rawmode, one byte a sample, as PIL reads it; no predictor;
  * every other compression by libtiff: PackBits, LZW (codes most
    significant bit first, widths one code early; and the old
    least-significant-first variant libtiff still reads) and Deflate, each
    strip or tile decoded to its full size from its byte count, then
    horizontal differencing (predictor 2) undone at 8, 16 and 32 bits and
    the floating-point predictor (3: byte planes, most significant first,
    differenced byte by byte) on float32, for LZW and Deflate; and JPEG
    (compression 7): each strip or tile its own SOI…EOI stream, read after
    the ``JPEGTables`` stream (``_jpeg.decode_abbreviated``), libtiff's
    checks on its size and sampling kept; YCbCr converted by libjpeg (PIL
    asks for ``JPEGCOLORMODE_RGB``), RGB and gray as stored.

Then PIL's unpacking and ``load_image``'s conversion: 1-bit (black- or
white-is-zero) and gray at 2, 4 and 8 bits (scaled ×85, ×17; inverted for
white-is-zero); 12- and 16-bit gray clipped to 255; signed 16-bit, 32-bit
and float gray as PIL's modes I and F through ``convert("RGB")`` (clipped;
floats truncated toward zero, NaN 0, +inf 255) — a big-endian file's
I;16BS, I;32BS and F;32BF samples come out byte-swapped through libtiff,
which hands PIL native-order samples that PIL reads big-endian; palettes
of 1-8 bits through the colour map's high bytes; RGB and RGBA (with unused
extra samples dropped) at 8 bits and at 16 (the high byte); associated
alpha (``RGBa``) divided out as ``Unpack.c`` does, c·255 // a clipped, 0
where a is 0; LA and PA; 8- and 16-bit CMYK through ``convert("RGB")``'s
rule (``utils/_jpeg.cmyk_to_rgb``); YCbCr that is not JPEG-compressed read
as PIL reads it: uncompressed by its raw decoder as RGBX (four file bytes a
pixel, no conversion), compressed through libtiff's RGBA interface
(``_ycbcr_rgba``). Gray stays one channel; 1-bit, 12- to 32-bit and float
gray, palette, YCbCr and CMYK become RGB; alpha makes RGBA.

Kinds PIL reads that the port does not yet — CCITT, LogLuv, the other
libtiff codecs, old-style JPEG but in one layout (``_old_jpeg``), CIELab,
rotated orientations, YCbCr in separate planes, a JPEG stream smaller than
its strip — raise
``NotImplementedError`` (ROADMAP item 17); files PIL refuses raise
``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ._jpeg import cmyk_to_rgb, decode_abbreviated, decode_raw_planes

SIGNATURES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")
PENDING = "is not supported by the port's decoder (ROADMAP item 17)"

# compression value → PIL's name (TiffImagePlugin.COMPRESSION_INFO); the
# port decodes 1, 5, 7, 8, 32773 and 32946, and 6 in one layout
# (``_old_jpeg``). 50001 is WebP-coded strips or tiles inside a TIFF:
# refused by this reader although ``utils/_webp.py`` reads WebP files
COMPRESSIONS = {1: "raw", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG",
                7: "JPEG", 8: "Deflate", 32771: "raw 16", 32773: "PackBits", 32809: "ThunderScan", 32946: "Deflate",
                34676: "SGI LogLuv", 34677: "SGI LogLuv24", 34925: "LZMA", 50000: "Zstd", 50001: "WebP-in-TIFF"}
DECODED = (1, 5, 6, 7, 8, 32773, 32946)

# (photometric, sample format, fill order, bits, extra samples) → (mode,
# rawmode): OPEN_INFO for both byte orders (its MM and II keys differ only
# in 16-bit gray, below), the rows the port decodes.
OPEN_INFO = {}
for _fill, _r in ((1, ""), (2, "R")):
    for _bits in (1, 2, 4, 8):
        _s = "" if _bits == 8 else f";{_bits}"
        if _bits == 1:
            OPEN_INFO[(0, (1,), _fill, (1,), ())] = ("1", "1;I" + _r)
            OPEN_INFO[(1, (1,), _fill, (1,), ())] = ("1", "1" + (";" + _r if _r else ""))
        else:
            OPEN_INFO[(0, (1,), _fill, (_bits,), ())] = ("L", f"L{_s or ';'}I{_r}")
            OPEN_INFO[(1, (1,), _fill, (_bits,), ())] = ("L", f"L{_s}" + (f";{_r}" if _r and not _s else _r))
        OPEN_INFO[(3, (1,), _fill, (_bits,), ())] = ("P", ("P" + _s + (";" + _r if _r and not _s else _r)))
OPEN_INFO[(1, (2,), 1, (8,), ())] = ("L", "L")
OPEN_INFO[(6, (1,), 1, (8,), ())] = ("L", "L")
OPEN_INFO[(6, (1,), 1, (8, 8, 8), ())] = ("RGB", "RGBX")  # PIL: JPEG gives RGB, libtiff's RGBA interface RGBX
OPEN_INFO[(2, (1,), 2, (8, 8, 8), ())] = ("RGB", "RGB;R")
OPEN_INFO[(1, (1,), 1, (8, 8), (2,))] = ("LA", "LA")
OPEN_INFO[(2, (1,), 1, (8, 8, 8), ())] = ("RGB", "RGB")
for _extra, _mode, _raw in (((), "RGBA", "RGBA"), ((0,), "RGB", "RGBX"), ((0, 0), "RGB", "RGBXX"),
                            ((0, 0, 0), "RGB", "RGBXXX"), ((1,), "RGBA", "RGBa"), ((1, 0), "RGBA", "RGBaX"),
                            ((1, 0, 0), "RGBA", "RGBaXX"), ((2,), "RGBA", "RGBA"), ((2, 0), "RGBA", "RGBAX"),
                            ((2, 0, 0), "RGBA", "RGBAXX"), ((999,), "RGBA", "RGBA")):
    OPEN_INFO[(2, (1,), 1, (8,) * (3 + len(_extra) + (not _extra)), _extra)] = (_mode, _raw)
for _extra, _mode, _raw in (((), "RGB", "RGB;16"), ((0,), "RGB", "RGBX;16"), ((1,), "RGBA", "RGBa;16"),
                            ((2,), "RGBA", "RGBA;16")):
    OPEN_INFO[(2, (1,), 1, (16,) * (3 + len(_extra)), _extra)] = (_mode, _raw)
OPEN_INFO[(2, (1,), 1, (16,) * 4, ())] = ("RGBA", "RGBA;16")
OPEN_INFO[(3, (1,), 1, (8, 8), (0,))] = ("P", "PX")
OPEN_INFO[(3, (1,), 1, (8, 8), (2,))] = ("PA", "PA")
for _extra, _raw in (((), "CMYK"), ((0,), "CMYKX"), ((0, 0), "CMYKXX")):
    OPEN_INFO[(5, (1,), 1, (8,) * (4 + len(_extra)), _extra)] = ("CMYK", _raw)
OPEN_INFO[(5, (1,), 1, (16,) * 4, ())] = ("CMYK", "CMYK;16")
# 16-bit gray: little-endian files only, but for photometric 1 (I;16B)
GRAY16 = {("<", 0, 1): ("I;16", "I;16"), ("<", 1, 1): ("I;16", "I;16"), (">", 1, 1): ("I;16B", "I;16B"),
          ("<", 1, 2): ("I;16", "I;16R")}
# the wider gray samples, by (byte order, photometric, sample format, fill
# order, bits): PIL's mode I (int32) or F (float32), and 12 bits as I;16
WIDE_GRAY = {("<", 1, (1,), 1, (12,)): ("I;16", "I;12"), ("<", 1, (2,), 1, (16,)): ("I", "I;16S"),
             (">", 1, (2,), 1, (16,)): ("I", "I;16BS"), ("<", 0, (3,), 1, (32,)): ("F", "F;32F"),
             (">", 0, (3,), 1, (32,)): ("F", "F;32BF"), ("<", 1, (1,), 1, (32,)): ("I", "I;32N"),
             ("<", 1, (2,), 1, (32,)): ("I", "I;32S"), (">", 1, (2,), 1, (32,)): ("I", "I;32BS"),
             ("<", 1, (3,), 1, (32,)): ("F", "F;32F"), (">", 1, (3,), 1, (32,)): ("F", "F;32BF")}
WIDE_DTYPES = {"I;16S": "i2", "I;16BS": "i2", "I;32N": "i4", "I;32S": "i4", "I;32BS": "i4", "F;32F": "f4",
               "F;32BF": "f4"}
# keys PIL reads that the port does not: (byte orders, photometric, sample
# format, fill order, bits, extra samples)
OPEN_INFO_PENDING = {("*", 8, (1,), 1, (8, 8, 8), ()): "CIELab"}

TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d",
         13: "I", 16: "Q", 17: "q", 18: "Q"}
# tags: width, length, bits, compression, photometric, fill order, strip
# offsets, orientation, samples, rows per strip, strip byte counts, planar
# configuration, predictor, colour map, tile width, length, offsets, byte
# counts, extra samples, sample format
(WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILLORDER, STRIPOFFSETS, ORIENTATION, SAMPLES, ROWSPERSTRIP,
 STRIPBYTECOUNTS, PLANAR, PREDICTOR, COLORMAP, TILEWIDTH, TILELENGTH, TILEOFFSETS, TILEBYTECOUNTS, EXTRASAMPLES,
 SAMPLEFORMAT) = (256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320, 322, 323, 324, 325, 338, 339)
# JPEGTables; YCbCrCoefficients, YCbCrSubsampling, ReferenceBlackWhite
JPEGTABLES, YCBCRCOEFFICIENTS, YCBCRSUBSAMPLING, REFERENCEBLACKWHITE = 347, 529, 530, 532
JPEGIFOFFSET, JPEGIFBYTECOUNT = 513, 514  # old-style JPEG's interchange-format stream
REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)  # each byte's bits reversed


def _ifd(data: bytes) -> tuple[str, dict]:
    """The byte order and the first IFD's tags (tag → tuple of values)."""
    order = "<" if data[:2] == b"II" else ">"
    big = data[2] == 0x2B  # PIL's test: a big-endian BigTIFF ("MM\0+") is read as a classic header
    try:
        if big:
            (at,) = struct.unpack_from(order + "Q", data, 8)
            (count,) = struct.unpack_from(order + "Q", data, at)
            at, entry, inline = at + 8, 20, 8
        else:
            (at,) = struct.unpack_from(order + "I", data, 4)
            (count,) = struct.unpack_from(order + "H", data, at)
            at, entry, inline = at + 2, 12, 4
        tags = {}
        for i in range(count):
            pos = at + i * entry
            tag, typ = struct.unpack_from(order + "HH", data, pos)
            (n,) = struct.unpack_from(order + ("Q" if big else "I"), data, pos + 4)
            if typ not in TYPES:
                continue
            fmt = TYPES[typ]
            size = struct.calcsize("<" + fmt) * n
            if size <= inline:
                value_at = pos + (12 if big else 8)
            else:
                (value_at,) = struct.unpack_from(order + ("Q" if big else "I"), data, pos + (12 if big else 8))
            vals = struct.unpack_from(f"{order}{n * len(fmt)}{fmt[0]}", data, value_at)
            if typ in (5, 10):
                vals = tuple(a / b if b else float("nan") for a, b in zip(vals[::2], vals[1::2]))
            tags[tag] = vals
    except struct.error as e:
        raise ValueError(f"TIFF: the IFD runs past the end of the file ({e})") from None
    return order, tags


def _mode(order: str, tags: dict, fill: int) -> tuple[str, str, tuple]:
    """PIL's (mode, rawmode) for the file's sample layout (``_setup``), and
    the bits of each sample."""
    photo = tags.get(PHOTOMETRIC, (0,))[0]
    if tags.get(COMPRESSION, (1,))[0] == 6:
        photo = 6
    sample_format = tags.get(SAMPLEFORMAT, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps = tags.get(BITS, (1,))
    extra = tags.get(EXTRASAMPLES, ())
    spp = tags.get(SAMPLES, (3 if tags.get(COMPRESSION, (1,))[0] == 6 and photo in (2, 6) else 1,))[0]
    if not isinstance(spp, int):
        raise ValueError(f"TIFF: samples a pixel {spp!r} (PIL: cannot identify the file)")
    if spp > 6:
        raise ValueError(f"TIFF: {spp} samples a pixel (PIL: invalid value for samples per pixel)")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError("TIFF: the bits a sample do not match the samples a pixel (PIL: unknown data organization)")
    key = (photo, sample_format, fill, bps, extra)
    if bps == (16,) and sample_format == (1,) and (order, photo, fill) in GRAY16:
        return GRAY16[(order, photo, fill)] + (bps,)
    if not extra and (order, photo, sample_format, fill, bps) in WIDE_GRAY:
        return WIDE_GRAY[(order, photo, sample_format, fill, bps)] + (bps,)
    if key in OPEN_INFO:
        return OPEN_INFO[key] + (bps,)
    for k, kind in OPEN_INFO_PENDING.items():
        if k[0] in ("*", order) and k[1:] == key:
            raise NotImplementedError(f"TIFF: {kind} samples {PENDING}")
    raise ValueError(f"TIFF: photometric {photo}, sample format {sample_format}, fill order {fill}, bits {bps}, "
                     f"extra samples {extra}, which PIL does not read either (unknown pixel mode)")


def lzw_msb(data: bytes, size: int) -> bytes:
    """libtiff's LZW decode of one strip or tile to ``size`` bytes: 9- to
    12-bit codes, most significant bit first, the width growing one code
    early; data that starts with a clear code written least significant
    bit first is the old variant (GIF's order, no early change)."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        from ._gif import lzw_codes_lsb

        out = lzw_codes_lsb(data, 8)
    else:
        total = 8 * len(data)
        data = bytes(data) + bytes(3)  # a code (≤ 12 bits at any bit offset) lies in the 3 bytes from its first
        pos, parts, n = 0, [], 0
        table = [bytes([i]) for i in range(256)] + [b"", b""]
        width, prev = 9, None
        while pos + width <= total and n < size:
            code = (int.from_bytes(data[pos >> 3:(pos >> 3) + 3], "big") >> (24 - (pos & 7) - width)) & ((1 << width) - 1)
            pos += width
            if code == 256:
                del table[258:]
                width, prev = 9, None
                continue
            if code == 257:
                break
            if prev is None:
                entry = table[code] if code < 256 else None
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                entry = None
            if entry is None:
                raise ValueError("TIFF: LZW code past the table (libtiff: corrupted LZW table)")
            parts.append(entry)
            n += len(entry)
            prev = entry
            if len(table) + 1 >= 1 << width and width < 12:
                width += 1
        out = b"".join(parts)
    if len(out) < size:
        raise ValueError("TIFF: LZW data ends before its strip or tile (libtiff: not enough data)")
    return out[:size]


def packbits(data: bytes, size: int) -> bytes:
    """libtiff's PackBits decode to ``size`` bytes: a header byte n ≥ 0 copies
    n + 1 literal bytes, −127 ≤ n < 0 repeats the next byte 1 − n times,
    −128 is skipped; a packet past ``size`` is cut."""
    out = bytearray()
    pos = 0
    while len(out) < size and pos < len(data):
        n = data[pos] - 256 if data[pos] > 127 else data[pos]
        pos += 1
        if n >= 0:
            out += data[pos:pos + n + 1]
            pos += n + 1
        elif n != -128:
            if pos >= len(data):
                break
            out += data[pos:pos + 1] * (1 - n)
            pos += 1
    if len(out) < size:
        raise ValueError("TIFF: PackBits data ends before its strip or tile (libtiff: not enough data)")
    return bytes(out[:size])


def _inflate(data: bytes, size: int) -> bytes:
    try:
        out = zlib.decompressobj().decompress(data, size)
    except zlib.error as e:
        raise ValueError(f"TIFF: Deflate data is corrupt ({e})") from None
    if len(out) < size:
        raise ValueError("TIFF: Deflate data ends before its strip or tile (libtiff: not enough data)")
    return out


def _unpredict(rows: np.ndarray, bits: int, stride: int, order: str) -> np.ndarray:
    """Undo horizontal differencing on (rows, bytes) of one chunk: running
    sums of each sample along its row, modulo 2^bits."""
    if bits == 8:
        v = rows.reshape(rows.shape[0], -1, stride).astype(np.int64)
        return (np.cumsum(v, 1) & 0xFF).astype(np.uint8).reshape(rows.shape)
    word = f"{order}u{bits // 8}"
    v = rows.reshape(rows.shape[0], -1).view(word).reshape(rows.shape[0], -1, stride).astype(np.uint64)
    out = (np.cumsum(v, 1, dtype=np.uint64) & np.uint64((1 << bits) - 1)).astype(word)
    return out.reshape(rows.shape[0], -1).view(np.uint8)


def _unpredict_float(rows: np.ndarray, bits: int, stride: int, order: str) -> np.ndarray:
    """Undo libtiff's floating-point predictor (``fpAcc``) on (rows, bytes)
    of one chunk: running byte sums along each row (stride: the samples a
    pixel), then the row's bytes, stored as planes most significant first,
    put back together value by value — here in the file's byte order."""
    n = bits // 8
    acc = _unpredict(rows, 8, stride, order)
    be = acc.reshape(rows.shape[0], n, -1).transpose(0, 2, 1)  # each value's bytes, most significant first
    return np.ascontiguousarray(be if order == ">" else be[..., ::-1]).reshape(rows.shape)


def _unpack(rows: np.ndarray, bits: int, n: int, order: str) -> np.ndarray:
    """(rows, bytes) → (rows, n) sample values of ``bits`` bits."""
    if bits < 8:
        v = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, bits)
        return (v << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.int64)[:, :n]
    if bits == 16:
        return np.ascontiguousarray(rows[:, :2 * n]).view(order + "u2").astype(np.int64)
    if bits == 12:  # two samples in three bytes, most significant bits first (PIL's I;12)
        t = np.pad(rows, ((0, 0), (0, -rows.shape[1] % 3))).reshape(rows.shape[0], -1, 3).astype(np.int64)
        pairs = np.stack([t[..., 0] << 4 | t[..., 1] >> 4, (t[..., 1] & 15) << 8 | t[..., 2]], -1)
        return pairs.reshape(rows.shape[0], -1)[:, :n]
    return rows[:, :n].astype(np.int64)


def _planes_of(tags: dict) -> tuple[int, int, int, int, list, list]:
    """(chunk width, chunk height, chunks across, chunks down, offsets, byte counts)."""
    width, height = tags[WIDTH][0], tags[LENGTH][0]
    if TILEOFFSETS in tags:
        tw, th = tags.get(TILEWIDTH, (None,))[0], tags.get(TILELENGTH, (None,))[0]
        if not tw or not th:
            raise ValueError("TIFF: tiles without a tile width or length (PIL: invalid tile dimensions)")
        return tw, th, -(-width // tw), -(-height // th), list(tags[TILEOFFSETS]), list(tags.get(TILEBYTECOUNTS, ()))
    if STRIPOFFSETS not in tags:
        raise ValueError("TIFF: no strips or tiles (PIL: unknown data organization)")
    rows = min(tags.get(ROWSPERSTRIP, (height,))[0], height) or height
    return width, rows, 1, -(-height // rows), list(tags[STRIPOFFSETS]), list(tags.get(STRIPBYTECOUNTS, ()))


def _raw_samples(data: bytes, tags: dict, rawmode: str, fill: int, bps: tuple, planar: int, bps_count: int,
                 pixel_bits: int | None = None) -> list:
    """PIL's own path for uncompressed files (``ImageFile.load`` and
    ``RawDecode.c``) → the (H, row bytes) rows of each plane it fills, each
    pixel ``pixel_bits`` wide (the rawmode's; by default the samples')."""
    width, height = tags[WIDTH][0], tags[LENGTH][0]
    tw, th, _, _, offsets, _ = _planes_of(tags)
    if TILEOFFSETS not in tags:
        th = tags.get(ROWSPERSTRIP, (height,))[0]
    if tw == width and th == height and planar != 2:
        offsets = offsets[-1:]
    bits = 8 if planar == 2 else pixel_bits or sum(bps)  # separate planes: a letter of the rawmode, a byte each
    out = []
    x = y = layer = 0
    for offset in offsets:
        if layer >= (len(rawmode) if planar == 2 else 1):
            raise ValueError("TIFF: more strips or tiles than planes (PIL: unknown data organization)")
        if layer == len(out):
            out.append(np.zeros((height, -(-width * bits // 8)), np.uint8))
        w = min(x + tw, width) - x
        h = min(y + th, height) - y
        nbytes = -(-w * bits // 8)
        stride = int(tw * sum(bps) / 8 / (bps_count if planar == 2 else 1)) if x + tw > width else 0
        step = stride or nbytes
        need = (h - 1) * step + nbytes if h > 0 else 0
        chunk = data[offset:offset + need]
        if len(chunk) < need:
            raise ValueError("TIFF: the pixel data is truncated (PIL: image file is truncated)")
        if fill == 2:
            chunk = REVERSED[np.frombuffer(chunk, np.uint8)].tobytes()
        if h > 0:
            rows = np.frombuffer(chunk + bytes(step - nbytes), np.uint8).reshape(h, step)[:, :nbytes]
            x_byte = x * bits // 8
            if (x * bits) % 8:
                raise NotImplementedError(f"TIFF: sub-byte tiles at a bit offset {PENDING}")
            out[layer][y:y + h, x_byte:x_byte + nbytes] = rows
        x += tw
        if x >= width:
            x, y = 0, y + th
            if y >= height:
                y, layer = 0, layer + 1
    return out


def _coded_samples(data: bytes, order: str, tags: dict, compression: int, fill: int, bps: tuple,
                   planar: int) -> list:
    """libtiff's path: every strip or tile decoded to its full size →
    per plane, (H, row bytes) rows."""
    width, height = tags[WIDTH][0], tags[LENGTH][0]
    tw, th, across, down, offsets, counts = _planes_of(tags)
    tiled = TILEOFFSETS in tags
    nplanes = len(bps) if planar == 2 else 1
    pixel_bits = bps[0] if planar == 2 else sum(bps)
    predictor = tags.get(PREDICTOR, (1,))[0] if compression in (5, 8, 32946) else 1
    if predictor not in (1, 2, 3):
        raise ValueError(f"TIFF: predictor {predictor} (libtiff: bad value for Predictor)")
    if predictor == 2 and bps[0] not in (8, 16, 32):
        raise ValueError(f"TIFF: horizontal differencing at {bps[0]} bits, which libtiff does not undo")
    if predictor == 3 and (tags.get(SAMPLEFORMAT, (1,))[0] != 3 or bps[0] != 32):
        raise ValueError(f"TIFF: the floating-point predictor on {bps[0]}-bit samples of format "
                         f"{tags.get(SAMPLEFORMAT, (1,))[0]} (libtiff: not supported with that data format)")
    if len(offsets) < across * down * nplanes or len(counts) < len(offsets):
        raise ValueError("TIFF: fewer strip or tile offsets or byte counts than the image needs")
    row_bytes = -(-tw * pixel_bits // 8)
    jpeg = _jpeg_setup(data, tags, offsets, counts) if compression == 7 else None
    out = [np.zeros((height, -(-width * pixel_bits // 8)), np.uint8) for _ in range(nplanes)]
    for plane in range(nplanes):
        for j in range(down):
            for i in range(across):
                k = (plane * down + j) * across + i
                rows = th if tiled else min(th, height - j * th)
                raw = data[offsets[k]:offsets[k] + counts[k]]
                if fill == 2:
                    raw = REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
                size = rows * row_bytes
                if compression == 7:
                    raw = _jpeg_chunk(raw, jpeg, rows, tw, j == down - 1 and not tiled)
                elif compression == 5:
                    raw = lzw_msb(raw, size)
                elif compression in (8, 32946):
                    raw = _inflate(raw, size)
                elif compression == 32773:
                    raw = packbits(raw, size)
                elif len(raw) < size:
                    raise ValueError("TIFF: the pixel data is truncated")
                chunk = np.frombuffer(raw, np.uint8, size).reshape(rows, row_bytes)
                if predictor == 2:
                    chunk = _unpredict(chunk, bps[0], 1 if planar == 2 else len(bps), order)
                elif predictor == 3:
                    chunk = _unpredict_float(chunk, bps[0], 1 if planar == 2 else len(bps), order)
                y0, x0 = j * th, i * tw
                h = min(rows, height - y0)
                nb = -(-min(tw, width - x0) * pixel_bits // 8)
                out[plane][y0:y0 + h, x0 * pixel_bits // 8:x0 * pixel_bits // 8 + nb] = chunk[:h, :nb]
    return out


def _jpeg_setup(data: bytes, tags: dict, offsets: list, counts: list) -> tuple:
    """What libtiff's JPEG codec needs for every strip or tile: the
    ``JPEGTables`` stream, whether libjpeg converts YCbCr to RGB (PIL asks for
    ``JPEGCOLORMODE_RGB`` where the photometric is YCbCr and the planes
    contiguous), the sampling the file declares (``YCbCrSubsampling``;
    where the tag is absent libtiff takes it from the first strip's frame
    header, else 2×2) and a memo of the Huffman tables built so far."""
    photo = tags.get(PHOTOMETRIC, (0,))[0]
    tables = bytes(tags[JPEGTABLES]) if JPEGTABLES in tags else None
    ycc = photo == 6
    sampling = (1, 1)
    if ycc:
        sampling = tuple(tags[YCBCRSUBSAMPLING][:2]) if YCBCRSUBSAMPLING in tags else _sof_sampling(
            data[offsets[0]:offsets[0] + counts[0]] if offsets and counts else b"")
    return tables, ycc, sampling, {}


def _sof_sampling(stream: bytes) -> tuple:
    """The first component's sampling factors in a JPEG stream's frame
    header (libtiff's ``JPEGFixupTagsSubsampling``), or 2×2 without one."""
    pos = 2
    while pos + 4 <= len(stream) and stream[pos] == 0xFF:
        marker, (length,) = stream[pos + 1], struct.unpack_from(">H", stream, pos + 2)
        if marker in (0xC0, 0xC1, 0xC2) and pos + 12 <= len(stream):
            hv = stream[pos + 11]
            return hv >> 4, hv & 15
        if marker == 0xDA:
            break
        pos += 2 + length
    return 2, 2


def _jpeg_chunk(stream: bytes, jpeg: tuple, rows: int, cols: int, last_strip: bool) -> bytes:
    """One strip or tile of a JPEG-compressed TIFF decoded to ``rows`` rows
    of ``cols`` pixels, as libtiff's ``JPEGPreDecode`` admits it: the
    stream's frame as wide as its strip or tile and as tall (the last strip
    may be taller; its extra rows are dropped)."""
    tables, ycc, sampling, memo = jpeg
    img = decode_abbreviated(stream, tables, ycc, sampling, memo)
    h, w = img.shape[:2]
    if w > cols or h > rows and not (last_strip and w == cols):
        raise ValueError(f"TIFF: a {w}x{h} JPEG in a {cols}x{rows} strip or tile (libtiff: JPEG strip/tile size "
                         "exceeds expected dimensions)")
    if w < cols or h < rows:
        raise NotImplementedError(f"TIFF: a JPEG smaller than its strip or tile {PENDING}")
    return img[:rows].tobytes()


def _ycbcr_rgba(data: bytes, tags: dict, compression: int, fill: int) -> np.ndarray:
    """libtiff's RGBA interface on contiguous 8-bit YCbCr (``tif_getimage.c``),
    which PIL's libtiff decoder takes for YCbCr that is not JPEG-compressed:
    each strip or tile decoded to its packed data units (``hs·vs`` luma
    samples, then Cb and Cr, for each ``hs × vs`` block), every pixel of a
    block given the block's chroma (replication, no filter; in an edge tile
    of 4×4 blocks each row of blocks starts where libtiff's
    ``putcontig8bitYCbCr44tile`` puts it, 8 bytes a skipped block early),
    then ``TIFFYCbCrtoRGB`` with the tables ``TIFFYCbCrToRGBInit`` builds in
    float from ``YCbCrCoefficients`` and ``ReferenceBlackWhite``."""
    if tags.get(PLANAR, (1,))[0] == 2:
        raise NotImplementedError(f"TIFF: YCbCr in separate planes {PENDING}")
    hs, vs = tuple(tags.get(YCBCRSUBSAMPLING, (2, 2))[:2])
    if (hs, vs) not in ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)):  # tif_getimage.c's cases
        raise ValueError(f"TIFF: YCbCr subsampling {hs}x{vs} (libtiff: can not handle format)")
    if compression != 1 and tags.get(PREDICTOR, (1,))[0] != 1:
        raise NotImplementedError(f"TIFF: a predictor on YCbCr data units {PENDING}")
    width, height = tags[WIDTH][0], tags[LENGTH][0]
    tw, th, across, down, offsets, counts = _planes_of(tags)
    tiled = TILEOFFSETS in tags
    if len(offsets) < across * down or len(counts) < len(offsets):
        raise ValueError("TIFF: fewer strip or tile offsets or byte counts than the image needs")
    unit = hs * vs + 2
    tables = _ycbcr_tables(tags)
    out = np.zeros((height, width, 3), np.uint8)
    for j in range(down):
        for i in range(across):
            k = j * across + i
            rows = th if tiled else min(th, height - j * th)
            across_units, down_units = -(-tw // hs), -(-rows // vs)
            size = across_units * down_units * unit
            raw = data[offsets[k]:offsets[k] + counts[k]]
            if fill == 2:
                raw = REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
            if compression == 5:
                raw = lzw_msb(raw, size)
            elif compression in (8, 32946):
                raw = _inflate(raw, size)
            elif compression == 32773:
                raw = packbits(raw, size)
            y0, x0 = j * th, i * tw
            h, w = min(rows, height - y0), min(tw, width - x0)
            # each row of data units read after the last one's ceil(w/hs) units
            # and a skip of the tile's columns past the image; libtiff's 4×4
            # case skips 10 bytes a skipped unit, not 18
            skip = (tw - w) // hs * (10 if (hs, vs) == (4, 4) else unit)
            used = -(-w // hs)
            at = (np.arange(down_units)[:, None] * (used * unit + skip) + np.arange(used)[None] * unit)
            u = np.frombuffer(raw, np.uint8, size)[at[..., None] + np.arange(unit)].astype(np.int64)
            yy, xx = np.mgrid[0:h, 0:w]
            luma = u[yy // vs, xx // hs, (yy % vs) * hs + xx % hs]
            cb, cr = u[yy // vs, xx // hs, hs * vs], u[yy // vs, xx // hs, hs * vs + 1]
            out[y0:y0 + h, x0:x0 + w] = _ycbcr_to_rgb(tables, luma, cb, cr)
    return out


def _ycbcr_to_rgb(tables: list, luma: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``TIFFYCbCrtoRGB`` on 8-bit samples with ``_ycbcr_tables``' tables."""
    yt, cr_r, cb_b, cr_g, cb_g = tables
    rgb = [yt[luma] + cr_r[cr], yt[luma] + ((cb_g[cb] + cr_g[cr]) >> 16), yt[luma] + cb_b[cb]]
    return np.clip(np.stack(rgb, -1), 0, 255).astype(np.uint8)


def _old_jpeg(data: bytes, tags: dict) -> np.ndarray:
    """Old-style JPEG (compression 6) in the layout libtiff reads as one
    stream: ``JPEGInterchangeFormat`` pointing at a whole JPEG file of the
    image's size, 3-component YCbCr, at most one strip and that inside the
    stream. PIL takes such a file as YCbCr through libtiff's RGBA interface,
    and libtiff's old-style codec hands that interface the raw components
    (no upsampling, no colour conversion): every pixel gets its block's
    chroma, then ``TIFFYCbCrtoRGB`` (``_ycbcr_tables``)."""
    width, height = tags[WIDTH][0], tags[LENGTH][0]
    if JPEGIFOFFSET not in tags or tags.get(PLANAR, (1,))[0] != 1 or tags.get(PHOTOMETRIC, (6,))[0] != 6:
        raise NotImplementedError(f"TIFF: old-style JPEG other than one YCbCr interchange-format stream {PENDING}")
    at = tags[JPEGIFOFFSET][0]
    stream = data[at:at + tags.get(JPEGIFBYTECOUNT, (len(data) - at,))[0]]
    strips = [(o, o + n) for o, n in zip(tags.get(STRIPOFFSETS, ()), tags.get(STRIPBYTECOUNTS, ()))]
    if len(strips) > 1 or any(o < at or end > at + len(stream) for o, end in strips):
        raise NotImplementedError(f"TIFF: old-style JPEG strips outside its interchange-format stream {PENDING}")
    planes, factors, size = decode_raw_planes(stream)
    hs, vs = tuple(tags.get(YCBCRSUBSAMPLING, (2, 2))[:2])
    if size != (height, width) or factors != [(hs, vs), (1, 1), (1, 1)]:
        raise NotImplementedError(f"TIFF: an old-style JPEG stream of another size or sampling than its tags "
                                  f"{PENDING}")
    yy, xx = np.mgrid[0:height, 0:width]
    return _ycbcr_to_rgb(_ycbcr_tables(tags), planes[0][yy, xx], planes[1][yy // vs, xx // hs],
                         planes[2][yy // vs, xx // hs])


def _ycbcr_tables(tags: dict) -> list:
    """``tif_color.c``'s ``TIFFYCbCrToRGBInit`` (SHIFT 16), its float
    arithmetic in float32: the Y, Cr→R, Cb→B, Cr→G and Cb→G tables."""
    f32 = np.float32
    luma = [f32(v) for v in tags.get(YCBCRCOEFFICIENTS, (0.299, 0.587, 0.114))[:3]]
    ref = [f32(v) for v in tags.get(REFERENCEBLACKWHITE, (0, 255, 128, 255, 128, 255))[:6]]

    def fix(x):  # (int32)(x * (1L << 16) + 0.5), x clamped to [0, 2] first (NaN → 0)
        x = f32(0) if not x >= 0 else min(x, f32(2))
        return int(float(f32(x) * f32(65536)) + 0.5)

    def code2v(c, rb, rw, cr):  # ((c − (int32)rb) · cr) / (rw − rb or 1), clamped to ±4096, to int32
        d = f32(rw - rb)
        v = f32(f32(c - int(rb)) * f32(cr)) / (d if d != 0 else f32(1))
        return int(f32(-4096) if not v >= -4096 else min(v, f32(4096)))

    d1 = fix(f32(2) - f32(2) * luma[0])
    d2 = -fix(f32(luma[0] * (f32(2) - f32(2) * luma[0])) / luma[1])
    d3 = fix(f32(2) - f32(2) * luma[2])
    d4 = -fix(f32(luma[2] * (f32(2) - f32(2) * luma[2])) / luma[1])
    tabs = [[], [], [], [], []]
    for x in range(-128, 128):
        cr = code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127)
        cb = code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127)
        for t, v in zip(tabs, (code2v(x + 128, ref[0], ref[1], 255), (d1 * cr + 32768) >> 16,
                               (d3 * cb + 32768) >> 16, d2 * cr, d4 * cb + 32768)):
            t.append(v)
    return [np.asarray(t, np.int64) for t in tabs]


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes → (H, W, 1) uint8 gray, (H, W, 3) RGB or (H, W, 4) RGBA:
    the first image."""
    if data[:4] not in SIGNATURES or len(data) < 8:
        raise ValueError("not a TIFF file")
    order, tags = _ifd(data)
    compression = tags.get(COMPRESSION, (1,))[0]
    if compression not in COMPRESSIONS:
        raise ValueError(f"TIFF: compression {compression}, which PIL does not read either")
    if WIDTH not in tags or LENGTH not in tags:
        raise ValueError("TIFF: no image width or length (PIL: missing dimensions)")
    width, height = tags[WIDTH][0], tags[LENGTH][0]
    if not (isinstance(width, int) and isinstance(height, int)):
        raise ValueError(f"TIFF: a {width}x{height} image (PIL: invalid dimensions)")
    fill = tags.get(FILLORDER, (1,))[0]
    mode, rawmode, bps = _mode(order, tags, fill)
    if compression != 1 and fill == 2:  # libtiff reverses the bits; PIL reads the fill-order-1 layout
        mode, rawmode, bps = _mode(order, tags, 1)
    if compression not in DECODED:
        raise NotImplementedError(f"TIFF: {COMPRESSIONS[compression]} compression {PENDING}")
    if tags.get(ORIENTATION, (1,))[0] in (5, 6, 7, 8):
        raise NotImplementedError(f"TIFF: orientation {tags[ORIENTATION][0]} {PENDING}")
    if not (width and height):
        raise ValueError(f"TIFF: a {width}x{height} image")
    planar = tags.get(PLANAR, (1,))[0]
    if compression != 1 and planar not in (1, 2):
        raise ValueError(f"TIFF: planar configuration {planar} (libtiff: bad value)")
    palette = None
    if mode in ("P", "PA"):
        cmap = np.asarray(tags.get(COLORMAP, ()), np.int64) // 256
        n = len(cmap) // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[:min(n, 256)] = cmap[:3 * n].reshape(3, n).T[:256]
    photo = tags.get(PHOTOMETRIC, (0,))[0]
    if compression == 6:
        if rawmode != "RGBX":
            raise NotImplementedError(f"TIFF: old-style JPEG of other than 3 samples {PENDING}")
        return _old_jpeg(data, tags)
    if compression == 7 and photo == 6 and planar == 1:
        rawmode = "RGB"  # PIL: libjpeg converts to RGB
    elif compression == 7 and planar == 2:
        if photo == 6:
            raise ValueError("TIFF: JPEG-compressed YCbCr in separate planes (PIL: decoder error)")
        raise NotImplementedError(f"TIFF: JPEG-compressed separate planes {PENDING}")
    elif rawmode == "RGBX" and photo == 6 and compression != 1:
        return _ycbcr_rgba(data, tags, compression, fill)
    if compression == 1:
        bps_count = {2: 3, 6: 3, 8: 3, 5: 4}.get(photo, 1) + len(tags.get(EXTRASAMPLES, ()))
        if photo == 6 and rawmode == "RGBX" and planar == 1:
            # PIL's raw decoder reads YCbCr as RGBX: four file bytes a pixel,
            # no colour conversion, the subsampling ignored
            rows = _raw_samples(data, tags, rawmode, fill, bps, planar, bps_count, pixel_bits=32)[0]
            return np.ascontiguousarray(rows.reshape(height, width, 4)[..., :3])
        planes = _raw_samples(data, tags, rawmode, fill, bps, planar, bps_count)
        if planar == 2:  # each plane read as the rawmode's letter, one byte a sample
            return _bands(planes, rawmode, mode, width, palette)
    else:
        if planar == 2:
            rawmode = _separate_rawmode(rawmode, tags)
        planes = _coded_samples(data, order, tags, compression, fill, bps, planar)
        if planar == 2:
            samples = np.stack([_unpack(p, bps[0], width, order) for p in planes], -1)
            if mode in ("LA", "PA"):  # PIL fills no alpha from a separate plane
                samples[..., 1] = 0
            return _convert(samples, rawmode, mode, palette)
    rows = planes[0]
    n = len(bps)
    if rawmode in WIDE_DTYPES:
        # libtiff hands PIL native (little-endian) samples, which PIL reads in
        # the rawmode's byte order: a big-endian file's I;16BS, I;32BS and
        # F;32BF samples come out byte-swapped unless PIL reads them raw
        word = ("<" if compression != 1 else order) + WIDE_DTYPES[rawmode]
        v = np.ascontiguousarray(rows[:, :width * (bps[0] // 8)]).view(word)
        return np.repeat(_wide_to_u8(v, mode)[..., None], 3, -1)
    samples = _unpack(rows, bps[0], width * n, order).reshape(height, width, n)
    return _convert(samples, rawmode, mode, palette)


def _wide_to_u8(v: np.ndarray, mode: str) -> np.ndarray:
    """``convert("RGB")``'s one channel from PIL's mode I (clipped to
    [0, 255]) or F (truncated toward zero, then clipped; NaN 0, +inf 255)."""
    if mode == "F":
        with np.errstate(invalid="ignore"):  # a byte-swapped sample may be a signalling NaN
            v = np.trunc(np.nan_to_num(v.astype(np.float64), nan=0.0, posinf=255.0, neginf=0.0))
    return np.clip(v, 0, 255).astype(np.uint8)


def _separate_rawmode(rawmode: str, tags: dict) -> str:
    """libtiff's separate planes as PIL gives them: RGBA without extra
    samples comes back with its alpha divided out (as ``RGBa``), RGBX only
    from tiles (strips fail in PIL's decoder), LA and PA without their alpha
    (``decode_tiff``); the other layouts with unused samples are not read
    yet."""
    base = rawmode.split(";")[0]
    if base == "RGBA" and EXTRASAMPLES not in tags:
        return "RGBa" + rawmode[4:]
    if base == "RGBX":
        if TILEOFFSETS not in tags:
            raise ValueError("TIFF: RGBX in separate strips (PIL: decoder error -2)")
        return rawmode
    if base in ("RGB", "RGBA", "RGBa", "CMYK", "LA", "PA"):
        return rawmode
    raise NotImplementedError(f"TIFF: {rawmode} samples in separate planes {PENDING}")


def _bands(planes: list, rawmode: str, mode: str, width: int, palette) -> np.ndarray:
    """PIL's raw path with separate planes: plane k is the band of the mode
    named by the rawmode's k-th letter, its bytes read one a pixel."""
    chans = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK"}.get(mode)  # PIL has no band unpackers for LA, PA
    if chans is None or not set(rawmode[:len(planes)]) <= set(chans):
        raise ValueError(f"TIFF: separate planes of rawmode {rawmode} (PIL: unknown raw mode)")
    h = planes[0].shape[0]
    img = np.zeros((h, width, len(chans)), np.int64)
    for letter, plane in zip(rawmode, planes):
        img[..., chans.index(letter)] = plane[:, :width]
    return _convert(img, chans, mode, palette)


def _convert(s: np.ndarray, rawmode: str, mode: str, palette) -> np.ndarray:
    """(H, W, samples) values in the rawmode's order → the JAX package's
    ``load_image`` array."""
    base = rawmode.split(";")[0]
    suffix = rawmode[len(base):]
    if mode == "1":
        v = s[..., 0] if "I" not in suffix else 1 - s[..., 0]
        return np.repeat((v * 255).astype(np.uint8)[..., None], 3, -1)
    if mode == "L":
        bits = {";2": 2, ";4": 4}.get(suffix[:2], 8)
        v = s[..., 0] * (255 // ((1 << bits) - 1))
        if "I" in suffix:
            v = 255 - v
        return v.astype(np.uint8)[..., None]
    if mode in ("I;16", "I;16B"):
        return np.repeat(np.minimum(s[..., :1], 255).astype(np.uint8), 3, -1)
    if mode in ("P", "PA"):
        rgb = palette[s[..., 0]]
        if mode == "PA":
            return np.concatenate([rgb, s[..., 1:2].astype(np.uint8)], -1)
        return rgb
    if suffix.startswith(";16"):
        s = s >> 8
    if mode == "LA":
        return s[..., [0, 0, 0, 1]].astype(np.uint8)
    if mode == "CMYK":
        c, m, y, k = (s[..., i].astype(np.uint8) for i in range(4))
        return cmyk_to_rgb(c, m, y, k)
    rgb = s[..., :3]
    if mode == "RGB":
        return rgb.astype(np.uint8)
    a = s[..., 3:4]
    if base.startswith("RGBa"):  # associated alpha divided out (Unpack.c's unpackRGBa)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, np.minimum(255, rgb * 255 // np.maximum(a, 1))))
    return np.concatenate([rgb, a], -1).astype(np.uint8)
