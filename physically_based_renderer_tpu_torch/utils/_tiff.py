"""TIFF decoding with NumPy and the standard library — the ``.tif`` part of
``utils/image_io.load_image``, bit for bit what PIL's ``TiffImagePlugin``
gives for the first image of a file, under the JAX package's mode rules.

The container: both byte orders, classic and (little-endian, as PIL tells
them) BigTIFF headers, the first IFD; strips and tiles (edge tiles cropped,
sub-byte tiles placed at their bit offset); contiguous and separate planes;
fill order 2 (each byte's bits reversed). The sample layout is mapped to
PIL's (mode, rawmode) as ``TiffImagePlugin.OPEN_INFO`` maps it, and the
file decoded by PIL's own two paths:

  * uncompressed files by PIL's raw decoder: each strip or tile read from
    its offset (its byte count unused), the rows of an edge tile at the
    tile's stride (rows overlap where it is short of them); with separate
    planes, plane k read with the k-th letter of the rawmode, one byte a
    sample (one sample's plane by its letter's unpacker: 1 bit for mode 1,
    32 for I and F); no predictor; a file of one strip or tile in a mode PIL
    memory-maps read at the size its orientation swapped (``_mapped``);
  * every other compression by libtiff: PackBits, LZW (codes most
    significant bit first, widths one code early; and the old
    least-significant-first variant libtiff still reads), Deflate, LZMA (an
    xz stream, ``lzma``; a strip liblzma fills before an error kept:
    ``utils/_xz.py``) and Zstd (``utils/_zstd.py``), each strip or tile
    decoded to its full size from its byte count, then horizontal
    differencing (predictor 2) undone at 8, 16 and 32 bits and the
    floating-point predictor (3: byte planes, most significant first,
    differenced byte by byte) on float32, for all but PackBits; CCITT
    Modified Huffman, RLEW, T.4 and T.6 (``utils/_ccitt.py``) and
    ThunderScan, 1 and 4 bits a pixel; old-style JPEG (compression 6:
    ``utils/_ojpeg.py``, one JPEG stream of the image made from its tags or
    its own header, drawn as libtiff's RGBA interface draws YCbCr, or one
    sample's rows); and JPEG (compression 7): each strip
    or tile its own SOI…EOI stream, read after the ``JPEGTables`` stream
    (``_jpeg.decode_abbreviated``) into PIL's one strip buffer (a smaller
    frame leaves the rest as the strip before left it), libtiff's checks on
    its size and sampling kept; YCbCr converted by libjpeg (PIL asks for
    ``JPEGCOLORMODE_RGB``), RGB, gray and separate planes as stored.

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
rule (``utils/_jpeg.cmyk_to_rgb``); CIELab through LittleCMS's Lab → sRGB
(``utils/_lab.py``) to RGBA; YCbCr that is not JPEG-compressed read as PIL
reads it: uncompressed by its raw decoder as RGBX (four file bytes a pixel,
no conversion), compressed through libtiff's RGBA interface
(``_ycbcr_rgba``, separate planes at 1×1). Gray stays one channel; 1-bit,
12- to 32-bit and float gray, palette, YCbCr and CMYK become RGB; alpha and
CIELab make RGBA. Last, the image is turned by its orientation as
``ImageOps.exif_transpose`` turns it (the tag, or the XMP packet's).

Files PIL refuses raise ``ValueError``.
"""

from __future__ import annotations

import lzma
import re
import struct
import zlib

import numpy as np

from ._ccitt import decode_ccitt
from ._jpeg import cmyk_to_rgb, decode_abbreviated
from ._lab import lab_to_rgb
from ._ojpeg import old_jpeg_gray, old_jpeg_separate, old_jpeg_units, subsampling_tag
from ._xz import xz_prefix
from ._zstd import decode_zstd_strip

SIGNATURES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")

# compression value → its name (TiffImagePlugin.COMPRESSION_INFO's values); the port decodes all but UNREAD
COMPRESSIONS = {1: "raw", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG",
                7: "JPEG", 8: "Deflate", 32771: "CCITT RLEW", 32773: "PackBits", 32809: "ThunderScan", 32946: "Deflate",
                34676: "SGI LogLuv", 34677: "SGI LogLuv24", 34925: "LZMA", 50000: "Zstd", 50001: "WebP-in-TIFF"}
UNREAD = (34676, 34677, 50001)  # SGI LogL / LogLuv (PIL has no mode for them), WebP (not in libtiff here)
PREDICTED = (5, 8, 32946, 34925, 50000)  # the codecs libtiff's predictor wraps
CCITT = (2, 3, 4, 32771)

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
OPEN_INFO[(8, (1,), 1, (8, 8, 8), ())] = ("LAB", "LAB")  # CIELab: a* and b* signed
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

TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d",
         13: "I", 16: "Q", 17: "q", 18: "Q"}
# tags: width, length, bits, compression, photometric, fill order, strip
# offsets, orientation, samples, rows per strip, strip byte counts, planar
# configuration, predictor, colour map, tile width, length, offsets, byte
# counts, extra samples, sample format
(WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILLORDER, STRIPOFFSETS, ORIENTATION, SAMPLES, ROWSPERSTRIP,
 STRIPBYTECOUNTS, PLANAR, PREDICTOR, COLORMAP, TILEWIDTH, TILELENGTH, TILEOFFSETS, TILEBYTECOUNTS, EXTRASAMPLES,
 SAMPLEFORMAT) = (256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320, 322, 323, 324, 325, 338, 339)
# JPEGTables; YCbCrCoefficients, ReferenceBlackWhite
JPEGTABLES, YCBCRCOEFFICIENTS, REFERENCEBLACKWHITE = 347, 529, 532
T4OPTIONS = 292
XMP = 700
# orientation → PIL's transpose of the (H, W, C) array (``ImageOps.exif_transpose``): FLIP_LEFT_RIGHT,
# ROTATE_180, FLIP_TOP_BOTTOM, TRANSPOSE, ROTATE_270, TRANSVERSE, ROTATE_90
TRANSPOSES = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
              5: lambda a: a.transpose(1, 0, 2), 6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
              7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1], 8: lambda a: a.transpose(1, 0, 2)[::-1]}
MAPPED = {"L": 1, "P": 1, "RGBA": 4, "CMYK": 4, "I;16": 2, "I;16B": 2}  # PIL's _MAPMODES here → bytes a pixel
LETTER_BITS = {"1": 1, "L": 8, "P": 8, "I": 32, "F": 32}  # a one-sample plane's rawmode letter → its bits
REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)  # each byte's bits reversed


def _ifd(data: bytes) -> tuple[str, dict, dict]:
    """The byte order, the first IFD's tags (tag → tuple of values) and
    each tag's field type (a tag of no values has a type, but no values)."""
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
        tags, types = {}, {}
        for i in range(count):
            pos = at + i * entry
            tag, typ = struct.unpack_from(order + "HH", data, pos)
            (n,) = struct.unpack_from(order + ("Q" if big else "I"), data, pos + 4)
            if typ not in TYPES:
                continue
            if n == 0:  # PIL keeps no tag of no values (libtiff may refuse one: ``_decode``)
                types[tag] = typ
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
            tags[tag], types[tag] = vals, typ
    except struct.error as e:
        raise ValueError(f"TIFF: the IFD runs past the end of the file ({e})") from None
    return order, tags, types


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


def _unlzma(data: bytes, size: int) -> bytes:
    """libtiff's ``LZMADecode``: one xz stream (no concatenation) decoded
    until ``size`` bytes are out; an error liblzma meets in the call that
    fills them is not seen (``_xz.xz_prefix``: what it writes before one)."""
    try:
        out = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(data, size)
    except lzma.LZMAError:  # Python drops the output of the call that fails
        out = xz_prefix(data, size)
    if len(out) < size:
        raise ValueError("TIFF: LZMA data ends before its strip or tile (libtiff: not enough data)")
    return bytes(out[:size])


def thunderscan(data: bytes, width: int, rows: int) -> bytes:
    """libtiff's ``ThunderDecode``, row by row: 4-bit pixels from runs of the
    last pixel, 2- and 3-bit deltas (one value of each skips) and raw
    values, each row from pixel 0 at value 0; a row that is not filled
    exactly fails the strip. → ``rows`` rows of packed 4-bit pixels."""
    out = np.zeros((rows, width + 1), np.uint8)
    pos = 0
    for y in range(rows):
        row, last, n = out[y], 0, 0
        while pos < len(data) and n < width:
            b = data[pos]
            pos += 1
            code = b >> 6
            if code == 0:
                if n + (b & 63) > width:
                    raise ValueError("TIFF: a ThunderScan run past its row (libtiff: too much data)")
                row[n:n + (b & 63)] = last
                n += b & 63
                continue
            values = ([(b >> s) & 3 for s in (4, 2, 0) if (b >> s) & 3 != 2] if code == 1 else
                      [(b >> s) & 7 for s in (3, 0) if (b >> s) & 7 != 4] if code == 2 else [b & 15])
            for v in values:
                last = (last + (0, 1, 0, -1)[v] if code == 1 else last + (0, 1, 2, 3, 0, -3, -2, -1)[v]
                        if code == 2 else v) & 15
                if n < width:
                    row[n] = last
                    n += 1
        if n != width:
            raise ValueError("TIFF: a ThunderScan row short of its pixels (libtiff: not enough data)")
    pairs = out[:, :width + (width & 1)].reshape(rows, -1, 2)
    return (pairs[..., 0] << 4 | pairs[..., 1]).tobytes()


def _decompress(compression: int, raw: bytes, size: int) -> bytes:
    """One strip or tile of a byte-oriented libtiff codec → ``size`` bytes."""
    if compression == 5:
        return lzw_msb(raw, size)
    if compression in (8, 32946):
        return _inflate(raw, size)
    if compression == 32773:
        return packbits(raw, size)
    if compression == 34925:
        return _unlzma(raw, size)
    if compression == 50000:
        return decode_zstd_strip(raw, size)
    if len(raw) < size:
        raise ValueError("TIFF: the pixel data is truncated")
    return raw


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
    bits = pixel_bits or (8 if planar == 2 else sum(bps))  # separate planes: a letter of the rawmode, a byte each
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
        step = stride or nbytes  # a stride under the row's bytes reads rows that overlap, as PIL does
        need = (h - 1) * step + nbytes if h > 0 else 0
        chunk = data[offset:offset + need]
        if len(chunk) < need:
            raise ValueError("TIFF: the pixel data is truncated (PIL: image file is truncated)")
        if fill == 2 and planar != 2:  # a plane's letter of the rawmode reads its bytes as stored
            chunk = REVERSED[np.frombuffer(chunk, np.uint8)].tobytes()
        if h > 0:
            rows = np.lib.stride_tricks.as_strided(np.frombuffer(chunk, np.uint8), (h, nbytes), (step, 1))
            _place(out[layer], rows, y, x, w, bits)
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
    predictor = tags.get(PREDICTOR, (1,))[0] if compression in PREDICTED else 1
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
    if tiled and th * row_bytes > -(-th * pixel_bits // 8) * tw:  # PIL's bound on libtiff's tile size
        raise ValueError("TIFF: a sub-byte tile larger than PIL's bound on it (PIL: decoder error -2)")
    jpeg = _jpeg_setup(data, tags, offsets, counts) if compression == 7 else None
    held = np.zeros((th, row_bytes), np.uint8)  # PIL's one strip or tile buffer, what each JPEG leaves unwritten kept
    ccitt = {}  # libtiff's fax state that outlives a strip or tile
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
                    raw = _jpeg_chunk(raw, jpeg, held[:rows], j == down - 1 and not tiled)
                elif compression == 32809:
                    if bps != (4,):
                        raise ValueError(f"TIFF: ThunderScan at {bps} bits (libtiff: only 4 bits a sample)")
                    raw = thunderscan(raw, tw, rows)
                elif compression in CCITT:
                    raw = decode_ccitt(raw, compression, tw, rows, tags.get(T4OPTIONS, (0,))[0], offsets[k], ccitt)
                else:
                    raw = _decompress(compression, raw, size)
                chunk = np.frombuffer(raw, np.uint8, size).reshape(rows, row_bytes)
                if predictor == 2:
                    chunk = _unpredict(chunk, bps[0], 1 if planar == 2 else len(bps), order)
                elif predictor == 3:
                    chunk = _unpredict_float(chunk, bps[0], 1 if planar == 2 else len(bps), order)
                y0, x0 = j * th, i * tw
                _place(out[plane], chunk[:min(rows, height - y0)], y0, x0, min(tw, width - x0), pixel_bits)
    return out


def _place(out: np.ndarray, rows: np.ndarray, y: int, x: int, w: int, bits: int) -> None:
    """Write the first ``w`` pixels (``bits`` each) of a chunk's (h, bytes)
    rows at pixel (y, x) of a plane's (H, row bytes) rows: whole bytes, or
    bit by bit where x·bits falls inside a byte (sub-byte tiles)."""
    nb = -(-w * bits // 8)
    if x * bits % 8 == 0:
        out[y:y + rows.shape[0], x * bits // 8:x * bits // 8 + nb] = rows[:, :nb]
        return
    plane = np.unpackbits(out[y:y + rows.shape[0]], axis=1)
    plane[:, x * bits:x * bits + w * bits] = np.unpackbits(rows, axis=1)[:, :w * bits]
    out[y:y + rows.shape[0]] = np.packbits(plane, axis=1)


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
        sampling = subsampling_tag(tags) or _sof_sampling(
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


def _jpeg_chunk(stream: bytes, jpeg: tuple, held: np.ndarray, last_strip: bool) -> bytes:
    """One strip or tile of a JPEG-compressed TIFF decoded into ``held``,
    its (rows, row bytes) buffer, as libtiff's ``JPEGPreDecode`` admits it
    and ``JPEGDecode`` writes it: the stream's frame no wider than its strip
    or tile and no taller (the last strip may be taller; its extra rows are
    dropped); a smaller frame's rows written from the left of the first
    rows, the rest of the buffer left as the strip or tile before left it
    (PIL decodes every strip or tile into one buffer; before the first, the
    port's is zero where PIL's holds whatever memory it was given)."""
    tables, ycc, sampling, memo = jpeg
    img = decode_abbreviated(stream, tables, ycc, sampling, memo)
    h, w = img.shape[:2]
    rows, cols = held.shape[0], held.shape[1] // img.shape[2]
    if w > cols or h > rows and not (last_strip and w == cols):
        raise ValueError(f"TIFF: a {w}x{h} JPEG in a {cols}x{rows} strip or tile (libtiff: JPEG strip/tile size "
                         "exceeds expected dimensions)")
    n = min(h, rows)
    held[:n, :w * img.shape[2]] = img[:n].reshape(n, -1)
    return held.tobytes()


def _ycbcr_rgba(data: bytes, order: str, tags: dict, compression: int, fill: int) -> np.ndarray:
    """libtiff's RGBA interface on contiguous 8-bit YCbCr (``tif_getimage.c``),
    which PIL's libtiff decoder takes for YCbCr that is not JPEG-compressed:
    each strip or tile decoded to its packed data units (``hs·vs`` luma
    samples, then Cb and Cr, for each ``hs × vs`` block), every pixel of a
    block given the block's chroma (replication, no filter; in an edge tile
    of 4×4 blocks each row of blocks starts where libtiff's
    ``putcontig8bitYCbCr44tile`` puts it, 8 bytes a skipped block early),
    then ``TIFFYCbCrtoRGB`` with the tables ``TIFFYCbCrToRGBInit`` builds in
    float from ``YCbCrCoefficients`` and ``ReferenceBlackWhite``."""
    hs, vs = subsampling_tag(tags) or (2, 2)
    if tags.get(PLANAR, (1,))[0] == 2:  # putseparate8bitYCbCr11tile: libtiff's one separate-plane case
        if (hs, vs) != (1, 1):
            raise ValueError(f"TIFF: YCbCr {hs}x{vs} in separate planes (libtiff: can not handle format)")
        y, cb, cr = (p[:, :tags[WIDTH][0]].astype(np.int64)
                     for p in _coded_samples(data, order, tags, compression, fill, (8, 8, 8), 2))
        return _ycbcr_to_rgb(_ycbcr_tables(tags), y, cb, cr)
    if (hs, vs) not in ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)):  # tif_getimage.c's cases
        raise ValueError(f"TIFF: YCbCr subsampling {hs}x{vs} (libtiff: can not handle format)")
    predictor = tags.get(PREDICTOR, (1,))[0] if compression in PREDICTED else 1
    if predictor not in (1, 2):
        raise ValueError(f"TIFF: predictor {predictor} on 8-bit YCbCr (libtiff: not supported)")
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
            raw = _decompress(compression, raw, size)
            step = tw * 3 if tiled else -(-width // hs) * unit // vs
            if predictor == 2 and size % step == 0 and step % 3 == 0:
                # libtiff undoes the differencing on the data units as if they were rows of 3-byte
                # pixels: rows of a tile's width × 3 bytes, or of a strip's scanline (a row of data units
                # over the vertical subsampling), each byte summed with the one 3 before it; where the
                # units do not divide so it fails the strip, which the RGBA interface (PIL asks it not
                # to stop on errors) then draws undifferenced
                raw = _unpredict(np.frombuffer(raw, np.uint8, size).reshape(-1, step), 8, 3, "<").tobytes()
            _put_ycbcr(out, raw, tables, (hs, vs), tw, rows, j * th, i * tw)
    return out


def _put_ycbcr(out: np.ndarray, raw: bytes, tables: list, sampling: tuple, tw: int, rows: int, y0: int,
               x0: int) -> None:
    """``putcontig8bitYCbCr*tile``: one strip's or tile's packed data units
    (``raw``, ``rows`` rows ``tw`` wide) drawn into ``out`` at (y0, x0), each
    pixel given its block's chroma."""
    hs, vs = sampling
    height, width = out.shape[:2]
    unit = hs * vs + 2
    h, w = min(rows, height - y0), min(tw, width - x0)
    # each row of data units read after the last one's ceil(w/hs) units
    # and a skip of the tile's columns past the image; libtiff's 4×4
    # case skips 10 bytes a skipped unit, not 18
    skip = (tw - w) // hs * (10 if (hs, vs) == (4, 4) else unit)
    used = -(-w // hs)
    at = (np.arange(-(-rows // vs))[:, None] * (used * unit + skip) + np.arange(used)[None] * unit)
    u = np.frombuffer(raw, np.uint8, -(-tw // hs) * -(-rows // vs) * unit)[at[..., None] + np.arange(unit)]
    u = u.astype(np.int64)
    yy, xx = np.mgrid[0:h, 0:w]
    luma = u[yy // vs, xx // hs, (yy % vs) * hs + xx % hs]
    cb, cr = u[yy // vs, xx // hs, hs * vs], u[yy // vs, xx // hs, hs * vs + 1]
    out[y0:y0 + h, x0:x0 + w] = _ycbcr_to_rgb(tables, luma, cb, cr)


def _ycbcr_to_rgb(tables: list, luma: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``TIFFYCbCrtoRGB`` on 8-bit samples with ``_ycbcr_tables``' tables."""
    yt, cr_r, cb_b, cr_g, cb_g = tables
    rgb = [yt[luma] + cr_r[cr], yt[luma] + ((cb_g[cb] + cr_g[cr]) >> 16), yt[luma] + cb_b[cb]]
    return np.clip(np.stack(rgb, -1), 0, 255).astype(np.uint8)


def _old_jpeg(data: bytes, order: str, tags: dict, rawmode: str, planar: int) -> np.ndarray:
    """Old-style JPEG (compression 6, ``utils/_ojpeg.py``) as PIL takes it:
    three samples through libtiff's RGBA interface (``_put_ycbcr``; separate
    planes ``_old_jpeg_separate``), one buffer a strip or a row of tiles — a
    tile libtiff fails before decoding drawn from a zeroed buffer, and the
    file refused where the first of a strip or row of tiles fails so; one
    sample placed as PIL's own strip and tile reads place it, one tile
    buffer kept across the tiles."""
    width, height = tags[WIDTH][0], tags[LENGTH][0]
    if TILEOFFSETS in tags:
        tw, th = tags.get(TILEWIDTH, (0,))[0], tags.get(TILELENGTH, (0,))[0]
    else:
        tw, th = width, min(tags.get(ROWSPERSTRIP, (height,))[0], height) or height
    across, down = -(-width // tw), -(-height // th)
    if planar == 2:
        return _old_jpeg_separate(old_jpeg_separate(data, order, tags), tags, tw, th, across, down)
    if rawmode == "L":
        chunks = old_jpeg_gray(data, order, tags)
        out = np.zeros((height, width, 1), np.uint8)
        held = np.zeros((th, tw), np.uint8)
        for k, (rows, n) in enumerate(chunks):
            held[:n] = rows[:n]  # a tile's rows past libjpeg's frame keep what the tile before left
            j, i = divmod(k, across)
            h, w = min(th, height - j * th), min(tw, width - i * tw)
            out[j * th:j * th + h, i * tw:i * tw + w, 0] = held[:h, :w]
        return out
    (hs, vs), chunks = old_jpeg_units(data, order, tags)
    tables = _ycbcr_tables(tags)
    out = np.zeros((height, width, 3), np.uint8)
    for j in range(down):
        buf = None  # gtStripContig's or gtTileContig's buffer: one a strip, one a row of tiles
        for i in range(across):
            k = j * across + i
            rows = th if TILEOFFSETS in tags else min(th, height - j * th)
            if chunks[k] is not None:
                buf = chunks[k]
            elif buf is None:
                raise ValueError("TIFF: old-style JPEG: libtiff fails a strip or tile before decoding it, after an "
                                 "error in the one before (PIL: decoder error)")
            else:
                buf = np.zeros_like(buf)  # TIFFReadEncodedTile zeroes the row's buffer
            _put_ycbcr(out, buf.tobytes(), tables, (hs, vs), tw, rows, j * th, i * tw)
    return out


def _old_jpeg_separate(chunks: list, tags: dict, tw: int, th: int, across: int, down: int) -> np.ndarray:
    """``gtStripSeparate`` / ``gtTileSeparate`` over old-style JPEG's three
    planes: one buffer a strip or a row of tiles, each plane's rows read in
    turn (a read libtiff fails before decoding zeroes its rows; the first of
    a strip or row of tiles refuses the file), then
    ``putseparate8bitYCbCr11tile``."""
    width, height = tags[WIDTH][0], tags[LENGTH][0]
    tables = _ycbcr_tables(tags)
    out = np.zeros((height, width, 3), np.uint8)
    for j in range(down):
        buf = None
        for i in range(across):
            k = j * across + i
            for plane in range(3):
                rows = chunks[plane][k]
                if rows is None and buf is None:
                    raise ValueError("TIFF: old-style JPEG: libtiff fails the first plane of a strip or tile before "
                                     "decoding it (PIL: decoder error)")
                if buf is None:
                    buf = np.zeros((3, th, tw), np.uint8)
                if rows is None:
                    buf[plane] = 0
                else:
                    buf[plane, :len(rows)] = rows
            h, w = min(th, height - j * th), min(tw, width - i * tw)
            y, cb, cr = (buf[p, :h, :w].astype(np.int64) for p in range(3))
            out[j * th:j * th + h, i * tw:i * tw + w] = _ycbcr_to_rgb(tables, y, cb, cr)
    return out


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
    the first image, turned by its orientation as PIL turns it."""
    if data[:4] not in SIGNATURES or len(data) < 8:
        raise ValueError("not a TIFF file")
    order, tags, types = _ifd(data)
    try:
        img = _decode(data, order, tags, types, _orientation_tag(tags, types) >= 5)
    except IndexError:  # a tag the image needs stored with no values (a count of 0), or no strips at all
        raise ValueError("TIFF: a tag without the values the image needs (PIL: cannot read the file)") from None
    return np.ascontiguousarray(TRANSPOSES.get(_orientation(tags, types), lambda a: a)(img))


def _orientation_tag(tags: dict, types: dict) -> int:
    """The Orientation tag as PIL's ``tag_v2`` and ``getexif`` read it: its
    first value where it is a number (a byte, string or undefined field
    reads as bytes, which name no orientation), else 0."""
    v = tags.get(ORIENTATION, ())
    if types.get(ORIENTATION) in (1, 2, 7) or not v:
        return 0
    return next((k for k in TRANSPOSES if v[0] == k), 0)


def _orientation(tags: dict, types: dict) -> int:
    """The orientation ``ImageOps.exif_transpose`` applies: the tag's, or
    where the file has none the first ``tiff:Orientation`` digit of its XMP
    packet (tag 700) — a packet PIL holds as a string or numbers fails its
    bytes pattern."""
    if ORIENTATION in tags or XMP not in tags:
        return _orientation_tag(tags, types)
    v = tags[XMP]
    if types[XMP] in (1, 7):
        text = bytes(v)
    elif (bytes(v[:-1] if v[-1:] == (0,) else v) if types[XMP] == 2 else (v[0] if len(v) == 1 else v)):
        raise ValueError("TIFF: an XMP packet that is not bytes (PIL: expected a bytes-like object)")
    else:
        return 0
    m = re.search(rb'tiff:Orientation(="|>)([0-9])', text)
    return int(m[2]) if m and int(m[2]) in TRANSPOSES else 0


def _decode(data: bytes, order: str, tags: dict, types: dict, swapped: bool) -> np.ndarray:
    """The first image at its stored size — but where PIL memory-maps a raw
    file under an orientation of 5 to 8 (``_mapped``)."""
    compression = tags.get(COMPRESSION, (1,))[0]
    if compression not in COMPRESSIONS or compression in UNREAD:
        raise ValueError(f"TIFF: compression {COMPRESSIONS.get(compression, compression)}, which PIL does not read "
                         "either")
    if WIDTH not in tags or LENGTH not in tags:
        raise ValueError("TIFF: no image width or length (PIL: missing dimensions)")
    width, height = tags[WIDTH][0], tags[LENGTH][0]
    if not (isinstance(width, int) and isinstance(height, int)):
        raise ValueError(f"TIFF: a {width}x{height} image (PIL: invalid dimensions)")
    if compression != 1 and any(t in types and t not in tags for t in (BITS, SAMPLES, ROWSPERSTRIP)):
        raise ValueError("TIFF: a sample or strip tag of no values (libtiff: cannot read the directory)")
    fill = tags.get(FILLORDER, (1,))[0]
    mode, rawmode, bps = _mode(order, tags, fill)
    if compression != 1 and fill == 2:  # libtiff reverses the bits; PIL reads the fill-order-1 layout
        mode, rawmode, bps = _mode(order, tags, 1)
    if not (width and height):
        raise ValueError(f"TIFF: a {width}x{height} image")
    planar = tags.get(PLANAR, (1,))[0]
    if compression != 1 and planar not in (1, 2):
        raise ValueError(f"TIFF: planar configuration {planar} (libtiff: bad value)")
    if compression != 1 and len(bps) == 1:
        planar = 1  # libtiff: one sample's plane is the contiguous layout
    palette = None
    if mode in ("P", "PA"):
        cmap = np.asarray(tags.get(COLORMAP, ()), np.int64) // 256
        n = len(cmap) // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[:min(n, 256)] = cmap[:3 * n].reshape(3, n).T[:256]
    photo = tags.get(PHOTOMETRIC, (0,))[0]
    if compression == 6:
        if planar == 2 and len(tags.get(STRIPOFFSETS, ())) == len(tags.get(STRIPBYTECOUNTS, ())) == 1:
            planar = 1  # libtiff: one strip and one byte count are one contiguous image
        return _old_jpeg(data, order, tags, rawmode, planar)
    if compression == 7 and photo == 6 and planar == 1:
        rawmode = "RGB"  # PIL: libjpeg converts to RGB
    elif compression == 7 and planar == 2 and photo == 6:
        raise ValueError("TIFF: JPEG-compressed YCbCr in separate planes (PIL: decoder error)")
    elif rawmode == "RGBX" and photo == 6 and compression != 1:
        return _ycbcr_rgba(data, order, tags, compression, fill)
    if compression == 1:
        bps_count = {2: 3, 6: 3, 8: 3, 5: 4}.get(photo, 1) + len(tags.get(EXTRASAMPLES, ()))
        if photo == 6 and rawmode == "RGBX" and planar == 1:
            # PIL's raw decoder reads YCbCr as RGBX: four file bytes a pixel,
            # no colour conversion, the subsampling ignored
            rows = _raw_samples(data, tags, rawmode, fill, bps, planar, bps_count, pixel_bits=32)[0]
            return np.ascontiguousarray(rows.reshape(height, width, 4)[..., :3])
        tile_rawmode = rawmode[0] if planar == 2 else rawmode
        mapped = _mapped(data, tags, mode, tile_rawmode, planar, bps, bps_count) if swapped else None
        if mapped is not None:
            planes, (width, height) = [mapped[0]], mapped[1]
        else:
            letter_bits = LETTER_BITS.get(tile_rawmode) if planar == 2 and tile_rawmode == mode else None
            planes = _raw_samples(data, tags, rawmode, fill, bps, planar, bps_count, letter_bits)
        if planar == 2:  # each plane read as the rawmode's letter
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


def _mapped(data: bytes, tags: dict, mode: str, tile_rawmode: str, planar: int, bps: tuple,
            bps_count: int) -> tuple | None:
    """PIL's memory map of a raw file (``ImageFile.load``: one strip or tile,
    read in the image's own mode) where the orientation swaps PIL's size
    before the map is made: the pixels read as rows of the image's height,
    as many rows as its width, each at the tile's stride. → (rows, (width,
    height)) at that swapped size, or None where PIL decodes the file."""
    width, height = tags[WIDTH][0], tags[LENGTH][0]
    if tile_rawmode != mode or mode not in MAPPED:
        return None
    tw, th, _, _, offsets, _ = _planes_of(tags)
    if TILEOFFSETS not in tags:
        th = tags.get(ROWSPERSTRIP, (height,))[0]
    if tw == width and th == height and planar != 2:
        offsets = offsets[-1:]
    if len(offsets) != 1:
        return None
    stride = int(tw * sum(bps) / 8 / (bps_count if planar == 2 else 1)) if tw > width else 0
    at, row = offsets[0], height * MAPPED[mode]
    if at + width * stride > len(data):  # ImageFile's own check: PIL decodes instead
        return None
    step = stride or row
    if at + width * step > len(data):
        raise ValueError("TIFF: the pixel data is truncated (PIL: buffer is not large enough)")
    rows = np.lib.stride_tricks.as_strided(np.frombuffer(data, np.uint8, offset=at), (width, row), (step, 1))
    return np.array(rows), (height, width)


def _wide_to_u8(v: np.ndarray, mode: str) -> np.ndarray:
    """``convert("RGB")``'s one channel from PIL's mode I (clipped to
    [0, 255]) or F (truncated toward zero, then clipped; NaN 0, +inf 255)."""
    if mode == "F":
        with np.errstate(invalid="ignore"):  # a byte-swapped sample may be a signalling NaN
            v = np.trunc(np.nan_to_num(v.astype(np.float64), nan=0.0, posinf=255.0, neginf=0.0))
    return np.clip(v, 0, 255).astype(np.uint8)


def _separate_rawmode(rawmode: str, tags: dict) -> str:
    """libtiff's separate planes as PIL gives them: RGBA without extra
    samples comes back with its alpha divided out (as ``RGBa``), LA and PA
    without their alpha (``_decode``), CIELab as stored; a layout with an
    unused extra sample (RGBX, RGBXX, RGBaX, RGBAX: PIL fills the image's
    bands from the first planes) only from tiles — from strips PIL's
    decoder fails."""
    base = rawmode.split(";")[0]
    if base == "RGBA" and EXTRASAMPLES not in tags:
        return "RGBa" + rawmode[4:]
    if "X" in base and TILEOFFSETS not in tags:
        raise ValueError(f"TIFF: {base} in separate strips (PIL: decoder error -2)")
    return "LAB;P" if base == "LAB" else rawmode


def _bands(planes: list, rawmode: str, mode: str, width: int, palette) -> np.ndarray:
    """PIL's raw path with separate planes: plane k is the band of the mode
    named by the rawmode's k-th letter, its bytes read one a pixel; one
    sample's plane read by the letter's own unpacker (``LETTER_BITS``: as
    stored, no scaling, inversion or bit reversal)."""
    if len(planes) == 1 and mode in LETTER_BITS and rawmode[0] == mode:
        p = planes[0]
        if mode == "1":
            return np.repeat((np.unpackbits(p, axis=1)[:, :width] * 255)[..., None], 3, -1)
        if mode in ("I", "F"):
            v = np.ascontiguousarray(p[:, :4 * width]).view("<i4" if mode == "I" else "<f4")
            return np.repeat(_wide_to_u8(v, mode)[..., None], 3, -1)
        return palette[p[:, :width]] if mode == "P" else np.ascontiguousarray(p[:, :width, None])
    chans = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "LAB": "LAB"}.get(mode)  # none for LA, PA
    if chans is None or not set(rawmode[:len(planes)]) <= set(chans):
        raise ValueError(f"TIFF: separate planes of rawmode {rawmode} (PIL: unknown raw mode)")
    h = planes[0].shape[0]
    img = np.zeros((h, width, len(chans)), np.int64)
    for letter, plane in zip(rawmode, planes):
        img[..., chans.index(letter)] = plane[:, :width]
    return _convert(img, chans + (";P" if mode == "LAB" else ""), mode, palette)


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
    if mode == "LAB":  # LittleCMS to RGB; load_image asks for RGBA ("A" is in "LAB"), the alpha PIL's fourth byte
        if suffix == ";P":  # separate planes: PIL's band unpackers copy a* and b* as stored, the fourth byte 0
            return np.concatenate([lab_to_rgb(s.astype(np.uint8)), np.zeros(s.shape[:-1] + (1,), np.uint8)], -1)
        lab = s.astype(np.uint8) ^ np.array([0, 128, 128], np.uint8)  # PIL's LAB unpacker flips their sign bits
        return np.concatenate([lab_to_rgb(lab), np.full(lab.shape[:-1] + (1,), 255, np.uint8)], -1)
    rgb = s[..., :3]
    if mode == "RGB":
        return rgb.astype(np.uint8)
    a = s[..., 3:4]
    if base.startswith("RGBa"):  # associated alpha divided out (Unpack.c's unpackRGBa)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, np.minimum(255, rgb * 255 // np.maximum(a, 1))))
    return np.concatenate([rgb, a], -1).astype(np.uint8)
