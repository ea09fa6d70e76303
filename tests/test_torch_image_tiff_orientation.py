"""PyTorch port vs the JAX package: the TIFF Orientation tag (274) in
``utils/image_io.load_image``.

PIL turns every TIFF it loads by its orientation (``ImageOps.exif_transpose``
from ``TiffImageFile.load_end``): 2 ``FLIP_LEFT_RIGHT``, 3 ``ROTATE_180``,
4 ``FLIP_TOP_BOTTOM``, 5 ``TRANSPOSE``, 6 ``ROTATE_270``, 7 ``TRANSVERSE``,
8 ``ROTATE_90``; 0, 1 and 9 leave the image as stored. Each file of every
decode path — PIL's raw decoder and its memory map, libtiff's LZW, Deflate,
PackBits, JPEG, LZMA, Zstd and CCITT, tiles and separate planes, 1-bit,
palette, 16-bit and float samples, old-style JPEG and libtiff's RGBA
interface for YCbCr — is re-tagged with every value 0-9 as SHORT and as
LONG, and the port's decode must equal the JAX package's ``load_image`` in
shape and bit for bit (``held_to_jax``). Then the tag's other field types,
a tag of two values, the XMP packet's ``tiff:Orientation`` where the tag is
absent, and PIL's memory-mapped raw files, which PIL reads at the swapped
size before it turns them.
"""

import io
import os
import struct
import tempfile

import numpy as np
import pytest
from PIL import Image

from chip_smoke import write_jpeg_tiff, write_tiff
from physically_based_renderer_tpu_torch.utils.image_io import load_image
from test_torch_image_formats import _seeded_photo, _write, held_to_jax
from test_torch_image_tiff_jpeg_ico import _jpeg, old_jpeg_tiff, ycbcr_tiff

H, W = 6, 8
TRANSPOSES = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
              5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
              7: lambda a: np.rot90(a, 2).transpose(1, 0, 2), 8: lambda a: np.rot90(a, 1)}


def with_tags(data: bytes, extra: dict) -> bytes:
    """A copy of classic-TIFF ``data`` whose first IFD is written again at
    the end with ``extra`` (tag → (type, count, field bytes), or None to
    drop the tag); the pixel data stays where it was."""
    order = "<" if data[:2] == b"II" else ">"
    (at,) = struct.unpack_from(order + "I", data, 4)
    (n,) = struct.unpack_from(order + "H", data, at)
    entries = {struct.unpack_from(order + "H", data, at + 2 + 12 * i)[0]: data[at + 2 + 12 * i:at + 14 + 12 * i]
               for i in range(n)}
    out = bytearray(data) + bytes(len(data) & 1)
    for tag, value in extra.items():
        if value is None:
            entries.pop(tag, None)
            continue
        typ, count, payload = value
        if len(payload) <= 4:
            field = payload.ljust(4, b"\0")
        else:
            field = struct.pack(order + "I", len(out))
            out += payload + bytes(len(payload) & 1)
        entries[tag] = struct.pack(order + "HHI", tag, typ, count) + field
    ifd = len(out)
    out += struct.pack(order + "H", len(entries)) + b"".join(entries[t] for t in sorted(entries)) + bytes(4)
    out[4:8] = struct.pack(order + "I", ifd)
    return bytes(out)


def orientation(data: bytes, value, typ: int = 3) -> bytes:
    order = "<" if data[:2] == b"II" else ">"
    fmt = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q"}.get(typ)
    payload = struct.pack(order + "II", *value) if typ == 5 else struct.pack(order + fmt, value)
    return with_tags(data, {274: (typ, 1, payload)})


def _pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _written(img, **kw) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        write_tiff(os.path.join(d, "w.tif"), img, **kw)
        with open(os.path.join(d, "w.tif"), "rb") as f:
            return f.read()


def _path_files() -> dict:
    """One small file of each decode path."""
    rng = np.random.default_rng(18)
    rgb, rgba = _seeded_photo(rng, H, W, 3), _seeded_photo(rng, H, W, 4)
    gray = rgb[..., 0]
    files = {}
    for comp in ("raw", "tiff_lzw", "tiff_deflate", "packbits", "lzma", "zstd"):
        files[f"RGB {comp}"] = _pil(Image.fromarray(rgb), compression=comp)
        files[f"RGBA {comp}"] = _pil(Image.fromarray(rgba), compression=comp)
    files["L raw"] = _pil(Image.fromarray(gray))
    files["L jpeg"] = _pil(Image.fromarray(gray), compression="jpeg")
    files["RGB jpeg"] = _pil(Image.fromarray(rgb), compression="jpeg")
    files["P raw"] = _pil(Image.fromarray(rgb).convert("P"))
    files["P lzw"] = _pil(Image.fromarray(rgb).convert("P"), compression="tiff_lzw")
    files["CMYK raw"] = _pil(Image.fromarray(rgba, "CMYK"))
    files["1 raw"] = _pil(Image.fromarray(gray).convert("1"))
    files["1 group4"] = _pil(Image.fromarray(gray).convert("1"), compression="group4")
    files["1 group3 2-D"] = _pil(Image.fromarray(gray).convert("1"), compression="group3", tiffinfo={292: 1})
    files["I;16 raw"] = _pil(Image.fromarray(gray.astype(np.uint16) * 3, "I;16"))
    files["F deflate"] = _pil(Image.fromarray(gray.astype(np.float32) / 2, "F"), compression="tiff_deflate")
    files["LAB raw"] = _pil(Image.frombytes("LAB", (W, H), rgb.tobytes()))
    for name, kw in (("tiles lzw", dict(tile=(4, 4), compression=5)), ("tiles raw", dict(tile=(4, 4), compression=1)),
                     ("one wide tile raw", dict(tile=(16, 16), compression=1)),
                     ("planes lzw", dict(planar=2, compression=5)), ("planes raw", dict(planar=2, compression=1)),
                     ("16-bit big-endian raw", dict(bits=16, byteorder=">", compression=1))):
        img = rgb if "16" not in name else rgb[..., :1].astype(np.uint16) * 200
        files[name] = _written(img, **kw)
        files[name + ", one sample"] = _written(img[..., :1], **kw)
    files["YCbCr lzw 2x2"] = ycbcr_tiff(rng, H, W, 2, 2, 5)
    files["YCbCr lzw 2x2 tiles"] = ycbcr_tiff(rng, H, W, 2, 2, 5, tile=(16, 16))
    files["YCbCr raw"] = ycbcr_tiff(rng, H, W, 2, 2, 1)
    files["old-style JPEG"] = old_jpeg_tiff(_seeded_photo(rng, 16, 24, 3), (2, 2))
    with tempfile.TemporaryDirectory() as d:
        write_jpeg_tiff(os.path.join(d, "j.tif"), [_jpeg(_seeded_photo(rng, 16, 16, 3), 2)], 16, 16)
        with open(os.path.join(d, "j.tif"), "rb") as f:
            files["JPEG-in-TIFF YCbCr"] = f.read()
    return files


PATHS = _path_files()


@pytest.mark.parametrize("name", list(PATHS))
def test_every_orientation_on_every_path(tmp_path, name):
    """Orientations 0-9, as SHORT and as LONG: the port equals PIL, and a
    file PIL does not mis-read (its memory map below) comes out as the
    stored image turned by PIL's transpose."""
    data = PATHS[name]
    stored = held_to_jax(_write(tmp_path, "o.tif", data))
    assert stored is not None
    for typ in (3, 4):
        for value in range(10):
            got = held_to_jax(_write(tmp_path, f"o{value}.tif", orientation(data, value, typ)))
            if value in TRANSPOSES and not (value >= 5 and got.shape == stored.shape and H != W):
                assert np.array_equal(got, np.ascontiguousarray(TRANSPOSES[value](stored))), (typ, value)
            elif value not in TRANSPOSES:
                assert np.array_equal(got, stored), (typ, value)


FIELD_TYPES = {  # name → (type, value) of the tag: PIL reads numbers, not bytes or strings
    "SBYTE 6": (6, 6), "SSHORT 6": (8, 6), "SLONG 6": (9, 6), "RATIONAL 6/1": (5, (6, 1)),
    "RATIONAL 12/2": (5, (12, 2)), "RATIONAL 13/2": (5, (13, 2)), "RATIONAL 6/0": (5, (6, 0)),
    "FLOAT 6": (11, 6.0), "DOUBLE 3": (12, 3.0), "LONG8 5": (16, 5), "BYTE 6": (1, 6), "SSHORT -2": (8, -2),
    "LONG 65542": (4, 65542),
}


@pytest.mark.parametrize("kind", ["L raw", "RGB tiff_lzw"])
def test_orientation_field_types(tmp_path, kind):
    """The tag as each field type, as PIL's ``tag_v2`` and ``getexif`` read
    it: a number turns the image, BYTE, UNDEFINED and ASCII fields (bytes
    and a string to PIL) and a count of 0 do not; two values read as the
    first."""
    data = PATHS[kind]
    for name, (typ, value) in FIELD_TYPES.items():
        assert held_to_jax(_write(tmp_path, "t.tif", orientation(data, value, typ))) is not None, name
    for extra in ({274: (7, 1, b"\x06")}, {274: (2, 2, b"6\0")}, {274: (3, 0, b"")},
                  {274: (3, 2, struct.pack("<HH", 8, 1))}, {274: (3, 2, struct.pack("<HH", 6, 6))}):
        assert held_to_jax(_write(tmp_path, "t.tif", with_tags(data, extra))) is not None, extra


XMP = b'<x:xmpmeta><rdf:Description tiff:Orientation="6"/></x:xmpmeta>'


@pytest.mark.parametrize("kind", ["L raw", "RGB tiff_lzw"])
def test_xmp_orientation(tmp_path, kind):
    """Without the tag PIL takes the first ``tiff:Orientation`` digit of the
    XMP packet (700), as an attribute or an element, BYTE or UNDEFINED; a
    packet PIL holds as a string or numbers fails its bytes pattern — the
    port refuses those files too; with the tag present, even 0, the packet
    is not read."""
    data = PATHS[kind]
    cases = [{700: (1, len(XMP), XMP)}, {700: (7, len(XMP), XMP)},
             {700: (1, 37, b"<tiff:Orientation>8</tiff:Orientation>"[:37])},
             {700: (1, 21, b'tiff:Orientation="9"x')}, {700: (7, 21, b'tiff:Orientation="36"')},
             {700: (1, len(XMP), XMP), 274: (3, 1, struct.pack("<H", 3))},
             {700: (1, len(XMP), XMP), 274: (3, 1, struct.pack("<H", 0))},
             {700: (2, 1, b"\0")}, {700: (3, 1, struct.pack("<H", 0))}]
    for extra in cases:
        assert held_to_jax(_write(tmp_path, "x.tif", with_tags(data, extra))) is not None, extra
    for extra in ({700: (2, 4, b"abc\0")}, {700: (3, 1, struct.pack("<H", 3))}, {700: (3, 2, bytes(4))}):
        path = _write(tmp_path, "y.tif", with_tags(data, extra))
        assert held_to_jax(path) is None, extra
        with pytest.raises(ValueError, match="XMP"):
            load_image(path)


@pytest.mark.parametrize("mode", ["L", "P", "RGBA", "CMYK", "I;16", "planes of one sample", "one wide tile"])
def test_memory_mapped_raw_files(tmp_path, mode):
    """PIL memory-maps a raw file of one strip or tile read in its own mode
    (``Image._MAPMODES``) — at the size its orientation of 5-8 has already
    swapped, so the pixels come out as rows of the image's height, as many
    rows as its width, and are then turned. The port reads them so; two
    strips (no map) read upright."""
    rng = np.random.default_rng(len(mode))
    a = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    data = {"L": lambda: _pil(Image.fromarray(a[..., 0])), "P": lambda: _pil(Image.fromarray(a[..., :3]).convert("P")),
            "RGBA": lambda: _pil(Image.fromarray(a)), "CMYK": lambda: _pil(Image.fromarray(a, "CMYK")),
            "I;16": lambda: _written(a[..., :1].astype(np.uint16) * 3, bits=16, byteorder=">", compression=1),
            "planes of one sample": lambda: _written(a[..., :1], planar=2, compression=1),
            "one wide tile": lambda: _written(a[..., :1], tile=(16, 16), compression=1)}[mode]()
    stored = load_image(_write(tmp_path, "s.tif", data))
    for value in (5, 6, 7, 8):
        got = held_to_jax(_write(tmp_path, "m.tif", orientation(data, value)))
        assert got.shape == stored.shape and not np.array_equal(got, TRANSPOSES[value](stored)), value
    two_strips = _written(a[..., :1], rows_per_strip=3, compression=1)
    stored = load_image(_write(tmp_path, "t.tif", two_strips))
    for value in (5, 6, 7, 8):
        got = held_to_jax(_write(tmp_path, "n.tif", orientation(two_strips, value)))
        assert np.array_equal(got, TRANSPOSES[value](stored)), value
