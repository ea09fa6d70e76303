"""PyTorch port vs the JAX package: ``utils/image_io.load_image`` on GIF
(``utils/_gif.py``) and TIFF (``utils/_tiff.py``) files, and ``obj_scene``'s
pages from an MTL whose maps are a DDS, a GIF and a TIFF.

Every file is decoded by the port and by the JAX package's own
``load_image`` (PIL 12.1 with its libtiff) and the two held with
``np.array_equal`` (``held_to_jax``): no tolerance. Where PIL refuses a
file, the port must raise ``ValueError`` too.

GIF: the files PIL writes in each mode (interlaced or not, with a
transparency index, optimised); files written here by
``chip_smoke.write_gif`` at every LZW code size from 2 to 8 (and 9-11),
interlaced, with a full 4096-entry table cleared at once or later; files
crafted for the rest (a sub-rectangle, one past the screen's edge, a gray
local table under a colour global one, indices past the table, several
graphic-control extensions, comment and application extensions, stray
bytes, data that ends early or holds a bad code). TIFF: the files PIL
writes (raw, PackBits, LZW, Deflate in modes 1, L, LA, P, RGB, RGBA, CMYK,
I;16, I;16B) and, by ``chip_smoke.write_tiff``, every kind the port reads —
1-, 2-, 4-, 8- and 16-bit gray of both photometrics, 1-, 4- and 8-bit
palettes, RGB, RGBA, RGBX, associated alpha (8 and 16 bits), LA, PA, CMYK
(8 and 16) — over no compression, PackBits, LZW and Deflate × predictor 1
and 2 × strips and tiles × contiguous and separate planes × both byte
orders; then fill order 2, BigTIFF, the old LZW bit order, every
premultiplied (colour, alpha) pair, and files PIL refuses. LZW and
Deflate pages are built here, byte by byte, never by provoking libtiff
into an error.
"""

import itertools
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from chip_smoke import lzw_encode, write_dds, write_gif, write_tiff
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu_torch import scenes
from physically_based_renderer_tpu_torch.utils.image_io import load_image
from test_torch_image_formats import _blocky, _seeded_photo, _write, held_to_jax
from test_torch_obj_loader import write_sphere_obj

# -- GIF --------------------------------------------------------------------------------------

GIF_PIL_MODES = ("L", "P", "RGB", "1")


@pytest.mark.parametrize("mode", GIF_PIL_MODES)
def test_gif_written_by_pil(tmp_path, mode):
    """PIL's GIF writer at 37×23: plain, interlace off, a transparency
    index, optimised (a shorter table)."""
    rng = np.random.default_rng(len(mode) + 30)
    a = rng.integers(0, 256, (23, 37)).astype(np.uint8)
    im = Image.fromarray(a, "L")
    if mode == "P":
        im = Image.fromarray(a, "P")
        im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tolist())
    elif mode == "RGB":
        im = Image.fromarray(_seeded_photo(rng, 23, 37, 3))
    elif mode == "1":
        im = im.convert("1")
    for kw in ({}, {"interlace": False}, {"transparency": 5}, {"optimize": True}):
        path = str(tmp_path / "p.gif")
        im.save(path, **kw)
        assert held_to_jax(path) is not None, kw


@pytest.mark.parametrize("bits", range(2, 12))
def test_gif_code_sizes(tmp_path, bits):
    """``write_gif`` at LZW code size ``bits`` (indices below 2^min(bits, 8)),
    progressive rows and interlaced, with a colour table and with the gray
    ramp PIL reads as L; each decode equal to the indices through the table."""
    rng = np.random.default_rng(bits)
    vals = 1 << min(bits, 8)
    a = rng.integers(0, vals, (29, 41, 1)).astype(np.uint8)
    pal = rng.integers(0, 256, (vals, 3)).astype(np.uint8)
    for interlace, palette in itertools.product((False, True), (pal, None)):
        path = str(tmp_path / "c.gif")
        write_gif(path, a, palette, interlace=interlace, min_bits=bits)
        got = held_to_jax(path)
        want = a if palette is None else pal[a[..., 0]]
        assert np.array_equal(got, want), (interlace, palette is None)


@pytest.mark.parametrize("late_clear", [None, 0, 7, 500])
def test_gif_full_table(tmp_path, late_clear):
    """160×160 random indices fill the 4096-entry table several times; the
    clear code comes at once or after ``late_clear`` more 12-bit codes with
    the table frozen."""
    rng = np.random.default_rng(40)
    a = rng.integers(0, 256, (160, 160, 1)).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    path = str(tmp_path / "f.gif")
    write_gif(path, a, pal, late_clear=late_clear)
    assert np.array_equal(held_to_jax(path), pal[a[..., 0]])


def gif(sw, sh, gtable=None, exts=b"", x0=0, y0=0, w=None, h=None, ltable=None, interlace=False, pixels=b"",
        min_bits=8, codes=None, tail=None, trailer=b"\x3b") -> bytes:
    """A GIF89a file written field by field: the screen, its table, the
    extension bytes ``exts``, one image descriptor and its table, LZW data
    (``codes``, else the LZW of ``pixels``) in 255-byte sub-blocks, or the
    raw ``tail`` in their place."""
    def table_flags(t):
        return 0 if t is None else 0x80 | ((len(t) // 3).bit_length() - 2) & 7

    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, table_flags(gtable), 0, 0) + (gtable or b"") + exts
    w, h = sw if w is None else w, sh if h is None else h
    out += b"\x2c" + struct.pack("<HHHHB", x0, y0, w, h, table_flags(ltable) | (0x40 if interlace else 0))
    out += (ltable or b"") + bytes([min_bits])
    if tail is None:
        codes = lzw_encode(bytes(pixels), min_bits) if codes is None else codes
        tail = b"".join(bytes([len(codes[i:i + 255])]) + codes[i:i + 255] for i in range(0, len(codes), 255)) + b"\0"
    return out + tail + trailer


def gce(index, flags=1) -> bytes:
    return b"\x21\xf9\x04" + struct.pack("<BHB", flags, 0, index) + b"\x00"


RNG = np.random.default_rng(41)
COL = RNG.integers(0, 256, 768).astype(np.uint8).tobytes()
GRAY = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
PX = RNG.integers(0, 256, 12 * 9).astype(np.uint8).tobytes()
GIF_CRAFTED = {
    "sub_rectangle": gif(20, 15, COL, x0=3, y0=4, w=12, h=9, pixels=PX),
    "sub_rectangle_transparency": gif(20, 15, COL, gce(9), x0=3, y0=4, w=12, h=9, pixels=PX),
    "sub_rectangle_past_screen": gif(10, 8, COL, x0=3, y0=4, w=12, h=9, pixels=PX),
    "sub_rectangle_interlaced": gif(20, 15, COL, x0=3, y0=4, w=12, h=9, pixels=PX, interlace=True),
    "gray_local_under_colour": gif(12, 9, COL, ltable=GRAY, pixels=PX),
    "colour_local_under_gray": gif(12, 9, GRAY, ltable=COL, pixels=PX),
    "no_table": gif(12, 9, None, pixels=PX),
    "gray_transparency": gif(20, 15, GRAY, gce(200), x0=2, y0=2, w=12, h=9, pixels=PX),
    "index_past_4_entries": gif(12, 9, COL[:12], pixels=PX),
    "index_past_16_entries": gif(12, 9, COL[:48], pixels=PX),
    "two_control_extensions": gif(20, 15, COL, gce(9) + gce(3, 0), x0=3, y0=4, w=12, h=9, pixels=PX),
    "comment_application_stray_bytes": gif(12, 9, COL, b"\x21\xfe\x05hello\x03abc\x00"
                                           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00\x00\x07", pixels=PX),
    "data_ends_early": gif(12, 9, COL, codes=lzw_encode(PX, 8)[:40]),
    "file_ends_early": gif(12, 9, COL, tail=b"\x20" + lzw_encode(PX, 8)[:20], trailer=b""),
    "end_code_early": gif(12, 9, COL, codes=lzw_encode(PX[:50], 8)),
    "no_data_blocks": gif(12, 9, COL, tail=b"\x00"),
    "code_past_table": gif(12, 9, COL, codes=bytes([0x00, 0xFF, 0xFF, 0x7F]) + bytes(20)),
    "code_size_12": gif(12, 9, COL, min_bits=12, codes=bytes(30)),
    "code_size_13": gif(12, 9, COL, min_bits=13, codes=bytes(30)),
    "no_image": b"GIF89a" + struct.pack("<HHBBB", 4, 4, 0, 0, 0) + b"\x3b",
    "zero_size": gif(0, 0, COL, w=0, h=0),
    "short_control_extension": gif(12, 9, COL, b"\x21\xf9\x02\x01\x00\x00", pixels=PX),
}


@pytest.mark.parametrize("name", list(GIF_CRAFTED))
def test_gif_crafted(tmp_path, name):
    held_to_jax(_write(tmp_path, f"{name}.gif", GIF_CRAFTED[name]))


# -- TIFF -------------------------------------------------------------------------------------

TIFF_PIL_MODES = ("1", "L", "LA", "P", "RGB", "RGBA", "CMYK", "I;16", "I;16B")
TIFF_PIL_COMPRESSIONS = ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate")


@pytest.mark.parametrize("mode", TIFF_PIL_MODES)
def test_tiff_written_by_pil(tmp_path, mode):
    """PIL's TIFF writer at 37×23 in each of its compressions PIL reads
    back through the port's paths."""
    rng = np.random.default_rng(len(mode) + 50)
    channels = {"LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}.get(mode, 1)
    a = _blocky(rng, 23, 37, channels)
    if mode == "1":
        im = Image.fromarray(a[..., 0] > 127)
    elif mode in ("I;16", "I;16B"):
        im = Image.frombytes(mode, (37, 23), rng.integers(0, 1024, (23, 37)).astype(
            "<u2" if mode == "I;16" else ">u2").tobytes())
    elif mode == "P":
        im = Image.fromarray(a[..., 0], "P")
        im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tolist())
    else:
        im = Image.fromarray(a[..., 0] if channels == 1 else a, mode)
    for compression in TIFF_PIL_COMPRESSIONS:
        path = str(tmp_path / "p.tif")
        im.save(path, compression=compression)
        assert held_to_jax(path) is not None, compression


H, W = 37, 45
TIFF_KINDS = {  # name → write_tiff's keywords and (sample count, top value)
    "bilevel_black_is_zero": (dict(photometric=1, bits=1), (1, 2)),
    "bilevel_white_is_zero": (dict(photometric=0, bits=1), (1, 2)),
    "gray2": (dict(photometric=1, bits=2), (1, 4)),
    "gray4_black_is_zero": (dict(photometric=1, bits=4), (1, 16)),
    "gray4_white_is_zero": (dict(photometric=0, bits=4), (1, 16)),
    "gray8_black_is_zero": (dict(photometric=1), (1, 256)),
    "gray8_white_is_zero": (dict(photometric=0), (1, 256)),
    "gray16": (dict(photometric=1, bits=16), (1, 1024)),
    "gray16_white_is_zero": (dict(photometric=0, bits=16), (1, 1024)),
    "palette1": (dict(photometric=3, bits=1, colormap=RNG.integers(0, 65536, (2, 3))), (1, 2)),
    "palette4": (dict(photometric=3, bits=4, colormap=RNG.integers(0, 65536, (16, 3))), (1, 16)),
    "palette8": (dict(photometric=3, colormap=RNG.integers(0, 65536, (256, 3))), (1, 256)),
    "rgb8": ({}, (3, 256)),
    "rgb16": (dict(bits=16), (3, 65536)),
    "rgba8": (dict(extra_samples=(2,)), (4, 256)),
    "rgba8_no_extra_samples": ({}, (4, 256)),
    "rgbx8": (dict(extra_samples=(0,)), (4, 256)),
    "rgba8_associated": (dict(extra_samples=(1,)), (4, 256)),
    "rgba16": (dict(bits=16, extra_samples=(2,)), (4, 65536)),
    "rgba16_associated": (dict(bits=16, extra_samples=(1,)), (4, 65536)),
    "la8": (dict(photometric=1, extra_samples=(2,)), (2, 256)),
    "pa8": (dict(photometric=3, extra_samples=(2,), colormap=RNG.integers(0, 65536, (256, 3))), (2, 256)),
    "cmyk8": (dict(photometric=5), (4, 256)),
    "cmyk16": (dict(photometric=5, bits=16), (4, 65536)),
}
COMPRESSIONS = (1, 32773, 5, 8, 32946)


@pytest.mark.parametrize("kind", list(TIFF_KINDS))
def test_tiff_layouts(tmp_path, kind):
    """One kind over compression × predictor × strips (8 rows) and tiles
    (16×32: edge tiles cropped on both axes) × contiguous and separate
    planes × little- and big-endian."""
    kw, (n, top) = TIFF_KINDS[kind]
    rng = np.random.default_rng(len(kind))
    img = rng.integers(0, top, (H, W, n))
    decoded = 0
    for comp, pred, tiled, planar, order in itertools.product(COMPRESSIONS, (1, 2), (False, True), (1, 2), "<>"):
        if (n == 1 and planar == 2) or (pred == 2 and kw.get("bits", 8) < 8):
            continue
        path = str(tmp_path / "t.tif")
        write_tiff(path, img, compression=comp, predictor=pred, planar=planar, byteorder=order,
                   tile=(16, 32) if tiled else None, rows_per_strip=8, **kw)
        decoded += held_to_jax(path) is not None
    assert decoded >= 8, decoded


def test_tiff_modes_follow_pil_open_info():
    """Every sample layout PIL's ``TiffImagePlugin.OPEN_INFO`` lists maps to
    its (mode, rawmode) in the port (16-bit rawmodes without their byte
    order: the port reads the file's), or names ROADMAP item 17."""
    from PIL import TiffImagePlugin

    from physically_based_renderer_tpu_torch.utils import _tiff

    pending = 0
    for (prefix, photo, fmt, fill, bits, extra), (mode, rawmode) in TiffImagePlugin.OPEN_INFO.items():
        tags = {262: (photo,), 339: fmt, 266: (fill,), 258: bits, 338: extra, 277: (len(bits),)}
        try:
            got = _tiff._mode("<" if prefix == TiffImagePlugin.II else ">", tags, fill)
        except NotImplementedError as e:
            assert "ROADMAP item 17" in str(e)
            pending += 1
            continue
        assert got[0] == mode and rawmode.startswith(got[1]) and got[2] == bits, (photo, bits, extra, got)
    assert pending == 0, pending  # CIELab, the last layout pending, is read since the port's Lab conversion


def tiff_ifd(entries: dict, order: str = "<", data: bytes = b"", big: bool = False) -> bytes:
    """A TIFF file: header, ``data`` at offset 8 (16 for BigTIFF), then one
    IFD of ``entries`` (tag → (type, values); a RATIONAL's values in
    (numerator, denominator) pairs), values past the entry's field stored
    after the IFD."""
    head = (b"II" if order == "<" else b"MM") + struct.pack(order + ("HHH" if big else "H"),
                                                            *((43, 8, 0) if big else (42,)))
    first = len(head) + (8 if big else 4)
    ifd_at = first + len(data) + (len(data) & 1)
    entry, count_fmt, off_fmt = (20, "Q", "Q") if big else (12, "H", "I")
    extra_at = ifd_at + struct.calcsize(order + count_fmt) + entry * len(entries) + struct.calcsize(order + off_fmt)
    extra, body = b"", b""
    for tag in sorted(entries):
        typ, vals = entries[tag]
        payload = struct.pack(f"{order}{len(vals)}{ {1: 'B', 2: 'B', 3: 'H', 4: 'I', 5: 'I', 7: 'B'}.get(typ, 'Q') }",
                              *vals)
        inline = 8 if big else 4
        field = payload.ljust(inline, b"\0") if len(payload) <= inline else struct.pack(order + off_fmt,
                                                                                         extra_at + len(extra))
        if len(payload) > inline:
            extra += payload + bytes(len(payload) & 1)
        body += struct.pack(order + "HH" + off_fmt, tag, typ, len(vals) // (2 if typ == 5 else 1)) + field
    return (head + struct.pack(order + off_fmt, ifd_at) + data + bytes(len(data) & 1)
            + struct.pack(order + count_fmt, len(entries)) + body + bytes(struct.calcsize(order + off_fmt)) + extra)


def gray_entries(w, h, n_bytes, compression=1, offset=8, more=None) -> dict:
    """The tags of a one-strip 8-bit gray image at ``offset``, and ``more``."""
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [8]), 259: (3, [compression]), 262: (3, [1]),
            273: (4, [offset]), 277: (3, [1]), 278: (3, [h]), 279: (4, [n_bytes])}
    tags.update(more or {})
    return tags


PIX = RNG.integers(0, 256, 6 * 5).astype(np.uint8).tobytes()
REVERSED = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))
LZW_PIX = lzw_encode(PIX, 8, msb=True)
OLD_LZW_PIX = lzw_encode(PIX, 8)  # least significant bit first, no early change: the variant libtiff still reads
TIFF_CRAFTED = {
    "fill_order_2_raw": tiff_ifd(gray_entries(6, 5, 30, more={266: (3, [2])}), data=PIX),
    "fill_order_2_lzw": tiff_ifd(gray_entries(6, 5, len(LZW_PIX), 5, more={266: (3, [2])}),
                                 data=LZW_PIX.translate(REVERSED)),
    "bigtiff": tiff_ifd(gray_entries(6, 5, 30, offset=16), data=PIX, big=True),
    "bigtiff_big_endian_lzw": tiff_ifd(gray_entries(6, 5, len(LZW_PIX), 5, offset=16), ">", LZW_PIX, big=True),
    "old_lzw_bit_order": tiff_ifd(gray_entries(6, 5, len(OLD_LZW_PIX), 5), data=OLD_LZW_PIX),
    "deflate_raw_stream": tiff_ifd(gray_entries(6, 5, 32, 8), data=zlib.compress(PIX)[2:-4]),
    "no_rows_per_strip": tiff_ifd({k: v for k, v in gray_entries(6, 5, 30).items() if k != 278}, data=PIX),
    "rows_per_strip_past_height": tiff_ifd(gray_entries(6, 5, 30, more={278: (4, [2**32 - 1])}), data=PIX),
    "raw_strip_reads_on_past_its_bytes": tiff_ifd(gray_entries(6, 5, 20), data=PIX[:20]),
    "lzw_truncated": tiff_ifd(gray_entries(6, 5, 6, 5), data=LZW_PIX[:6]),
    "packbits_truncated": tiff_ifd(gray_entries(6, 5, 4, 32773), data=bytes([5]) + PIX[:3]),
    "no_width": tiff_ifd({k: v for k, v in gray_entries(6, 5, 30).items() if k != 256}, data=PIX),
    "no_strips": tiff_ifd({k: v for k, v in gray_entries(6, 5, 30).items() if k not in (273, 279)}, data=PIX),
    "unknown_compression": tiff_ifd(gray_entries(6, 5, 30, 9), data=PIX),
    "unknown_photometric": tiff_ifd(gray_entries(6, 5, 30, more={262: (3, [4])}), data=PIX),
    "predictor_2_at_4_bits": tiff_ifd(gray_entries(6, 5, 6, 5, more={258: (3, [4]), 317: (3, [2])}),
                                      data=lzw_encode(PIX[:15], 8, msb=True)),
    "unknown_predictor": tiff_ifd(gray_entries(6, 5, len(LZW_PIX), 5, more={317: (3, [5])}), data=LZW_PIX),
    "six_samples_rgb": tiff_ifd(gray_entries(2, 1, 6, more={258: (3, [8] * 6), 262: (3, [2]), 277: (3, [6]),
                                                         338: (3, [0, 0, 0])}), data=PIX[:12]),
    "seven_samples": tiff_ifd(gray_entries(2, 1, 14, more={258: (3, [8] * 7), 262: (3, [2]), 277: (3, [7])}),
                              data=PIX[:14]),
    "bits_do_not_match_samples": tiff_ifd(gray_entries(2, 1, 6, more={258: (3, [8, 8]), 262: (3, [2]),
                                                                   277: (3, [3])}), data=PIX[:6]),
    "invalid_header_little": b"II\x00\x2a" + tiff_ifd(gray_entries(6, 5, 30), data=PIX)[4:],
    "ifd_past_end": b"II*\x00" + struct.pack("<I", 4000) + bytes(8),
}


@pytest.mark.parametrize("name", list(TIFF_CRAFTED))
def test_tiff_crafted(tmp_path, name):
    held_to_jax(_write(tmp_path, f"{name}.tif", TIFF_CRAFTED[name]))


def test_tiff_associated_alpha_every_pair(tmp_path):
    """Every (colour, alpha) pair of 8-bit associated alpha, contiguous
    (PIL's raw path) and LZW-coded: Unpack.c's c·255 // a, clipped, 0 where
    a is 0, the colour itself where a is 255."""
    a, c = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    img = np.stack([c, 255 - c, (c * 7) % 256, a], -1)
    for comp in (1, 5):
        path = str(tmp_path / "a.tif")
        write_tiff(path, img, compression=comp, extra_samples=(1,), rows_per_strip=64)
        got = held_to_jax(path)
        assert np.array_equal(got[..., 3], a)


def test_tiff_round_trips_through_write_tiff(tmp_path):
    """``chip_smoke.write_tiff`` as phase ai writes the colour page (LZW,
    predictor 2, 64×64 tiles) and a gray one: both packages read the
    samples back unchanged."""
    rng = np.random.default_rng(51)
    for c in (1, 3, 4):
        a = _seeded_photo(rng, 70, 90, c)
        path = str(tmp_path / f"r{c}.tif")
        write_tiff(path, a, compression=5, predictor=2, tile=(64, 64), extra_samples=(2,) if c == 4 else ())
        assert np.array_equal(held_to_jax(path), a)


# -- the scene ------------------------------------------------------------------------------


def test_obj_scene_pages_from_dds_gif_and_tiff(tmp_path):
    """An MTL whose diffuse map is a DDS (B8G8R8A8), roughness a GIF (a gray
    ramp palette: an L page), metallic a TIFF (LZW, predictor 2, tiles) and
    normal map a BC1 DDS: the asset cache's pages and the atlas equal the
    JAX package's ``obj_scene``'s."""
    path = write_sphere_obj(tmp_path, textured=False)
    rng = np.random.default_rng(52)
    (tmp_path / "maps").mkdir()
    write_dds(str(tmp_path / "maps" / "albedo.dds"), _seeded_photo(rng, 40, 40, 3))
    write_gif(str(tmp_path / "maps" / "rough.gif"), _blocky(rng, 40, 40, 1))
    write_tiff(str(tmp_path / "maps" / "metal.tif"), _blocky(rng, 40, 40, 3), compression=5, predictor=2,
               tile=(32, 32))
    from test_torch_image_dds import bc_file
    (tmp_path / "maps" / "normal.dds").write_bytes(
        bc_file("BC1", 32, 32, rng.integers(0, 256, 64 * 8, dtype=np.uint8).tobytes()))
    (tmp_path / "sphere.mtl").write_text(
        "newmtl painted\nKd 1 1 1\nNs 128\nPm 0.25\nmap_Kd maps/albedo.dds\nmap_Pr maps/rough.gif\n"
        "map_Pm maps/metal.tif\nmap_bump maps/normal.dds\nnewmtl plain\nKd 0.2 0.6 0.9\nNs 32\n")
    jcache = jscenes.AssetCache(asset_root=str(tmp_path), texture_size=32)
    cache = scenes.AssetCache(asset_root=str(tmp_path), texture_size=32)
    jscene = jscenes.obj_scene(path, assets=jcache, texture_size=32, prefer_native=False)
    scene = scenes.obj_scene(path, assets=cache, texture_size=32, device="cpu")
    assert len(cache.pages) == len(jcache.pages) == 4 and cache.srgb == jcache.srgb
    for got, ref in zip(cache.pages, jcache.pages):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    for a, b in zip(scene.atlas.mips, jscene.atlas.mips):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("has_tex", "tex_index"):
        np.testing.assert_array_equal(getattr(scene.materials, f).numpy(), np.asarray(getattr(jscene.materials, f)))
    assert load_image(str(tmp_path / "maps" / "rough.gif")).shape == (40, 40, 1)
