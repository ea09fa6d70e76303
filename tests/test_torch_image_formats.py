"""PyTorch port vs the JAX package: ``utils/image_io.load_image`` on the kinds
past PNG and baseline JPEG — progressive and CMYK / YCCK JPEG
(``utils/_jpeg.py``), TGA (``utils/_tga.py``) and BMP (``utils/_bmp.py``).

Every file is decoded by the port and by the JAX package's own
``load_image`` (PIL 12.1 on libjpeg-turbo here) and the two held with
``np.array_equal``: no tolerance. Where PIL refuses a file, the port must
raise ``ValueError`` too.

JPEG: files PIL encodes from seeded images, progressive (gray, 4:4:4, 4:2:2,
4:2:0; quality 75 and 95; 17×13 and 100×75; restart markers off and on;
optimised Huffman tables off and on), each also equal to its baseline
twin's decode; CMYK baseline and progressive, with PIL's Adobe marker, with
the marker's transform set to 2 (YCCK) and with the marker removed. TGA and
BMP: the files PIL writes in each of its modes (TGA raw and RLE, bottom-up
and top-down), and files written here byte by byte for what PIL's writers
never emit (16-bit pixels and colour maps, 24- and 32-bit colour maps, a map
that starts past entry 0, right-to-left rows, RLE packets that cross rows;
4-bit, RLE8, RLE4, bitfields, alpha masks, negative heights, OS/2 headers).
The committed fixtures decode to their manifest digests, and ``obj_scene``'s
pages from an MTL that names a TGA, a BMP and a progressive JPEG equal the
JAX package's.
"""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.utils.image_io import load_image as jax_load_image
from physically_based_renderer_tpu_torch import scenes
from physically_based_renderer_tpu_torch.utils.image_io import load_image
from test_torch_obj_loader import write_sphere_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def held_to_jax(path) -> np.ndarray | None:
    """The port's decode of ``path`` equals the JAX package's, or both refuse
    the file (the port with ``ValueError``). Returns the decode, if any."""
    try:
        ref = jax_load_image(str(path))
    except Exception:  # noqa: BLE001 — whatever PIL raises for a file it refuses
        with pytest.raises(ValueError):
            load_image(str(path))
        return None
    got = load_image(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape, (got.shape, ref.shape)
    assert np.array_equal(got, ref), int(np.abs(got.astype(int) - ref).max())
    return got


def _write(tmp_path, name, data: bytes) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _seeded_photo(rng, h, w, c):
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * (np.sin(xx / 7.0) * np.cos(yy / 5.0))[..., None] + rng.normal(0, 25, (h, w, c))
    return np.clip(base, 0, 255).astype(np.uint8)


def _blocky(rng, h, w, c):
    """Flat 4×4 blocks with some noisy rows: runs and literals for RLE."""
    a = np.repeat(np.repeat(rng.integers(0, 256, (-(-h // 4), -(-w // 4), c)), 4, 0), 4, 1)[:h, :w]
    a[::3] = rng.integers(0, 256, a[::3].shape)
    return a.astype(np.uint8)


# -- progressive and CMYK JPEG --------------------------------------------------------------

JPEG_MODES = {"gray": None, "444": 0, "422": 1, "420": 2}


def _jpeg(a, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a[..., 0] if a.shape[-1] == 1 else a).save(buf, "JPEG", **opts)
    return buf.getvalue()


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("mode", list(JPEG_MODES))
def test_progressive_jpeg_matches_jax(tmp_path, mode, quality):
    """17×13 and 100×75, restart markers off, every 3 MCUs and every MCU row,
    optimised Huffman tables off and on; each equal to its baseline twin."""
    rng = np.random.default_rng(10 * quality + len(mode))
    sub = {} if mode == "gray" else dict(subsampling=JPEG_MODES[mode])
    for h, w in ((13, 17), (75, 100)):
        a = _seeded_photo(rng, h, w, 1 if mode == "gray" else 3)
        for restart in ({}, dict(restart_marker_blocks=3), dict(restart_marker_rows=1)):
            for optimize in (False, True):
                data = _jpeg(a, quality=quality, progressive=True, optimize=optimize, **sub, **restart)
                assert data.find(b"\xff\xc2") > 0 and (b"\xff\xdd" in data) == bool(restart)
                got = held_to_jax(_write(tmp_path, "p.jpg", data))
                twin = load_image(_write(tmp_path, "b.jpg", _jpeg(a, quality=quality, **sub, **restart)))
                assert np.array_equal(got, twin), (h, w, restart, optimize)


def _strip_adobe(data: bytes) -> bytes:
    i = data.index(b"Adobe") - 4  # the APP14 marker and its length
    assert data[i:i + 2] == b"\xff\xee"
    (length,) = struct.unpack(">H", data[i + 2:i + 4])
    return data[:i] + data[i + 2 + length:]


@pytest.mark.parametrize("variant", ["adobe", "ycck", "no_marker"])
@pytest.mark.parametrize("progressive", [False, True])
def test_cmyk_jpeg_matches_jax(tmp_path, progressive, variant):
    """PIL writes CMYK inverted behind an Adobe marker of transform 0; set to
    2 the same file is YCCK; without the marker libjpeg reads CMYK again.
    Quality 75 and 95, 30×41 (not a multiple of the MCU)."""
    rng = np.random.default_rng(3 + progressive)
    for quality in (75, 95):
        buf = io.BytesIO()
        Image.fromarray(_seeded_photo(rng, 30, 41, 4), "CMYK").save(buf, "JPEG", quality=quality,
                                                                   progressive=progressive)
        data = bytearray(buf.getvalue())
        at = data.index(b"Adobe")
        assert data[at + 11] == 0
        if variant == "ycck":
            data[at + 11] = 2
        elif variant == "no_marker":
            data = bytearray(_strip_adobe(bytes(data)))
            assert b"Adobe" not in data
        got = held_to_jax(_write(tmp_path, "c.jpg", bytes(data)))
        assert got.shape == (30, 41, 3)


# -- TGA ------------------------------------------------------------------------------------

TGA_PIL_MODES = {"L": 1, "LA": 2, "P": 1, "1": 1, "RGB": 3, "RGBA": 4}


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("mode", list(TGA_PIL_MODES))
def test_tga_written_by_pil(tmp_path, mode, rle):
    """PIL's own TGA writer at 37×23, bottom-up (its default) and top-down.
    PIL cannot read back its 1-bit RLE file: the port refuses it as well."""
    rng = np.random.default_rng(len(mode) + 7 * rle)
    a = _blocky(rng, 23, 37, TGA_PIL_MODES[mode])
    if mode == "1":
        im = Image.fromarray(a[..., 0] > 127)
    elif mode == "P":
        im = Image.fromarray(a[..., 0], "P")
        im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tolist())
    else:
        im = Image.fromarray(a[..., 0] if a.shape[-1] == 1 else a, mode)
    for orientation in (-1, 1):
        path = str(tmp_path / f"t{orientation}.tga")
        im.save(path, rle=rle, orientation=orientation)
        got = held_to_jax(path)
        assert (got is None) == (mode == "1" and rle)


def tga(w, h, image_type, depth, pixels, cmap=None, cmap_depth=0, start=0, flags=0x20, ident=b"") -> bytes:
    n = 0 if cmap is None else len(cmap) // (cmap_depth // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(ident), int(cmap is not None), image_type, start, n, cmap_depth, 0, 0,
                       w, h, depth, flags)
    return head + ident + (cmap or b"") + pixels


def run(count, pixel):
    return bytes([0x80 | (count - 1)]) + pixel


def literal(pixels, size):
    return bytes([len(pixels) // size - 1]) + pixels


RNG = np.random.default_rng(11)
ALL16 = np.arange(65536, dtype="<u2").tobytes()
MAP24 = RNG.integers(0, 256, 3 * 40).astype(np.uint8).tobytes()
MAP16 = RNG.integers(0, 65536, 40).astype("<u2").tobytes()
IDX = RNG.integers(0, 48, 6 * 9).astype(np.uint8).tobytes()  # 9 rows of 6, some past the 40-entry maps
TGA_CRAFTED = {
    "16bit_all_values": tga(256, 256, 2, 16, ALL16),
    "16bit_attribute_bit": tga(256, 256, 2, 16, ALL16, flags=0x21),
    "16bit_rle_bottom_up": tga(3, 2, 10, 16, run(3, b"\x1f\x80") + literal(ALL16[:6], 2), flags=0x01),
    "24bit_map": tga(6, 9, 1, 8, IDX, MAP24, 24),
    "24bit_map_start_5": tga(6, 9, 1, 8, IDX, MAP24, 24, start=5),
    "16bit_map": tga(6, 9, 1, 8, IDX, MAP16, 16, flags=0x00),
    "32bit_map": tga(6, 9, 1, 8, IDX, RNG.integers(0, 256, 4 * 40).astype(np.uint8).tobytes(), 32),
    "map_past_256": tga(2, 1, 1, 8, b"\x00\x01", MAP24[:30], 24, start=250),
    "gray_alpha_mapped": tga(6, 9, 3, 16, RNG.integers(0, 256, 6 * 9 * 2).astype(np.uint8).tobytes(), MAP24, 24),
    "gray_with_map": tga(6, 9, 3, 8, IDX, MAP24, 24),
    "rgb_with_map": tga(1, 1, 2, 24, b"\x01\x02\x03", MAP24, 24),
    "mapped_rle_right_to_left": tga(6, 9, 9, 8, b"".join(run(2, IDX[i:i + 1]) + literal(IDX[i + 1:i + 5], 1)
                                                        for i in range(0, 54, 6)), MAP24, 24, flags=0x30),
    "top_down_right_to_left": tga(5, 4, 2, 24, RNG.integers(0, 256, 60).astype(np.uint8).tobytes(), flags=0x30),
    "bottom_up_32bit": tga(5, 4, 2, 32, RNG.integers(0, 256, 80).astype(np.uint8).tobytes(), flags=0x08),
    "id_section": tga(2, 1, 2, 24, b"\x01\x02\x03\x04\x05\x06", ident=b"made by hand"),
    "gray_1bit": tga(10, 3, 3, 1, b"\xff\xc0\x81\x40\x12\x80", flags=0x00),
    "literal_across_rows": tga(3, 3, 11, 8, literal(b"\x01\x02\x03\x04", 1) + literal(b"\x05\x06\x07\x08\x09", 1)),
    "literals_and_runs_across_rows": tga(4, 3, 10, 24, run(2, b"\x01\x02\x03") + literal(bytes(range(30)), 3)),
    "run_across_rows": tga(3, 2, 11, 8, run(4, b"\x07") + run(2, b"\x09")),
    "rle_truncated": tga(3, 2, 11, 8, run(3, b"\x07") + literal(b"\x01", 1)),
    "raw_truncated": tga(3, 2, 3, 8, b"\x01\x02\x03\x04"),
    "rle_trailing_bytes": tga(2, 1, 11, 8, run(2, b"\x05") + b"\x99\x98"),
    "gray_24bit": tga(2, 1, 3, 24, bytes(6)),
    "mapped_without_map": tga(2, 1, 1, 8, b"\x00\x01"),
}


@pytest.mark.parametrize("name", list(TGA_CRAFTED))
def test_tga_crafted(tmp_path, name):
    held_to_jax(_write(tmp_path, f"{name}.tga", TGA_CRAFTED[name]))


# -- BMP ------------------------------------------------------------------------------------

BMP_PIL_MODES = {"1": 1, "L": 1, "P": 1, "RGB": 3, "RGBA": 4}


@pytest.mark.parametrize("mode", list(BMP_PIL_MODES))
def test_bmp_written_by_pil(tmp_path, mode):
    """PIL's own BMP writer at 37×23 (rows padded to 4 bytes); its RGBA file
    (BI_RGB at 32 bits) reads back as RGB."""
    rng = np.random.default_rng(len(mode) + 20)
    a = _blocky(rng, 23, 37, BMP_PIL_MODES[mode])
    if mode == "1":
        im = Image.fromarray(a[..., 0] > 127)
    elif mode == "P":
        im = Image.fromarray(a[..., 0], "P")
        im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tolist())
    else:
        im = Image.fromarray(a[..., 0] if a.shape[-1] == 1 else a, mode)
    path = str(tmp_path / "p.bmp")
    im.save(path)
    got = held_to_jax(path)
    assert got.shape[-1] == {"L": 1}.get(mode, 3)


def bmp(w, h, bits, pixels, compression=0, palette=b"", masks=None, header=40, colors=0, offset=None) -> bytes:
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
        extra = b""
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, h, 1, bits, compression, len(pixels), 2835, 2835, colors, 0)
        extra = b""
        if header == 40 and masks is not None:
            extra = struct.pack("<III", *masks[:3])
        elif header > 40:
            fields = struct.pack("<IIII", *(tuple(masks or ()) + (0, 0, 0, 0))[:4]) + bytes(max(header - 56, 0))
            info += fields[:header - 40]
    off = 14 + len(info) + len(extra) + len(palette) if offset is None else offset
    return b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + info + extra + palette + pixels


def rows(h, w, bits, rng) -> bytes:
    stride = ((w * bits + 31) >> 3) & ~3
    return rng.integers(0, 256, h * stride).astype(np.uint8).tobytes()


PAL16 = RNG.integers(0, 256, 16 * 4).astype(np.uint8).tobytes()
PAL256 = RNG.integers(0, 256, 256 * 4).astype(np.uint8).tobytes()
GRAY256 = b"".join(bytes([i, i, i, 0]) for i in range(256))
GRAY16 = b"".join(bytes([i, i, i, 0]) for i in range(16))
RLE8 = bytes([3, 5, 0, 3, 1, 2, 3, 0, 0, 0, 2, 9, 0, 4, 7, 8, 7, 8, 0, 0, 6, 11, 0, 0, 0, 1])
RLE4 = bytes([5, 0x12, 0, 0, 0, 4, 0x34, 0x56, 0, 0, 7, 0xAB, 0, 0, 0, 1])
BMP_CRAFTED = {
    "4bit_palette": bmp(7, 5, 4, rows(5, 7, 4, RNG), palette=PAL16),
    "4bit_small_palette": bmp(7, 5, 4, rows(5, 7, 4, RNG), palette=PAL16[:24], colors=6),
    "1bit_colour_palette": bmp(13, 3, 1, rows(3, 13, 1, RNG), palette=PAL16[:8], colors=2),
    "8bit_gray_palette": bmp(9, 4, 8, rows(4, 9, 8, RNG), palette=GRAY256),
    "4bit_identity_gray": bmp(8, 3, 4, rows(3, 8, 4, RNG), palette=GRAY16),
    "4bit_identity_gray_too_wide": bmp(9, 3, 4, rows(3, 9, 4, RNG), palette=GRAY16),
    "rle8": bmp(6, 3, 8, RLE8, compression=1, palette=PAL256),
    "rle8_clipped_run_and_delta": bmp(3, 2, 8, bytes([5, 5, 0, 0, 0, 2, 1, 0, 1, 0, 2, 6, 0, 1]), compression=1,
                                      palette=PAL256),
    "rle8_gray": bmp(6, 3, 8, RLE8, compression=1, palette=GRAY256),
    "rle8_short": bmp(3, 2, 8, bytes([3, 5, 0, 1]), compression=1, palette=PAL256),
    "rle4": bmp(7, 2, 4, RLE4, compression=2, palette=PAL16),
    "rle4_odd_literal": bmp(4, 1, 4, bytes([0, 3, 0x12, 0x30, 2, 0x45, 0, 1]), compression=2, palette=PAL16),
    "16bit_555": bmp(256, -256, 16, ALL16),
    "16bit_565_bitfields": bmp(256, -256, 16, ALL16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
    "16bit_555_bitfields_v5": bmp(256, 256, 16, ALL16, compression=3, masks=(0x7C00, 0x3E0, 0x1F, 0), header=124),
    "16bit_other_bitfields": bmp(2, 1, 16, bytes(4), compression=3, masks=(0xF, 0xF0, 0xF00)),
    "24bit_negative_height": bmp(5, -3, 24, rows(3, 5, 24, RNG)),
    "24bit_bitfields": bmp(5, 3, 24, rows(3, 5, 24, RNG), compression=3, masks=(0xFF0000, 0xFF00, 0xFF)),
    "32bit_bgrx": bmp(5, 3, 32, rows(3, 5, 32, RNG)),
    "32bit_bitfields_v3": bmp(5, 3, 32, rows(3, 5, 32, RNG), compression=3, masks=(0xFF0000, 0xFF00, 0xFF)),
    "32bit_alpha_v4": bmp(5, -3, 32, rows(3, 5, 32, RNG), compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                          header=108),
    "32bit_rgba_v5": bmp(5, 3, 32, rows(3, 5, 32, RNG), compression=3, masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                         header=124),
    "32bit_abgr_v5": bmp(5, 3, 32, rows(3, 5, 32, RNG), compression=3, masks=(0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                         header=124),
    "32bit_xbgr_v2": bmp(5, 3, 32, rows(3, 5, 32, RNG), compression=3, masks=(0xFF000000, 0xFF0000, 0xFF00),
                         header=52),
    "32bit_zero_masks_v5": bmp(5, 3, 32, rows(3, 5, 32, RNG), compression=3, masks=(0, 0, 0, 0), header=124),
    "32bit_raw_v5": bmp(5, 3, 32, rows(3, 5, 32, RNG), header=124),
    "offset_at_palette": bmp(4, 2, 8, rows(2, 4, 8, RNG), palette=PAL16[:16], colors=4, offset=54),
    "os2_header": bmp(6, 2, 8, rows(2, 6, 8, RNG), palette=PAL256[:3 * 256], header=12),
    "palette_past_256": bmp(2, 1, 8, bytes(4), palette=PAL256 + PAL16[:40], colors=266),
    "pixels_truncated": bmp(5, 3, 24, rows(3, 5, 24, RNG)[:-8]),
    "png_compression": bmp(2, 1, 24, bytes(8), compression=5),
    "unknown_header": b"BM" + struct.pack("<IHHII", 60, 0, 0, 54, 44) + bytes(40),
}


@pytest.mark.parametrize("name", list(BMP_CRAFTED))
def test_bmp_crafted(tmp_path, name):
    held_to_jax(_write(tmp_path, f"{name}.bmp", BMP_CRAFTED[name]))


# -- JPEG kinds past baseline and progressive Huffman, and what PIL refuses --------------------------


def _jpeg_variant(kind: str) -> bytes:
    import jpeg_encoders as enc

    a = _seeded_photo(np.random.default_rng(9), 16, 16, 3)
    data = bytearray(_jpeg(a, quality=90, progressive=kind == "incomplete"))
    if kind == "incomplete":  # the last scan (the final refinement) left out: libjpeg block-smooths
        last = data.rindex(b"\xff\xda")
        return bytes(data[:last]) + b"\xff\xd9"
    if kind == "arithmetic":  # the same coefficients, arithmetic-coded (SOF9)
        return enc.transcode_to_arith(bytes(data))
    if kind == "lossless":  # the pixels as a lossless RGB frame (SOF3)
        return enc.write_lossless([a[..., i] for i in range(3)], [(1, 1)] * 3, psv=5, ids=(82, 71, 66))
    if kind == "arithmetic lossless":  # SOF11
        lossless = bytearray(enc.write_lossless([a[..., 0]], [(1, 1)], psv=1))
        lossless[lossless.index(b"\xff\xc3") + 1] = 0xCB
        return bytes(lossless)
    sof = data.index(b"\xff\xc0")
    if kind == "12bit":
        data[sof + 4] = 12
    else:
        data[sof + 1] = {"hierarchical": 0xC5}[kind]
    return bytes(data)


@pytest.mark.parametrize("kind,error,match", [
    ("incomplete", None, None),
    ("lossless", None, None),
    ("arithmetic", None, None),
    ("hierarchical", ValueError, "hierarchical.*does not read either"),
    ("12bit", ValueError, "12-bit.*does not read either"),
    ("arithmetic lossless", ValueError, "SOF11.*does not read either"),
])
def test_jpeg_kinds_that_raise(tmp_path, kind, error, match):
    """The kinds PIL refuses raise ``ValueError`` (hierarchical, 12-bit,
    SOF11, which PIL's libjpeg-turbo has no decoder for); those the port
    raised ``NotImplementedError`` for until it read them — a progressive
    file missing its last scan, lossless, arithmetic-coded — now decode
    equal to the JAX package's ``load_image``."""
    path = _write(tmp_path, "k.jpg", _jpeg_variant(kind))
    if error is None:
        assert held_to_jax(path) is not None
    else:
        with pytest.raises(error, match=match):
            load_image(path)
        assert held_to_jax(path) is None


PENDING_KINDS = {  # kind → (PIL's save, the port's ValueError on a stub)
    "LZMA TIFF": (dict(format="TIFF", compression="lzma"), "TIFF: the IFD"),
    "CCITT TIFF": (dict(format="TIFF", compression="group4"), "TIFF: the IFD"),
}


@pytest.mark.parametrize("kind", list(PENDING_KINDS))
def test_other_formats_raise(tmp_path, kind):
    """Kinds PIL reads that the port named ROADMAP item 17 for until it read
    them — LZMA TIFF, CCITT G4 TIFF — decode equal to the JAX package's
    ``load_image``; the same signature on bytes that are no image is a
    ValueError."""
    save, refused = PENDING_KINDS[kind]
    path = str(tmp_path / "f.img")
    im = Image.fromarray(np.zeros((4, 4, 3), np.uint8))
    (im.convert("1") if kind.startswith("CCITT") else im).save(path, **save)
    assert held_to_jax(path) is not None
    with open(path, "rb") as f:
        stub = f.read(4)
    with pytest.raises(ValueError, match=refused):
        load_image(_write(tmp_path, "stub.img", stub + bytes(4)))


# -- the committed fixtures and the scene that reads them -----------------------------------

NEW_FIXTURES = {"page_color_1024_progressive.jpg": "page_color_1024.jpg",
                "page_gray_1024_progressive.jpg": "page_gray_1024.jpg", "cmyk_512.jpg": None}


@pytest.mark.parametrize("name", list(NEW_FIXTURES))
def test_new_fixtures_decode_to_their_digests(name):
    with open(os.path.join(DATA, "manifest.json")) as f:
        manifest = json.load(f)
    entry, path = manifest[name], os.path.join(DATA, name)
    got = held_to_jax(path)
    digest = hashlib.sha256(got.tobytes()).hexdigest()
    assert list(got.shape) == entry["shape"] and os.path.getsize(path) == entry["bytes"]
    assert digest == entry["decoded_sha256"]
    if NEW_FIXTURES[name]:  # the progressive twin decodes as its baseline twin
        assert digest == manifest[NEW_FIXTURES[name]]["decoded_sha256"]


def test_obj_scene_pages_from_tga_bmp_and_progressive_jpeg(tmp_path):
    """An MTL whose diffuse map is a progressive JPEG, roughness a TGA (RLE,
    top-down), metallic a BMP and normal map a 16-bit TGA: the asset cache's
    pages and the atlas equal the JAX package's ``obj_scene``'s."""
    path = write_sphere_obj(tmp_path, textured=False)
    rng = np.random.default_rng(12)
    (tmp_path / "maps").mkdir()
    Image.fromarray(_seeded_photo(rng, 40, 40, 3)).save(tmp_path / "maps" / "albedo.jpg", quality=90,
                                                        progressive=True)
    Image.fromarray(_blocky(rng, 40, 40, 1)[..., 0]).save(tmp_path / "maps" / "rough.tga", rle=True, orientation=1)
    Image.fromarray(_blocky(rng, 40, 40, 3)).save(tmp_path / "maps" / "metal.bmp")
    (tmp_path / "maps" / "normal.tga").write_bytes(
        tga(32, 32, 2, 16, RNG.integers(0, 65536, 32 * 32).astype("<u2").tobytes(), flags=0x00))
    (tmp_path / "sphere.mtl").write_text(
        "newmtl painted\nKd 1 1 1\nNs 128\nPm 0.25\nmap_Kd maps/albedo.jpg\nmap_Pr maps/rough.tga\n"
        "map_Pm maps/metal.bmp\nmap_bump maps/normal.tga\nnewmtl plain\nKd 0.2 0.6 0.9\nNs 32\n")
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
