"""PyTorch port vs the JAX package: the last of the reference loaders'
formats in ``load_image`` — JPEG-in-TIFF, YCbCr TIFF, the wide TIFF samples
and ICO.

Every file here is written by PIL, or built byte by byte around streams PIL
encodes (``chip_smoke.write_jpeg_tiff``, ``write_ico``, ``write_tiff``), and
the port's decode must equal the JAX package's ``load_image`` (PIL 12 with
libjpeg-turbo and libtiff) bit for bit — shape, dtype and samples — or both
must refuse it (the port with ``ValueError``):

* JPEG-in-TIFF (compression 7): photometric 6 (YCbCr, ``YCbCrSubsampling``
  1×1, 2×1, 2×2; libjpeg converts to RGB with fancy upsampling inside each
  strip or tile), 2 (RGB: the samples as stored) and 1 / 0 (gray); one
  strip, several strips, tiles with cropped edges; with and without
  ``JPEGTables``; PIL's own writer; libtiff's checks (sampling factors,
  component count, a stream larger than its strip);
* YCbCr that is not JPEG: uncompressed (PIL's raw decoder reads it as RGBX),
  LZW / Deflate / PackBits (libtiff's RGBA interface: replicated chroma,
  float ``TIFFYCbCrToRGB`` tables from ``ReferenceBlackWhite`` and
  ``YCbCrCoefficients``);
* 12-bit, signed 16-bit, 32-bit unsigned and signed, and float32 gray, in
  both byte orders, under predictors 1, 2 and 3 (the floating-point one),
  through ``convert("RGB")``: clipped (I), truncated toward zero and clipped
  (F: NaN 0, +inf 255), and byte-swapped where libtiff hands PIL a
  big-endian file's I;16BS / I;32BS / F;32BF samples in native order;
* ICO: PIL's writer (PNG- and BMP-coded entries, every mode), DIBs at 1, 4,
  8, 24 and 32 bits with their AND masks, PIL's choice of entry, a PNG
  entry larger than its directory size;

then ``chip_smoke``'s writers and the committed fixture against the
manifest, and an ``obj_scene`` whose maps are these kinds against JAX's.
"""

import hashlib
import io
import itertools
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from chip_smoke import FIXTURE_DIR, split_jpeg_tables, write_ico, write_jpeg_tiff, write_tiff
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu_torch import scenes
from physically_based_renderer_tpu_torch.utils import _tiff
from physically_based_renderer_tpu_torch.utils.image_io import load_image, save_png
from test_torch_image_formats import _blocky, _seeded_photo, _write, held_to_jax
from test_torch_image_gif_tiff import tiff_ifd
from test_torch_obj_loader import write_sphere_obj

H, W = 45, 70
SUBSAMPLING = {(1, 1): 0, (2, 1): 1, (2, 2): 2}  # YCbCrSubsampling → PIL's JPEG subsampling option


def _jpeg(block: np.ndarray, sub: int | None, quality: int = 85) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(block[..., 0] if block.shape[-1] == 1 else block).save(
        buf, "JPEG", quality=quality, **({} if sub is None else dict(subsampling=sub)))
    return buf.getvalue()


def jpeg_tiff(path, img, *, photometric=6, sampling=(2, 2), tile=None, rows_per_strip=None, tables=False,
              byteorder="<", sampling_tag=True, last_strip_full=False):
    """``img`` as a JPEG-compressed TIFF: each strip or tile (edge tiles
    padded by repetition) a JPEG PIL encodes, its tables moved into
    ``JPEGTables`` with ``tables``."""
    h, w, c = img.shape
    th, tw = tile or (rows_per_strip or h, w)
    chunks, shared = [], None
    for y in range(0, h, th):
        for x in range(0, w, tw):
            block = img[y:y + th, x:x + tw]
            if tile or last_strip_full:
                block = np.pad(block, ((0, th - block.shape[0]), (0, tw - block.shape[1]) if tile else (0, 0),
                                       (0, 0)), mode="edge")
            stream = _jpeg(block, SUBSAMPLING[sampling] if c == 3 else None)
            if tables:
                shared, stream = split_jpeg_tables(stream)
            chunks.append(stream)
    write_jpeg_tiff(path, chunks, w, h, components=c, photometric=photometric,
                    subsampling=sampling if sampling_tag else None, rows_per_strip=rows_per_strip, tile=tile,
                    tables=shared, byteorder=byteorder)
    return path


# -- JPEG-in-TIFF ---------------------------------------------------------------------------

JPEG_KINDS = {  # name → (photometric, YCbCrSubsampling, samples)
    "ycbcr_1x1": (6, (1, 1), 3), "ycbcr_2x1": (6, (2, 1), 3), "ycbcr_2x2": (6, (2, 2), 3),
    "rgb": (2, (1, 1), 3), "gray": (1, (1, 1), 1), "gray_white_is_zero": (0, (1, 1), 1),
}
LAYOUTS = {"one_strip": {}, "strips": dict(rows_per_strip=16), "tiles": dict(tile=(32, 32)),
           "tiles_16x48": dict(tile=(16, 48))}


@pytest.mark.parametrize("kind", list(JPEG_KINDS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_jpeg_in_tiff_layouts(tmp_path, kind, layout):
    """Each kind in each layout, with and without ``JPEGTables`` (the strips
    or tiles then abbreviated streams), and big-endian."""
    photometric, sampling, c = JPEG_KINDS[kind]
    img = _seeded_photo(np.random.default_rng(len(kind) + 7 * len(layout)), H, W, c)
    for tables, order in ((False, "<"), (True, "<"), (True, ">")):
        path = jpeg_tiff(str(tmp_path / "j.tif"), img, photometric=photometric, sampling=sampling, tables=tables,
                         byteorder=order, **LAYOUTS[layout])
        got = held_to_jax(path)
        assert got is not None and got.shape == (H, W, c), (tables, order)


@pytest.mark.parametrize("mode", ["RGB", "YCbCr", "L"])
def test_jpeg_in_tiff_written_by_pil(tmp_path, mode):
    """PIL's own JPEG-in-TIFF writer (one strip, then 2 KiB strips; its
    YCbCr at 1×1 with ``ReferenceBlackWhite``), both with ``JPEGTables``."""
    img = Image.fromarray(_seeded_photo(np.random.default_rng(3), H, W, 3)).convert(mode)
    for kw in ({}, dict(strip_size=2048)):
        path = str(tmp_path / "p.tif")
        img.save(path, compression="jpeg", **kw)
        assert held_to_jax(path) is not None, kw


def test_jpeg_in_tiff_edges(tmp_path):
    """No ``YCbCrSubsampling`` tag (libtiff takes it from the first strip's
    frame header), a last strip stored at the full strip height, and the
    files libtiff refuses: sampling factors other than the tag's, an RGB
    stream not at 1×1, a component count other than the samples', a stream
    wider than its strip, JPEG YCbCr in separate planes."""
    rng = np.random.default_rng(11)
    img, gray = _seeded_photo(rng, H, W, 3), _seeded_photo(rng, H, W, 1)
    read = [jpeg_tiff(str(tmp_path / f"n{s}.tif"), img, sampling=s, sampling_tag=False, tables=t)
            for s, t in (((2, 2), False), ((1, 1), False), ((2, 1), True))]
    read.append(jpeg_tiff(str(tmp_path / "last.tif"), img, rows_per_strip=16, last_strip_full=True))
    for path in read:
        assert held_to_jax(path) is not None, path
    refused = {"tag_2x2_stream_1x1": dict(sampling=(1, 1)), "rgb_2x2": dict(photometric=2, sampling=(2, 2))}
    for name, kw in refused.items():
        path = jpeg_tiff(str(tmp_path / f"{name}.tif"), img, **kw)
        if name == "tag_2x2_stream_1x1":  # rewrite the tag: 2×2
            data = bytearray(open(path, "rb").read())
            i = data.index(struct.pack("<HHI", 530, 3, 2))
            data[i + 8:i + 12] = struct.pack("<HH", 2, 2)
            path = _write(tmp_path, f"{name}.tif", bytes(data))
        assert held_to_jax(path) is None, name
    stream = _jpeg(img, 2)
    for name, (chunk, w, c) in {"three_components_in_gray": (stream, W, 1), "wider_than_strip": (stream, W - 10, 3),
                                "gray_stream_in_ycbcr": (_jpeg(gray, None), W, 3)}.items():
        path = str(tmp_path / f"{name}.tif")
        write_jpeg_tiff(path, [chunk], w, H, components=c, photometric=6 if c == 3 else 1)
        assert held_to_jax(path) is None, name
    with pytest.raises(ValueError, match="separate planes"):
        _tiff.decode_tiff(open(jpeg_tiff(str(tmp_path / "sep.tif"), img), "rb").read().replace(
            struct.pack("<HHII", 284, 3, 1, 1), struct.pack("<HHII", 284, 3, 1, 2)))


def old_jpeg_tiff(img, sampling, strip=True, photometric=6):
    """Old-style JPEG (compression 6) as one interchange-format stream: the
    ``JPEGInterchangeFormat`` tags point at a whole JPEG PIL encodes, and
    the one strip (where given) at the same bytes."""
    h, w, _ = img.shape
    stream = _jpeg(img, SUBSAMPLING[sampling])
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [8, 8, 8]), 259: (3, [6]), 262: (3, [photometric]),
            277: (3, [3]), 278: (3, [h]), 530: (3, list(sampling)), 513: (4, [8]), 514: (4, [len(stream)])}
    if strip:
        tags.update({273: (4, [8]), 279: (4, [len(stream)])})
    return tiff_ifd(tags, data=stream)


@pytest.mark.parametrize("sampling", list(SUBSAMPLING))
def test_old_style_jpeg_interchange_format(tmp_path, sampling):
    """Compression 6 in the layout libtiff reads as one stream: PIL takes it
    as YCbCr through libtiff's RGBA interface, which gets the raw
    components (no upsampling, no colour conversion) and replicates each
    block's chroma; with and without the strip tags, at sizes off the MCU
    grid. Other old-style layouts raise ``NotImplementedError``."""
    rng = np.random.default_rng(sum(sampling))
    for (h, w), strip in itertools.product(((32, 48), (37, 45)), (True, False)):
        path = _write(tmp_path, "o.tif", old_jpeg_tiff(_seeded_photo(rng, h, w, 3), sampling, strip))
        assert held_to_jax(path) is not None, (h, w, strip)
    data = bytearray(old_jpeg_tiff(_seeded_photo(rng, 32, 48, 3), sampling))
    i = data.index(struct.pack("<HHI", 513, 4, 1))
    data[i:i + 2] = struct.pack("<H", 700)  # no interchange-format tag: the strips alone
    with pytest.raises(NotImplementedError, match="old-style JPEG.*ROADMAP item 17"):
        load_image(_write(tmp_path, "s.tif", bytes(data)))


# -- YCbCr that is not JPEG -----------------------------------------------------------------

def ycbcr_tiff(rng, h, w, hs, vs, compression, more=None, rows_per_strip=None, tile=None):
    """Packed YCbCr data units of random bytes (``hs·vs`` luma samples, Cb,
    Cr), uncompressed, LZW, Deflate or PackBits, in strips or tiles."""
    from chip_smoke import lzw_encode, packbits

    th, tw = tile or (rows_per_strip or h, w)
    chunks = []
    for _ in range(-(-h // th) * -(-w // tw)):
        raw = rng.integers(0, 256, -(-tw // hs) * -(-th // vs) * (hs * vs + 2)).astype(np.uint8).tobytes()
        chunks.append({1: lambda r: r, 5: lambda r: lzw_encode(r, 8, msb=True), 8: zlib.compress,
                       32773: packbits}[compression](raw))
    offsets = list(itertools.accumulate([8] + [len(c) + (len(c) & 1) for c in chunks[:-1]]))
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [8, 8, 8]), 259: (3, [compression]), 262: (3, [6]),
            277: (3, [3]), 530: (3, [hs, vs])}
    if tile:
        tags.update({322: (3, [tw]), 323: (3, [th]), 324: (4, offsets), 325: (4, [len(c) for c in chunks])})
    else:
        tags.update({273: (4, offsets), 278: (3, [th]), 279: (4, [len(c) for c in chunks])})
    tags.update(more or {})
    return tiff_ifd(tags, data=b"".join(c + bytes(len(c) & 1) for c in chunks))


def _rational(values, den=1):
    return [v for x in values for v in (int(round(x * den)), den)]


YCBCR_TAGS = {  # ReferenceBlackWhite (532) and YCbCrCoefficients (529), as RATIONALs
    "defaults": {},
    "video_range": {532: (5, _rational((16, 235, 128, 240, 128, 240)))},
    "half_codes": {532: (5, _rational((15, 235.5, 128, 239.5, 127.5, 240.5), 2))},
    "rec709": {529: (5, _rational((0.2126, 0.7152, 0.0722), 10000))},
}


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_ycbcr_not_jpeg(tmp_path, compression):
    """Every subsampling libtiff's RGBA interface takes (1×1 to 4×4; 1×4
    and 2×4 it refuses) at sizes that leave partial blocks, in strips and
    tiles, under the default and other reference ranges and coefficients.
    Uncompressed, PIL's raw decoder reads the file's bytes as RGBX."""
    rng = np.random.default_rng(compression)
    decoded = 0
    for (hs, vs), (h, w), (name, more) in itertools.product(
            ((1, 1), (2, 1), (2, 2), (1, 2), (4, 1), (4, 2), (4, 4), (1, 4), (2, 4)), ((9, 13), (8, 8)),
            YCBCR_TAGS.items()):
        layout = [dict()] if (h, w) == (9, 13) else [dict(rows_per_strip=4), dict(tile=(16, 16))]
        for kw in layout:
            path = _write(tmp_path, "y.tif", ycbcr_tiff(rng, h, w, hs, vs, compression, more, **kw))
            decoded += held_to_jax(path) is not None
    assert decoded >= 50, decoded


# -- 12-, 16-signed-, 32-bit and float samples ------------------------------------------------

KINDS = {  # name → (bits, sample format, dtype, sampler)
    "u12": (12, 1, np.uint16, lambda r, s: r.integers(0, 4096, s)),
    "i16": (16, 2, np.int16, lambda r, s: r.integers(-400, 700, s)),
    "u32": (32, 1, np.uint32, lambda r, s: r.integers(0, 2**32, s, dtype=np.uint64)),
    "i32": (32, 2, np.int32, lambda r, s: np.where(r.random(s) < 0.5, r.integers(-2**31, 2**31, s),
                                                   r.integers(-300, 600, s))),
    "f32": (32, 3, np.float32, lambda r, s: r.uniform(-60.0, 320.0, s)),
}
SPECIAL = np.array([np.nan, np.inf, -np.inf, -0.0, -0.5, 0.99, 60.936, 235.187, 254.999, 255.0, 255.5, 1e30],
                   np.float32)


@pytest.mark.parametrize("order", "<>")
@pytest.mark.parametrize("kind", list(KINDS))
def test_wide_gray_samples(tmp_path, kind, order):
    """One kind in one byte order over compression (none, LZW, Deflate,
    PackBits) × predictor 1 / 2 / 3 × strips and tiles (and photometric 0 for
    floats); the floats carry NaN, ±inf, −0, negatives and values past 255.
    PIL reads no big-endian 12-bit or 32-bit unsigned gray, and libtiff
    refuses predictor 3 on integers and predictor 2 at 12 bits: the port
    refuses them too."""
    bits, fmt, dtype, sample = KINDS[kind]
    rng = np.random.default_rng(len(kind) + (order == ">"))
    img = sample(rng, (23, 37, 1)).astype(dtype)
    if kind == "f32":
        img.reshape(-1)[:SPECIAL.size * 3:3] = SPECIAL
    decoded = 0
    for comp, pred, layout, photo in itertools.product((1, 5, 8, 32773), (1, 2, 3),
                                                       (dict(rows_per_strip=8), dict(tile=(16, 16))),
                                                       (1, 0) if kind == "f32" else (1,)):
        path = str(tmp_path / "w.tif")
        write_tiff(path, img, bits=bits, sample_format=fmt, compression=comp, predictor=pred, byteorder=order,
                   photometric=photo, **layout)
        got = held_to_jax(path)
        if got is not None:
            assert got.shape == (23, 37, 3)
            decoded += 1
    readable = not (order == ">" and kind in ("u12", "u32"))
    assert (decoded > 0) == readable, decoded


def test_float_tiff_convert_rule(tmp_path):
    """``convert("RGB")`` of PIL's mode F as the port applies it: truncation
    toward zero, clipped to [0, 255], NaN 0 and −inf 0, +inf 255: 60.936
    → 60 and 235.187 → 235, as PIL gives them."""
    path = str(tmp_path / "f.tif")
    write_tiff(path, SPECIAL.reshape(1, -1, 1), bits=32, sample_format=3, compression=8, predictor=3)
    got = held_to_jax(path)
    np.testing.assert_array_equal(got[0, :, 0], [0, 255, 0, 0, 0, 0, 60, 235, 254, 255, 255, 255])


# -- ICO -----------------------------------------------------------------------------------

def dib(rng, w, h, bits, palette=None, mask=True):
    """A DIB entry: 40-byte header (the height doubled), palette, colour
    bitmap rows bottom-up, then the AND mask (rows padded to 32 bits)."""
    stride = ((w * bits + 31) >> 3) & ~3
    colors = 0 if palette is None else len(palette) // 4
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0, colors, 0)
    pixels = rng.integers(0, 256, stride * h).astype(np.uint8).tobytes()
    and_mask = rng.integers(0, 256, -(-w // 32) * 4 * h).astype(np.uint8).tobytes() if mask else b""
    return head + (palette or b"") + pixels + and_mask


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P", "1", "LA"])
def test_ico_written_by_pil(tmp_path, mode):
    """PIL's ICO writer: PNG-coded entries (its default) and BMP-coded ones
    (PIL writes no LA bitmap), sizes 16, 32 and 48."""
    rng = np.random.default_rng(len(mode))
    img = Image.fromarray(np.concatenate([_seeded_photo(rng, 48, 48, 3),
                                          rng.integers(0, 256, (48, 48, 1)).astype(np.uint8)], -1)).convert(mode)
    for fmt in ("png", "bmp") if mode != "LA" else ("png",):
        path = str(tmp_path / "p.ico")
        img.save(path, sizes=[(16, 16), (32, 32), (48, 48)], bitmap_format=fmt)
        got = held_to_jax(path)
        assert got is not None and got.shape[:2] == (48, 48), fmt
        if fmt == "bmp":
            assert got.shape[2] == 4  # BMP-coded entries always carry the AND mask's or the 4th byte's alpha


@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
def test_ico_bitmap_entries(tmp_path, bits):
    """A DIB entry at each depth, at widths that pad its rows and its mask's,
    with random colour tables; and the 32-bit entry's alpha from its 4th
    bytes."""
    rng = np.random.default_rng(bits)
    palette = rng.integers(0, 256, 4 << bits).astype(np.uint8).tobytes() if bits <= 8 else None
    for w, h in ((16, 16), (13, 7), (40, 33)):
        path = str(tmp_path / "d.ico")
        write_ico(path, [(w, h, (1 << bits) % 256 if bits <= 8 else 0, bits, dib(rng, w, h, bits, palette))])
        got = held_to_jax(path)
        assert got is not None and got.shape == (h, w, 4)


def test_ico_entry_choice(tmp_path):
    """PIL's choice: the largest area, then the lowest colour depth (bits, or
    log2 of the colour count with bits 0); a PNG entry's own size wins over
    its directory size (here 1024² in a directory that says 256); entries
    past the end of the file or none at all: not an ICO (then not a TGA)."""
    rng = np.random.default_rng(5)
    p8 = rng.integers(0, 256, 1024).astype(np.uint8).tobytes()
    e8, e32 = (32, 32, 0, 8, dib(rng, 32, 32, 8, p8)), (32, 32, 0, 32, dib(rng, 32, 32, 32))
    e16 = (16, 16, 0, 32, dib(rng, 16, 16, 32))
    e4 = (32, 32, 16, 0, dib(rng, 32, 32, 4, rng.integers(0, 256, 64).astype(np.uint8).tobytes()))
    buf = io.BytesIO()
    Image.fromarray(_blocky(rng, 1024, 1024, 1)[..., 0]).save(buf, "PNG")
    big = (256, 256, 0, 32, buf.getvalue())
    for name, entries in {"32_then_8": [e32, e8, e16], "16_first": [e16, e32, e8], "colour_count": [e32, e4],
                          "png_1024_in_256": [e16, big], "png_alone": [big]}.items():
        path = str(tmp_path / f"{name}.ico")
        write_ico(path, entries)
        got = held_to_jax(path)
        assert got is not None, name
        if name.startswith("png"):
            assert got.shape == (1024, 1024, 1)
    for name, data in {"no_entries": b"\0\0\1\0\0\0", "entry_past_end": b"\0\0\1\0\1\0" + bytes(10)}.items():
        assert held_to_jax(_write(tmp_path, f"{name}.ico", data)) is None, name


# -- chip_smoke's writers, the fixture, and the scene ------------------------------------------

def test_chip_smoke_writers_read_as_pil_reads(tmp_path):
    """What phase ak writes on the card's machine (no PIL there), read here by
    both packages: the colour JPEG fixture wrapped as one JPEG-in-TIFF strip
    (photometric 6, 2×2) decodes to that JPEG's own digest; an ICO whose
    1024² PNG entry (``save_png``) is a gray page; a float32 Deflate TIFF
    under predictor 3 of a page + 0.25, which truncates to the page."""
    manifest = json.load(open(os.path.join(FIXTURE_DIR, "manifest.json")))
    with open(os.path.join(FIXTURE_DIR, "page_color_1024.jpg"), "rb") as f:
        stream = f.read()
    path = str(tmp_path / "strip.tif")
    write_jpeg_tiff(path, [stream], 1024, 1024)
    got = held_to_jax(path)
    assert hashlib.sha256(got.tobytes()).hexdigest() == manifest["page_color_1024.jpg"]["decoded_sha256"]
    gray = _blocky(np.random.default_rng(8), 1024, 1024, 1)
    save_png(str(tmp_path / "gray.png"), gray)
    write_ico(str(tmp_path / "gray.ico"), [(1024, 1024, 0, 32, open(tmp_path / "gray.png", "rb").read())])
    assert np.array_equal(held_to_jax(str(tmp_path / "gray.ico")), gray)
    page = _seeded_photo(np.random.default_rng(9), 256, 256, 1)
    write_tiff(str(tmp_path / "f.tif"), page.astype(np.float32) + np.float32(0.25), bits=32, sample_format=3,
               compression=8, predictor=3, rows_per_strip=64)
    assert np.array_equal(held_to_jax(str(tmp_path / "f.tif")), np.repeat(page, 3, -1))


def test_tiled_fixture_matches_manifest():
    """``tests/data/page_color_1024_tiles.tif`` (240² tiles, ``JPEGTables``,
    written by ``make_tiff_jpeg_fixtures.py``): the port's decode has PIL's
    digest."""
    entry = json.load(open(os.path.join(FIXTURE_DIR, "manifest.json")))["page_color_1024_tiles.tif"]
    path = os.path.join(FIXTURE_DIR, "page_color_1024_tiles.tif")
    got = load_image(path)
    assert list(got.shape) == entry["shape"] and os.path.getsize(path) == entry["bytes"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["decoded_sha256"]


def test_obj_scene_pages_from_jpeg_tiff_ico_and_float_tiff(tmp_path):
    """An MTL whose diffuse map is a tiled, table-abbreviated JPEG-in-TIFF,
    roughness an ICO (a BMP-coded entry: an RGBA page), metallic a float32
    TIFF (Deflate, predictor 3) and normal map an LZW YCbCr TIFF: the asset
    cache's pages and the atlas equal the JAX package's ``obj_scene``'s."""
    path = write_sphere_obj(tmp_path, textured=False)
    rng = np.random.default_rng(53)
    (tmp_path / "maps").mkdir()
    maps = tmp_path / "maps"
    jpeg_tiff(str(maps / "albedo.tif"), _seeded_photo(rng, 40, 40, 3), tile=(32, 32), tables=True)
    write_ico(str(maps / "rough.ico"), [(24, 24, 0, 24, dib(rng, 24, 24, 24))])
    write_tiff(str(maps / "metal.tif"), rng.uniform(0, 256, (40, 40, 1)).astype(np.float32), bits=32,
               sample_format=3, compression=8, predictor=3)
    (maps / "normal.tif").write_bytes(ycbcr_tiff(rng, 32, 32, 2, 2, 5))
    (tmp_path / "sphere.mtl").write_text(
        "newmtl painted\nKd 1 1 1\nNs 128\nPm 0.25\nmap_Kd maps/albedo.tif\nmap_Pr maps/rough.ico\n"
        "map_Pm maps/metal.tif\nmap_bump maps/normal.tif\nnewmtl plain\nKd 0.2 0.6 0.9\nNs 32\n")
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
    assert sorted(p.shape[-1] for p in cache.pages) == [3, 3, 3, 4]  # the ICO's BMP entry: RGBA
