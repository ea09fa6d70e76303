"""PyTorch port vs the JAX package: the TIFF, ICO and GIF layouts
``load_image`` named ROADMAP item 17 for until it read them — YCbCr in
separate planes, a JPEG stream smaller than its strip or tile, a predictor
on YCbCr data units, sub-byte tiles at a bit offset, JPEG-compressed
separate planes, separate planes of one sample or with unused extra
samples, a narrow 4-bit gray-palette ICO bitmap, tags of no values, GIF
LZW code sizes 0 and 1.

Every file is decoded by the port and by the JAX package's ``load_image``
(PIL 12.1 with libtiff) and the two held equal bit for bit
(``held_to_jax``), or both must refuse it (the port with ``ValueError``).
What each layout does in PIL, as the port reads it:

* YCbCr in separate planes: libtiff's RGBA interface has one separate-plane
  case, 8-bit 1×1 (``putseparate8bitYCbCr11tile``); other subsampling it
  refuses. Uncompressed, PIL's raw decoder reads the planes as R, G, B.
* A JPEG smaller than its strip or tile: libtiff warns and libjpeg writes
  the stream's rows from the left of the first rows; the rest of PIL's one
  strip buffer keeps what the strip or tile before left there (compared
  where a later strip or tile is the small one: before the first, PIL's
  buffer is uninitialised memory).
* A predictor on YCbCr data units: libtiff undoes it on rows of 3-byte
  "pixels" (a strip's scanline, a tile's width × 3); where the units do not
  divide so, the strip fails and the RGBA interface (told not to stop)
  draws it undifferenced.
* Sub-byte tiles: pixels placed at their bit offset; PIL's bound on a
  libtiff tile's size refuses tiles taller than wide at 1 bit.
* Separate planes: JPEG-compressed (one-component streams) read; one
  sample's plane read as the contiguous layout by libtiff and by its
  rawmode's letter in PIL's raw decoder (no scaling, inversion or bit
  reversal); unused extra samples from tiles only.
"""

import io
import itertools
import os
import tempfile

import numpy as np
import pytest
from PIL import Image

from chip_smoke import write_ico, write_jpeg_tiff, write_tiff, write_tiff_file
from physically_based_renderer_tpu_torch.utils.image_io import load_image
from test_torch_image_formats import _write, held_to_jax
from test_torch_image_tiff_jpeg_ico import _jpeg, dib, ycbcr_tiff

H, W = 10, 13


def _written(img, **kw) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        write_tiff(os.path.join(d, "w.tif"), img, **kw)
        with open(os.path.join(d, "w.tif"), "rb") as f:
            return f.read()


def _file(writer, *args, **kw) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        writer(os.path.join(d, "f"), *args, **kw)
        with open(os.path.join(d, "f"), "rb") as f:
            return f.read()


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_ycbcr_in_separate_planes(tmp_path, compression):
    """1×1, 2×1 and 2×2 subsampling over strips, one strip and tiles, with
    and without a predictor: libtiff's 1×1 case read, the others refused."""
    rng = np.random.default_rng(compression)
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    read = 0
    for sub, layout, predictor in itertools.product(((1, 1), (2, 1), (2, 2)),
                                                    (dict(), dict(tile=(16, 16)), dict(rows_per_strip=4)), (1, 2)):
        if predictor == 2 and compression in (1, 32773):
            continue
        data = _written(img, photometric=6, compression=compression, planar=2, predictor=predictor,
                        tags={530: (3, list(sub))}, **layout)
        read += held_to_jax(_write(tmp_path, "y.tif", data)) is not None
    assert read == {1: 9, 5: 6, 8: 6, 32773: 3}[compression], read  # uncompressed: all; libtiff: 1×1 only


@pytest.mark.parametrize("photometric,subsampling", [(2, None), (6, (2, 2)), (6, (2, 1)), (1, None)])
def test_jpeg_smaller_than_its_strip_or_tile(tmp_path, photometric, subsampling):
    """The second strip's (or tile's) JPEG shorter and narrower than its
    strip: its rows written from the left, the rest the first strip's."""
    rng = np.random.default_rng(photometric)
    img = rng.integers(0, 256, (32, 48, 3)).astype(np.uint8)
    c = 1 if photometric == 1 else 3
    src, sub = img[..., :c], {None: 0 if c == 3 else None, (2, 2): 2, (2, 1): 1}[subsampling]
    for h2, w2 in ((12, 40), (16, 40), (9, 48), (1, 8)):
        data = _file(write_jpeg_tiff, [_jpeg(src[:16], sub), _jpeg(src[16:16 + h2, :w2], sub)], 48, 32, components=c,
                     photometric=photometric, subsampling=subsampling, rows_per_strip=16)
        assert held_to_jax(_write(tmp_path, "s.tif", data)) is not None, (h2, w2)
        data = _file(write_jpeg_tiff, [_jpeg(src[:16, :16], sub), _jpeg(src[:h2, 16:16 + min(w2, 16)], sub)], 32, 16,
                     components=c, photometric=photometric, subsampling=subsampling, tile=(16, 16))
        assert held_to_jax(_write(tmp_path, "t.tif", data)) is not None, (h2, w2)


@pytest.mark.parametrize("compression", [5, 8, 32773])
def test_predictor_on_ycbcr_data_units(tmp_path, compression):
    """Predictor 2 on YCbCr data units at every subsampling libtiff's RGBA
    interface takes, over strips and tiles: undone where libtiff's rows
    divide the units, drawn undifferenced where they do not; predictor 3
    refused (PackBits takes no predictor)."""
    rng = np.random.default_rng(compression)
    for (hs, vs), (h, w), kw, predictor in itertools.product(
            ((1, 1), (2, 1), (2, 2), (1, 2), (4, 1), (4, 2), (4, 4)), ((9, 13), (16, 24)),
            (dict(), dict(rows_per_strip=4), dict(tile=(16, 16))), (2, 3)):
        data = ycbcr_tiff(rng, h, w, hs, vs, compression, {317: (3, [predictor])}, **kw)
        got = held_to_jax(_write(tmp_path, "p.tif", data))
        assert (got is None) == (predictor == 3 and compression != 32773), (hs, vs, h, w, kw, predictor)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_sub_byte_tiles(tmp_path, bits):
    """Gray tiles of 4, 8 and 12 pixels wide at 1, 2 and 4 bits — a tile
    starting inside a byte — uncompressed and through libtiff, contiguous
    and as one sample's separate plane; PIL's bound refuses 1-bit tiles
    taller than wide."""
    rng = np.random.default_rng(bits)
    img = rng.integers(0, 1 << bits, (H, W, 1)).astype(np.uint8)
    refused = 0
    for compression, tile, planar in itertools.product((1, 5, 8, 32773), ((4, 4), (8, 4), (4, 12)), (1, 2)):
        data = _written(img, bits=bits, compression=compression, tile=tile, photometric=1, planar=planar)
        refused += held_to_jax(_write(tmp_path, "b.tif", data)) is None
    assert refused == (6 if bits == 1 else 0), refused


@pytest.mark.parametrize("photometric", [2, 5, 1])
def test_jpeg_compressed_separate_planes(tmp_path, photometric):
    """RGB, CMYK and gray in separate planes, each strip or tile of each
    plane a one-component JPEG stream."""
    rng = np.random.default_rng(photometric)
    c = {2: 3, 5: 4, 1: 1}[photometric]
    im = rng.integers(0, 256, (16, 24, c)).astype(np.uint8)
    strips = [_jpeg(im[r:r + 8, :, k:k + 1], None) for k in range(c) for r in (0, 8)]
    tiles = [_jpeg(np.pad(im[:, x:x + 16, k:k + 1], ((0, 0), (0, 16 - im[:, x:x + 16].shape[1]), (0, 0))), None)
             for k in range(c) for x in (0, 16)]
    tags = {256: (4, [24]), 257: (4, [16]), 258: (3, [8] * c), 259: (3, [7]), 262: (3, [photometric]),
            277: (3, [c]), 284: (3, [2])}
    for chunks, tile in ((strips, None), (tiles, (16, 16))):
        data = _file(write_tiff_file, tags, chunks, tile, 8, "<")
        assert held_to_jax(_write(tmp_path, "j.tif", data)) is not None, tile


@pytest.mark.parametrize("extra", [(0,), (0, 0), (1, 0), (2, 0), (0, 0, 0), (2, 0, 0)])
def test_separate_planes_with_unused_samples(tmp_path, extra):
    """RGB with unused extra samples in separate planes: read from tiles
    (PIL fills the image's bands from the first planes), refused from
    strips and uncompressed."""
    rng = np.random.default_rng(len(extra))
    img = rng.integers(0, 256, (6, 7, 3 + len(extra))).astype(np.uint8)
    for compression, layout in itertools.product((1, 5, 8), (dict(), dict(tile=(16, 16)))):
        data = _written(img, compression=compression, planar=2, extra_samples=extra, **layout)
        got = held_to_jax(_write(tmp_path, "x.tif", data))
        assert (got is not None) == (compression != 1 and "tile" in layout), (compression, layout)


SAMPLES = [(1, 0, 1), (1, 1, 1), (2, 1, 1), (4, 0, 1), (4, 1, 1), (8, 0, 1), (8, 1, 1), (4, 3, 1), (8, 3, 1),
           (16, 1, 1), (16, 1, 2), (32, 1, 3), (32, 1, 2), (12, 1, 1)]


@pytest.mark.parametrize("bits,photometric,fmt", SAMPLES)
def test_one_sample_in_separate_planes(tmp_path, bits, photometric, fmt):
    """One sample in separate planes (planar configuration 2): through
    libtiff the contiguous layout; through PIL's raw decoder each plane read
    by its rawmode's letter — 1 bit for mode 1, a byte for L and P, 32 bits
    for I and F — with no scaling, inversion or bit reversal; I;16 and I;12
    refused as PIL refuses them."""
    rng = np.random.default_rng(bits * 7 + photometric)
    dtype = {1: np.uint16 if bits in (12, 16) else (np.uint32 if bits == 32 else np.uint8),
             2: np.int16 if bits == 16 else np.int32, 3: np.float32}[fmt]
    img = (rng.integers(0, 1 << min(bits, 12), (6, 8, 1)) if fmt != 3 else rng.uniform(-10, 300, (6, 8, 1)))
    cmap = rng.integers(0, 65536, (1 << bits, 3)) if photometric == 3 else None
    for compression, layout in itertools.product((1, 5, 8), (dict(), dict(tile=(16, 16)), dict(rows_per_strip=4),
                                                             dict(tile=(4, 4)))):
        data = _written(img.astype(dtype), bits=bits, photometric=photometric, compression=compression, planar=2,
                        colormap=cmap, sample_format=fmt if fmt != 1 else None, **layout)
        got = held_to_jax(_write(tmp_path, "o.tif", data))
        assert (got is None) == (bits in (12, 16) and fmt == 1 and compression == 1), (compression, layout)


def test_narrow_4_bit_gray_palette_ico(tmp_path):
    """A 4-bit ICO bitmap with a gray palette (palette[i] = i): PIL reads its
    bytes as 8-bit gray from a file object, so a row up to its stride wide
    decodes and a wider one is refused (codec configuration error)."""
    rng = np.random.default_rng(91)
    decoded = 0
    for colors in (16, 5, 3):
        palette = b"".join(bytes([i, i, i, 0]) for i in range(colors))
        for w, h in ((16, 16), (13, 7), (4, 3), (3, 5), (1, 1), (5, 2)):
            data = _file(write_ico, [(w, h, colors % 256, 4, dib(rng, w, h, 4, palette))])
            got = held_to_jax(_write(tmp_path, "g.ico", data))
            assert (got is not None) == (w <= 4), (colors, w, h)
            decoded += got is not None
    assert decoded == 9


@pytest.mark.parametrize("tag", [256, 258, 259, 262, 273, 277, 278, 279])
def test_tags_of_no_values(tmp_path, tag):
    """A tag stored with a count of 0 (found by a mutation fuzz): PIL keeps
    no such tag (its defaults apply), libtiff refuses a file whose
    BitsPerSample, SamplesPerPixel or RowsPerStrip has none. An LZW file
    whose StripByteCounts has none libtiff reads by estimating the count,
    which the port does not (it refuses the file)."""
    from test_torch_image_tiff_orientation import with_tags

    img = Image.fromarray(np.arange(48, dtype=np.uint8).reshape(6, 8))
    for compression in ("raw", "tiff_lzw"):
        buf = io.BytesIO()
        img.save(buf, "TIFF", compression=compression)
        path = _write(tmp_path, "z.tif", with_tags(buf.getvalue(), {tag: (3, 0, b"")}))
        if (compression, tag) == ("tiff_lzw", 279):
            with pytest.raises(ValueError, match="byte counts"):
                load_image(path)
            continue
        held_to_jax(path)


def _gif_of_codes(codes: list, code_bits: int, min_bits: int, w: int, h: int, palette, interlace: bool) -> bytes:
    """A GIF whose LZW data is ``codes``, each ``code_bits`` wide, least
    significant bit first, under LZW code size ``min_bits``."""
    import struct

    value = sum(int(c) << (i * code_bits) for i, c in enumerate(codes))
    data = value.to_bytes(max(1, -(-len(codes) * code_bits // 8)), "little")
    head = b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF0, 0, 0) + np.asarray(palette, np.uint8).tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255))
    desc = b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x40 if interlace else 0)
    return head + desc + bytes([min_bits]) + blocks + b"\x00\x3b"


@pytest.mark.parametrize("min_bits", [0, 1])
def test_gif_lzw_code_sizes_0_and_1(tmp_path, min_bits):
    """LZW code sizes the format does not allow, as PIL's decoder reads
    them: codes of ``min_bits + 1`` bits that never widen — each a pixel, a
    clear or (at 1) the end —; seeded random streams, some short of the
    image (refused as PIL refuses them), with colour and gray tables,
    interlaced or not."""
    rng = np.random.default_rng(min_bits)
    decoded = 0
    for _ in range(120):
        w, h = int(rng.integers(1, 9)), int(rng.integers(1, 6))
        codes = list(rng.integers(0, 2 << min_bits, int(rng.integers(0, w * h + 8))))
        palette = [[0, 0, 0], [1, 1, 1]] if rng.random() < 0.3 else rng.integers(0, 256, (2, 3))
        data = _gif_of_codes(codes, min_bits + 1, min_bits, w, h, palette, bool(rng.integers(2)))
        decoded += held_to_jax(_write(tmp_path, "c.gif", data)) is not None
    assert decoded >= 10, decoded
