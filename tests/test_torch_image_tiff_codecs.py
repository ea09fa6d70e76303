"""PyTorch port vs the JAX package: the TIFF codecs PIL reads past the
reference's loaders — LZMA (34925), Zstd (50000), CCITT (2, 3, 4, 32771),
ThunderScan (32809) — and CIELab samples (photometric 8), in
``utils/image_io.load_image`` (``utils/_tiff.py`` with ``_zstd.py``,
``_ccitt.py`` and ``_lab.py``).

Every file is decoded by the port and by the JAX package's own ``load_image``
(PIL 12.1 with libtiff 4.7, its libzstd and liblzma, and LittleCMS for
``convert``) and the two held with ``np.array_equal`` (``held_to_jax``), or
both must refuse it (the port with ``ValueError``). The files: PIL's writer
(LZMA, Zstd, CCITT in every mode it writes); ``chip_smoke.write_tiff`` with
LZMA at several presets and integrity checks and Zstd (the ``zstandard``
package, the tests' encoder only) at several levels, as strips and tiles,
under predictors 1-3, one strip past 128 KiB; Zstd frames as libtiff reads
them (the first frame only, cut at the strip's size); a Zstd frame built by
hand in the RLE modes no encoder here picks; CCITT tiles made of strips PIL
encodes and RLEW rows built by hand; ThunderScan rows built by hand and
random; LogLuv and WebP-in-TIFF, which PIL refuses; the committed fixtures;
then a seeded mutation fuzz of each codec, PIL against the port.

CCITT strips that end early are pinned as libtiff reads them here: Modified
Huffman and a T.4 row cut mid-row fail the strip; T.4 at an EOL search and
T.6 after its first row keep the rows decoded. PIL leaves the rows after
those in its buffer as it found it — uninitialised memory — so those rows
are compared only where the port's rows are white to the end (``held_ccitt``).
"""

import hashlib
import io
import json
import lzma
import os
import struct
import tempfile

import numpy as np
import pytest
import zstandard
from PIL import Image

from chip_smoke import FIXTURE_DIR, write_tiff, write_tiff_file
from physically_based_renderer_tpu.utils.image_io import load_image as jax_load_image
from physically_based_renderer_tpu_torch.utils import _lab, _zstd
from physically_based_renderer_tpu_torch.utils.image_io import load_image
from test_torch_image_formats import _seeded_photo, _write, held_to_jax
from test_torch_image_gif_tiff import gray_entries, tiff_ifd

H, W = 23, 37


def _pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _written(img, **kw) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        write_tiff(os.path.join(d, "w.tif"), img, **kw)
        with open(os.path.join(d, "w.tif"), "rb") as f:
            return f.read()


def _strip(data: bytes) -> bytes:
    im = Image.open(io.BytesIO(data))
    return data[im.tag_v2[273][0]:im.tag_v2[273][0] + im.tag_v2[279][0]]


# -- LZMA and Zstd ----------------------------------------------------------------------------

PIL_MODES = {"RGB": (3, 2), "RGBA": (4, 2), "L": (1, 2), "I;16": (1, 2), "F": (1, 1), "1": (1, 1), "P": (3, 2)}


@pytest.mark.parametrize("mode", list(PIL_MODES))
@pytest.mark.parametrize("codec", ["lzma", "zstd"])
def test_lzma_and_zstd_written_by_pil(tmp_path, codec, mode):
    """PIL's writer in each mode, with and without horizontal differencing
    where libtiff takes it (8- and 16-bit samples)."""
    rng = np.random.default_rng(len(mode))
    photo = _seeded_photo(rng, H, W, 4)
    img = {"RGB": lambda: Image.fromarray(photo[..., :3]), "RGBA": lambda: Image.fromarray(photo),
           "L": lambda: Image.fromarray(photo[..., 0]), "P": lambda: Image.fromarray(photo[..., :3]).convert("P"),
           "I;16": lambda: Image.fromarray(photo[..., 0].astype(np.uint16) * 2, "I;16"),
           "F": lambda: Image.fromarray(photo[..., 0].astype(np.float32) * 1.5 - 20, "F"),
           "1": lambda: Image.fromarray(photo[..., 0]).convert("1")}[mode]()
    for predictor in range(1, PIL_MODES[mode][1] + 1):
        path = _write(tmp_path, "p.tif", _pil(img, compression=codec, tiffinfo={317: predictor}))
        assert held_to_jax(path) is not None, predictor


LZMA_CODERS = {f"preset {p}, check {c}": (lambda r, p=p, c=c: lzma.compress(r, format=lzma.FORMAT_XZ, check=c,
                                                                          preset=p))
               for p, c in ((0, lzma.CHECK_NONE), (6, lzma.CHECK_CRC32), (9 | lzma.PRESET_EXTREME, lzma.CHECK_CRC64),
                            (3, lzma.CHECK_SHA256))}
ZSTD_CODERS = {f"level {lv}{', checksum' if ck else ''}":
               (lambda r, lv=lv, ck=ck: zstandard.ZstdCompressor(level=lv, write_checksum=ck).compress(r))
               for lv, ck in ((-5, False), (1, True), (3, False), (9, True), (19, False))}
LAYOUTS = {"strips": dict(rows_per_strip=7), "one strip": {}, "tiles": dict(tile=(16, 16))}


@pytest.mark.parametrize("coder", list(LZMA_CODERS) + list(ZSTD_CODERS))
def test_lzma_and_zstd_coders(tmp_path, coder):
    """Chunks coded by liblzma at four presets and integrity checks, or by
    libzstd at five levels with and without the checksum: 8-bit RGB under
    predictors 1 and 2, 16-bit gray under 2, float32 under 3, as strips,
    one strip and tiles."""
    codec = LZMA_CODERS.get(coder) or ZSTD_CODERS[coder]
    compression = 34925 if coder in LZMA_CODERS else 50000
    rng = np.random.default_rng(len(coder))
    rgb = _seeded_photo(rng, H, W, 3)
    for layout, kw in LAYOUTS.items():
        for img, extra in ((rgb, dict(predictor=1)), (rgb, dict(predictor=2)),
                           (rgb[..., :1].astype(np.uint16) * 3, dict(bits=16, predictor=2)),
                           (rgb[..., :1].astype(np.float32) - 40.5, dict(bits=32, sample_format=3, predictor=3))):
            data = _written(img, compression=compression, codec=codec, **extra, **kw)
            assert held_to_jax(_write(tmp_path, "c.tif", data)) is not None, (layout, extra)


def test_zstd_strip_past_128k(tmp_path):
    """A float32 strip of 147,456 bytes: frames of several blocks, whose
    later blocks repeat their tables; at two levels."""
    img = (np.add.outer(np.arange(192), np.arange(192)) % 97).astype(np.float32)[..., None] * 2.5
    for level in (3, 19):
        data = _written(img, bits=32, sample_format=3, compression=50000, predictor=3,
                        codec=lambda r, lv=level: zstandard.ZstdCompressor(level=lv).compress(r))
        assert len(_strip(data)) > 0 and held_to_jax(_write(tmp_path, "b.tif", data)) is not None, level


def _zstd_corpus() -> list:
    rng = np.random.default_rng(50000)
    return [bytes(1000), rng.integers(0, 256, 5000).astype(np.uint8).tobytes(),
            rng.integers(0, 4, 300000).astype(np.uint8).tobytes(), b"hello world, " * 5000,
            b"Q" * 64 + bytes(range(256)) * 3,
            np.cumsum(rng.integers(0, 20, 60000)).astype(np.uint8).tobytes(),
            bytes(rng.integers(65, 70, 3000).astype(np.uint8)), bytes(300000) + b"tail data",
            b"The quick brown fox jumps over the lazy dog. " * 7,
            b"".join(bytes([i % 251]) + b"abcdefghijklmnop" for i in range(3000)),
            b"".join(bytes([65 + i % 7]) + bytes(5) for i in range(3000)),  # at 19: literals in one stream
            bytes(np.clip(np.random.default_rng(0).normal(128, 20, 540000)[-140000:], 0, 255).astype(np.uint8))]


def test_zstd_decoder_modes():
    """``_zstd.decompress`` equals libzstd's output on a corpus at levels
    -5 to 19, and meets every block kind (raw, RLE, compressed), literal kind
    (raw, Huffman in 1 and 4 streams, treeless; RLE in the frame built by
    hand), Huffman weight coding (4-bit, FSE) and sequence-table mode
    (predefined, RLE, FSE, repeat) on the way."""
    seen = set()
    lit, weights, table = _zstd._literals, _zstd._huffman_weights, _zstd._table

    def spy_literals(data, pos, state):
        kind, fmt = data[pos] & 3, (data[pos] >> 2) & 3
        seen.add(("literals", kind, 1 if kind >= 2 and fmt == 0 else 4 if kind >= 2 else 0))
        return lit(data, pos, state)

    def spy_weights(data, pos):
        seen.add(("weights", data[pos] >= 128))
        return weights(data, pos)

    def spy_table(kind, mode, data, pos, state):
        seen.add(("table", kind, mode))
        return table(kind, mode, data, pos, state)

    frames = [zstandard.ZstdCompressor(level=lv).compress(t) for t in _zstd_corpus() for lv in (-5, 1, 3, 19)]
    try:
        _zstd._literals, _zstd._huffman_weights, _zstd._table = spy_literals, spy_weights, spy_table
        for frame in frames + [RLE_FRAME]:
            assert _zstd.decompress(frame) == zstandard.ZstdDecompressor().decompress(frame)
    finally:
        _zstd._literals, _zstd._huffman_weights, _zstd._table = lit, weights, table
    for frame in frames:
        pos = _zstd._frame_header(frame, 4)[1]
        while True:
            header = int.from_bytes(frame[pos:pos + 3], "little")
            seen.add(("block", (header >> 1) & 3))
            pos += 3 + (1 if (header >> 1) & 3 == 1 else header >> 3)
            if header & 1:
                break
    want = ({("block", k) for k in range(3)} | {("literals", 0, 0), ("literals", 1, 0), ("literals", 2, 1),
                                                ("literals", 2, 4), ("literals", 3, 4)}
            | {("weights", True), ("weights", False)}
            | {("table", k, m) for k in ("LL", "OF", "ML") for m in range(4)})
    assert want <= seen, sorted(want - seen, key=str)


# a frame built by hand: RLE literals ("A" five times), one sequence whose three tables are RLE
# (literal-length code 5, offset code 2 with the extra bit 1: offset 2, match-length code 0: 3)
_RLE_BLOCK = bytes([5 << 3 | 1, 65, 1, 1 << 6 | 1 << 4 | 1 << 2, 5, 2, 0, 0b101])
RLE_FRAME = (_zstd.MAGIC.to_bytes(4, "little") + bytes([0x20, 8]) + (1 | 2 << 1 | len(_RLE_BLOCK) << 3).to_bytes(3, "little")
             + _RLE_BLOCK)


def test_zstd_whole_streams():
    """The RFC's reading of a whole stream: concatenated frames, skippable
    frames between them, an empty frame; and a frame libzstd refuses."""
    parts = _zstd_corpus()[:4]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    stream = skip + b"".join(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(p) + skip for p in parts)
    assert _zstd.decompress(stream + zstandard.ZstdCompressor().compress(b"")) == b"".join(parts)
    bad = bytearray(zstandard.ZstdCompressor(write_checksum=True).compress(parts[3]))
    bad[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        _zstd.decompress(bytes(bad))


def _zstd_strip_cases() -> dict:
    pix = (np.arange(64 * 40) % 251).astype(np.uint8).tobytes()
    half, c = len(pix) // 2, lambda d, **kw: zstandard.ZstdCompressor(**kw).compress(d)
    skip = (0x184D2A50).to_bytes(4, "little") + (4).to_bytes(4, "little") + b"abcd"
    flip = lambda f: f[:-1] + bytes([f[-1] ^ 1])  # noqa: E731
    words = [bytes(np.random.default_rng(5).integers(0, 9, 300).astype(np.uint8)) for _ in range(200)]
    return {"plain": c(pix), "checksum": c(pix, write_checksum=True), "no content size": c(pix, write_content_size=False),
            "two frames": c(pix[:half]) + c(pix[half:]), "skippable first": skip + c(pix),
            "skippable after": c(pix) + skip, "bad checksum": flip(c(pix, write_checksum=True)),
            "longer content": c(pix + bytes(100)),
            "longer content, bad checksum": flip(c(pix + bytes(100), write_checksum=True)),
            "truncated": c(pix)[:-5], "trailing bytes": c(pix) + b"garbage", "empty frame first": c(b"") + c(pix),
            "dictionary": zstandard.ZstdCompressor(dict_data=zstandard.train_dictionary(1024, words)).compress(pix),
            "hand-built RLE modes": RLE_FRAME + bytes(64 * 40 - 8)}


ZSTD_STRIPS = _zstd_strip_cases()


@pytest.mark.parametrize("case", list(ZSTD_STRIPS))
def test_zstd_strips_as_libtiff_reads_them(tmp_path, case):
    """libtiff's ``ZSTDDecode``: the strip's first frame only (a skippable
    frame first gives nothing), decoded until the strip is full — a longer
    frame is cut, its checksum unread —; a short frame, a bad checksum of a
    frame that fits, a dictionary refused."""
    stream = ZSTD_STRIPS[case]
    held_to_jax(_write(tmp_path, "z.tif", tiff_ifd(gray_entries(64, 40, len(stream), 50000), data=stream)))


def test_lzma_strips_as_libtiff_reads_them(tmp_path):
    """libtiff's ``LZMADecode``: one xz stream (no concatenation) read until
    the strip is full; a stream cut short of it, a corrupt one, or an
    integrity check that fails before the strip is full, refused; a check
    that fails after, or a stream cut after, not seen."""
    pix = (np.arange(64 * 40) % 251).astype(np.uint8).tobytes()
    x = lambda d, **kw: lzma.compress(d, format=lzma.FORMAT_XZ, **kw)  # noqa: E731
    crc = bytearray(x(pix, check=lzma.CHECK_CRC32))
    crc[-17] ^= 1  # inside the block's CRC32, after its data
    longer = bytearray(x(pix + bytes(5000), check=lzma.CHECK_CRC64))
    longer[-20] ^= 1
    for stream in (x(pix), x(pix)[:-30], x(pix)[:40], x(pix) + x(pix), bytes(crc), bytes(longer),
                   x(pix + bytes(5000))[:-40], b"\xfd7zXZ\0" + bytes(30), x(pix)[:30] + bytes(20) + x(pix)[50:]):
        held_to_jax(_write(tmp_path, "l.tif", tiff_ifd(gray_entries(64, 40, len(stream), 34925), data=stream)))


# -- CCITT --------------------------------------------------------------------------------------

def _bilevel(kind: str, h: int, w: int, rng) -> np.ndarray:
    if kind == "noise":
        return rng.random((h, w)) < 0.5
    if kind == "blobs":
        return np.add.outer(np.sin(np.arange(h) / 3), np.cos(np.arange(w) / 5)) > 0.3
    if kind == "runs":  # long runs: make-up codes past 1728 (the extended ones)
        a = np.zeros((h, w), bool)
        for r in range(h):
            cuts = np.sort(rng.integers(0, w, 6))
            for i in range(0, 6, 2):
                a[r, cuts[i]:cuts[i + 1]] = True
        return a
    return np.full((h, w), kind == "black")


CCITT_SAVES = {"MH": dict(compression="tiff_ccitt"), "G3 1-D": dict(compression="group3"),
               "G3 2-D": dict(compression="group3", tiffinfo={292: 1}),
               "G3 1-D fill bits": dict(compression="group3", tiffinfo={292: 4}),
               "G3 2-D fill bits": dict(compression="group3", tiffinfo={292: 5}), "G4": dict(compression="group4"),
               "G4 fill order 2": dict(compression="group4", tiffinfo={266: 2}),
               "G3 2-D fill order 2": dict(compression="group3", tiffinfo={292: 1, 266: 2})}


def held_ccitt(path) -> np.ndarray | None:
    """``held_to_jax`` for CCITT files that may end early: where PIL keeps
    rows libtiff never wrote (its buffer's old contents), the port's rows
    from the first such row on are white — one value — and only the rows
    before it are compared."""
    try:
        ref = jax_load_image(str(path))
    except Exception:  # noqa: BLE001 — whatever PIL raises for a file it refuses
        with pytest.raises(ValueError):
            load_image(str(path))
        return None
    got = load_image(str(path))
    assert got.shape == ref.shape
    rows = [i for i in range(got.shape[0]) if not np.array_equal(got[i], ref[i])]
    if rows:
        tail = got[rows[0]:]
        assert (tail == tail.flat[0]).all(), rows[:5]
    return got


@pytest.mark.parametrize("save", list(CCITT_SAVES))
def test_ccitt_written_by_pil(tmp_path, save):
    """PIL's CCITT writer at sizes from 1×1 to 4 rows of 5,000 pixels (make-up
    codes to 2560), noise, blobs, long runs, all white, all black; and each
    file re-tagged white-is-zero (photometric 0)."""
    rng = np.random.default_rng(len(save))
    for (h, w), kind in ((((1, 1), "noise"), ((5, 7), "noise"), ((H, W), "blobs"), ((64, 128), "noise"),
                          ((3, 2700), "runs"), ((4, 5000), "runs"), ((9, 40), "white"), ((9, 40), "black"))):
        img = Image.fromarray(_bilevel(kind, h, w, rng).astype(np.uint8) * 255).convert("1")
        data = _pil(img, **CCITT_SAVES[save])
        assert held_to_jax(_write(tmp_path, "c.tif", data)) is not None, (h, w, kind)
        white_is_zero = data.replace(struct.pack("<HHIH", 262, 3, 1, 1), struct.pack("<HHIH", 262, 3, 1, 0), 1)
        assert white_is_zero != data
        assert held_to_jax(_write(tmp_path, "d.tif", white_is_zero)) is not None, (h, w, kind)


@pytest.mark.parametrize("save", ["MH", "G3 2-D", "G4"])
def test_ccitt_tiles(tmp_path, save):
    """Tiles of 16×16 and 32×16 pixels, each the strip PIL codes for that
    tile's pixels (edge tiles padded white), fill order 1 and 2."""
    rng = np.random.default_rng(7)
    img = _bilevel("blobs", 40, 50, rng) ^ (rng.random((40, 50)) < 0.05)
    code = {"MH": 2, "G3 2-D": 3, "G4": 4}[save]
    for th, tw in ((16, 16), (32, 16)):
        chunks = []
        for y in range(0, 40, th):
            for x in range(0, 50, tw):
                block = np.zeros((th, tw), bool)
                part = img[y:y + th, x:x + tw]
                block[:part.shape[0], :part.shape[1]] = part
                chunks.append(_strip(_pil(Image.fromarray(~block).convert("1"), **CCITT_SAVES[save])))
        tags = {256: (4, [50]), 257: (4, [40]), 258: (3, [1]), 259: (3, [code]), 262: (3, [0]), 277: (3, [1])}
        if save == "G3 2-D":
            tags[292] = (4, [1])
        with tempfile.TemporaryDirectory() as d:
            write_tiff_file(os.path.join(d, "t.tif"), tags, chunks, (th, tw), th, "<")
            with open(os.path.join(d, "t.tif"), "rb") as f:
                data = f.read()
        assert held_to_jax(_write(tmp_path, "t.tif", data)) is not None, (th, tw)


def _mh_bits(runs: list) -> str:
    """Modified Huffman codes of a row's runs (white first, ≤ 63 pixels each)."""
    from physically_based_renderer_tpu_torch.utils._ccitt import BLACK_TERM, WHITE_TERM

    return "".join((BLACK_TERM if i & 1 else WHITE_TERM)[r] for i, r in enumerate(runs))


def test_ccitt_rlew(tmp_path):
    """Compression 32771 (CCITT RLEW, PIL's "tiff_raw_16"): Modified Huffman
    rows each ending on a 16-bit word; rows padded to bytes or to words, the
    strip at even and odd offsets, white-is-zero and black-is-zero."""
    rows = [[16], [0, 16], [2, 5, 7, 2], [16], [3, 3, 3, 3, 3, 1]]
    for align, pad, photo in ((8, 0, 0), (16, 0, 0), (16, 1, 1), (8, 3, 1), (16, 2, 0)):
        bits = "".join(b + "0" * (-len(b) % align) for b in map(_mh_bits, rows))
        bits += "0" * (-len(bits) % 8)
        data = int(bits, 2).to_bytes(len(bits) // 8, "big")
        tags = {256: (3, [16]), 257: (3, [5]), 258: (3, [1]), 259: (3, [32771]), 262: (3, [photo]), 277: (3, [1]),
                273: (4, [8 + pad]), 278: (3, [5]), 279: (4, [len(data)])}
        held_to_jax(_write(tmp_path, "r.tif", tiff_ifd(tags, data=bytes(pad) + data)))
    tags[279] = (4, [len(data)])
    assert held_to_jax(_write(tmp_path, "s.tif", tiff_ifd(tags, data=bytes(pad) + data))) is not None


@pytest.mark.parametrize("save", ["MH", "G3 1-D", "G3 2-D", "G4"])
def test_ccitt_strips_that_end_early(tmp_path, save):
    """The strip cut at every byte: Modified Huffman fails short of its last
    row, as does a T.4 2-D row cut in the middle; T.4 ending at an EOL search
    and T.6 after its first row keep the rows they decoded (PIL's rows after
    them are its buffer's old memory: ``held_ccitt``). T.4 2-D strips that
    end at an EOL search in their first rows PIL refuses and the port keeps
    (not compared)."""
    rng = np.random.default_rng(3)
    img = Image.fromarray(_bilevel("blobs", 17, 23, rng).astype(np.uint8) * 255).convert("1")
    data = _pil(img, **CCITT_SAVES[save])
    strip = _strip(data)
    code = {"MH": 2, "G3 1-D": 3, "G3 2-D": 3, "G4": 4}[save]
    kept = 0
    for cut in range(1, len(strip) + 1):
        tags = {256: (4, [23]), 257: (4, [17]), 258: (3, [1]), 259: (3, [code]), 262: (3, [1]), 277: (3, [1])}
        if save == "G3 2-D":
            tags[292] = (4, [1])
        with tempfile.TemporaryDirectory() as d:
            write_tiff_file(os.path.join(d, "e.tif"), tags, [strip[:cut]], None, 17, "<")
            with open(os.path.join(d, "e.tif"), "rb") as f:
                path = _write(tmp_path, "e.tif", f.read())
        try:
            jax_load_image(path)
        except Exception:  # noqa: BLE001
            if save == "G3 2-D":
                continue
        kept += held_ccitt(path) is not None
    assert kept == {"MH": 1, "G3 1-D": 62, "G3 2-D": 32, "G4": 16}[save], kept  # MH: the whole strip only


# -- CIELab, ThunderScan, the codecs PIL refuses --------------------------------------------------

def test_lab_to_rgb_subsample():
    """``_lab.lab_to_rgb`` equals PIL's ``convert("RGB")`` of mode LAB on a
    seeded 2^18 of the 2^24 triples and every triple of the cube's edges
    (held equal over all 2^24 while the port was written)."""
    rng = np.random.default_rng(8)
    lab = rng.integers(0, 256, (1 << 18, 3)).astype(np.uint8)
    edges = np.array(np.meshgrid(*[[0, 1, 127, 128, 129, 254, 255]] * 3, indexing="ij")).reshape(3, -1).T
    lab = np.concatenate([lab, edges.astype(np.uint8)])
    pil = np.asarray(Image.frombytes("LAB", (len(lab), 1), (lab ^ np.uint8([0, 128, 128])).tobytes()).convert("RGB"))
    assert np.array_equal(_lab.lab_to_rgb(lab), pil[0])


@pytest.mark.parametrize("layout", ["PIL", "raw", "lzw, predictor 2", "deflate tiles", "raw planes", "lzw planes",
                                    "zstd tiled planes"])
def test_cielab_tiff(tmp_path, layout):
    """CIELab (photometric 8, 8 bits, a* and b* signed) in each layout PIL
    reads: contiguous (PIL's ``LAB`` unpacker flips a* and b*'s sign bits
    and sets the fourth byte), separate planes (its band unpackers copy them
    as stored and leave it 0); ``load_image`` asks for RGBA (the mode's
    name holds an "A")."""
    rng = np.random.default_rng(len(layout))
    lab = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    kw = {"raw": dict(compression=1), "lzw, predictor 2": dict(compression=5, predictor=2),
          "deflate tiles": dict(compression=8, tile=(16, 16)), "raw planes": dict(compression=1, planar=2),
          "lzw planes": dict(compression=5, planar=2),
          "zstd tiled planes": dict(compression=50000, planar=2, tile=(16, 16),
                                    codec=zstandard.ZstdCompressor().compress)}.get(layout)
    data = _pil(Image.frombytes("LAB", (W, H), lab.tobytes())) if kw is None else _written(lab, photometric=8, **kw)
    got = held_to_jax(_write(tmp_path, "lab.tif", data))
    assert got.shape == (H, W, 4)


@pytest.mark.parametrize("photometric,bits,extra", [(8, 16, ()), (9, 8, ()), (10, 8, ()), (8, 8, (0,)),
                                                    (8, 8, (2,))])
def test_cielab_kinds_pil_refuses(tmp_path, photometric, bits, extra):
    """16-bit CIELab, ICC Lab (9), ITU Lab (10) and CIELab with an extra
    sample: PIL has no mode for them, so ``ValueError``."""
    rng = np.random.default_rng(photometric + bits)
    lab = rng.integers(0, 256, (6, 7, 3 + len(extra))).astype(np.uint16 if bits == 16 else np.uint8)
    data = _written(lab * (257 if bits == 16 else 1), photometric=photometric, bits=bits, compression=1,
                    extra_samples=extra)
    path = _write(tmp_path, "r.tif", data)
    assert held_to_jax(path) is None
    with pytest.raises(ValueError, match="which PIL does not read either"):
        load_image(path)


def _thunder(rows: list, w: int, photo: int = 1) -> bytes:
    data = bytes(sum(rows, []))
    tags = {256: (3, [w]), 257: (3, [len(rows)]), 258: (3, [4]), 259: (3, [32809]), 262: (3, [photo]), 277: (3, [1]),
            273: (4, [8]), 278: (3, [len(rows)]), 279: (4, [len(data)])}
    return tiff_ifd(tags, data=data)


def test_thunderscan(tmp_path):
    """ThunderScan 4-bit rows built by hand — raw values, runs of the last
    value, 2- and 3-bit deltas with their skip codes, a run ending the row,
    a run past it, a row short of its pixels —, both photometrics; then
    random bytes, which libtiff mostly refuses."""
    cases = [[[0xC5, 0x45, 0x8F], [0x02, 0xC9, 0x47, 0x03]], [[0xC5, 0x05], [0xC3, 0x45, 0x01, 0xC2], [0x06]],
             [[0xC5, 0x04, 0xC1], [0x03, 0x03]], [[0xC0, 0x6A, 0xA4, 0x80 | 0o47, 0x01]], [[0xCF, 0x47, 0x7F]],
             [[0xC5, 0x07]], [[0xC1, 0xC2]], [[0x40 | 0b111111, 0x00, 0x03]]]
    for rows in cases:
        for photo in (0, 1):
            held_to_jax(_write(tmp_path, "t.tif", _thunder(rows, 6, photo)))
    assert held_to_jax(_write(tmp_path, "t.tif", _thunder(cases[0], 6))) is not None
    rng = np.random.default_rng(32809)
    decoded = 0
    for _ in range(150):
        w, h = int(rng.integers(1, 12)), int(rng.integers(1, 4))
        rows = [list(rng.integers(0, 256, int(rng.integers(1, 2 * w + 2)))) for _ in range(h)]
        decoded += held_to_jax(_write(tmp_path, "r.tif", _thunder(rows, w, int(rng.integers(0, 2))))) is not None
    assert decoded >= 10, decoded


@pytest.mark.parametrize("compression,photo,samples,bits", [
    (34676, 32844, 1, 16), (34676, 32845, 3, 16), (34677, 32845, 3, 8), (34676, 1, 1, 16), (50001, 2, 3, 8)])
def test_codecs_pil_refuses(tmp_path, compression, photo, samples, bits):
    """SGI LogL / LogLuv (PIL has no mode for photometric 32844 / 32845; on
    other photometrics libtiff's codec refuses) and WebP-in-TIFF (not built
    into libtiff here): ``ValueError``, as PIL refuses them."""
    data = bytes(64)
    if compression == 50001:
        buf = io.BytesIO()
        Image.fromarray(np.zeros((2, 6, 3), np.uint8)).save(buf, "WEBP", lossless=True)
        data = buf.getvalue()
    tags = {256: (3, [6]), 257: (3, [2]), 258: (3, [bits] * samples), 259: (3, [compression]), 262: (3, [photo]),
            277: (3, [samples]), 273: (4, [8]), 278: (3, [2]), 279: (4, [len(data)])}
    path = _write(tmp_path, "n.tif", tiff_ifd(tags, data=data))
    assert held_to_jax(path) is None
    if photo in (1, 2):
        with pytest.raises(ValueError, match="which PIL does not read either"):
            load_image(path)


# -- the committed fixtures ------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["page_color_1024_zstd.tif", "page_mask_1024_g4.tif", "page_mask_1024_g3.tif"])
def test_committed_fixtures_match_manifest(name):
    """``tests/data/make_tiff_codec_fixtures.py``'s files decode to PIL's
    digests; the Zstd page to the colour JPEG's samples, the G3 twin to the
    G4 mask's."""
    with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    img = load_image(os.path.join(FIXTURE_DIR, name))
    assert list(img.shape) == manifest[name]["shape"]
    assert hashlib.sha256(img.tobytes()).hexdigest() == manifest[name]["decoded_sha256"]
    twin = {"page_color_1024_zstd.tif": "page_color_1024.jpg", "page_mask_1024_g3.tif": "page_mask_1024_g4.tif"}
    if name in twin:
        assert manifest[name]["decoded_sha256"] == manifest[twin[name]]["decoded_sha256"]


# -- a seeded mutation fuzz of each codec --------------------------------------------------------

def _fuzz_bases() -> dict:
    rng = np.random.default_rng(99)
    photo = _seeded_photo(rng, 9, 40, 3)
    bilevel = Image.fromarray(_bilevel("blobs", 17, 23, rng).astype(np.uint8) * 255).convert("1")
    return {"lzma": _pil(Image.fromarray(photo), compression="lzma", tiffinfo={317: 2}),
            "zstd": _pil(Image.fromarray(photo), compression="zstd", tiffinfo={317: 2}),
            "zstd, level 19": _written(photo, compression=50000,
                                       codec=lambda r: zstandard.ZstdCompressor(level=19).compress(r)),
            "MH": _pil(bilevel, **CCITT_SAVES["MH"]), "G3 1-D": _pil(bilevel, **CCITT_SAVES["G3 1-D"]),
            "G3 2-D": _pil(bilevel, **CCITT_SAVES["G3 2-D"]), "G4": _pil(bilevel, **CCITT_SAVES["G4"])}


FUZZ_BASES = _fuzz_bases()
# mutants where the port knowingly differs: LZMA mutant 1 (three bits flipped near the end of the LZMA
# chunk) still fills the strip in liblzma before its chunk check fails; Python's lzma drops that call's
# output and the port's raw-chunk fallback stops two bytes short — the port refuses what PIL decodes
KNOWN_DIFFERENCES = {"lzma": {1}}


@pytest.mark.parametrize("codec", list(FUZZ_BASES))
def test_mutation_fuzz(tmp_path, codec):
    """60 seeded mutants of one strip (bits flipped, a byte zeroed, bytes
    inserted): the port decodes each as PIL does or refuses it as PIL does
    (CCITT under ``held_ccitt``; a T.4 2-D strip whose resynchronisation runs
    to the end in its first rows PIL refuses and the port keeps), but for
    the ``KNOWN_DIFFERENCES`` pinned here. Mutants the fuzz found while the
    codecs were written are fixed in the decoders: libzstd's fast
    four-stream Huffman loop (no check that a stream ends with its
    literals), liblzma's output before an error in the call that fills the
    strip, CCITT rows past a premature EOL or a bad code padded white."""
    data = FUZZ_BASES[codec]
    im = Image.open(io.BytesIO(data))
    offset, count = im.tag_v2[273][0], im.tag_v2[279][0]
    rng = np.random.default_rng(sum(codec.encode()))
    for index in range(60):
        strip = bytearray(data[offset:offset + count])
        op = rng.integers(3)
        if op == 0:
            for _ in range(int(rng.integers(1, 4))):
                strip[int(rng.integers(len(strip)))] ^= 1 << int(rng.integers(8))
        elif op == 1:
            strip[int(rng.integers(len(strip)))] = 0
        else:
            at = int(rng.integers(len(strip)))
            strip[at:at] = bytes(rng.integers(0, 256, int(rng.integers(1, 3))).astype(np.uint8))
        mutant = bytearray(data) + strip
        (at,) = struct.unpack_from("<I", mutant, 4)
        (n,) = struct.unpack_from("<H", mutant, at)
        for k in range(n):
            tag, typ, _ = struct.unpack_from("<HHI", mutant, at + 2 + 12 * k)
            if tag in (273, 279):
                struct.pack_into("<I" if typ == 4 else "<H", mutant, at + 10 + 12 * k,
                                 len(data) if tag == 273 else len(strip))
        path = _write(tmp_path, "m.tif", bytes(mutant))
        if index in KNOWN_DIFFERENCES.get(codec, ()):
            jax_load_image(path)
            with pytest.raises(ValueError):
                load_image(path)
            continue
        if codec in ("lzma", "zstd", "zstd, level 19"):
            held_to_jax(path)
            continue
        try:
            jax_load_image(path)
        except Exception:  # noqa: BLE001
            if codec == "G3 2-D":
                continue
        held_ccitt(path)
