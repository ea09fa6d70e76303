"""PyTorch port vs the JAX package: old-style JPEG TIFF (compression 6) in
``load_image`` (``utils/_ojpeg.py`` under ``utils/_tiff.py``).

Every file is decoded by the port and by the JAX package's ``load_image``
(PIL 12.1 with libtiff 4.7's ``tif_ojpeg.c`` and libjpeg-turbo) and the two
held equal bit for bit (``held_to_jax``), or both must refuse it (the port
with ``ValueError``). The files are written by
``chip_smoke.write_old_jpeg_tiff`` around JPEG streams PIL encodes, one a
strip or tile:

* the table layout (``JPEGQTables`` / ``JPEGDCTables`` / ``JPEGACTables``,
  each strip its entropy-coded data; libtiff inserts RSTn between strips),
  one, two and four strips, gray (photometric 1) and RGB (photometric 2,
  which libtiff takes as YCbCr); the interchange-format layout
  (``JPEGInterchangeFormat`` over a whole stream) at 1×1 under a 2×2 tag
  and with no tag; the split header (``JPEGInterchangeFormat`` over
  SOI…SOS, the strips the entropy-coded data) — each at a size on and off
  the MCU grid;
* what else libtiff reads: tiles (one column, and several, where libjpeg's
  frame is one column tall and the later tiles get its last rows), restart
  intervals from the tag and from a DRI in the header, data with RSTn
  more and less often than the interval, one stream's data cut across
  strips (libtiff's RSTn then fail the decode: PIL draws the strip from a
  zeroed buffer), strips swapped, short or empty, unshared table offsets,
  ``JPEGProc`` 14 (not read), the first component's sampling from the
  header's SOF (4×1, 4×2, 1×2) where the tag disagrees or is absent, a
  ``YCbCrSubsampling`` of one or three values (ignored, as by libtiff for
  JPEG-in-TIFF and YCbCr too), a stream taller than the image, big-endian files (where libtiff's post-decode
  step is the byte-swapper's and each strip after the first is read a strip
  late);
* separate planes: one JPEG stream a plane, found by its SOS in a
  three-scan stream, or not found in the table layout; one strip tagged
  separate, read as contiguous;
* files PIL refuses: sampling libjpeg would have to upsample (3×1, chroma
  not at 1×1), 4×4 (too many blocks an MCU), 1×4 (no RGBA routine), three
  samples of photometric 1, one sample of YCbCr, missing tables, a table
  past the end of the file, a progressive or lossless header, a stream
  narrower than the image, strips not a multiple of the MCU's height;

then 60 seeded mutants of the table layout's tags and strips, the committed
1024² fixtures against the manifest, and an ``obj_scene`` whose maps are
old-style JPEG TIFFs against the JAX package's.
"""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from chip_smoke import FIXTURE_DIR, jpeg_parts, write_old_jpeg_tiff
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu_torch import scenes
from physically_based_renderer_tpu_torch.utils.image_io import load_image
from test_torch_image_formats import _seeded_photo, _write, held_to_jax
from test_torch_image_gif_tiff import tiff_ifd
from test_torch_obj_loader import write_sphere_obj

SUBSAMPLING = {(1, 1): 0, (2, 1): 1, (2, 2): 2}  # YCbCrSubsampling → PIL's JPEG subsampling option
SIZES = ((64, 48), (37, 45))  # (height, width): on the 16-pixel MCU grid, and off it


def _jpeg(block: np.ndarray, sampling=(2, 2), **kw) -> bytes:
    buf = io.BytesIO()
    gray = block.shape[-1] == 1
    Image.fromarray(block[..., 0] if gray else block).save(
        buf, "JPEG", quality=85, **({} if gray else dict(subsampling=SUBSAMPLING[sampling])), **kw)
    return buf.getvalue()


def _strips(img: np.ndarray, rows: int, sampling=(2, 2), **kw) -> list:
    return [_jpeg(img[y:y + rows], sampling, **kw) for y in range(0, img.shape[0], rows)]


def _file(tmp_path, name: str, streams: list, width: int, height: int, **kw) -> str:
    path = str(tmp_path / name)
    write_old_jpeg_tiff(path, streams, width, height, **kw)
    return path


def _with_sampling(stream: bytes, factors: list) -> bytes:
    """A stream with its frame header's sampling factors replaced."""
    s = bytearray(stream)
    at = s.index(b"\xff\xc0")
    for c, hv in enumerate(factors):
        s[at + 11 + 3 * c] = hv
    return bytes(s)


def _tables_file(tmp_path, name: str, chunks: list, source: bytes, width: int, height: int, **kw) -> str:
    """The table layout with ``source``'s tables and ``chunks`` as the strips'
    entropy-coded data."""
    header = jpeg_parts(source)["header"]
    return _file(tmp_path, name, [header + c + b"\xff\xd9" for c in chunks], width, height, **kw)


# -- the layouts PIL reads ----------------------------------------------------------------------

def _motivation(img: np.ndarray, tmp_path, kind: str) -> str:
    h, w, _ = img.shape
    half = -(-h // 32) * 16  # two strips of a multiple of 16 rows
    return {
        "tables, one strip": lambda: _file(tmp_path, "t1.tif", _strips(img, h), w, h),
        "tables, two strips": lambda: _file(tmp_path, "t2.tif", _strips(img, half), w, h, rows_per_strip=half),
        "tables, four strips": lambda: _file(tmp_path, "t4.tif", _strips(img, 16), w, h, rows_per_strip=16),
        "tables, gray": lambda: _file(tmp_path, "g.tif", _strips(img[..., :1], 16), w, h, rows_per_strip=16,
                                      photometric=1),
        "split header": lambda: _file(tmp_path, "s.tif", _strips(img, 16), w, h, rows_per_strip=16, layout="split"),
        "interchange 1x1, tag 2x2": lambda: _file(tmp_path, "i.tif", [_jpeg(img, (1, 1))], w, h,
                                                  layout="interchange"),
        "interchange 1x1, no tag": lambda: _file(tmp_path, "n.tif", [_jpeg(img, (1, 1))], w, h,
                                                 layout="interchange", subsampling=None),
        "photometric RGB": lambda: _file(tmp_path, "r.tif", _strips(img, 16), w, h, rows_per_strip=16,
                                         photometric=2),
    }[kind]()


@pytest.mark.parametrize("kind", ["tables, one strip", "tables, two strips", "tables, four strips", "tables, gray",
                                  "split header", "interchange 1x1, tag 2x2", "interchange 1x1, no tag",
                                  "photometric RGB"])
def test_old_jpeg_layouts(tmp_path, kind):
    """Each layout PIL reads, on and off the MCU grid: the port's decode
    equals PIL's through libtiff bit for bit."""
    for h, w in SIZES:
        img = _seeded_photo(np.random.default_rng(h + len(kind)), h, w, 3)
        got = held_to_jax(_motivation(img, tmp_path, kind))
        assert got is not None and got.shape == (h, w, 1 if "gray" in kind else 3), (kind, h, w)


def test_tiles_and_restart_intervals(tmp_path):
    """Tiles (one column; two across, where libjpeg's frame is one column of
    tiles tall and the later tiles get its last iMCU row), a restart
    interval from the tag over data with RSTn as often, more often and less
    often (libjpeg then meets a marker out of place: the strip drawn from
    zeros), a DRI in the split header, big-endian."""
    rng = np.random.default_rng(5)
    img = _seeded_photo(rng, 64, 48, 3)
    pad = np.pad(img, ((0, 0), (0, 16), (0, 0)), mode="edge")
    cases = {
        "column": _file(tmp_path, "c.tif", [_jpeg(img[y:y + 32]) for y in (0, 32)], 48, 64, tile=(32, 48)),
        "two across": _file(tmp_path, "a.tif", [_jpeg(pad[y:y + 32, x:x + 32]) for y in (0, 32) for x in (0, 32)],
                            48, 64, tile=(32, 32)),
        "gray two across": _file(tmp_path, "ga.tif", [_jpeg(pad[y:y + 32, x:x + 32, :1]) for y in (0, 32)
                                                      for x in (0, 32)], 48, 64, tile=(32, 32), photometric=1),
        "big-endian": _file(tmp_path, "be.tif", _strips(img, 16), 48, 64, rows_per_strip=16, byteorder=">"),
        "big-endian gray": _file(tmp_path, "bg.tif", _strips(img[..., :1], 16), 48, 64, rows_per_strip=16,
                                 photometric=1, byteorder=">"),
        "split, DRI 3": _file(tmp_path, "d.tif", _strips(img, 16, restart_marker_blocks=3), 48, 64,
                              rows_per_strip=16, layout="split", restart_interval=3),
    }
    for every, interval in ((3, 3), (1, 3), (3, 2), (2, 5)):
        cases[f"RSTn every {every}, interval {interval}"] = _file(
            tmp_path, f"r{every}{interval}.tif", [_jpeg(img, restart_marker_blocks=every)], 48, 64,
            restart_interval=interval)
    for name, path in cases.items():
        assert held_to_jax(path) is not None, name


def test_damaged_strips_and_tables(tmp_path):
    """One stream's entropy-coded data cut across four strips (libtiff's
    RSTn between them land inside MCUs), strips swapped, the last short, one
    empty, the first short; tables at their own offsets, ``JPEGProc`` 14."""
    rng = np.random.default_rng(6)
    img = _seeded_photo(rng, 64, 48, 3)
    one = _jpeg(img)
    data = jpeg_parts(one)["data"]
    cuts = [0, len(data) // 4, len(data) // 2, 3 * len(data) // 4, len(data)]
    own = [jpeg_parts(s)["data"] for s in _strips(img, 16)]
    kw = dict(width=48, height=64, rows_per_strip=16)
    cases = {
        "one stream cut in four": [data[cuts[i]:cuts[i + 1]] for i in range(4)],
        "swapped": [own[1], own[0], own[2], own[3]],
        "last short": own[:3] + [own[3][:20]],
        "one empty": [own[0], b"", own[2], own[3]],
        "first short": [own[0][:25]] + own[1:],
    }
    for name, chunks in cases.items():
        assert held_to_jax(_tables_file(tmp_path, "d.tif", chunks, one, **kw)) is not None, name
    path = _file(tmp_path, "p.tif", _strips(img, 16), 48, 64, rows_per_strip=16, extra={512: (3, [14])})
    assert held_to_jax(path) is not None
    parts, blob, offsets = jpeg_parts(one), b"", {}
    for key, table in (("q", parts["dqt"][0]), ("qc", parts["dqt"][1]), ("dc", parts["dht"][(0, 0)]),
                       ("dcc", parts["dht"][(0, 1)]), ("ac", parts["dht"][(1, 0)]), ("acc", parts["dht"][(1, 1)])):
        for copy in range(2):  # each chroma component its own copy of the table
            offsets[key, copy] = 8 + len(blob)
            blob += table + bytes(len(table) & 1)
    tags = {256: (4, [48]), 257: (4, [64]), 258: (3, [8, 8, 8]), 259: (3, [6]), 262: (3, [6]), 277: (3, [3]),
            278: (4, [64]), 530: (3, [2, 2]), 273: (4, [8 + len(blob)]), 279: (4, [len(data)]),
            519: (4, [offsets["q", 0], offsets["qc", 0], offsets["qc", 1]]),
            520: (4, [offsets["dc", 0], offsets["dcc", 0], offsets["dcc", 1]]),
            521: (4, [offsets["ac", 0], offsets["acc", 0], offsets["acc", 1]])}
    assert held_to_jax(_write(tmp_path, "u.tif", tiff_ifd(tags, data=blob + data))) is not None


@pytest.mark.parametrize("factors, tag", [([0x41, 0x11, 0x11], (2, 2)), ([0x41, 0x11, 0x11], None),
                                          ([0x42, 0x11, 0x11], (1, 1)), ([0x12, 0x11, 0x11], None),
                                          ([0x22, 0x11, 0x11], (2, 1))])
def test_sampling_from_the_frame_header(tmp_path, factors, tag):
    """The first component's sampling in the interchange-format stream's SOF
    wins over the tag (or its 2×2 default): 4×1, 4×2, 1×2 and 2×2 decoded
    as libtiff lays them out (the data PIL's 4:2:0 encoder wrote, read at the
    header's sampling)."""
    img = _seeded_photo(np.random.default_rng(7), 32, 48, 3)
    stream = _with_sampling(_jpeg(img), factors)
    path = _file(tmp_path, "f.tif", [stream], 48, 32, layout="interchange", subsampling=tag)
    assert held_to_jax(path) is not None


def test_subsampling_tag_of_another_count(tmp_path):
    """libtiff reads ``YCbCrSubsampling`` only as two values and ignores the
    tag at another count (the 2×2 default, or for JPEG-in-TIFF the first
    strip's frame header): old-style JPEG, JPEG-in-TIFF and LZW YCbCr."""
    from test_torch_image_tiff_jpeg_ico import jpeg_tiff, ycbcr_tiff

    rng = np.random.default_rng(14)
    img = _seeded_photo(rng, 32, 48, 3)
    for values in ([1], [2], [1, 1, 1], [4]):
        path = _file(tmp_path, "o.tif", _strips(img, 16, (1, 1)), 48, 32, rows_per_strip=16,
                     extra={530: (3, values)})
        assert held_to_jax(path) is not None, values
    for name, data in (("jpeg", open(jpeg_tiff(str(tmp_path / "j.tif"), img), "rb").read()),
                       ("ycbcr", ycbcr_tiff(rng, 16, 16, 2, 2, 5))):
        data = bytearray(data)
        struct.pack_into("<I", data, data.index(struct.pack("<HHI", 530, 3, 2)) + 4, 1)  # one value
        assert held_to_jax(_write(tmp_path, f"{name}.tif", bytes(data))) is not None, name


def test_stream_of_another_size(tmp_path):
    """An interchange-format stream taller than the image (libtiff reads the
    rows it needs), and one shorter, which libtiff refuses."""
    img = _seeded_photo(np.random.default_rng(8), 48, 40, 3)
    assert held_to_jax(_file(tmp_path, "t.tif", [_jpeg(img)], 40, 37, layout="interchange")) is not None
    assert held_to_jax(_file(tmp_path, "s.tif", [_jpeg(img[:32])], 40, 37, layout="interchange")) is None


def _three_scans(img: np.ndarray) -> bytes:
    """A sequential JPEG of three scans, one a component (1×1, shared tables),
    each scan the entropy-coded data PIL writes for that plane alone."""
    h, w, _ = img.shape
    planes = [jpeg_parts(_jpeg(img[..., c:c + 1])) for c in range(3)]

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    first = planes[0]
    stream = (b"\xff\xd8" + seg(0xDB, b"\x00" + first["dqt"][0]) + seg(0xC4, b"\x00" + first["dht"][(0, 0)])
              + seg(0xC4, b"\x10" + first["dht"][(1, 0)])
              + seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x11, 0, 2, 0x11, 0, 3, 0x11, 0])))
    for c, p in enumerate(planes):
        stream += seg(0xDA, bytes([1, c + 1, 0, 0, 63, 0])) + p["data"]
    return stream + b"\xff\xd9"


def test_separate_planes(tmp_path):
    """Three samples in separate planes (YCbCr 1×1, libtiff's one separate
    RGBA case): one stream a plane, its SOS searched for after the plane
    before's — found in a three-scan interchange-format stream; not found in
    the table layout, which leaves Cb and Cr zero and the luma session's data
    gone after its first strip (PIL refuses three strips a plane); one strip
    and one byte count tagged separate, which libtiff reads as contiguous."""
    img = _seeded_photo(np.random.default_rng(13), 32, 48, 3)
    separate = {284: (3, [2])}
    planes = {284: (3, [2]), 258: (3, [8, 8, 8]), 277: (3, [3]), 530: (3, [1, 1])}  # three samples of one-plane streams
    scans = _three_scans(img)
    at = [scans.index(jpeg_parts(_jpeg(img[..., c:c + 1]))["data"]) for c in range(3)]
    cases = {
        "three scans": (tiff_ifd({256: (4, [48]), 257: (4, [32]), 258: (3, [8, 8, 8]), 259: (3, [6]), 262: (3, [6]),
                                  277: (3, [3]), 278: (4, [32]), 284: (3, [2]), 513: (4, [8]), 514: (4, [len(scans)]),
                                  530: (3, [1, 1]), 273: (4, [8 + a for a in at]),
                                  279: (4, [at[1] - at[0], at[2] - at[1], len(scans) - at[2]])}, data=scans), True),
        "table layout, two strips a plane": (_file(tmp_path, "a.tif", [
            _jpeg(img[y:y + 16, :, c:c + 1]) for c in range(3) for y in (0, 16)], 48, 32, rows_per_strip=16,
            extra=planes), True),
        "table layout, four strips a plane": (_file(tmp_path, "b.tif", [
            _jpeg(img[y:y + 8, :, c:c + 1]) for c in range(3) for y in range(0, 32, 8)], 48, 32, rows_per_strip=8,
            extra=planes), False),
        "one strip": (_file(tmp_path, "c.tif", [_jpeg(img)], 48, 32, extra=separate), True),
    }
    for name, (path, read) in cases.items():
        if isinstance(path, bytes):
            path = _write(tmp_path, "s.tif", path)
        assert (held_to_jax(path) is not None) == read, name


def test_files_pil_refuses(tmp_path):
    """Each file PIL refuses, the port refuses with ``ValueError``."""
    rng = np.random.default_rng(9)
    img = _seeded_photo(rng, 32, 48, 3)
    one, strips = _jpeg(img), _strips(img, 16)
    parts = jpeg_parts(one)
    header = bytearray(parts["header"])
    progressive = _jpeg(img, progressive=True)
    refused = {
        "3x1 (libjpeg would upsample)": _file(tmp_path, "a.tif", [_with_sampling(one, [0x31, 0x11, 0x11])], 48, 32,
                                              layout="interchange"),
        "chroma 2x1": _file(tmp_path, "b.tif", [_with_sampling(one, [0x22, 0x21, 0x11])], 48, 32,
                            layout="interchange"),
        "4x4": _file(tmp_path, "c.tif", [_with_sampling(one, [0x44, 0x11, 0x11])], 48, 32, layout="interchange"),
        "1x4": _file(tmp_path, "d.tif", [_with_sampling(one, [0x14, 0x11, 0x11])], 48, 32, layout="interchange"),
        "three samples of photometric 1": _file(tmp_path, "e.tif", [one], 48, 32, layout="interchange",
                                                photometric=1),
        "one sample of YCbCr": _file(tmp_path, "f.tif", _strips(img[..., :1], 16), 48, 32, rows_per_strip=16,
                                     photometric=6),
        "progressive header": _file(tmp_path, "g.tif", [progressive], 48, 32, layout="interchange"),
        "narrower stream": _file(tmp_path, "h.tif", [_jpeg(img[:, :40])], 48, 32, layout="interchange"),
        "strips of 8 rows at 2x2": _file(tmp_path, "i.tif", _strips(img, 8), 48, 32, rows_per_strip=8),
    }
    path = _file(tmp_path, "j.tif", strips, 48, 32, rows_per_strip=16)
    data = bytearray(open(path, "rb").read())
    for tag, name in ((519, "no JPEGQTables"), (520, "no JPEGDCTables")):
        i = data.index(struct.pack("<HHI", tag, 4, 3))
        refused[name] = _write(tmp_path, f"{tag}.tif", bytes(data[:i]) + struct.pack("<H", 700) + bytes(data[i + 2:]))
    i = data.index(struct.pack("<HHI", 521, 4, 3))
    past = bytearray(data)
    struct.pack_into("<3I", past, struct.unpack_from("<I", data, i + 8)[0], *[len(data) + 100] * 3)
    refused["tables past the end of the file"] = _write(tmp_path, "k.tif", bytes(past))
    sof = header.index(b"\xff\xc0")
    header[sof + 1] = 0xC3  # a lossless frame header: libjpeg refuses libtiff's scan header for it
    refused["lossless header"] = _file(tmp_path, "l.tif", [bytes(header) + parts["data"] + b"\xff\xd9"], 48, 32,
                                       layout="interchange")
    for name, path in refused.items():
        assert held_to_jax(path) is None, name


# -- a seeded mutation fuzz ---------------------------------------------------------------------

def test_mutation_fuzz(tmp_path):
    """60 seeded mutants of the table layout (37×40, three strips): a table
    offset moved, a strip's offset or byte count changed, the sampling tag,
    the restart interval or the rows a strip changed, the tables made one,
    strips swapped, or bits flipped in the tables and strips; the port
    decodes each as PIL does or refuses it as PIL does."""
    img = _seeded_photo(np.random.default_rng(10), 40, 37, 3)
    path = _file(tmp_path, "base.tif", _strips(img, 16), 37, 40, rows_per_strip=16)
    data = open(path, "rb").read()
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    base = {}
    for k in range(n):
        tag, typ, count = struct.unpack_from("<HHI", data, ifd + 2 + 12 * k)
        at = ifd + 10 + 12 * k
        if count * {3: 2, 4: 4}[typ] > 4:
            (at,) = struct.unpack_from("<I", data, at)
        base[tag] = (typ, list(struct.unpack_from(f"<{count}{'H' if typ == 3 else 'I'}", data, at)))
    rng = np.random.default_rng(11)
    decoded = 0
    for index in range(60):
        tags = {k: (t, list(v)) for k, (t, v) in base.items()}
        blob = bytearray(data[8:ifd])
        op = int(rng.integers(6))
        if op == 0:
            for _ in range(int(rng.integers(1, 4))):
                blob[int(rng.integers(len(blob)))] ^= 1 << int(rng.integers(8))
        elif op == 1:
            k = int(rng.choice([519, 520, 521]))
            j = int(rng.integers(3))
            tags[k][1][j] = max(0, tags[k][1][j] + int(rng.integers(-70, 70)))
        elif op == 2:
            k = int(rng.choice([273, 279]))
            j = int(rng.integers(len(tags[k][1])))
            tags[k][1][j] = max(0, tags[k][1][j] + int(rng.integers(-40, 40)))
        elif op == 3:
            k = int(rng.choice([530, 515, 278]))
            tags[k] = {530: (3, [int(x) for x in rng.choice([1, 2, 4], 2)]), 515: (3, [int(rng.integers(0, 12))]),
                       278: (4, [int(rng.choice([8, 16, 24, 32, 40, 7]))])}[k]
        elif op == 4:
            k = int(rng.choice([519, 520, 521]))
            tags[k] = (4, [tags[k][1][0]] * 3 if rng.integers(2) else tags[k][1][:1])
        else:
            i, j = (int(x) for x in rng.choice(3, 2, replace=False))
            for k in (273, 279):
                tags[k][1][i], tags[k][1][j] = tags[k][1][j], tags[k][1][i]
        decoded += held_to_jax(_write(tmp_path, "m.tif", tiff_ifd(tags, data=bytes(blob)))) is not None
    assert decoded >= 30, decoded


# -- the fixtures and the slice as a whole -------------------------------------------------------

@pytest.mark.parametrize("name", ["page_color_1024_old_jpeg.tif", "page_gray_1024_old_jpeg.tif"])
def test_fixture_matches_manifest(name):
    """The committed 1024² pages (``tests/data/make_old_jpeg_fixtures.py``:
    the table layout, 16 strips, the restart interval of one): the port's
    decode has PIL's digest."""
    entry = json.load(open(os.path.join(FIXTURE_DIR, "manifest.json")))[name]
    path = os.path.join(FIXTURE_DIR, name)
    got = load_image(path)
    assert list(got.shape) == entry["shape"] and os.path.getsize(path) == entry["bytes"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["decoded_sha256"]


def test_obj_scene_pages_from_old_jpeg_tiff(tmp_path):
    """An MTL whose diffuse map is an old-style JPEG TIFF in the table layout
    (three strips) and whose roughness map one in gray: the asset cache's
    pages and the atlas equal the JAX package's ``obj_scene``'s."""
    path = write_sphere_obj(tmp_path, textured=False)
    rng = np.random.default_rng(12)
    (tmp_path / "maps").mkdir()
    maps = tmp_path / "maps"
    albedo, rough = _seeded_photo(rng, 40, 40, 3), _seeded_photo(rng, 40, 40, 1)
    write_old_jpeg_tiff(str(maps / "albedo.tif"), _strips(albedo, 16), 40, 40, rows_per_strip=16)
    write_old_jpeg_tiff(str(maps / "rough.tif"), _strips(rough, 16), 40, 40, rows_per_strip=16, photometric=1)
    (tmp_path / "sphere.mtl").write_text(
        "newmtl painted\nKd 1 1 1\nNs 128\nPm 0.25\nmap_Kd maps/albedo.tif\nmap_Pr maps/rough.tif\n"
        "newmtl plain\nKd 0.2 0.6 0.9\nNs 32\n")
    jcache = jscenes.AssetCache(asset_root=str(tmp_path), texture_size=32)
    cache = scenes.AssetCache(asset_root=str(tmp_path), texture_size=32)
    jscene = jscenes.obj_scene(path, assets=jcache, texture_size=32, prefer_native=False)
    scene = scenes.obj_scene(path, assets=cache, texture_size=32, device="cpu")
    assert len(cache.pages) == len(jcache.pages) == 2 and cache.srgb == jcache.srgb
    for got, ref in zip(cache.pages, jcache.pages):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    for a, b in zip(scene.atlas.mips, jscene.atlas.mips):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("has_tex", "tex_index"):
        np.testing.assert_array_equal(getattr(scene.materials, f).numpy(), np.asarray(getattr(jscene.materials, f)))
