"""PyTorch port vs the JAX package: the JPEG kinds past baseline and
progressive Huffman — arithmetic-coded sequential (SOF9) and progressive
(SOF10), lossless (SOF3), progressive files that libjpeg block-smooths or
whose scans come out of order — through ``utils/image_io.load_image``.

PIL writes none of these, so ``tests/jpeg_encoders.py`` does: an arithmetic
coder after libjpeg's ``jcarith.c`` (its own copy of T.81 Table D.2)
re-codes the coefficients of files PIL writes, with DAC conditioning,
restart intervals and scan scripts; a lossless coder writes predictors 1-7,
point transforms, restarts, interleaved and one-component scans; a scan
editor drops, reorders and repeats the scans of PIL's progressive files.
Every file is decoded by the port and by the JAX package's ``load_image``
(PIL 12.1 on libjpeg-turbo 3.1 here) and the two held with
``np.array_equal``; where PIL refuses a file the port raises ``ValueError``.
PIL's decode is the oracle, so an encoder slip shows as a disagreement or a
refusal, never as a pass.

Also pinned: libjpeg-turbo's colour rules (JFIF, Adobe, component ids; a
lossless frame stored as YCbCr is refused), its SIMD IDCT on coefficients
out of range, PIL's 64 KB reads that no arithmetic scan may outrun, SOF11
(which libjpeg-turbo refuses), the committed fixtures' digests, the same
streams inside a TIFF, and seeded mutants of each kind.
"""

import functools
import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

import jpeg_encoders as enc
from physically_based_renderer_tpu_torch.utils.image_io import load_image
from test_torch_image_formats import _seeded_photo, _write, held_to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def _pil_jpeg(a: np.ndarray, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a[..., 0] if a.shape[-1] == 1 else a, "CMYK" if a.shape[-1] == 4 else None).save(
        buf, "JPEG", **opts)
    return buf.getvalue()


def _photo(seed: int, h: int, w: int, c: int) -> np.ndarray:
    return _seeded_photo(np.random.default_rng(seed), h, w, c)


def _adobe(data: bytes, transform: int) -> bytes:
    """``data`` with its Adobe segment's transform set (PIL writes CMYK with
    transform 0)."""
    d = bytearray(data)
    i = d.index(b"Adobe")
    d[i + 11] = transform
    return bytes(d)


def _mode_file(mode: str, seed: int, h: int = 29, w: int = 35, **opts) -> bytes:
    """A Huffman-coded file PIL writes in ``mode``: gray, 4:4:4 / 4:2:2 /
    4:2:0 YCbCr, CMYK (Adobe transform 0) or YCCK (transform 2)."""
    c = {"gray": 1, "cmyk": 4, "ycck": 4}.get(mode, 3)
    sub = dict(subsampling=SUBSAMPLING[mode]) if mode in SUBSAMPLING else {}
    data = _pil_jpeg(_photo(seed, h, w, c), quality=85, **sub, **opts)
    return _adobe(data, 2) if mode == "ycck" else data


# -- SOF9: arithmetic-coded sequential ----------------------------------------------------------

DAC = {("DC", 0): (2, 5), ("AC", 0): 20, ("DC", 1): (0, 0), ("AC", 1): 1}


@pytest.mark.parametrize("restart", [0, 1, 7])
@pytest.mark.parametrize("mode", ["gray", "444", "422", "420", "cmyk", "ycck"])
def test_sof9_matches_jax(tmp_path, mode, restart):
    """PIL's file re-coded arithmetically at 29×35 (off the MCU grid) with
    default and non-default DAC conditioning, and without restarts at 8×8
    (one MCU): equal to the JAX package's decode and to the Huffman file's."""
    for (h, w), dacs in (((29, 35), (None, DAC)), ((8, 8), (DAC,)))[:1 if restart else 2]:
        base = _mode_file(mode, 31 + restart, h, w)
        twin = held_to_jax(_write(tmp_path, "b.jpg", base))
        for dac in dacs:
            data = enc.transcode_to_arith(base, restart=restart, dac=dac)
            assert data[data.index(b"\xff\xc9") + 1] == 0xC9
            got = held_to_jax(_write(tmp_path, "a.jpg", data))
            assert np.array_equal(got, twin), (h, w, dac)


@pytest.mark.parametrize("restart", [0, 3])
def test_sof9_bad_arithmetic_code(tmp_path, restart):
    """A zero run past the block (libjpeg's "bad arithmetic code"): the rest
    of its restart interval stays zero, as in PIL's decode."""
    base = _mode_file("420", 5)
    width, height, comps, qt, adobe, jfif = enc.read_coefficients(base)
    data = enc.write_arith(width, height, comps, qt, restart=restart, overflow={(0, 14)}, jfif=jfif)
    got = held_to_jax(_write(tmp_path, "c.jpg", data))
    assert not np.array_equal(got, held_to_jax(_write(tmp_path, "b.jpg", base)))


# -- SOF10: arithmetic-coded progressive ------------------------------------------------------

SA_SCRIPT = [((0, 1, 2), 0, 0, 0, 2), ((0,), 1, 9, 0, 3), ((0,), 10, 63, 0, 2), ((1,), 1, 63, 0, 1),
             ((2,), 1, 63, 0, 1), ((0, 1, 2), 0, 0, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((0,), 1, 9, 3, 2),
             ((0,), 1, 63, 2, 1), ((0,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0), ((2,), 1, 63, 1, 0)]
GRAY_SA_SCRIPT = [((0,), 0, 0, 0, 2), ((0,), 1, 9, 0, 3), ((0,), 10, 63, 0, 2), ((0,), 0, 0, 2, 1),
                  ((0,), 0, 0, 1, 0), ((0,), 1, 9, 3, 2), ((0,), 1, 63, 2, 1), ((0,), 1, 63, 1, 0)]


@pytest.mark.parametrize("script", ["simple", "successive approximation"])
@pytest.mark.parametrize("mode", ["gray", "420", "444", "cmyk"])
def test_sof10_matches_jax(tmp_path, mode, script):
    """PIL's progressive file re-coded arithmetically with its own scans
    (libjpeg's simple progression) or a deeper successive-approximation
    script with a restart every 2 MCUs: equal to the Huffman twin."""
    base = _mode_file(mode, 41, progressive=script == "simple")
    twin = held_to_jax(_write(tmp_path, "b.jpg", base))
    if script == "simple":
        kw = dict(progressive=True)
    elif mode == "gray":
        kw = dict(progressive=True, script=GRAY_SA_SCRIPT)
    elif mode == "cmyk":  # the DC scans take K too; its AC comes whole in one scan
        steps = [((0, 1, 2, 3) if s == (0, 1, 2) else s, *rest) for s, *rest in SA_SCRIPT]
        kw = dict(progressive=True, script=steps[:5] + [((3,), 1, 63, 0, 0)] + steps[5:])
    else:
        kw = dict(progressive=True, script=SA_SCRIPT)
    restart = 0 if script == "simple" else 2
    got = held_to_jax(_write(tmp_path, "p.jpg", enc.transcode_to_arith(base, restart=restart, **kw)))
    assert np.array_equal(got, twin)


# -- scans out of order (libjpeg's JWRN_BOGUS_PROGRESSION) ---------------------------------------

def _bogus(units: list, kind: str) -> list:
    return {"AC before DC": [units[1], units[0]] + units[2:],
            "refine whose Ah does not match": [units[0], units[-1]] + units[1:-1],
            "refine sent twice": units + [units[-1]],
            "DC sent twice": [units[0], units[0]] + units[1:],
            "first AC sent twice": [units[0], units[1], units[1]] + units[2:],
            "reversed": units[::-1]}[kind]


@pytest.mark.parametrize("coding", ["Huffman", "arithmetic"])
@pytest.mark.parametrize("kind", ["AC before DC", "refine whose Ah does not match", "refine sent twice",
                                  "DC sent twice", "first AC sent twice", "reversed"])
def test_out_of_order_scans(tmp_path, kind, coding):
    """libjpeg warns and decodes each scan as its header says, each
    coefficient's precision becoming the scan's Al; PIL decodes these, the
    port equals it (gray Huffman and 4:2:0 arithmetic files)."""
    base = _mode_file("gray" if coding == "Huffman" else "420", 51, progressive=True)
    if coding == "arithmetic":
        base = enc.transcode_to_arith(base, progressive=True)
    head, units, tail = enc.split_scans(base)
    assert held_to_jax(_write(tmp_path, "o.jpg", enc.join_scans(head, _bogus(units, kind), tail))) is not None


# -- block smoothing of an incomplete progressive file ----------------------------------------

@pytest.mark.parametrize("keep", range(1, 10))
@pytest.mark.parametrize("mode", ["420", "gray"])
def test_smoothing_of_dropped_scans(tmp_path, mode, keep):
    """PIL's progressive file with its trailing scans dropped (libjpeg's
    simple progression: 10 scans in colour, 6 in gray): libjpeg-turbo 3.1's
    5×5 block smoothing, where only DC has come the DC estimate too; at
    64×48 and at 17×13 or 24×20, whose last iMCU row of a 2×2 component is
    short (libjpeg-turbo's row indices there)."""
    for h, w in ((48, 64), (13, 17) if keep % 2 else (20, 24)):
        head, units, tail = enc.split_scans(_mode_file(mode, 61 + keep, h, w, progressive=True))
        if keep < len(units):
            got = held_to_jax(_write(tmp_path, "s.jpg", enc.join_scans(head, units[:keep], tail)))
            assert got is not None


@pytest.mark.parametrize("keep", [2, 6, 9])
def test_smoothing_of_arithmetic_successive_approximation(tmp_path, keep):
    """The successive-approximation script cut short, arithmetic-coded: the
    estimates clamped to the bits still unknown."""
    base = _mode_file("444", 71)
    got = held_to_jax(_write(tmp_path, "s.jpg", enc.transcode_to_arith(base, progressive=True,
                                                                        script=SA_SCRIPT[:keep])))
    assert got is not None


# -- SOF3: lossless ---------------------------------------------------------------------------

@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("psv", range(1, 8))
def test_sof3_gray_predictors(tmp_path, psv, pt):
    """Every predictor, point transform 0 and 2, restarts off and every row
    or every 4 rows, at 23×31 and 1×9."""
    for h, w in ((23, 31), (1, 9)):
        g = _photo(psv + 10 * pt, h, w, 1)[..., 0]
        for rows in (0, 1 + 3 * (psv % 2)):
            assert held_to_jax(_write(tmp_path, "l.jpg", enc.write_lossless([g], [(1, 1)], psv, pt, rows))) is not None


LOSSLESS_COLOUR = {  # (component ids, JFIF, Adobe transform): no marker means RGB in a lossless frame
    "RGB ids": ((82, 71, 66), False, None),
    "YCbCr ids": ((1, 2, 3), False, None),
    "other ids": ((5, 6, 7), False, None),
    "Adobe RGB": ((1, 2, 3), False, 0),
    "JFIF: YCbCr (refused)": ((1, 2, 3), True, None),
    "Adobe YCbCr (refused)": ((82, 71, 66), False, 1),
    "Adobe unknown (refused)": ((1, 2, 3), False, 2),
}


@pytest.mark.parametrize("name", list(LOSSLESS_COLOUR))
def test_sof3_colour_rules(tmp_path, name):
    ids, jfif, adobe = LOSSLESS_COLOUR[name]
    c = _photo(3, 21, 18, 3)
    data = enc.write_lossless([c[..., i] for i in range(3)], [(1, 1)] * 3, 4, 1, 2, ids=ids, jfif=jfif, adobe=adobe)
    got = held_to_jax(_write(tmp_path, "c.jpg", data))
    assert (got is None) == name.endswith("(refused)")


@pytest.mark.parametrize("layout", ["420", "422", "411", "420 restarts", "one scan a component",
                                    "one scan a component, 420", "cmyk", "ycck (refused)", "gray 2x2 sampled"])
def test_sof3_sampling_and_scans(tmp_path, layout):
    """Subsampled components (replicated, not fancy-upsampled: a lossless
    frame has no context rows), MCUs of several samples, a restart each row,
    one scan a component, four components."""
    c = _photo(4, 21, 18, 4)
    y, sub = c[..., 0], {"420": (2, 2), "422": (2, 1), "411": (4, 1)}
    if layout == "cmyk" or layout.startswith("ycck"):
        data = enc.write_lossless([c[..., i] for i in range(4)], [(1, 1)] * 4, 5, 0, 0,
                                  adobe=2 if layout.startswith("ycck") else 0)
    elif layout == "gray 2x2 sampled":
        data = enc.write_lossless([y], [(2, 2)], 6, 0, 1)
    elif layout == "one scan a component":
        data = enc.write_lossless([c[..., i] for i in range(3)], [(1, 1)] * 3, 6, 1, 0, interleaved=False)
    else:
        h, v = sub[next(k for k in sub if k in layout)]
        planes = [y, c[::v, ::h, 1], c[::v, ::h, 2]]
        data = enc.write_lossless(planes, [(h, v), (1, 1), (1, 1)], 7, 0, 1 if "restarts" in layout else 0,
                                  width=18, height=21, interleaved="one scan" not in layout)
    got = held_to_jax(_write(tmp_path, "s.jpg", data))
    assert (got is None) == layout.endswith("(refused)")


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    d = bytearray(data)
    d[d.index(marker) + offset] = value
    return bytes(d)


def _lossless_variant(kind: str) -> bytes:
    g = _photo(8, 12, 10, 1)[..., 0]
    base = enc.write_lossless([g], [(1, 1)], 1, 0, 1)
    if kind == "category 16 and wrap-around":
        d = np.zeros((4, 5), np.int64)
        d[0, 0], d[1, 2], d[2, 3], d[3, 4] = 32768, -32767, 200, 300
        return enc.write_lossless([np.zeros((4, 5), np.uint8)], [(1, 1)], 5, 0, 0, diffs=[d])
    if kind == "restart not whole rows":
        return _patched(base, b"\xff\xdd", 5, 7)
    sos = base.index(b"\xff\xda") + 7  # Ss, Se, Ah/Al of a one-component scan
    offset, value = {"predictor 0": (0, 0), "Se 1": (1, 1), "Ah 1": (2, 0x10), "Pt 8": (2, 8)}[kind]
    d = bytearray(base)
    d[sos + offset] = value
    return bytes(d)


@pytest.mark.parametrize("kind", ["category 16 and wrap-around", "restart not whole rows", "predictor 0", "Se 1",
                                  "Ah 1", "Pt 8"])
def test_sof3_edges_and_refusals(tmp_path, kind):
    """Differences of 32768 and samples wrapping modulo 2^16 (kept to their
    low 8 bits); the scan parameters and restart intervals libjpeg refuses."""
    got = held_to_jax(_write(tmp_path, "e.jpg", _lossless_variant(kind)))
    assert (got is None) == (kind != "category 16 and wrap-around")


def test_sof11_refused_by_both(tmp_path):
    """SOF11 (arithmetic-coded lossless): libjpeg-turbo 3.1 bundled with PIL
    has no lossless arithmetic decoder, so PIL refuses it; so does the port."""
    data = _patched(enc.write_lossless([_photo(9, 8, 8, 1)[..., 0]], [(1, 1)], 1), b"\xff\xc3", 1, 0xCB)
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError, match="SOF11.*does not read either"):
        load_image(_write(tmp_path, "x.jpg", data))


# -- colour rules and the IDCT of lossy frames ------------------------------------------------

def _without_jfif(data: bytes) -> bytes:
    i = data.index(b"\xff\xe0")
    return data[:i] + data[i + 2 + int.from_bytes(data[i + 2:i + 4], "big"):]


def _with_ids(data: bytes, ids: tuple) -> bytes:
    d = bytearray(data)
    sof = d.index(b"\xff\xc0")
    for k, v in enumerate(ids):
        d[sof + 10 + 3 * k] = v
    sos = d.index(b"\xff\xda")
    for k in range(d[sos + 4]):
        d[sos + 5 + 2 * k] = ids[d[sos + 5 + 2 * k] - 1]
    return bytes(d)


@pytest.mark.parametrize("case", ["no JFIF, ids 1 2 3", "no JFIF, ids R G B", "no JFIF, ids 5 6 7", "JFIF, ids R G B",
                                  "JFIF and Adobe 0", "Adobe 0", "Adobe 2"])
def test_lossy_colour_rules(tmp_path, case):
    """jdapimin.c's default_decompress_parms on three components: a JFIF
    marker says YCbCr, else an Adobe transform (0 RGB), else ids "R", "G",
    "B" say RGB and others YCbCr."""
    base = _pil_jpeg(_photo(12, 30, 27, 3), quality=80, subsampling=0)
    bare = _without_jfif(base)
    data = {"no JFIF, ids 1 2 3": bare, "no JFIF, ids R G B": _with_ids(bare, (82, 71, 66)),
            "no JFIF, ids 5 6 7": _with_ids(bare, (5, 6, 7)), "JFIF, ids R G B": _with_ids(base, (82, 71, 66)),
            "JFIF and Adobe 0": base[:2] + enc._markers(False, 0) + base[2:],
            "Adobe 0": bare[:2] + enc._markers(False, 0) + bare[2:],
            "Adobe 2": bare[:2] + enc._markers(False, 2) + bare[2:]}[case]
    assert held_to_jax(_write(tmp_path, "c.jpg", data)) is not None


@pytest.mark.parametrize("scale", [50, 600, 3000, 16000])
def test_idct_out_of_range(tmp_path, scale):
    """Coefficients whose samples leave 0-255 by far: libjpeg-turbo's SIMD
    islow IDCT keeps dequantised values to 16 bits and saturates (the port
    follows it, not jidctint.c's wrap-around); DC-only blocks take its
    16-bit shortcut."""
    rng = np.random.default_rng(scale)
    for dc_only in (False, True):
        blocks = np.round(rng.normal(0, scale, (4, 4, 64)) * (rng.random((4, 4, 64)) < 0.5)).astype(np.int64)
        blocks = np.clip(blocks, -32767, 32767)
        if dc_only:
            blocks[..., 1:] = 0
        comps = [dict(id=1, h=1, v=1, tq=0, dc=0, ac=0, blocks=blocks)]
        data = enc.write_arith(32, 32, comps, {0: rng.integers(1, 256, 64)})
        assert held_to_jax(_write(tmp_path, "i.jpg", data)) is not None


# -- PIL's 64 KB reads --------------------------------------------------------------------------

def _large_arith(progressive: bool) -> bytes:
    rng = np.random.default_rng(13)
    a = np.clip(_seeded_photo(rng, 120, 120, 3).astype(int) + rng.normal(0, 12, (120, 120, 3)), 0, 255)
    return enc.transcode_to_arith(_pil_jpeg(a.astype(np.uint8), quality=85, progressive=progressive),
                                  progressive=progressive)


@pytest.mark.parametrize("progressive", [False, True])
def test_arithmetic_scans_past_pils_reads(tmp_path, progressive):
    """PIL reads a JPEG 64 KB at a time, reading on only where libjpeg
    suspends, which its arithmetic decoder cannot: a scan whose decoding
    reads past the last 64 KB read fails in PIL. A COM segment moves the
    first and the last scan's end across the first boundary, byte by byte:
    the port refuses exactly the files PIL refuses."""
    head, units, tail = enc.split_scans(_large_arith(progressive))
    refused, read = 0, 0
    for k in sorted({0, len(units) - 1}):
        end = len(head) + 4 + sum(len(u) for u in units[:k + 1])
        for d in (-2, -1, 0, 1, 2):
            pad = 65536 - end + d
            if 0 <= pad <= 65533:
                com = b"\xff\xfe" + (pad + 2).to_bytes(2, "big") + bytes(pad)
                got = held_to_jax(_write(tmp_path, "w.jpg", head + com + b"".join(units) + tail))
                refused, read = refused + (got is None), read + (got is not None)
    assert refused and read, (refused, read)


# -- the committed fixtures -------------------------------------------------------------------

FIXTURES = {"page_color_1024_arith.jpg": None, "page_color_1024_progressive_arith.jpg": "page_color_1024.jpg",
            "page_gray_1024_lossless.jpg": "page_gray_1024.jpg", "page_color_1024_smoothed.jpg": None}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixtures_decode_to_their_digests(name):
    """tests/data/make_jpeg_arith_lossless_fixtures.py's files: the port's
    decode is PIL's digest; the SOF10 page and the lossless page decode as
    their Huffman twins."""
    with open(os.path.join(DATA, "manifest.json")) as f:
        manifest = json.load(f)
    entry, path = manifest[name], os.path.join(DATA, name)
    got = load_image(path)
    digest = hashlib.sha256(got.tobytes()).hexdigest()
    assert list(got.shape) == entry["shape"] and os.path.getsize(path) == entry["bytes"]
    assert digest == entry["decoded_sha256"]
    if FIXTURES[name]:
        assert digest == manifest[FIXTURES[name]]["decoded_sha256"]


# -- inside a TIFF ----------------------------------------------------------------------------

def _tiff_streams() -> dict:
    a, g = _photo(2, 32, 32, 3), _photo(3, 32, 32, 1)
    return {
        "progressive YCbCr": (_pil_jpeg(a, quality=85, progressive=True), 3, 6),
        "arithmetic YCbCr": (enc.transcode_to_arith(_pil_jpeg(a, quality=85)), 3, 6),
        "arithmetic progressive YCbCr": (enc.transcode_to_arith(_pil_jpeg(a, quality=85, progressive=True),
                                                                progressive=True), 3, 6),
        "arithmetic gray": (enc.transcode_to_arith(_pil_jpeg(g, quality=85)), 1, 1),
        "lossless gray": (enc.write_lossless([g[..., 0]], [(1, 1)], 7), 1, 1),
        "lossless RGB": (enc.write_lossless([a[..., i] for i in range(3)], [(1, 1)] * 3, 1, ids=(82, 71, 66)), 3, 2),
        "lossless YCbCr (refused)": (enc.write_lossless([a[..., i] for i in range(3)], [(1, 1)] * 3, 1, jfif=True),
                                     3, 6),
    }


@pytest.mark.parametrize("name", ["progressive YCbCr", "arithmetic YCbCr", "arithmetic progressive YCbCr",
                                  "arithmetic gray", "lossless gray", "lossless RGB", "lossless YCbCr (refused)"])
def test_streams_in_a_jpeg_tiff(tmp_path, name):
    """libtiff hands a JPEG-in-TIFF strip to libjpeg, which reads
    progressive, arithmetic and lossless streams there too (colour-converting
    none but YCbCr, which it refuses in a lossless frame)."""
    from chip_smoke import write_jpeg_tiff

    stream, c, photometric = _tiff_streams()[name]
    path = str(tmp_path / "t.tif")
    write_jpeg_tiff(path, [stream], 32, 32, components=c, photometric=photometric,
                    subsampling=(2, 2) if photometric == 6 and "lossless" not in name else
                    ((1, 1) if photometric == 6 else None))
    got = held_to_jax(path)
    assert (got is None) == name.endswith("(refused)")


# -- seeded mutants ---------------------------------------------------------------------------

@functools.cache
def _mutant_seeds() -> dict:
    a = _photo(20, 29, 35, 3)
    g = _photo(21, 27, 22, 1)
    head, units, tail = enc.split_scans(_pil_jpeg(g, quality=85, progressive=True))
    return {
        "SOF9 4:2:0, restarts": enc.transcode_to_arith(_pil_jpeg(a, quality=85, subsampling=2), restart=3),
        "SOF10 gray, restarts": enc.transcode_to_arith(_pil_jpeg(g, quality=85, progressive=True), progressive=True,
                                                       restart=2),
        "SOF3 gray, predictor 7": enc.write_lossless([g[..., 0]], [(1, 1)], 7, 1, 2),
        "smoothed gray": enc.join_scans(head, units[:3], tail),
    }


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("kind", ["SOF9 4:2:0, restarts", "SOF10 gray, restarts", "SOF3 gray, predictor 7",
                                  "smoothed gray"])
def test_mutants(tmp_path, kind, seed):
    """1-4 bytes set, flipped, dropped or inserted at random: whatever PIL
    decodes the port decodes the same, whatever it refuses the port refuses
    (a ~5,300-mutant fuzz of these kinds found the marker, restart,
    insufficient-data and IDCT rules pinned above)."""
    rng = np.random.default_rng(1000 * list(_mutant_seeds()).index(kind) + seed)
    data = bytearray(_mutant_seeds()[kind])
    how = rng.integers(0, 4)
    for _ in range(int(rng.integers(1, 5))):
        i = int(rng.integers(2, len(data) - 2))
        if how == 0:
            data[i] = int(rng.integers(0, 256))
        elif how == 1:
            data[i] ^= 1 << int(rng.integers(0, 8))
        elif how == 2:
            del data[i]
        else:
            data.insert(i, int(rng.integers(0, 256)))
    held_to_jax(_write(tmp_path, "m.jpg", bytes(data)))


def _without(data: bytes, marker: int) -> bytes:
    """``data`` without its ``marker`` segments before the first scan."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != marker:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    return bytes(out + data[pos:])


@pytest.mark.parametrize("kind", ["baseline", "progressive", "lossless"])
def test_missing_huffman_tables(tmp_path, kind):
    """A sequential Huffman file that defines no tables gets T.81's standard
    ones (``jdhuff.c``'s ``std_huff_tables``; PIL writes them unoptimised, so
    its baseline file decodes the same); progressive and lossless files do
    not, and both refuse them."""
    a = _photo(14, 24, 24, 3)
    data = {"baseline": _pil_jpeg(a, quality=85), "progressive": _pil_jpeg(a, quality=85, progressive=True),
            "lossless": enc.write_lossless([a[..., 0]], [(1, 1)], 1)}[kind]
    got = held_to_jax(_write(tmp_path, "h.jpg", _without(data, 0xC4)))
    assert (got is None) == (kind != "baseline")
    if kind == "baseline":
        assert np.array_equal(got, held_to_jax(_write(tmp_path, "b.jpg", data)))
