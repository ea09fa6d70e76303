"""PyTorch port vs the JAX package: ``utils/image_io.load_image`` on WebP —
the container (``utils/_webp.py``), VP8L lossless (``utils/_vp8l.py``), VP8
lossy (``utils/_vp8.py``) and the ``ALPH`` alpha plane.

Every file is decoded by the port and by the JAX package's own
``load_image`` (PIL 12.1 on libwebp 1.6) and the two held with
``np.array_equal``: no tolerance. Where PIL refuses a file, the port must
raise ``ValueError`` too.

Files PIL writes: lossless at odd sizes, every ``method`` × ``quality``,
RGBA with ``exact`` on and off, palettes of 2 to 256 colours (every bundling
width); lossy at ``quality`` 0-100 × ``method`` 0, 3, 6 on smooth and noisy
images, sizes that are not a multiple of 16, lossy with alpha at
``alpha_quality`` 0 / 50 / 100; ``VP8X`` with ICC, EXIF and XMP chunks;
animations (their first frame). Files the test writes: ``ALPH`` chunks byte by
byte (raw under each filter; a PIL-written VP8L plane under each filter),
VP8 frames whose first partition is re-encoded from the port's recorded
decisions with the simple loop filter, a sharpness, loop-filter deltas or
2, 4 and 8 token partitions (PIL's encoder writes none of them), a
paletted ``ALPH`` stream cut inside and before its last symbol, first
``ANMF`` frames offset inside a larger canvas, truncated or corrupt files,
and files PIL writes with a few bytes set at random (seeded). The
committed WebP fixtures decode to their manifest digests, and
``obj_scene``'s pages from an MTL that names WebP maps equal the JAX
package's.
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
from physically_based_renderer_tpu_torch import scenes
from physically_based_renderer_tpu_torch.utils import _vp8
from physically_based_renderer_tpu_torch.utils.image_io import load_image
from test_torch_image_formats import held_to_jax
from test_torch_obj_loader import write_sphere_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def _photo(rng, h, w, c):
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * (np.sin(xx / 7.0) * np.cos(yy / 5.0))[..., None] + rng.normal(0, 25, (h, w, c))
    return np.clip(base, 0, 255).astype(np.uint8)


def _smooth(h, w, c):
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 100 * np.sin(xx[..., None] / 17.0 + np.arange(c)) * np.cos(yy / 13.0)[..., None]
    return np.clip(base, 0, 255).astype(np.uint8)


def _save(img, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", **options)
    return buf.getvalue()


def _held(tmp_path, data: bytes, name="f.webp"):
    path = tmp_path / name
    path.write_bytes(data)
    return held_to_jax(path)


def chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(flags: int, width: int, height: int) -> bytes:
    size = (width - 1).to_bytes(3, "little") + (height - 1).to_bytes(3, "little")
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + size)


def chunks_of(data: bytes) -> dict:
    """The top-level chunks of a RIFF WEBP file, by fourcc (the first of each)."""
    out, pos = {}, 12
    while pos + 8 <= len(data):
        (n,) = struct.unpack_from("<I", data, pos + 4)
        out.setdefault(data[pos:pos + 4], data[pos + 8:pos + 8 + n])
        pos += 8 + n + (n & 1)
    return out


RNG = np.random.default_rng(15)
PHOTO_SMALL = _photo(RNG, 10, 14, 3)
VP8L_SMALL = chunks_of(_save(PHOTO_SMALL, lossless=True))[b"VP8L"]
VP8_SMALL = chunks_of(_save(PHOTO_SMALL, quality=80))[b"VP8 "]
_WITH_ALPHA = chunks_of(_save(np.dstack([PHOTO_SMALL, _smooth(10, 14, 1)]), quality=80, alpha_quality=100))
ALPH_SMALL, VP8_ALPHA_SMALL = _WITH_ALPHA[b"ALPH"], _WITH_ALPHA[b"VP8 "]


# -- lossless (VP8L) ------------------------------------------------------------------------


@pytest.mark.parametrize("size", [(1, 1), (3, 5), (17, 33), (127, 65)])
def test_lossless_odd_sizes(tmp_path, size):
    got = _held(tmp_path, _save(_photo(np.random.default_rng(size[0]), *size, 3), lossless=True))
    assert got.shape == (*size, 3)


@pytest.mark.parametrize("method", range(7))
@pytest.mark.parametrize("quality", [0, 50, 100])
def test_lossless_methods_and_qualities(tmp_path, method, quality):
    img = _photo(np.random.default_rng(method * 7 + quality), 40, 56, 3)
    got = _held(tmp_path, _save(img, lossless=True, method=method, quality=quality))
    assert np.array_equal(got, img)  # lossless


@pytest.mark.parametrize("exact", [True, False])
def test_lossless_rgba_exact(tmp_path, exact):
    rng = np.random.default_rng(3)
    img = _photo(rng, 40, 56, 4)
    img[..., 3] = rng.integers(0, 256, (40, 56))
    img[::3, :, 3] = 0  # transparent rows: without `exact` the encoder may change their RGB
    got = _held(tmp_path, _save(img, lossless=True, exact=exact))
    assert got.shape == img.shape and np.array_equal(got[..., 3], img[..., 3])


@pytest.mark.parametrize("colours", [2, 3, 4, 11, 16, 17, 256])
def test_lossless_palettes(tmp_path, colours):
    """Colour indexing at every bundling width: 8, 4, 2 and 1 indices a pixel."""
    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 3)).astype(np.uint8)
    img = pal[rng.integers(0, colours, (45, 61))]
    data = _save(img, lossless=True)
    assert _held(tmp_path, data).shape == img.shape


# -- lossy (VP8) ----------------------------------------------------------------------------


@pytest.mark.parametrize("quality", [0, 10, 50, 75, 90, 100])
@pytest.mark.parametrize("method", [0, 3, 6])
@pytest.mark.parametrize("kind", ["smooth", "noisy"])
def test_lossy_qualities_and_methods(tmp_path, quality, method, kind):
    img = _smooth(48, 80, 3) if kind == "smooth" else _photo(np.random.default_rng(quality + method), 48, 80, 3)
    got = _held(tmp_path, _save(img, quality=quality, method=method))
    assert got.shape == img.shape


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (31, 17), (100, 75), (33, 50)])
def test_lossy_sizes(tmp_path, size):
    got = _held(tmp_path, _save(_photo(np.random.default_rng(size[1]), *size, 3), quality=75))
    assert got.shape == (*size, 3)


def test_lossy_segmentation_off_and_on(tmp_path):
    """PIL's encoder turns segmentation off at quality 100 and on below."""
    img = _photo(np.random.default_rng(5), 48, 64, 3)
    for quality, segments in ((100, 0), (50, 1)):
        data = _save(img, quality=quality)
        record = []
        _vp8.decode_vp8(chunks_of(data)[b"VP8 "], record)
        assert record[2][1] == segments  # after colour space and clamping type
        _held(tmp_path, data)


def test_gray_image_is_rgb(tmp_path):
    got = _held(tmp_path, _save(_smooth(20, 30, 1)[..., 0], quality=80))
    assert got.shape == (20, 30, 3)


@pytest.mark.parametrize("alpha_quality", [0, 50, 100])
def test_lossy_with_alpha(tmp_path, alpha_quality):
    img = _photo(np.random.default_rng(alpha_quality), 50, 70, 4)
    img[..., 3] = _smooth(50, 70, 1)[..., 0]
    data = _save(img, quality=80, alpha_quality=alpha_quality)
    assert b"ALPH" in chunks_of(data)
    assert _held(tmp_path, data).shape == img.shape


# -- crafted ALPH chunks --------------------------------------------------------------------


@pytest.mark.parametrize("pre", [0, 1])
@pytest.mark.parametrize("filt", range(4))
def test_raw_alpha_under_each_filter(tmp_path, filt, pre):
    """Compression 0: the plane's bytes are the filter's residuals."""
    plane = np.random.default_rng(filt).integers(0, 256, 10 * 14).astype(np.uint8)
    alph = bytes([filt << 2 | pre << 4]) + plane.tobytes()
    got = _held(tmp_path, riff(vp8x(0x10, 14, 10), chunk(b"ALPH", alph), chunk(b"VP8 ", VP8_SMALL)))
    assert got.shape == (10, 14, 4)
    if filt == 0:
        assert np.array_equal(got[..., 3].ravel(), plane)


@pytest.mark.parametrize("filt", range(4))
def test_lossless_alpha_under_each_filter(tmp_path, filt):
    """Compression 1: PIL's VP8L-coded plane read under each filter."""
    alph = bytes([(ALPH_SMALL[0] & ~0x0C) | filt << 2]) + ALPH_SMALL[1:]
    assert ALPH_SMALL[0] & 3 == 1
    got = _held(tmp_path, riff(vp8x(0x10, 14, 10), chunk(b"ALPH", alph), chunk(b"VP8 ", VP8_ALPHA_SMALL)))
    assert got.shape == (10, 14, 4)


@pytest.mark.parametrize("header", [0x02, 0x40, 0x20])
def test_bad_alpha_header_raises(tmp_path, header):
    """Compression 2, a reserved bit, pre-processing 2: PIL refuses."""
    alph = bytes([header]) + bytes(140)
    assert _held(tmp_path, riff(vp8x(0x10, 14, 10), chunk(b"ALPH", alph), chunk(b"VP8 ", VP8_SMALL))) is None


def _reversed8(v: int) -> int:
    return int(f"{v:08b}"[::-1], 2)


def _paletted_alpha_stream(packed: list) -> tuple[bytes, int]:
    """A headerless VP8L alpha stream for an 8x4 plane: colour indexing with
    4 gray levels (2 bits an index, 4 to a packed pixel), no colour cache,
    single-symbol red, blue, alpha and distance codes and a green code of
    256 eight-bit literals: libwebp's 8-bit path. Returns the stream and
    the bit where the last packed pixel's symbol starts."""
    w = BitWriter()
    single = lambda: w.put(1, 1).put(0, 1).put(0, 1).put(0, 1)  # noqa: E731 — a simple code of symbol 0
    w.put(1, 1).put(3, 2).put(3, 8)  # a transform: colour indexing, 4 colours
    w.put(0, 1)  # the palette image: no colour cache
    w.put(1, 1).put(1, 1).put(1, 1).put(0, 8).put(85, 8)  # green: a simple code of 0 and 85
    for _ in range(4):
        single()
    for g in (0, 85, 85, 85):  # delta-coded gray levels 0, 85, 170, 255
        w.put(g == 85, 1)
    w.put(0, 1).put(0, 1).put(0, 1)  # no more transforms, no colour cache, no meta codes
    w.put(0, 1).put(8, 4)  # green: a normal code, 12 code-length code lengths (17 18 0 1 2 3 4 5 16 6 7 8)
    for length in (0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1):
        w.put(length, 3)
    w.put(1, 1).put(3, 3).put(254, 8)  # max_symbol = 2 + 254 tokens
    for _ in range(256):
        w.put(1, 1)  # code length 8 for each literal
    for _ in range(4):
        single()
    for v in packed[:-1]:
        w.put(_reversed8(v), 8)
    last = w.n
    w.put(_reversed8(packed[-1]), 8)
    return w.bytes()[:(w.n + 7) // 8], last


@pytest.mark.parametrize("cut", ["inside the last symbol", "before the last symbol", "complete"])
def test_paletted_alpha_end_of_data(tmp_path, cut):
    """libwebp decodes such a plane on its 8-bit path, which refuses data
    that ends before the last pixel's symbol starts but reads the bits of a
    last symbol cut short as zeros."""
    stream, last = _paletted_alpha_stream([0x1B, 0xE4, 0x27, 0x72, 0x8D, 0xD8, 0x4E, 0xB1])
    keep = {"inside the last symbol": (last + 7) // 8 if last % 8 else last // 8 + 1,
            "before the last symbol": last // 8 - 1, "complete": len(stream)}[cut]
    assert keep < len(stream) or cut == "complete"
    got = _held(tmp_path, riff(vp8x(0x10, 8, 4), chunk(b"ALPH", b"\x01" + stream[:keep]), chunk(b"VP8 ", _vp8_8x4())))
    assert (got is None) == (cut == "before the last symbol")
    if cut == "complete":
        levels = np.array([0, 85, 170, 255])[np.array([[(v >> 2 * k) & 3 for k in range(4)] for v in
                                                       [0x1B, 0xE4, 0x27, 0x72, 0x8D, 0xD8, 0x4E, 0xB1]])]
        assert np.array_equal(got[..., 3], levels.reshape(4, 8))


def _vp8_8x4() -> bytes:
    return chunks_of(_save(_photo(np.random.default_rng(8), 4, 8, 3), quality=80))[b"VP8 "]


# -- the first partition re-encoded: the simple loop filter, sharpness, deltas --------------


class BoolEncoder:
    """RFC 6386 §7.3's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def write(self, prob: int, bit: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _filter_bit_index(record) -> int:
    """The position of the filter-type decision in a first partition's
    decisions: after colour space, clamping and the segment header."""
    i = 2
    use_segment = record[i][1]
    i += 1
    if use_segment:
        update_map, update_data = record[i][1], record[i + 1][1]
        i += 2
        if update_data:
            i += 1  # absolute or delta
            for bits in (7, 7, 7, 7, 6, 6, 6, 6):
                i += 1 + (bits + 1) * record[i][1]
        if update_map:
            for _ in range(3):
                i += 1 + 8 * record[i][1]
    return i


def _literal(value: int, bits: int) -> list:
    return [(128, (value >> b) & 1) for b in range(bits - 1, -1, -1)]


def _reencoded(payload: bytes, variant: str) -> bytes:
    """The VP8 payload with its first partition re-encoded from the port's
    recorded decisions, one header field changed."""
    record = []
    _vp8.decode_vp8(payload, record)
    i = _filter_bit_index(record)
    assert record[i + 10][1] == 0  # PIL writes no loop-filter deltas
    if variant == "simple":
        assert record[i][1] == 0
        record[i] = (128, 1)
    elif variant == "unchanged":
        pass
    elif variant.startswith("partitions"):  # n copies of the one token partition, rows taking them in turn
        n = int(variant[len("partitions"):])
        assert record[i + 11:i + 13] == _literal(0, 2)
        record[i + 11:i + 13] = _literal(n.bit_length() - 1, 2)
    elif variant.startswith("sharpness"):
        record[i + 7:i + 10] = _literal(int(variant[-1]), 3)
    else:  # deltas: ref_frame[0] and mode[0] (B_PRED) set, the others absent
        deltas = [(128, 1), (128, 1)]
        for value in (-9, 7):
            deltas += [(128, 1)] + _literal(abs(value), 6) + [(128, int(value < 0))] + [(128, 0)] * 3
        record[i + 10:i + 11] = deltas
    enc = BoolEncoder()
    for prob, bit in record:
        enc.write(prob, bit)
    part0 = enc.flush()
    bits = payload[0] | (payload[1] << 8) | (payload[2] << 16)
    old = bits >> 5
    tag = (bits & 0x1F) | (len(part0) << 5)
    tokens = payload[10 + old:]
    if variant.startswith("partitions"):
        n = int(variant[len("partitions"):])
        tokens = len(tokens).to_bytes(3, "little") * (n - 1) + tokens * n
    return tag.to_bytes(3, "little") + payload[3:10] + part0 + tokens


@pytest.mark.parametrize("variant", ["unchanged", "simple", "sharpness3", "sharpness6", "deltas", "partitions2",
                                     "partitions4", "partitions8"])
def test_reencoded_first_partition(tmp_path, variant):
    """The simple loop filter, a sharpness, loop-filter deltas and 2, 4 or 8
    token partitions (copies of the one PIL wrote: macroblock row r reads
    copy r mod n from its start, whatever that decodes to), none of which
    PIL's encoder writes; "unchanged" holds the encoder itself."""
    img = _photo(np.random.default_rng(11), 40, 56, 3)
    payload = chunks_of(_save(img, quality=40))[b"VP8 "]
    plain = _vp8.decode_vp8(payload)
    got = _held(tmp_path, riff(chunk(b"VP8 ", _reencoded(payload, variant))))
    assert got.shape == (40, 56, 3)
    assert np.array_equal(got, plain) == (variant == "unchanged")  # the field took effect


# -- the extended and animated containers ---------------------------------------------------


@pytest.mark.parametrize("lossless", [False, True])
def test_vp8x_with_icc_exif_xmp(tmp_path, lossless):
    exif = b"Exif\x00\x00MM\x00*\x00\x00\x00\x08\x00\x00"
    data = _save(_photo(np.random.default_rng(2), 20, 30, 3), lossless=lossless, quality=80, icc_profile=b"\x01" * 131,
                 exif=exif, xmp=b"<x:xmpmeta/>")
    assert data[12:16] == b"VP8X" and {b"ICCP", b"EXIF", b"XMP "} <= set(chunks_of(data))
    assert _held(tmp_path, data).shape == (20, 30, 3)


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("channels", [3, 4])
def test_animation_first_frame(tmp_path, lossless, channels):
    """An animated RGB file gives RGB; with alpha, RGBA."""
    rng = np.random.default_rng(channels)
    frames = [Image.fromarray(_photo(rng, 24, 32, channels)) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:], duration=50, lossless=lossless,
                   quality=70)
    data = buf.getvalue()
    assert b"ANMF" in chunks_of(data)
    assert _held(tmp_path, data).shape == (24, 32, channels)


def anmf(x: int, y: int, w: int, h: int, *inner: bytes) -> bytes:
    head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, 100))
    return chunk(b"ANMF", head + b"\0" + b"".join(inner))


ANIM = chunk(b"ANIM", struct.pack("<IH", 0xFF112233, 0))


@pytest.mark.parametrize("flags", [0x02, 0x12])
@pytest.mark.parametrize("image", ["VP8L", "VP8", "VP8+ALPH", "size field off"])
def test_anmf_offset_and_smaller_than_canvas(tmp_path, image, flags):
    """The first frame at (4, 6) of a 20x18 canvas: the rest transparent
    black; RGBA only under the alpha flag; the frame's size is its
    bitstream's, whatever the ANMF header says."""
    inner = {"VP8L": (chunk(b"VP8L", VP8L_SMALL),), "VP8": (chunk(b"VP8 ", VP8_SMALL),),
             "VP8+ALPH": (chunk(b"ALPH", ALPH_SMALL), chunk(b"VP8 ", VP8_ALPHA_SMALL)),
             "size field off": (chunk(b"VP8L", VP8L_SMALL),)}[image]
    w, h = (12, 9) if image == "size field off" else (14, 10)
    got = _held(tmp_path, riff(vp8x(flags, 20, 18), ANIM, anmf(4, 6, w, h, *inner)))
    assert got.shape == (18, 20, 4 if flags & 0x10 else 3)
    outside = np.ones((18, 20), bool)
    outside[6:16, 4:18] = False
    assert not got[outside].any()


@pytest.mark.parametrize("case", ["alpha flag, no ALPH", "ALPH, no alpha flag", "VP8L, alpha flag",
                                  "canvas larger than the image", "frame outside the canvas", "reserved flag",
                                  "trailing chunks", "data past the RIFF size", "ALPH after the image, alpha flag",
                                  "ALPH after the image, no flag", "VP8L after ALPH", "two images", "two ALPH chunks",
                                  "a chunk between ALPH and VP8", "canvas past PIL's pixel limit"])
def test_vp8x_rules(tmp_path, case):
    """Pinned against PIL: a VP8X alpha flag without ALPH gives RGBA (alpha
    255); an ALPH chunk without the flag RGBA too (WebPGetFeatures sees the
    chunk, the demuxer drops it); a VP8L's own bit decides its mode; a
    still image must fill its canvas; an ANMF frame must lie inside it; an
    ALPH chunk kept must come before its image, and with nothing between
    them; a second image ends the frame; PIL opens no image of more than
    2 · 89,478,485 pixels."""
    files = {
        "alpha flag, no ALPH": riff(vp8x(0x10, 14, 10), chunk(b"VP8 ", VP8_SMALL)),
        "ALPH, no alpha flag": riff(vp8x(0x00, 14, 10), chunk(b"ALPH", ALPH_SMALL), chunk(b"VP8 ", VP8_ALPHA_SMALL)),
        "VP8L, alpha flag": riff(vp8x(0x10, 14, 10), chunk(b"VP8L", VP8L_SMALL)),
        "canvas larger than the image": riff(vp8x(0x00, 16, 12), chunk(b"VP8 ", VP8_SMALL)),
        "frame outside the canvas": riff(vp8x(0x02, 20, 18), ANIM, anmf(8, 10, 14, 10, chunk(b"VP8L", VP8L_SMALL))),
        "reserved flag": riff(vp8x(0x40, 14, 10), chunk(b"VP8 ", VP8_SMALL)),
        "trailing chunks": riff(vp8x(0x00, 14, 10), chunk(b"ICCP", b"abc"), chunk(b"VP8 ", VP8_SMALL),
                                chunk(b"EXIF", b"abcd"), chunk(b"ABCD", b"x")),
        "data past the RIFF size": riff(chunk(b"VP8 ", VP8_SMALL)) + b"junk" * 3,
        "ALPH after the image, alpha flag": riff(vp8x(0x10, 14, 10), chunk(b"VP8 ", VP8_ALPHA_SMALL),
                                                 chunk(b"ALPH", ALPH_SMALL)),
        "ALPH after the image, no flag": riff(vp8x(0x00, 14, 10), chunk(b"VP8 ", VP8_ALPHA_SMALL),
                                              chunk(b"ALPH", ALPH_SMALL)),
        "VP8L after ALPH": riff(chunk(b"VP8 ", VP8_SMALL), chunk(b"ALPH", ALPH_SMALL), chunk(b"VP8L", VP8L_SMALL)),
        "two images": riff(chunk(b"VP8 ", VP8_SMALL), chunk(b"VP8 ", VP8_ALPHA_SMALL)),
        "two ALPH chunks": riff(vp8x(0x10, 14, 10), chunk(b"ALPH", ALPH_SMALL), chunk(b"ALPH", ALPH_SMALL),
                                chunk(b"VP8 ", VP8_ALPHA_SMALL)),
        "a chunk between ALPH and VP8": riff(vp8x(0x10, 14, 10), chunk(b"ALPH", ALPH_SMALL), chunk(b"ICCP", b"abcd"),
                                             chunk(b"VP8 ", VP8_ALPHA_SMALL)),
        "canvas past PIL's pixel limit": riff(vp8x(0x02, 16384, 10923), ANIM, anmf(0, 0, 14, 10, chunk(b"VP8L", VP8L_SMALL))),
    }
    want = {"alpha flag, no ALPH": (10, 14, 4), "ALPH, no alpha flag": (10, 14, 4), "VP8L, alpha flag": (10, 14, 3),
            "trailing chunks": (10, 14, 3), "data past the RIFF size": (10, 14, 3),
            "ALPH after the image, no flag": (10, 14, 3), "two images": (10, 14, 3)}
    got = _held(tmp_path, files[case])
    if case in want:
        assert got.shape == want[case]
        if got.shape[-1] == 4:
            assert (got[..., 3] == 255).all()
    else:
        assert got is None


# -- truncated and corrupt files ------------------------------------------------------------


class BitWriter:
    """VP8L's bit order: least significant first."""

    def __init__(self):
        self.value, self.n = 0, 0

    def put(self, value: int, bits: int) -> "BitWriter":
        self.value |= value << self.n
        self.n += bits
        return self

    def bytes(self) -> bytes:
        return self.value.to_bytes((self.n + 7) // 8 + 4, "little")


def _incomplete_code_vp8l() -> bytes:
    """A 4x4 VP8L stream whose first prefix code is incomplete: code lengths
    (1, 2) for symbols 0 and 1 (Kraft sum 3/4)."""
    w = BitWriter().put(0x2F, 8).put(3, 14).put(3, 14).put(0, 1).put(0, 3)
    w.put(0, 1).put(0, 1).put(0, 1)  # no transform, no colour cache, no meta codes
    w.put(0, 1).put(1, 4)  # a normal code; 5 code-length code lengths (order 17, 18, 0, 1, 2)
    for length in (0, 0, 0, 1, 1):
        w.put(length, 3)
    w.put(1, 1).put(0, 3).put(0, 2)  # max_symbol = 2 + 0
    w.put(0, 1).put(1, 1)  # code-length symbols 1 and 2
    return w.bytes()


def _corrupt(kind: str) -> bytes:
    good = riff(chunk(b"VP8 ", VP8_SMALL))
    first = (VP8_SMALL[0] | VP8_SMALL[1] << 8 | VP8_SMALL[2] << 16) >> 5
    return {
        "truncated file": good[:-3],
        "chunk size past the RIFF": good[:16] + struct.pack("<I", len(VP8_SMALL) + 10) + good[20:],
        "RIFF size over a partial chunk header": riff(chunk(b"VP8 ", VP8_SMALL), b"abc"),
        "VP8L signature": riff(chunk(b"VP8L", b"\x2e" + VP8L_SMALL[1:])),
        "VP8L version": riff(chunk(b"VP8L", VP8L_SMALL[:4] + bytes([VP8L_SMALL[4] | 0x20]) + VP8L_SMALL[5:])),
        "VP8L cut short": riff(chunk(b"VP8L", VP8L_SMALL[:len(VP8L_SMALL) // 2])),
        "incomplete prefix code": riff(chunk(b"VP8L", _incomplete_code_vp8l())),
        "token partition cut short": riff(chunk(b"VP8 ", VP8_SMALL[:10 + first + 2])),
        "token partition empty": riff(chunk(b"VP8 ", VP8_SMALL[:10 + first])),
        "first partition cut short": riff(chunk(b"VP8 ", VP8_SMALL[:10 + first // 2])),
        "VP8 start code": riff(chunk(b"VP8 ", VP8_SMALL[:3] + b"\x9d\x01\x2b" + VP8_SMALL[6:])),
        "VP8 inter frame": riff(chunk(b"VP8 ", bytes([VP8_SMALL[0] | 1]) + VP8_SMALL[1:])),
        "no image chunk": riff(vp8x(0x00, 14, 10), chunk(b"EXIF", b"abcd")),
        "unknown first chunk": riff(chunk(b"ABCD", b"abcd"), chunk(b"VP8 ", VP8_SMALL)),
    }[kind]


CORRUPT = ["truncated file", "chunk size past the RIFF", "RIFF size over a partial chunk header", "VP8L signature",
           "VP8L version", "VP8L cut short", "incomplete prefix code", "token partition cut short",
           "token partition empty", "first partition cut short", "VP8 start code", "VP8 inter frame",
           "no image chunk", "unknown first chunk"]


@pytest.mark.parametrize("kind", CORRUPT)
def test_corrupt_files_raise(tmp_path, kind):
    assert _held(tmp_path, _corrupt(kind)) is None
    with pytest.raises(ValueError):
        load_image(str(tmp_path / "f.webp"))


def _mutation_base(kind: str) -> bytes:
    rng = np.random.default_rng(21)
    rgba = _photo(rng, 20, 35, 4)
    rgba[..., 3] = _smooth(20, 35, 1)[..., 0]
    if kind == "lossless":
        return _save(_photo(rng, 12, 17, 3), lossless=True)
    if kind == "palette":
        return _save(rng.integers(0, 256, (5, 3)).astype(np.uint8)[rng.integers(0, 5, (13, 19))], lossless=True)
    if kind == "lossy":
        return _save(rgba[..., :3], quality=60)
    if kind == "lossy + alpha":  # alpha_quality 50: a level-reduced, colour-indexed ALPH plane
        return _save(rgba, quality=60, alpha_quality=50)
    buf = io.BytesIO()
    frames = [Image.fromarray(_photo(rng, 18, 22, 4)) for _ in range(3)]
    frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:], duration=40, quality=60)
    return buf.getvalue()


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("kind", ["lossless", "palette", "lossy", "lossy + alpha", "animation"])
def test_mutated_files(tmp_path, kind, seed):
    """One to three bytes past the RIFF tag set at random: the port decodes
    what PIL decodes, bit for bit, and refuses what PIL refuses."""
    data = bytearray(_mutation_base(kind))
    rng = np.random.default_rng(seed)
    for _ in range(rng.integers(1, 4)):
        data[int(rng.integers(4, len(data)))] = int(rng.integers(0, 256))
    _held(tmp_path, bytes(data))


# -- the committed fixtures and the scene that reads them -----------------------------------

FIXTURES = ["page_color_1024_lossless.webp", "page_color_1024_q90.webp", "page_rgba_512_q80.webp"]


def test_fixtures_decode_to_their_digests():
    with open(os.path.join(DATA, "manifest.json")) as f:
        manifest = json.load(f)
    assert sum(os.path.getsize(os.path.join(DATA, n)) for n in FIXTURES) < 800_000
    for name in FIXTURES:
        entry, path = manifest[name], os.path.join(DATA, name)
        got = held_to_jax(path)
        digest = hashlib.sha256(got.tobytes()).hexdigest()
        assert list(got.shape) == entry["shape"] and os.path.getsize(path) == entry["bytes"]
        assert digest == entry["decoded_sha256"], name
    # the lossless page is the JPEG page's decode, bit for bit
    assert manifest[FIXTURES[0]]["decoded_sha256"] == manifest["page_color_1024.jpg"]["decoded_sha256"]


def test_obj_scene_pages_from_webp(tmp_path):
    """An MTL whose diffuse map is a lossy WebP with alpha, roughness a
    lossless WebP of a gray image and normal map a lossy WebP: the asset
    cache's pages and the atlas equal the JAX package's ``obj_scene``'s."""
    path = write_sphere_obj(tmp_path, textured=False)
    rng = np.random.default_rng(13)
    (tmp_path / "maps").mkdir()
    rgba = _photo(rng, 40, 40, 4)
    rgba[..., 3] = _smooth(40, 40, 1)[..., 0]
    (tmp_path / "maps" / "albedo.webp").write_bytes(_save(rgba, quality=85))
    (tmp_path / "maps" / "rough.webp").write_bytes(_save(_smooth(40, 40, 1)[..., 0], lossless=True))
    (tmp_path / "maps" / "normal.webp").write_bytes(_save(_photo(rng, 32, 32, 3), quality=60))
    (tmp_path / "sphere.mtl").write_text(
        "newmtl painted\nKd 1 1 1\nNs 128\nPm 0.25\nmap_Kd maps/albedo.webp\nmap_Pr maps/rough.webp\n"
        "map_bump maps/normal.webp\nnewmtl plain\nKd 0.2 0.6 0.9\nNs 32\n")
    jcache = jscenes.AssetCache(asset_root=str(tmp_path), texture_size=32)
    cache = scenes.AssetCache(asset_root=str(tmp_path), texture_size=32)
    jscene = jscenes.obj_scene(path, assets=jcache, texture_size=32, prefer_native=False)
    scene = scenes.obj_scene(path, assets=cache, texture_size=32, device="cpu")
    assert len(cache.pages) == len(jcache.pages) == 3 and cache.srgb == jcache.srgb
    for got, ref in zip(cache.pages, jcache.pages):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    for a, b in zip(scene.atlas.mips, jscene.atlas.mips):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("has_tex", "tex_index"):
        np.testing.assert_array_equal(getattr(scene.materials, f).numpy(), np.asarray(getattr(jscene.materials, f)))
