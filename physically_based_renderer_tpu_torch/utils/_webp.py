"""WebP decoding with NumPy — the ``.webp`` part of ``utils/image_io.load_image``:
bit for bit what PIL 12.1 gives, which decodes every WebP file through
libwebp 1.6's ``WebPAnimDecoder`` (the first frame, composed on a canvas
cleared to transparent black), under the JAX package's mode rules.

The container, as libwebp's demuxer reads it: the RIFF header (data past
the RIFF size ignored, a file shorter than it refused) and the chunk walk
with odd sizes padded; a simple ``VP8 `` or ``VP8L`` file; ``VP8X`` with its
flags and 24-bit canvas size (a still image must fill its canvas exactly);
``ALPH`` (kept only under the VP8X alpha flag in a still image); ``ICCP``,
``EXIF``, ``XMP `` and unknown chunks skipped (PIL applies none of them);
``ANIM`` / ``ANMF``: the first frame only, at its offset (2 × the stored
value) on the canvas. The bitstreams are ``utils/_vp8l.py`` (lossless) and
``utils/_vp8.py`` (lossy); an ``ALPH`` chunk's plane is raw (compression 0)
or a headerless VP8L stream whose green is the alpha (compression 1), then
un-filtered (none, horizontal, vertical or gradient, each with libwebp's
first-row and first-column rules) and joined to the VP8 RGB without
premultiplying. The level-reduction pre-processing flag needs no work
with dithering off.

Mode (PIL's sniff through ``WebPGetFeatures``): RGBA when the file has
alpha — a VP8L's ``alpha_is_used`` bit, the VP8X alpha flag of a VP8 file
or an animation, an ``ALPH`` chunk before a still image — else RGB (PIL's
RGBX, the X dropped), gray images included. Every file PIL refuses raises
``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from ._vp8 import decode_vp8, vp8_size
from ._vp8l import decode_vp8l, vp8l_size

MAX_CHUNK = (1 << 32) - 1 - 8 - 1  # libwebp's MAX_CHUNK_PAYLOAD
ALPHA_FLAG, ANIMATION_FLAG, VALID_FLAGS = 0x10, 0x02, 0x3E
IMAGE_CHUNKS = (b"VP8 ", b"VP8L")
PIL_PIXEL_LIMIT = 2 * (1024 * 1024 * 1024 // 4 // 3)  # Image.open refuses more pixels (a decompression bomb)


def is_webp(data: bytes) -> bool:
    """PIL's test: ``RIFF····WEBP`` and a first chunk VP8, VP8L or VP8X."""
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP" and data[12:16] in (b"VP8 ", b"VP8L", b"VP8X")


def _features(fourcc: bytes, payload: bytes, size: int) -> tuple[int, int, bool]:
    """(width, height, has_alpha) of an image chunk, as WebPGetFeatures
    reads it; ValueError where it fails."""
    if fourcc == b"VP8L":
        return vp8l_size(payload)
    return (*vp8_size(payload, size), False)


class _Frame:
    """An image (and alpha) found by the chunk walk."""

    def __init__(self):
        self.alpha = None  # (offset, size) of the ALPH payload
        self.image = None  # (fourcc, offset, padded size) of the VP8 / VP8L payload
        self.width = self.height = 0
        self.has_alpha = False
        self.x = self.y = 0


def _chunk(data: bytes, pos: int, end: int) -> tuple[bytes, int, int]:
    """The chunk header at ``pos`` → (fourcc, size, padded size); its padded
    payload must fit before ``end``."""
    fourcc = data[pos:pos + 4]
    (size,) = struct.unpack_from("<I", data, pos + 4)
    if size > MAX_CHUNK:
        raise ValueError("WebP: a chunk size past the limit")
    padded = size + (size & 1)
    if padded > end - pos - 8:
        raise ValueError(f"WebP: the {fourcc!r} chunk passes the end of the RIFF data")
    return fourcc, size, padded


def _store_frame(data: bytes, pos: int, end: int, frame: _Frame) -> int:
    """libwebp's StoreFrame: an optional ALPH, then one VP8 / VP8L chunk;
    any other chunk (or a second of either) ends the frame. Returns the
    position after the chunks taken."""
    if end - pos < 8:
        raise ValueError("WebP: the data ends before a chunk header")
    while True:
        fourcc, size, padded = _chunk(data, pos, end)
        if fourcc == b"ALPH":
            if frame.alpha is not None:
                return pos
            frame.alpha = (pos + 8, size)
        elif fourcc in IMAGE_CHUNKS:
            if fourcc == b"VP8L" and frame.alpha is not None:
                raise ValueError("WebP: an ALPH chunk before a VP8L image")
            if frame.image is not None:
                return pos
            payload = data[pos + 8:pos + 8 + padded]
            frame.width, frame.height, alpha = _features(fourcc, payload, size)
            frame.has_alpha |= alpha
            frame.image = (fourcc, pos + 8, padded)
        else:
            return pos
        pos += 8 + padded
        if pos == end:
            return pos
        if end - pos < 8:
            raise ValueError("WebP: the data ends inside a chunk header")


def _demux(data: bytes) -> tuple[int, int, _Frame]:
    """The canvas size and the first frame, or ValueError where libwebp's
    WebPDemux refuses the file."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("WebP: not a RIFF WEBP file")
    (riff,) = struct.unpack_from("<I", data, 4)
    if riff < 8 or riff > MAX_CHUNK:
        raise ValueError("WebP: a bad RIFF size")
    end = riff + 8
    if len(data) < end:
        raise ValueError(f"WebP: the file ends after {len(data)} of its {end} bytes (truncated)")
    first = data[12:16]
    if first in IMAGE_CHUNKS:
        frame = _Frame()
        _store_frame(data, 12, end, frame)
        frame.alpha = None  # no VP8X, so no alpha flag: libwebp drops an ALPH chunk
        return frame.width, frame.height, frame
    if first != b"VP8X":
        raise ValueError("WebP: the first chunk is not VP8, VP8L or VP8X")
    (size,) = struct.unpack_from("<I", data, 16)
    if size > MAX_CHUNK or size < 10:
        raise ValueError("WebP: a bad VP8X chunk size")
    padded = size + (size & 1)
    if padded > end - 20:
        raise ValueError("WebP: the VP8X chunk passes the end of the RIFF data")
    flags = data[20]
    cw = 1 + int.from_bytes(data[24:27], "little")
    ch = 1 + int.from_bytes(data[27:30], "little")
    if cw * ch >= 1 << 32:
        raise ValueError("WebP: the canvas is too large")
    pos = 20 + padded
    if end - pos < 8:
        raise ValueError("WebP: no chunk after VP8X")
    animated = bool(flags & ANIMATION_FLAG)
    frames, anim = [], False
    while True:
        fourcc, _, cpad = _chunk(data, pos, end)
        if fourcc == b"VP8X":
            raise ValueError("WebP: a second VP8X chunk")
        if fourcc in (b"ALPH",) + IMAGE_CHUNKS:
            if anim or animated:
                raise ValueError("WebP: a still image in an animation")
            if frames:
                raise ValueError("WebP: a second still image")
            frame = _Frame()
            pos = _store_frame(data, pos, end, frame)
            if not flags & ALPHA_FLAG:
                frame.alpha = None
            frames.append(frame)
        elif fourcc == b"ANIM":
            if cpad < 6:
                raise ValueError("WebP: a short ANIM chunk")
            anim = True
            pos += 8 + cpad
        elif fourcc == b"ANMF":
            if not anim:
                raise ValueError("WebP: an ANMF chunk before ANIM")
            if cpad < 16:
                raise ValueError("WebP: a short ANMF chunk")
            head = data[pos + 8:pos + 24]
            x = 2 * int.from_bytes(head[0:3], "little")
            y = 2 * int.from_bytes(head[3:6], "little")
            fw = 1 + int.from_bytes(head[6:9], "little")
            fh = 1 + int.from_bytes(head[9:12], "little")
            if fw * fh >= 1 << 32:
                raise ValueError("WebP: an ANMF frame too large")
            start = pos + 24
            frame = _Frame()
            frame.x, frame.y = x, y
            pos = _store_frame(data, start, end, frame)
            if pos - start > cpad - 16:
                raise ValueError("WebP: an ANMF frame's chunks pass its end")
            if animated and (frame.image is not None or frame.alpha is not None):
                frames.append(frame)
        else:  # ICCP, EXIF, XMP and unknown chunks
            pos += 8 + cpad
        if pos == end:
            break
        if end - pos < 8:
            raise ValueError("WebP: the data ends inside a chunk header")
    if flags & ~VALID_FLAGS & 0xFF:
        raise ValueError("WebP: reserved VP8X flags set")
    if not frames:
        raise ValueError("WebP: no frame")
    for f in frames:
        if f.image is None:
            raise ValueError("WebP: a frame without an image chunk")
        if f.alpha is not None and f.alpha[0] > f.image[1]:
            raise ValueError("WebP: an ALPH chunk after its image")
        if not animated:
            if f.x or f.y or f.width != cw or f.height != ch:
                raise ValueError("WebP: a still image that does not fill its canvas")
        elif f.x + f.width > cw or f.y + f.height > ch:
            raise ValueError("WebP: a frame outside its canvas")
    return cw, ch, frames[0]


def _has_alpha(data: bytes, frame: _Frame) -> bool:
    """PIL's mode sniff: WebPGetFeatures' has_alpha over the whole file (a
    failure there leaves PIL's RGBA)."""
    first = data[12:16]
    if first == b"VP8L":
        return frame.has_alpha
    if first == b"VP8 ":
        return False
    (size,) = struct.unpack_from("<I", data, 16)
    if size != 10:
        return True
    flags = data[20]
    if flags & ANIMATION_FLAG:
        return bool(flags & ALPHA_FLAG)
    alpha = bool(flags & ALPHA_FLAG)
    pos, end = 30, len(data)
    found_alpha = False
    while pos + 8 <= end and data[pos:pos + 4] not in IMAGE_CHUNKS:
        if data[pos:pos + 4] == b"ALPH":
            found_alpha = True
        (csize,) = struct.unpack_from("<I", data, pos + 4)
        pos += 8 + csize + (csize & 1)
    if pos + 8 <= end and data[pos:pos + 4] == b"VP8L":
        alpha = frame.has_alpha
    return alpha or found_alpha


def _unfilter(delta: np.ndarray, method: int) -> np.ndarray:
    """Undo the ALPH filter (1 horizontal, 2 vertical, 3 gradient) on an
    (H, W) uint8 plane; row 0 of every filter is horizontal from 0."""
    if method == 0:
        return delta
    d = delta.astype(np.int64)
    h, w = d.shape
    out = np.zeros((h, w), np.int64)
    out[0] = np.cumsum(d[0]) & 0xFF
    if h == 1:
        return out.astype(np.uint8)
    if method == 1:  # column 0 from above, the rest from the left
        col0 = np.cumsum(d[:, 0]) & 0xFF
        out[1:, 0] = col0[1:]
        out[1:, 1:] = (col0[1:, None] + np.cumsum(d[1:, 1:], 1)) & 0xFF
    elif method == 2:  # from above
        out[1:] = (out[0][None, :] + np.cumsum(d[1:], 0)) & 0xFF
    else:  # gradient: clip(left + top − top-left), column 0 from above; wavefronts of x + y
        out[1:, 0] = (out[0, 0] + np.cumsum(d[1:, 0])) & 0xFF
        for k in range(2, h + w - 1):
            ys = np.arange(max(1, k - w + 1), min(h - 1, k - 1) + 1)
            xs = k - ys
            g = np.clip(out[ys, xs - 1] + out[ys - 1, xs] - out[ys - 1, xs - 1], 0, 255)
            out[ys, xs] = (d[ys, xs] + g) & 0xFF
    return out.astype(np.uint8)


def _decode_alpha(chunk: bytes, width: int, height: int) -> np.ndarray:
    """An ALPH payload → (H, W) uint8 alpha."""
    if len(chunk) <= 1:
        raise ValueError("WebP: an empty ALPH chunk")
    head = chunk[0]
    method, filt, pre, reserved = head & 3, (head >> 2) & 3, (head >> 4) & 3, head >> 6
    if method > 1 or pre > 1 or reserved:
        raise ValueError("WebP: a bad ALPH header")
    if method == 0:
        if len(chunk) - 1 < width * height:
            raise ValueError("WebP: a raw ALPH plane shorter than the image")
        plane = np.frombuffer(chunk, np.uint8, width * height, 1).reshape(height, width)
    else:
        argb = decode_vp8l(chunk[1:], headerless=(width, height))
        plane = ((argb >> 8) & 0xFF).astype(np.uint8)
    return _unfilter(plane, filt)


def _decode_frame(data: bytes, frame: _Frame) -> np.ndarray:
    """The frame's bitstream → (h, w, 4) uint8 RGBA."""
    fourcc, off, padded = frame.image
    payload = data[off:off + padded]
    if fourcc == b"VP8L":
        argb = decode_vp8l(payload)
        bgra = argb.view(np.uint8).reshape(argb.shape + (4,))
        return np.ascontiguousarray(bgra[..., [2, 1, 0, 3]])
    rgb = decode_vp8(payload)
    h, w, _ = rgb.shape
    alpha = np.full((h, w), 255, np.uint8)
    if frame.alpha is not None:
        a_off, a_size = frame.alpha
        alpha = _decode_alpha(data[a_off:a_off + a_size], w, h)
    return np.concatenate([rgb, alpha[..., None]], -1)


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes → (H, W, 3) uint8 RGB or (H, W, 4) RGBA: the first frame
    on its canvas."""
    if not is_webp(data):
        raise ValueError("not a WebP file")
    data = bytes(data)
    cw, ch, frame = _demux(data)
    if cw * ch > PIL_PIXEL_LIMIT:
        raise ValueError(f"WebP: a {cw}x{ch} canvas, past the {PIL_PIXEL_LIMIT} pixels PIL opens")
    data = data[:struct.unpack_from("<I", data, 4)[0] + 8]
    rgba = _decode_frame(data, frame)
    canvas = np.zeros((ch, cw, 4), np.uint8)
    canvas[frame.y:frame.y + frame.height, frame.x:frame.x + frame.width] = rgba
    if _has_alpha(data, frame):
        return canvas
    return np.ascontiguousarray(canvas[..., :3])
