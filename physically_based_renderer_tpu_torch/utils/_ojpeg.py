"""Old-style JPEG (TIFF compression 6) as libtiff 4.7's ``tif_ojpeg.c``
reads it for PIL — for ``utils/_tiff.py``.

libtiff makes one JPEG stream of the whole image (of one column of tiles,
for a tiled file; of one plane, for separate planes) and hands it to
libjpeg:

  * its header comes from the file's own JPEG data where that starts with a
    marker — the bytes at ``JPEGInterchangeFormat`` (clipped to the file),
    then the strips or tiles, read marker by marker up to SOS (SOI, APPn and
    COM skipped; DRI, DQT and DHT kept; SOF0, SOF1 or SOF3 checked against
    the tags; SOS's components and tables kept, the rest of it replaced;
    a separate plane's SOS searched for after the plane before's) — or else
    is made from the tags: ``JPEGQTables``, ``JPEGDCTables`` and
    ``JPEGACTables`` point at each component's bare table (an offset equal
    to the one before reuses that table), the frame is the strip's or
    tile's width by all of their rows, component ids 0, 1, 2;
  * then SOI, DQT and DHT, DRI, SOF, SOS (Ss 0, Se 63), and the
    entropy-coded data: what follows the header's SOS, then each strip or
    tile (from its offset, its byte count or to the end of the file; one
    past the file's end is empty), RSTn after each but the last, EOI at the
    end and ever after. With several strips or tiles the restart interval
    is the MCUs of one (unless a DRI in the header sets another), so each
    strip's own entropy-coded segment decodes from fresh predictions;
  * libjpeg reads it raw (``jpeg_read_raw_data``: no upsampling, no colour
    conversion; block rows and columns past a component's real ones left as
    libtiff's buffer held them) where a stream has three components, and
    libtiff packs each iMCU row into YCbCr data units; one component is
    read as scanlines. libtiff's ``resync_to_restart`` fails the decode at
    any restart marker out of place, and every read after it in the session.

The sampling is the first component's in the header's SOF where one comes
before SOS (libtiff's ``OJPEGSubsamplingCorrect``; the tag's, 2×2 by
default, otherwise); sampling libtiff cannot lay out as data units fails
the decode. ``JPEGProc`` is not read. libtiff counts the strips it has read
in its post-decode step; on a big-endian file (read on a little-endian
host) the byte-swapper's step replaces it and every strip after the first is read
a strip late. PIL takes three samples as YCbCr through libtiff's RGBA
interface (``_tiff._put_ycbcr``: replicated chroma, ``TIFFYCbCrtoRGB``),
which draws a strip or tile whose decode failed from a zeroed buffer and
refuses the file where a later one fails before decoding; one sample as the
strip's or tile's gray rows, any failure refusing the file.
"""

from __future__ import annotations

import numpy as np

from ._jpeg import _planes, _samples, decode_old_jpeg_stream

(WIDTH, LENGTH, PHOTOMETRIC, STRIPOFFSETS, SAMPLES, ROWSPERSTRIP, STRIPBYTECOUNTS, TILEWIDTH, TILELENGTH,
 TILEOFFSETS, TILEBYTECOUNTS) = (256, 257, 262, 273, 277, 278, 279, 322, 323, 324, 325)
JPEGIFOFFSET, JPEGIFBYTECOUNT, JPEGRESTARTINTERVAL = 513, 514, 515
JPEGQTABLES, JPEGDCTABLES, JPEGACTABLES, YCBCRSUBSAMPLING = 519, 520, 521, 530
SOF0, SOF1, SOF3, DHT, SOI, SOS, DQT, DRI, COM = 0xC0, 0xC1, 0xC3, 0xC4, 0xD8, 0xDA, 0xDB, 0xDD, 0xFE


class _Fail(Exception):
    """libtiff's old-style JPEG codec fails (quietly, in its sampling pass)."""


def _fail(message: str):
    raise ValueError(f"TIFF: old-style JPEG: {message}")


class _Source:
    """``OJPEGReadBufferFill`` over the codec's pieces — the interchange-format
    bytes, then each strip's or tile's — as the header reader takes bytes:
    a byte or a block may cross from one piece to the next, a skip stops at
    the end of the piece it starts in."""

    def __init__(self, pieces: list):
        self.pieces, self.k, self.pos = pieces, 0, 0

    def peek(self) -> int:
        while self.pos >= len(self.pieces[self.k]):
            if self.k + 1 == len(self.pieces):
                raise _Fail("the JPEG data ends in its header")
            self.k, self.pos = self.k + 1, 0
        return self.pieces[self.k][self.pos]

    def byte(self) -> int:
        b = self.peek()
        self.pos += 1
        return b

    def word(self) -> int:
        return self.byte() << 8 | self.byte()

    def block(self, n: int) -> bytes:
        return bytes(self.byte() for _ in range(n))

    def skip(self, n: int) -> None:
        self.pos = min(self.pos + n, len(self.pieces[self.k]))


def subsampling_tag(tags: dict) -> tuple | None:
    """``YCbCrSubsampling`` as libtiff reads it: two values, or none (a tag
    of another count it ignores)."""
    v = tags.get(YCBCRSUBSAMPLING, ())
    return tuple(v) if len(v) == 2 else None


def _ints(tags: dict, tag: int) -> list:
    """An offset-array tag's values as libtiff keeps them (a count past 3, or
    values that are not integers, and the tag is refused: no values)."""
    v = tags.get(tag, ())
    if len(v) > 3 or not all(isinstance(x, int) for x in v):
        v = ()
    return list(v) + [0] * (3 - len(v))


class _Codec:
    """The codec's state for one image: its geometry, sampling, tables and
    the header it writes."""

    def __init__(self, data: bytes, tags: dict, photometric: int, samples: int, planes: int = 1):
        self.data, self.tags = data, tags
        self.width, self.height = tags[WIDTH][0], tags[LENGTH][0]
        self.tiled = TILEOFFSETS in tags
        if self.tiled:
            self.sw, self.sl = tags.get(TILEWIDTH, (0,))[0], tags.get(TILELENGTH, (0,))[0]
            if not self.sw or not self.sl:
                _fail("tiles without a tile width or length")
            self.sl_total = -(-self.height // self.sl) * self.sl
            self.per_image = -(-self.width // self.sw) * -(-self.height // self.sl)
            offsets, counts = tags[TILEOFFSETS], tags.get(TILEBYTECOUNTS, ())
        else:
            rps = tags.get(ROWSPERSTRIP, (0xFFFFFFFF,))[0]
            self.sw, self.sl, self.sl_total = self.width, rps, self.height
            if not rps:
                _fail("a RowsPerStrip of 0 (libtiff: zero strip size)")
            self.per_image = -(-self.height // rps)
            offsets, counts = tags.get(STRIPOFFSETS, ()), tags.get(STRIPBYTECOUNTS, ())
            if self.per_image * planes > 1 and STRIPBYTECOUNTS not in tags:
                _fail("no StripByteCounts (libtiff: missing required field)")
        # libtiff pads short offset and count arrays with zeros; a count of 0 runs to the end of the file
        count = self.per_image * planes
        offsets = list(offsets[:count]) + [0] * (count - len(offsets[:count]))
        counts = list(counts[:count]) + [0] * (count - len(counts[:count]))
        size = len(data)
        self.striles = []
        for o, n in zip(offsets, counts):
            if not 0 < o < size:
                self.striles.append(b"")
            else:
                self.striles.append(data[o:size if not n else min(o + n, size)])
        at, n = tags.get(JPEGIFOFFSET, (0,))[0], tags.get(JPEGIFBYTECOUNT, (0,))[0]
        self.interchange = data[at:size if not n or at + n > size else at + n] if 0 < at < size else b""
        self.photometric, self.samples = photometric, samples
        self.per_plane = samples if planes == 1 else 1  # components a JPEG stream
        self.hs, self.vs = subsampling_tag(tags) or (2, 2)
        self.forced = False
        self.restart = tags.get(JPEGRESTARTINTERVAL, (0,))[0] & 0xFFFF
        self.qtable, self.dctable, self.actable = {}, {}, {}
        self.sof = None  # (marker, height, width, [(id, hv, tq)])
        self.sos = [[0, 0] for _ in range(3)]  # (component id, DC << 4 | AC table) each
        self.sos_end = {}  # plane → (piece, position) where its entropy-coded data starts

    def correct_sampling(self) -> None:
        """``OJPEGSubsamplingCorrect``: three-sample YCbCr takes the first
        component's sampling from the header's SOF (the tag's where none
        comes before SOS or the header is cut short); sampling outside 1, 2
        and 4, or chroma not at 1×1, has libjpeg upsample instead."""
        if self.samples != 3 or self.photometric not in (6, 10):
            self.hs = self.vs = 1
            return
        try:
            self._header(correcting=True)
        except _Fail:
            pass
        if self.forced:
            self.hs = self.vs = 1

    def _header(self, correcting: bool) -> tuple[int, int]:
        """``OJPEGReadHeaderInfoSec``: the markers from the start of the
        JPEG data up to SOS → where the entropy-coded data starts (piece,
        position)."""
        src = _Source([self.interchange] + self.striles)
        while True:
            if src.peek() != 0xFF:
                break
            src.byte()
            m = src.byte()
            while m == 0xFF:
                m = src.byte()
            if m == SOI:
                pass
            elif m == COM or 0xE0 <= m <= 0xEF:
                n = src.word()
                if n < 2:
                    raise _Fail("a corrupt APPn or COM marker")
                src.skip(n - 2)
            elif m == DRI:
                if src.word() != 4:
                    raise _Fail("a corrupt DRI marker")
                self.restart = src.word()
            elif m == DQT:
                n = src.word()
                if n <= 2:
                    raise _Fail("a corrupt DQT marker")
                if correcting:
                    src.skip(n - 2)
                    continue
                n -= 2
                while n > 0:
                    if n < 65:
                        raise _Fail("a corrupt DQT marker")
                    body = src.block(65)
                    if body[0] & 15 > 3:
                        raise _Fail("a corrupt DQT marker")
                    self.qtable[body[0] & 15] = b"\xff\xdb\x00\x43" + body
                    n -= 65
            elif m == DHT:
                n = src.word()
                if n <= 2:
                    raise _Fail("a corrupt DHT marker")
                if correcting:
                    src.skip(n - 2)
                    continue
                body = src.block(n - 2)
                o = body[0]
                if o & 0xF0 not in (0, 16) or o & 15 > 3:
                    raise _Fail("a corrupt DHT marker")
                (self.actable if o & 16 else self.dctable)[o & 15] = bytes([0xFF, DHT, n >> 8, n & 255]) + body
            elif m in (SOF0, SOF1, SOF3):
                self._sof(src, m, correcting)
                if correcting:
                    break
            elif m == SOS:
                if correcting:
                    break
                self._sos(src, 0)
                break
            else:
                raise _Fail(f"marker 0x{m:02X} in its JPEG data (libtiff: unknown marker type)")
        return src.k, src.pos

    def _sof(self, src: _Source, marker: int, correcting: bool) -> None:
        """``OJPEGReadHeaderInfoSecStreamSof``."""
        if self.sof is not None:
            raise _Fail("a second SOF marker")
        lf = src.word()
        if lf < 11 or (lf - 8) % 3:
            raise _Fail("a corrupt SOF marker")
        n = (lf - 8) // 3
        if not correcting and n != self.samples:
            raise _Fail(f"a JPEG frame of {n} components for {self.samples} samples")
        if src.byte() != 8:
            raise _Fail("a JPEG frame of other than 8 bits a sample")
        if correcting:
            src.skip(4)
        else:
            y, x = src.word(), src.word()
            if y < self.height and y < self.sl_total:
                raise _Fail(f"a JPEG frame {y} rows tall for {self.height}")
            if x < self.width and x < self.sw:
                raise _Fail(f"a JPEG frame {x} columns wide for {self.width}")
            if x > self.sw:
                raise _Fail(f"a JPEG frame {x} columns wide, wider than its strip or tile ({self.sw})")
        if src.byte() != n:
            raise _Fail("a corrupt SOF marker")
        comps = []
        for q in range(n):
            cid, hv, tq = src.byte(), src.byte(), src.byte()
            if correcting:
                if q == 0:
                    self.hs, self.vs = hv >> 4, hv & 15
                    self.forced |= self.hs not in (1, 2, 4) or self.vs not in (1, 2, 4)
                else:
                    self.forced |= hv != 0x11
            elif not self.forced and hv != ((self.hs << 4 | self.vs) if q == 0 else 0x11):
                raise _Fail("JPEG sampling factors other than the file's (libtiff: unexpected subsampling values)")
            comps.append((cid, hv, tq))
        if not correcting:
            self.sof = (marker, y, x, comps)

    def _sos(self, src: _Source, plane: int) -> None:
        """``OJPEGReadHeaderInfoSecStreamSos``: the components of ``plane`` on
        (all of them, or the one of a separate plane) and their tables kept,
        Ss, Se, Ah and Al skipped."""
        if self.sof is None:
            raise _Fail("a SOS marker before SOF")
        if src.word() != 6 + 2 * self.per_plane or src.byte() != self.per_plane:
            raise _Fail("a corrupt SOS marker")
        for o in range(self.per_plane):
            self.sos[plane + o] = [src.byte(), src.byte()]
        src.skip(3)
        self.sos_end[plane] = (src.k, src.pos)

    def secondary_sos(self, plane: int) -> None:
        """``OJPEGReadSecondarySos``: a separate plane's SOS, searched for
        after the nearest plane before it whose SOS was found."""
        start = max(p for p in self.sos_end if p < plane)
        src = _Source([self.interchange] + self.striles)
        src.k, src.pos = self.sos_end[start]
        for p in range(start + 1, plane + 1):
            while True:
                if src.byte() == 0xFF:
                    m = src.byte()
                    while m == 0xFF:
                        m = src.byte()
                    if m == SOS:
                        break
            self._sos(src, p)

    def _tag_tables(self) -> None:
        """``OJPEGReadHeaderInfoSecTables*``: each component's quantisation
        table (64 bytes) and DC and AC Huffman tables (16 counts, then the
        symbols) at its tag's offset, as tables of the component's number."""
        data = self.data
        for tag, kind in ((JPEGQTABLES, "Q"), (JPEGDCTABLES, "DC"), (JPEGACTABLES, "AC")):
            offsets = _ints(self.tags, tag)
            if not offsets[0]:
                raise _Fail(f"no JPEG {kind} tables (libtiff: missing JPEG tables)")
            for m in range(self.samples):
                if offsets[m] and (m == 0 or offsets[m] != offsets[m - 1]):
                    if offsets[m] in offsets[:max(m - 1, 0)]:
                        raise _Fail(f"JPEG {kind} table offsets repeated out of turn")
                    at = offsets[m]
                    if kind == "Q":
                        body = data[at:at + 64]
                        if len(body) < 64:
                            raise _Fail("a JPEG table past the end of the file")
                        self.qtable[m] = b"\xff\xdb\x00\x43" + bytes([m]) + body
                        self.sof[3][m] = (m, self.sof[3][m][1], m)
                        continue
                    counts = data[at:at + 16]
                    q = sum(counts)
                    symbols = data[at + 16:at + 16 + q]
                    if len(counts) < 16 or len(symbols) < q:
                        raise _Fail("a JPEG table past the end of the file")
                    head = bytes([0xFF, DHT, (19 + q) >> 8 & 255, (19 + q) & 255])
                    if kind == "DC":
                        self.dctable[m] = head + bytes([m]) + counts + symbols
                        self.sos[m][1] = m << 4
                    else:
                        self.actable[m] = head + bytes([16 | m]) + counts + symbols
                        self.sos[m][1] |= m
                elif kind == "Q":
                    self.sof[3][m] = (m, self.sof[3][m][1], self.sof[3][m - 1][2])
                elif kind == "DC":
                    self.sos[m][1] = self.sos[m - 1][1]
                else:
                    self.sos[m][1] |= self.sos[m - 1][1] & 15

    def header(self) -> None:
        """``OJPEGReadHeaderInfo``: the checks on the layout, the restart
        interval, then the header from the file's JPEG data or the tags."""
        if self.samples not in (1, 3):
            _fail(f"{self.samples} samples a pixel (libtiff: not supported for this compression)")
        if self.sl < self.height:
            if self.hs not in (1, 2, 4) or self.vs not in (1, 2, 4):
                _fail(f"sampling {self.hs}x{self.vs} (libtiff: invalid subsampling values)")
            if self.sl % (self.vs * 8):
                _fail(f"strips or tiles of {self.sl} rows under vertical sampling {self.vs} (libtiff: incompatible)")
            self.restart = -(-self.sw // (self.hs * 8)) * (self.sl // (self.vs * 8)) & 0xFFFF
        try:
            self.sos_end[0] = self._header(correcting=False)
            if self.sof is None:  # no frame in the file's JPEG data: the tables from the tags
                self.sof = (SOF0, self.sl_total, self.sw,
                            [(o, (self.hs << 4 | self.vs) if o == 0 else 0x11, 0) for o in range(self.samples)])
                self._tag_tables()
                for o in range(1, self.samples):
                    self.sos[o][0] = o
        except _Fail as e:
            _fail(str(e))

    def stream(self, plane: int = 0) -> bytes:
        """``OJPEGWriteStream``: the stream libjpeg reads for ``plane`` (all
        the components, or a separate plane's one)."""
        marker, y, x, comps = self.sof
        comps, sos = comps[plane:plane + self.per_plane], self.sos[plane:plane + self.per_plane]
        head = b"\xff\xd8" + b"".join(t.get(i, b"") for t in (self.qtable, self.dctable, self.actable)
                                       for i in range(4))
        if self.restart:
            head += bytes([0xFF, DRI, 0, 4, self.restart >> 8, self.restart & 255])
        n = len(comps)
        head += bytes([0xFF, marker, 0, 8 + 3 * n, 8, y >> 8 & 255, y & 255, x >> 8 & 255, x & 255, n])
        head += b"".join(bytes(c) for c in comps)
        head += bytes([0xFF, SOS, 0, 6 + 2 * n, n]) + b"".join(bytes(c) for c in sos) + bytes([0, 63, 0])
        return head + self._entropy(*self.sos_end[plane])

    def _entropy(self, k: int, pos: int) -> bytes:
        """``OJPEGWriteStreamCompressed``: the data after the header's SOS,
        then each strip or tile; RSTn after one that gave data while more
        follow, EOI after the last — or no EOI where libtiff runs out of
        strips after an RSTn (libjpeg then meets the end of the data)."""
        pieces = [self.interchange] + self.striles
        out, rst, rest = [], 0, pieces[k][pos:]
        while True:
            if rest:
                out.append(rest)
                if k == len(pieces) - 1:
                    return b"".join(out) + b"\xff\xd9"
                if k:
                    out.append(bytes([0xFF, 0xD0 + rst]))
                    rst = (rst + 1) & 7
            k += 1
            if k == len(pieces):
                return b"".join(out)
            rest = pieces[k]


def _photometric(tags: dict) -> int:
    """libtiff's photometric for compression 6: YCbCr where the tag is
    missing or says RGB."""
    p = tags.get(PHOTOMETRIC, (6,))[0]
    return 6 if p == 2 else p


def _reads(codec: _Codec, frame: dict, rows_of, swab: bool) -> list:
    """libtiff's reads of the strips or tiles in turn, in libjpeg's output
    rows (eight an iMCU row: data-unit rows, or scanlines): for each, None
    where ``OJPEGPreDecode``'s skip to it fails, else (its first row, whether
    its decode fails). A failure leaves libjpeg failing from then on. libtiff
    counts a strip or tile read in its post-decode step — on a byte-swapped
    (big-endian) file the swapper's, set with BitsPerSample after the codec's
    own, takes its place: nothing is counted, and each strip or tile after
    the first is read after a skip of one more."""
    failed = frame["failed_mcu"]
    limit = failed // frame["mcux"] * 8 if failed is not None else None
    lps = -(-codec.sl // codec.vs)  # lines_per_strile
    out, cursor, done, dead = [], 0, 0, False
    for k in range(len(codec.striles)):
        while not dead and done < k:  # OJPEGPreDecodeSkip*: one strip or tile's rows
            dead = limit is not None and cursor + lps > limit
            cursor, done = cursor + lps, done + 1
        if dead:
            out.append(None)
            continue
        rows = rows_of(k)
        dead = limit is not None and cursor + rows > limit
        out.append((cursor, dead))
        cursor, done = cursor + rows, done + (not swab)
    return out


def _raw_buffer(plane: np.ndarray, comp: dict) -> np.ndarray:
    """A component as ``jpeg_read_raw_data`` leaves libtiff's buffer: the
    block columns past the component's real ones never written (zeros),
    the last iMCU row's block rows past its real ones keeping the row
    before's."""
    plane = plane.copy()
    plane[:, -(-comp["w"] // 8) * 8:] = 0
    step = comp["v"] * 8
    for r in range(-(-comp["h_px"] // 8) * 8, plane.shape[0]):
        plane[r] = plane[r - step] if r >= step else 0
    return plane


def old_jpeg_units(data: bytes, order: str, tags: dict) -> tuple[tuple, list]:
    """Three samples read through libtiff's RGBA interface → ((hs, vs), for
    each strip or tile: None where libtiff fails it before decoding, else
    its packed YCbCr data units as a (rows, units across, unit bytes)
    array — zeros where its decode fails), or ValueError where PIL refuses
    the file."""
    codec = _Codec(data, tags, _photometric(tags), tags.get(SAMPLES, (3,))[0])
    if codec.photometric != 6:
        _fail(f"three samples of photometric {codec.photometric}, which PIL does not read (decoder error)")
    codec.correct_sampling()
    hs, vs = codec.hs, codec.vs
    if (hs, vs) not in ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)):
        _fail(f"YCbCr subsampling {hs}x{vs} (libtiff: can not handle format)")
    codec.header()
    frame = _frame(codec)
    y, cb, cr = (_raw_buffer(p, c) for p, c in zip(_samples(frame), frame["comps"]))
    unit = hs * vs + 2
    units_across = -(-codec.sw // hs)
    total = -(-frame["height"] // (vs * 8)) * 8  # data-unit rows libjpeg gives; after them libtiff's buffer keeps
    # the last iMCU row's
    uy, ux = np.mgrid[0:total, 0:units_across]
    luma = np.stack([y[uy * vs + sy, ux * hs + sx] for sy in range(vs) for sx in range(hs)], -1)
    units = np.concatenate([luma, cb[uy, ux][..., None], cr[uy, ux][..., None]], -1).astype(np.uint8)
    rows_of = (lambda k: -(-codec.sl // vs)) if codec.tiled else (
        lambda k: -(-min(codec.sl, codec.height - k * codec.sl) // vs))
    out = []
    for k, read in enumerate(_reads(codec, frame, rows_of, order == ">")):
        if read is None:
            out.append(None)
            continue
        u = read[0] + np.arange(rows_of(k))
        u = np.where(u < total, u, total - 8 + u % 8)
        out.append(np.zeros_like(units[u]) if read[1] else units[u])  # a failed decode: libtiff zeroes the buffer
    return (hs, vs), out


def old_jpeg_gray(data: bytes, order: str, tags: dict) -> list:
    """One sample through libtiff's strip or tile reads → for each strip or
    tile, (its rows of samples, how many libjpeg gave: rows past the
    frame's last get none, PIL's buffer keeping what the strip or tile
    before left there), or ValueError where PIL refuses the file (any
    failure)."""
    codec = _Codec(data, tags, _photometric(tags), tags.get(SAMPLES, (1,))[0])
    if codec.photometric == 6:
        _fail("one sample of YCbCr (libtiff: invalid samples a pixel)")
    codec.correct_sampling()
    codec.header()
    frame = _frame(codec)
    plane = _planes(frame)[0].astype(np.uint8)
    rows_of = (lambda k: codec.sl) if codec.tiled else (lambda k: min(codec.sl, codec.height - k * codec.sl))
    out = []
    for k, read in enumerate(_reads(codec, frame, rows_of, order == ">")):
        if read is None or read[1]:
            _fail("a restart marker out of place in its JPEG data (libtiff: libjpeg error)")
        rows = plane[read[0]:read[0] + rows_of(k)]
        out.append((rows, len(rows)))
    return out


def old_jpeg_separate(data: bytes, order: str, tags: dict) -> list:
    """Three samples in separate planes through libtiff's RGBA interface
    (``putseparate8bitYCbCr11tile``: YCbCr at 1×1 only) → for each strip or
    tile, its Y, Cb and Cr rows: None where libtiff fails the read before
    decoding, zeros where the decode fails; or ValueError where PIL refuses
    the file. Each plane is its own JPEG stream of one component, its
    header's SOS searched for after the plane before's (``secondary_sos``),
    and the interface reads the planes in turn, so ``OJPEGPreDecode`` runs
    its session machine on every read (``_SeparateReads``)."""
    codec = _Codec(data, tags, _photometric(tags), tags.get(SAMPLES, (3,))[0], planes=3)
    if codec.photometric != 6:
        _fail(f"three samples of photometric {codec.photometric}, which PIL does not read (decoder error)")
    codec.correct_sampling()
    if (codec.hs, codec.vs) != (1, 1):
        _fail(f"YCbCr subsampling {codec.hs}x{codec.vs} in separate planes (libtiff: can not handle format)")
    codec.header()
    reads = _SeparateReads(codec, order == ">")
    out = [[None] * codec.per_image for _ in range(3)]
    for k in range(codec.per_image):
        for plane in range(3):
            out[plane][k] = reads.read(plane, k)
    return out


class _SeparateReads:
    """libtiff's old-style JPEG session over reads of separate planes: the
    live session (its plane, output row, strips read), libjpeg failed in it,
    or its data gone (a plane's SOS search that fails moves libtiff's
    source to the end under the live session); a header that fails leaves
    libjpeg's session open, which fails every later one."""

    def __init__(self, codec: _Codec, swab: bool):
        self.codec, self.swab = codec, swab
        self.lps = -(-codec.sl // codec.vs)
        self.planes, self.session, self.stuck = {}, None, False

    def _plane(self, plane: int):
        """(rows, the first row libjpeg fails at or None), or None where its
        header fails."""
        if plane not in self.planes:
            try:
                frame = _frame(self.codec, plane)
                failed = frame["failed_mcu"]
                self.planes[plane] = (_planes(frame)[0].astype(np.uint8),
                                      failed // frame["mcux"] * 8 if failed is not None else None)
            except ValueError:
                self.planes[plane] = None
        return self.planes[plane]

    def read(self, plane: int, k: int):
        codec, s = self.codec, self.session
        if plane not in codec.sos_end:
            try:
                codec.secondary_sos(plane)
            except _Fail:
                if s is not None:
                    s["gone"] = True
                return None
        if s is not None and (s["plane"] != plane or s["done"] > k):
            s = self.session = None
        if s is None:
            facts = None if self.stuck else self._plane(plane)
            if facts is None:
                self.stuck = True
                return None
            s = self.session = dict(plane=plane, row=0, done=0, gone=False, dead=False, facts=facts)
        rows, limit = s["facts"]
        while s["done"] < k:  # OJPEGPreDecodeSkipScanlines
            if s["gone"] or s["dead"] or limit is not None and s["row"] + self.lps > limit:
                s["dead"] = True
                return None
            s["row"], s["done"] = s["row"] + self.lps, s["done"] + 1
        n = codec.sl if codec.tiled else min(codec.sl, codec.height - k * codec.sl)
        if s["gone"] or s["dead"] or limit is not None and s["row"] + n > limit:
            s["dead"] = True
            return np.zeros((n, codec.sw), np.uint8)  # the decode fails: libtiff zeroes the buffer
        got = rows[s["row"]:s["row"] + n]
        s["row"] += n
        if not self.swab:  # OJPEGPostDecode: one more read; the plane's last ends the session
            s["done"] += 1
            if s["done"] % codec.per_image == 0:
                self.session = None
        return got


def _frame(codec: _Codec, plane: int = 0) -> dict:
    """The codec's stream (of ``plane``) decoded, with
    ``OJPEGWriteHeaderInfo``'s checks on what ``jpeg_start_decompress``
    reports."""
    frame = decode_old_jpeg_stream(codec.stream(plane))
    if frame["width"] != codec.sw:
        _fail(f"a JPEG frame {frame['width']} columns wide for strips or tiles of {codec.sw}")
    if (frame["hmax"], frame["vmax"]) != (codec.hs, codec.vs):
        _fail(f"JPEG sampling {frame['hmax']}x{frame['vmax']} where libtiff expects {codec.hs}x{codec.vs}")
    return frame
