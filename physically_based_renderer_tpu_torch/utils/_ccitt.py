"""CCITT bilevel decoding (TIFF compression 2, 3, 4 and 32771) in plain
Python — libtiff's ``tif_fax3.c`` as PIL's libtiff runs it, for
``utils/_tiff.py``.

Compression 2 (Modified Huffman) and 32771 (the same, each row ending on a
16-bit word): one-dimensional rows of white and black runs, each row from a
byte boundary. Compression 3 (T.4): an EOL before every row, then a
one-dimensional row, or with T4Options bit 0 a tag bit choosing a
one-dimensional or a two-dimensional row; fill bits before an EOL are
skipped as any run of zeros is. Compression 4 (T.6): two-dimensional rows,
no EOLs, an EOFB (or the end of the data) ending the strip early.
Uncompressed mode (the extension code) libtiff does not read: it ends the
row. Each strip or tile starts from an all-white reference row.

libtiff's split of faults is kept: a row that comes out too short or too
long (a premature EOL, a bad code) is warned about and cut or padded with
white as ``CLEANUP_RUNS`` does, and decoding goes on with the next row; the
end of the data before the last row fails the strip (PIL refuses the file),
but for T.6, where a strip that ends after its first row keeps the rows it
has, and for T.4 where the data ends after an EOL's zeros: libtiff 4.7 then
decodes "without EOL" (``FAXMODE_NOEOL``, for the rest of the image), the
bits read again from the strip's start into the row it was on. The bits
past the end read as zeros, libtiff's ``NeedBits`` padding. A
two-dimensional row's reference is libtiff's run buffer as the row before
left it: its runs, an imaginary change, then what older rows left there.
Rows come out as libtiff hands them to PIL: one bit a pixel, black 1.
"""

from __future__ import annotations

import numpy as np

# (code, run) for the white and black terminating and make-up codes, and
# the extended make-up codes both colours share (ITU-T T.4, tables 2 and 3)
WHITE_TERM = ("00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 "
              "110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 "
              "0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 "
              "00010111 00101000 00101001 00101010 00101011 00101100 00101101 00000100 00000101 00001010 "
              "00001011 01010010 01010011 01010100 01010101 00100100 00100101 01011000 01011001 01011010 "
              "01011011 01001010 01001011 00110010 00110011 00110100").split()
WHITE_MAKEUP = ("11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 "
                "011001101 011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 "
                "011011010 011011011 010011000 010011001 010011010 011000 010011011").split()
BLACK_TERM = ("0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 "
              "00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 "
              "00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 000011001100 "
              "000011001101 000001101000 000001101001 000001101010 000001101011 000011010010 000011010011 "
              "000011010100 000011010101 000011010110 000011010111 000001101100 000001101101 000011011010 "
              "000011011011 000001010100 000001010101 000001010110 000001010111 000001100100 000001100101 "
              "000001010010 000001010011 000000100100 000000110111 000000111000 000000100111 000000101000 "
              "000001011000 000001011001 000000101011 000000101100 000001011010 000001100110 "
              "000001100111").split()
BLACK_MAKEUP = ("0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
                "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 "
                "0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 "
                "0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
                "0000001100100 0000001100101").split()
EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 "
              "000000010110 000000010111 000000011100 000000011101 000000011110 000000011111").split()
# the two-dimensional mode codes: pass, horizontal, vertical 0 / right 1-3 / left 1-3, extension
PASS, HORIZ, V0, VR, VL, EXT, EOL, TERM, MAKEUP, BAD = range(10)
MODE_CODES = [("0001", PASS, 0), ("001", HORIZ, 0), ("1", V0, 0), ("011", VR, 1), ("000011", VR, 2),
              ("0000011", VR, 3), ("010", VL, 1), ("000010", VL, 2), ("0000010", VL, 3), ("0000001", EXT, 0),
              ("0000000", EOL, 0)]

_TABLES = {}


def _table(width: int, codes: list) -> list:
    """A lookup table on the next ``width`` bits (most significant first):
    (kind, value, code length) for every prefix; BAD where no code fits."""
    tab = [(BAD, 0, 0)] * (1 << width)
    for code, kind, value in codes:
        shift = width - len(code)
        first = int(code, 2) << shift
        tab[first:first + (1 << shift)] = [(kind, value, len(code))] * (1 << shift)
    return tab


def _tables() -> tuple:
    """The white (12-bit), black (13-bit) and mode (7-bit) tables, as
    ``mkg3states`` lays them out: 11 zero bits an EOL in the run tables,
    7 in the mode table."""
    if not _TABLES:
        shared = [(c, MAKEUP, 1792 + 64 * i) for i, c in enumerate(EXT_MAKEUP)] + [("0" * 11, EOL, 0)]
        _TABLES["white"] = _table(12, [(c, TERM, i) for i, c in enumerate(WHITE_TERM)]
                                  + [(c, MAKEUP, 64 * (i + 1)) for i, c in enumerate(WHITE_MAKEUP)] + shared)
        _TABLES["black"] = _table(13, [(c, TERM, i) for i, c in enumerate(BLACK_TERM)]
                                  + [(c, MAKEUP, 64 * (i + 1)) for i, c in enumerate(BLACK_MAKEUP)] + shared)
        _TABLES["mode"] = _table(7, MODE_CODES)
    return _TABLES["white"], _TABLES["black"], _TABLES["mode"]


class _EOF(Exception):
    """libtiff's ``NeedBits`` found no bits left."""


class _NoEOL(Exception):
    """``SYNC_EOL`` found the data ending after an EOL's zeros."""


class _Bits:
    """libtiff's bit accumulator over one strip: bits most significant
    first, bytes loaded one at a time as ``NeedBits8`` / ``NeedBits16``
    load them, zeros past the end until a need finds the accumulator
    empty."""

    def __init__(self, data: bytes):
        self.n = len(data)
        b = np.frombuffer(bytes(data) + bytes(80), np.uint8).astype(np.uint64)
        w = np.zeros(self.n + 72, np.uint64)
        for k in range(8):
            w |= b[k:k + self.n + 72] << np.uint64(56 - 8 * k)
        self.windows = w.tolist()
        self.pos = self.avail = self.cp = 0

    def need(self, n: int, wide: bool = False) -> None:
        if self.avail >= n:
            return
        if self.cp >= self.n:
            if self.avail == 0:
                raise _EOF
            self.avail = n
            return
        self.cp += 1
        self.avail += 8
        if wide and self.avail < n:
            if self.cp >= self.n:
                self.avail = n
            else:
                self.cp += 1
                self.avail += 8

    def peek(self, n: int) -> int:
        p = self.pos
        return (self.windows[p >> 3] >> (64 - (p & 7) - n)) & ((1 << n) - 1)

    def clear(self, n: int) -> None:
        self.pos += n
        self.avail -= n

    def lookup(self, tab: list, width: int, wide: bool) -> tuple:
        self.need(width, wide)
        entry = tab[self.peek(width)]
        self.clear(entry[2])
        return entry


class _Row:
    """One row's runs as libtiff builds them (``SETVALUE``,
    ``CLEANUP_RUNS``): white first, alternating; ``a0`` the position
    reached, ``pending`` the run length not yet set."""

    def __init__(self, lastx: int):
        self.runs, self.a0, self.pending, self.lastx = [], 0, 0, lastx

    def set(self, x: int) -> None:
        self.runs.append(self.pending + x)
        self.a0 += x
        self.pending = 0

    def cleanup(self) -> None:
        if self.pending:
            self.set(0)
        if self.a0 != self.lastx:  # libtiff warns of a bad line length and pads with white
            while self.a0 > self.lastx and self.runs:
                self.a0 -= self.runs.pop()
            if self.a0 < self.lastx:
                self.a0 = max(self.a0, 0)
                if len(self.runs) & 1:
                    self.set(0)
                self.set(self.lastx - self.a0)
            elif self.a0 > self.lastx:
                self.set(self.lastx)
                self.set(0)


def _run(bits: _Bits, row: _Row, tab: list, width: int) -> int:
    """One run of a colour: make-up codes, then a terminating code, set. →
    TERM, or the kind of the code that ends the row instead (EOL, BAD)."""
    while True:
        kind, value, _ = bits.lookup(tab, width, True)
        if kind == TERM:
            row.set(value)
            return TERM
        if kind != MAKEUP:
            return kind
        row.a0 += value
        row.pending += value


def _expand1d(bits: _Bits, row: _Row, white: list, black: list) -> bool:
    """``EXPAND1D``: white and black runs until the row is full. → True
    where an EOL ended it."""
    while True:
        for tab, width in ((white, 12), (black, 13)):
            kind = _run(bits, row, tab, width)
            if kind != TERM or row.a0 >= row.lastx:
                row.cleanup()
                return kind == EOL
        if len(row.runs) >= 2 and row.runs[-1] == 0 and row.runs[-2] == 0:
            del row.runs[-2:]


def _expand2d(bits: _Bits, row: _Row, ref: list, white: list, black: list, mode: list) -> bool:
    """``EXPAND2D``: mode codes against the reference row's runs ``ref``
    until the row is full. → True where an EOL ended it."""
    lastx = row.lastx
    b1, pb = ref[0], 1
    eol = False

    def check_b1():
        nonlocal b1, pb
        if row.runs:
            while b1 <= row.a0 and b1 < lastx:
                b1 += ref[pb] + ref[pb + 1]
                pb += 2

    while row.a0 < lastx:
        kind, value, _ = bits.lookup(mode, 7, False)
        if kind == PASS:
            check_b1()
            b1 += ref[pb]
            pb += 1
            row.pending += b1 - row.a0
            row.a0 = b1
            b1 += ref[pb]
            pb += 1
        elif kind == HORIZ:
            first, second = (black, white) if len(row.runs) & 1 else (white, black)
            widths = (13, 12) if len(row.runs) & 1 else (12, 13)
            if _run(bits, row, first, widths[0]) != TERM or _run(bits, row, second, widths[1]) != TERM:
                break  # an EOL or a bad code: libtiff reports it and ends the row
            check_b1()
        elif kind in (V0, VR):
            check_b1()
            row.set(b1 - row.a0 + value)
            b1 += ref[pb]
            pb += 1
        elif kind == VL:
            check_b1()
            if b1 < row.a0 + value:
                break
            row.set(b1 - row.a0 - value)
            pb -= 1
            b1 -= ref[pb]
        elif kind == EXT:  # uncompressed mode, which libtiff does not read: the row ends
            row.runs.append(lastx - row.a0)
            break
        elif kind == EOL:
            row.runs.append(lastx - row.a0)
            bits.need(4)
            bits.clear(4)
            eol = True
            break
        else:
            break
    else:
        if row.pending:
            row.set(0)
    row.cleanup()
    return eol


def _sync_eol(bits: _Bits, seen: bool) -> None:
    """``SYNC_EOL``: unless an EOL was met already, bits skipped one at a
    time up to 11 zeros; then zero bytes, zero bits, and the EOL's 1 (the
    data ending among those zeros: ``_NoEOL``)."""
    if not seen:
        while True:
            bits.need(11, True)
            if bits.peek(11) == 0:
                break
            bits.clear(1)
    while True:
        try:
            bits.need(8)
        except _EOF:
            raise _NoEOL from None
        if bits.peek(8):
            break
        bits.clear(8)
    while bits.peek(1) == 0:
        bits.clear(1)
    bits.clear(1)


def _fill(runs: list, lastx: int) -> np.ndarray:
    """``_TIFFFax3fillruns``: runs → a row of pixels (black 1); each run is
    cut at the row's end in ``runs`` itself, which then serves as the next
    row's reference."""
    row = np.zeros(lastx, np.uint8)
    x = 0
    for i, r in enumerate(runs):
        if x + r > lastx or r > lastx:
            r = runs[i] = lastx - x
        if i & 1:
            row[x:x + r] = 1
        x += r
    return row


def decode_ccitt(data: bytes, compression: int, width: int, rows: int, t4options: int = 0,
                 offset: int = 0, state: dict | None = None) -> bytes:
    """One strip or tile → ``rows`` rows of ``width`` pixels, one bit each,
    each row padded to a byte (black 1); ``offset``, the data's position in
    the file, sets where a 32771 row's 16-bit word starts. ``state``, one
    dict for all the strips or tiles of an image: libtiff's no-EOL mode and
    its two run buffers, which outlive a strip."""
    white, black, mode = _tables()
    state = {} if state is None else state
    bits = _Bits(data)
    out = np.zeros((rows, width), np.uint8)
    two_d = compression == 4 or compression == 3 and t4options & 1
    if two_d:  # Fax3PreDecode: the current row in the first buffer, the reference (all white) in the second
        nruns = 2 * -(-(width + 1) // 32) * 32
        cur, ref = state.setdefault("runs", ([0] * nruns, [0] * nruns))
        ref[:2] = [width, 0]
    seen_eol = False
    line = 0
    while line < rows:
        row = _Row(width)
        try:
            if compression in (2, 32771):
                _expand1d(bits, row, white, black)
            elif compression == 3:
                if not state.get("no_eol"):
                    try:
                        _sync_eol(bits, seen_eol)
                    except _NoEOL:  # libtiff warns and decodes the strip again from its start, no EOLs
                        state["no_eol"], bits, seen_eol = True, _Bits(data), False
                        continue
                if t4options & 1:
                    bits.need(1)
                    one_d = bits.peek(1)
                    bits.clear(1)
                    seen_eol = (_expand1d(bits, row, white, black) if one_d
                                else _expand2d(bits, row, ref, white, black, mode))
                else:
                    seen_eol = _expand1d(bits, row, white, black)
            elif _expand2d(bits, row, ref, white, black, mode):  # an EOFB (or an EOL) ends a T.6 strip
                out[line] = _fill(row.runs, width)
                if line == 0:
                    raise ValueError("TIFF: a CCITT T.6 strip that ends in its first row (libtiff: premature EOF)")
                break
        except (_EOF, IndexError):
            if compression == 4 and line > 0 and data:
                row.cleanup()
                out[line] = _fill(row.runs, width)
                break  # kept: the rows after stay white (PIL leaves them as its buffer held them)
            raise ValueError("TIFF: CCITT data ends before its strip or tile (libtiff: premature EOF)") from None
        out[line] = _fill(row.runs, width)
        line += 1
        if compression == 2:  # each row from a byte boundary
            bits.clear(bits.avail % 8)
        elif compression == 32771:  # each row from a 16-bit word
            bits.clear(bits.avail % 16)
            if bits.avail == 0 and (offset + bits.cp) & 1:
                bits.cp += 1
                bits.pos += 8
        if two_d:  # the row's runs and an imaginary change, over what the buffer held; then the buffers swap
            n = min(len(row.runs), nruns)
            cur[:n] = row.runs[:n]
            if n < nruns:
                cur[n] = 0
            cur, ref = ref, cur
    return np.packbits(out, axis=1).tobytes()
