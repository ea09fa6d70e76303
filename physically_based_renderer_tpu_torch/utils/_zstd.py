"""Zstandard (RFC 8878) decoding with NumPy and plain Python — the codec of
TIFF compression 50000 in ``utils/_tiff.py``, with libtiff's use of libzstd.

Frames: the header (descriptor, window, dictionary id — a frame that names a
dictionary is refused, as libzstd refuses it with none loaded —, content
size), skippable frames, raw, RLE and compressed blocks, the content
checksum (the low 32 bits of XXH64). Literals: raw, RLE, and Huffman-coded
in one or four streams, the table read from FSE-compressed or 4-bit
weights, treeless literals reusing the last table. Sequences: predefined,
RLE, FSE and repeat modes for the literal lengths, offsets and match
lengths, the three repeat offsets with the literal-length-0 rule, and
matches that overlap their own output.

The Huffman literals are decoded without a loop over symbols: each stream's
bits are put in reading order, a table lookup at every bit position gives
the symbol and code length starting there, and the chain of positions the
decode visits is walked eight codes at a step. The sequences are a Python
loop over precomputed 64-bit windows of their bit stream.

``decode_zstd_strip`` is libtiff's ``ZSTDDecode``: the first frame of a
strip or tile (a skippable frame gives nothing), decoded until the strip's
size is out; a frame that ends short of it is refused, a frame longer than
it is cut, its later blocks and checksum unread. ``decompress`` is the
RFC's reading of a whole stream: every frame, skippable ones skipped.
"""

from __future__ import annotations

import numpy as np

MAGIC = 0xFD2FB528
BLOCK_MAX = 1 << 17
WINDOW_LOG_MAX = 27  # libzstd's default limit for a streaming decoder (ZSTD_WINDOWLOG_LIMIT_DEFAULT)
HUF_LOG_MAX = 12  # libzstd's HUF_TABLELOG_MAX

# literal-length and match-length codes → (baseline, extra bits)
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6), (128, 7), (256, 8),
    (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4), (99, 5), (131, 7),
    (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15), (65539, 16)]
# the predefined distributions (RFC 8878 §3.1.1.3.2.2) and accuracy logs
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
               -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# (max accuracy log, max symbol) of the literal-length, offset and match-length tables
LIMITS = {"LL": (9, 35), "OF": (8, 31), "ML": (9, 52)}


# -- bit streams ---------------------------------------------------------------------------


def _forward_bits(stream: bytes) -> tuple[np.ndarray, int, int]:
    """A backward bit stream (read from its last byte's highest bit below the
    end marker, down to the first byte's bit 0) in reading order: (its bytes
    reversed, with 8 zero bytes after, as uint8; the first data bit's
    position, most significant bit first; the number of data bits)."""
    if not stream or stream[-1] == 0:
        raise ValueError("zstd: a bit stream without its end marker (libzstd: corruption detected)")
    start = 8 - int(stream[-1]).bit_length() + 1
    b = np.frombuffer(stream[::-1] + bytes(8), np.uint8)
    return b, start, 8 * len(stream) - start


class _BackwardBits:
    """A backward bit stream read through 64-bit windows at every byte."""

    def __init__(self, stream: bytes):
        b, self.pos, self.total = _forward_bits(stream)
        self.end = self.pos + self.total
        w = np.zeros(len(b) - 7, np.uint64)
        for k in range(8):
            w |= b[k:len(b) - 7 + k].astype(np.uint64) << np.uint64(56 - 8 * k)
        self.windows = w.tolist()

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        return (self.windows[p >> 3] >> (64 - (p & 7) - n)) & ((1 << n) - 1) if n else 0


# -- FSE -------------------------------------------------------------------------------------


def read_fse_table(data: bytes, pos: int, max_log: int, max_symbol: int) -> tuple[list, int, int]:
    """An FSE table description (``FSE_readNCount``) at ``data[pos:]`` →
    (normalised counts, accuracy log, bytes used)."""
    end = len(data)

    def bits_at(bit):  # 32 bits from bit offset ``bit`` (little-endian), zeros past the end
        at = pos + (bit >> 3)
        return int.from_bytes(data[at:min(at + 5, end)].ljust(5, b"\0"), "little") >> (bit & 7)

    if pos >= end:
        raise ValueError("zstd: an FSE table description past the end of its block")
    log = (data[pos] & 15) + 5
    if log > max_log:
        raise ValueError(f"zstd: an FSE accuracy log of {log} (libzstd: table log too large)")
    bit, remaining, threshold, nbits = 4, (1 << log) + 1, 1 << log, log + 1
    counts, previous0 = [], False
    while True:
        if previous0:
            while True:
                rep = bits_at(bit) & 3
                bit += 2
                counts += [0] * rep
                if rep < 3:
                    break
            if len(counts) > max_symbol:
                break
        v = bits_at(bit)
        most = 2 * threshold - 1 - remaining
        if v & (threshold - 1) < most:
            count = v & (threshold - 1)
            bit += nbits - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= most
            bit += nbits
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        previous0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nbits = remaining.bit_length()
            threshold = 1 << (nbits - 1)
        if len(counts) > max_symbol:
            break
    used = (bit + 7) >> 3
    if remaining != 1 or len(counts) > max_symbol + 1 or pos + used > end:
        raise ValueError("zstd: a corrupt FSE table description (libzstd: corruption detected)")
    return counts, log, used


def build_fse(counts: list, log: int) -> tuple[list, list, list]:
    """``FSE_buildDTable``: the decoding table of a normalised distribution
    → (symbol, bits to read, next state base) for every state."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step = (size >> 1) + (size >> 3) + 3
    position = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[position] = s
            position = (position + step) & (size - 1)
            while position > high:
                position = (position + step) & (size - 1)
    if position != 0:
        raise ValueError("zstd: an FSE distribution that does not fill its table (libzstd: corruption detected)")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        state = nxt[symbols[u]]
        nxt[symbols[u]] += 1
        nbits[u] = log - (state.bit_length() - 1)
        base[u] = (state << nbits[u]) - size
    return symbols, nbits, base


# -- Huffman literals --------------------------------------------------------------------------


def _huffman_weights(data: bytes, pos: int) -> tuple[list, int]:
    """The Huffman tree description at ``data[pos:]`` → (weights of symbols
    0..n-1 before the implied last one, bytes used)."""
    header = data[pos]
    if header >= 128:
        n = header - 127
        raw = data[pos + 1:pos + 1 + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            raise ValueError("zstd: Huffman weights past the end of the block (libzstd: srcSize wrong)")
        weights = [w for b in raw for w in (b >> 4, b & 15)][:n]
        return weights, 1 + (n + 1) // 2
    size = header
    body = data[pos + 1:pos + 1 + size]
    if len(body) < size or size == 0:
        raise ValueError("zstd: Huffman weights past the end of the block (libzstd: srcSize wrong)")
    counts, log, used = read_fse_table(body, 0, 6, 255)
    symbols, nbits, base = build_fse(counts, log)
    bits = _BackwardBits(body[used:])
    try:
        return _fse_weights(bits, log, symbols, nbits, base), 1 + size
    except IndexError:
        raise ValueError("zstd: Huffman weights read past their stream (libzstd: corruption detected)") from None


def _fse_weights(bits, log: int, symbols: list, nbits: list, base: list) -> list:
    s1, s2 = bits.read(log), bits.read(log)
    weights = []
    while True:  # two interleaved states until the stream runs out (FSE_decompress_usingDTable_generic)
        weights.append(symbols[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.pos > bits.end:
            weights.append(symbols[s2])
            break
        weights.append(symbols[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.pos > bits.end:
            weights.append(symbols[s1])
            break
        if len(weights) > 255:
            raise ValueError("zstd: too many Huffman weights (libzstd: corruption detected)")
    if len(weights) > 255:
        raise ValueError("zstd: too many Huffman weights (libzstd: corruption detected)")
    return weights


def build_huffman(weights: list) -> tuple[np.ndarray, np.ndarray, int]:
    """``HUF_readStats`` and the decoding table: the implied last weight,
    then for every ``log``-bit code prefix its symbol and code length."""
    if any(w > HUF_LOG_MAX for w in weights):
        raise ValueError("zstd: a Huffman weight past the table's limit (libzstd: corruption detected)")
    total = sum((1 << w) >> 1 for w in weights)
    if total == 0:
        raise ValueError("zstd: Huffman weights that are all zero (libzstd: corruption detected)")
    log = total.bit_length()
    rest = (1 << log) - total
    if log > HUF_LOG_MAX or rest & (rest - 1):
        raise ValueError("zstd: Huffman weights that do not sum to a power of 2 (libzstd: corruption detected)")
    weights = list(weights) + [rest.bit_length()]
    if sum(w == 1 for w in weights) < 2 or sum(w == 1 for w in weights) & 1:
        raise ValueError("zstd: an invalid Huffman tree (libzstd: corruption detected)")
    symbols = np.zeros(1 << log, np.uint8)
    lengths = np.zeros(1 << log, np.int64)
    at = 0
    for w in range(1, log + 1):
        for s, sw in enumerate(weights):
            if sw == w:
                symbols[at:at + (1 << (w - 1))] = s
                lengths[at:at + (1 << (w - 1))] = log + 1 - w
                at += 1 << (w - 1)
    return symbols, lengths, log


def _huffman_stream(stream: bytes, n: int, table: tuple, exact: bool = True, before: bytes = b"") -> np.ndarray:
    """One Huffman stream → its ``n`` symbols: the code at every bit
    position by one lookup, then the positions the decode visits walked
    eight codes at a step. ``exact``: the stream must end exactly after
    them; else (libzstd's fast four-stream loop) it may end anywhere, its
    bits past its start read from the bytes ``before`` it."""
    symbols, lengths, log = table
    b, start, total = _forward_bits(stream)
    if before:
        b = np.concatenate([b[:-8], np.frombuffer(before[::-1], np.uint8), b[-8:]])
    span = total + 8 * HUF_LOG_MAX + 8
    p = np.arange(start, start + span)
    v = (b[:-2].astype(np.int64) << 16 | b[1:-1].astype(np.int64) << 8 | b[2:].astype(np.int64))
    code = (v[np.minimum(p >> 3, len(v) - 1)] >> (24 - log - (p & 7))) & ((1 << log) - 1)
    step1 = np.minimum(np.arange(span) + lengths[code], span - 1)
    step2 = step1[step1]
    step4 = step2[step2]
    step8 = step4[step4].tolist()
    heads, q = [], 0
    for _ in range((n + 7) // 8):
        heads.append(q)
        q = step8[q]
    q = np.asarray(heads, np.int64)
    s2, s4 = step2[q], step4[q]
    s6 = step2[s4]
    at = np.stack([q, step1[q], s2, step1[s2], s4, step1[s4], s6, step1[s6]], 1).reshape(-1)[:n]
    if exact and n and step1[at[-1]] != total:
        raise ValueError("zstd: a Huffman stream that does not end with its literals (libzstd: corruption detected)")
    return symbols[code[at]]


def _literals(data: bytes, pos: int, state: dict) -> tuple[bytes, int]:
    """The literals section at ``data[pos:]`` → (literals, bytes used)."""
    if pos >= len(data):
        raise ValueError("zstd: a block without its literals section (libzstd: corruption detected)")
    h0 = data[pos]
    kind, fmt = h0 & 3, (h0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, used = h0 >> 3, 1
        elif fmt == 1:
            size, used = (h0 >> 4) + (data[pos + 1] << 4), 2
        else:
            size, used = (h0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), 3
        if pos + used > len(data):
            raise ValueError("zstd: a literals header past the end of its block (libzstd: corruption detected)")
        if size > BLOCK_MAX:
            raise ValueError("zstd: more literals than a block holds (libzstd: corruption detected)")
        if kind == 0:
            lit = data[pos + used:pos + used + size]
            if len(lit) < size:
                raise ValueError("zstd: raw literals past the end of their block (libzstd: corruption detected)")
            return lit, used + size
        if pos + used >= len(data):
            raise ValueError("zstd: RLE literals without their byte (libzstd: corruption detected)")
        return bytes([data[pos + used]]) * size, used + 1
    nhead = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    if pos + nhead > len(data):
        raise ValueError("zstd: a literals header past the end of its block (libzstd: corruption detected)")
    v = int.from_bytes(data[pos:pos + nhead], "little")
    bits = {3: 10, 4: 14, 5: 18}[nhead]
    size, csize = (v >> 4) & ((1 << bits) - 1), v >> (4 + bits)
    streams = 1 if fmt == 0 else 4
    if size > BLOCK_MAX:
        raise ValueError("zstd: more literals than a block holds (libzstd: corruption detected)")
    if streams == 4 and size < 6:
        raise ValueError("zstd: four literal streams of fewer than 6 literals (libzstd: literals header wrong)")
    body = data[pos + nhead:pos + nhead + csize]
    if len(body) < csize:
        raise ValueError("zstd: Huffman literals past the end of their block (libzstd: corruption detected)")
    at = 0
    if kind == 2:
        weights, at = _huffman_weights(body, 0)
        state["huffman"] = build_huffman(weights)
    elif state.get("huffman") is None:
        raise ValueError("zstd: treeless literals with no table before them (libzstd: dictionary corrupted)")
    table = state["huffman"]
    if streams == 1:
        lit = _huffman_stream(body[at:], size, table)
    else:
        if csize - at < 10:
            raise ValueError("zstd: four literal streams in under 10 bytes (libzstd: corruption detected)")
        s1, s2, s3 = (int.from_bytes(body[at + 2 * k:at + 2 * k + 2], "little") for k in range(3))
        starts = [at + 6, at + 6 + s1, at + 6 + s1 + s2, at + 6 + s1 + s2 + s3]
        if starts[3] > csize:
            raise ValueError("zstd: a literal stream past the end of its block (libzstd: corruption detected)")
        quarter = (size + 3) // 4
        counts = [quarter, quarter, quarter, size - 3 * quarter]
        ends = starts[1:] + [csize]
        # libzstd's fast loop (every stream of 8 bytes or more, a table of 11 bits or fewer) checks only that
        # each stream gives its literals, reading past a stream's start into the bytes before it
        fast = min(e - a for a, e in zip(starts, ends)) >= 8 and table[2] <= 11 and 3 * quarter < size
        lit = np.concatenate([_huffman_stream(body[a:e], c, table, not fast, body[at:a] if fast else b"")
                              for a, e, c in zip(starts, ends, counts)])
    return lit.tobytes(), nhead + csize


# -- sequences -----------------------------------------------------------------------------------


def _table(kind: str, mode: int, data: bytes, pos: int, state: dict) -> int:
    """One of the three tables of a sequences section (mode 0 predefined,
    1 RLE, 2 FSE-coded, 3 the last block's) set in ``state``; → bytes used."""
    max_log, max_symbol = LIMITS[kind]
    if mode == 0:
        counts, log = {"LL": LL_DEFAULT, "OF": OF_DEFAULT, "ML": ML_DEFAULT}[kind]
        state[kind] = _state_table(kind, *build_fse(counts, log), log)
        return 0
    if mode == 1:
        if pos >= len(data) or data[pos] > max_symbol:
            raise ValueError(f"zstd: an RLE {kind} symbol past its range (libzstd: corruption detected)")
        state[kind] = _state_table(kind, [data[pos]], [0], [0], 0)
        return 1
    if mode == 2:
        counts, log, used = read_fse_table(data, pos, max_log, max_symbol)
        state[kind] = _state_table(kind, *build_fse(counts, log), log)
        return used
    if state.get(kind) is None:
        raise ValueError(f"zstd: a repeated {kind} table with none before it (libzstd: corruption detected)")
    return 0


def _state_table(kind: str, symbols: list, nbits: list, base: list, log: int) -> tuple:
    """A decoding table by state: the literal-length and match-length codes'
    baselines and extra bits, the offset codes themselves; then each state's
    bits to read, next state base, and the accuracy log."""
    if kind == "OF":
        return symbols, nbits, base, log
    codes = LL_CODES if kind == "LL" else ML_CODES
    return [codes[s][0] for s in symbols], [codes[s][1] for s in symbols], nbits, base, log


def _sequences(data: bytes, pos: int, state: dict) -> list:
    """The sequences section at ``data[pos:]`` (to the block's end) → the
    literal lengths, match lengths and offsets, the repeat offsets in
    ``state`` updated."""
    if pos >= len(data):
        raise ValueError("zstd: a block without its sequences section (libzstd: corruption detected)")
    b0 = data[pos]
    if b0 == 0:
        if pos + 1 != len(data):
            raise ValueError("zstd: bytes after an empty sequences section (libzstd: srcSize wrong)")
        return [], [], []
    if b0 < 128:
        n, pos = b0, pos + 1
    elif b0 < 255:
        if pos + 2 > len(data):
            raise ValueError("zstd: a sequences header past the end of its block (libzstd: srcSize wrong)")
        n, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        if pos + 3 > len(data):
            raise ValueError("zstd: a sequences header past the end of its block (libzstd: srcSize wrong)")
        n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if pos >= len(data):
        raise ValueError("zstd: a sequences section without its modes (libzstd: srcSize wrong)")
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ValueError("zstd: reserved bits set in the sequence modes (libzstd: corruption detected)")
    for kind, shift in (("LL", 6), ("OF", 4), ("ML", 2)):
        pos += _table(kind, (modes >> shift) & 3, data, pos, state)
    bits = _BackwardBits(data[pos:])
    try:
        return _decode_sequences(n, bits, state)
    except IndexError:  # read far past the stream's start
        raise ValueError("zstd: a sequences bit stream read past its start (libzstd: corruption detected)") from None


def _decode_sequences(n: int, bits: _BackwardBits, state: dict) -> tuple[list, list, list]:
    """The FSE decode of ``n`` sequences: one read of each sequence's extra
    bits (offset, match length, literal length), one of its three state
    updates (literal length, match length, offset)."""
    lb, le, lnb, lbase, llog = state["LL"]
    oc_, onb, obase, olog = state["OF"]
    mb, me, mnb, mbase, mlog = state["ML"]
    w, p = bits.windows, bits.pos
    k = llog + olog + mlog
    v = (w[p >> 3] >> (64 - (p & 7) - k)) & ((1 << k) - 1)
    p += k
    ll, of, ml = v >> (olog + mlog), (v >> mlog) & ((1 << olog) - 1), v & ((1 << mlog) - 1)
    rep0, rep1, rep2 = state["rep"]
    lits_, matches, offsets = [0] * n, [0] * n, [0] * n
    last = n - 1
    for i in range(n):
        oc, ne, nl = oc_[of], me[ml], le[ll]
        k = oc + ne + nl
        if k <= 56:
            v = (w[p >> 3] >> (64 - (p & 7) - k)) & ((1 << k) - 1)
        else:  # wider than one window: the three fields read one by one
            v, q = 0, p
            for f in (oc, ne, nl):
                v = (v << f) | ((w[q >> 3] >> (64 - (q & 7) - f)) & ((1 << f) - 1))
                q += f
        p += k
        lits = lb[ll] + (v & ((1 << nl) - 1))
        v >>= nl
        match = mb[ml] + (v & ((1 << ne) - 1))
        value = (1 << oc) + (v >> ne)
        if value > 3:
            rep2, rep1, rep0 = rep1, rep0, value - 3
        else:
            r = value - (lits != 0)  # 0, 1, 2: rep 1, 2, 3; with no literals 1 → rep 2, 2 → rep 3, 3 → rep 1 − 1
            if r:
                offset = rep1 if r == 1 else rep2 if r == 2 else rep0 - 1
                if offset == 0:
                    raise ValueError("zstd: a repeat offset of 0 (libzstd: corruption detected)")
                if r != 1:
                    rep2 = rep1
                rep1, rep0 = rep0, offset
        lits_[i], matches[i], offsets[i] = lits, match, rep0
        if i != last:
            a, b, c = lnb[ll], mnb[ml], onb[of]
            k = a + b + c
            v = (w[p >> 3] >> (64 - (p & 7) - k)) & ((1 << k) - 1)
            p += k
            of = obase[of] + (v & ((1 << c) - 1))
            v >>= c
            ml = mbase[ml] + (v & ((1 << b) - 1))
            ll = lbase[ll] + (v >> b)
    state["rep"] = [rep0, rep1, rep2]
    if p != bits.end:
        raise ValueError("zstd: a sequences bit stream that does not end with its sequences (libzstd: corruption "
                        "detected)")
    return lits_, matches, offsets


def _execute(out: bytearray, frame_start: int, literals: bytes, seqs: tuple) -> None:
    """A block's literals and matches appended to ``out`` (the frame's
    content from ``frame_start``) without a loop over sequences: every new
    byte points at a literal or at the byte its match copies, and the
    pointers into the block are followed by doubling until each names a
    literal or a byte of the frame before the block. A match reaching
    before the frame is refused."""
    lens, matches, offsets = (np.asarray(x, np.int64) for x in seqs)
    n = len(lens)
    nlit = int(lens.sum())
    if nlit > len(literals):
        raise ValueError("zstd: sequences past the end of the literals (libzstd: corruption detected)")
    if n == 0:
        out += literals
        return
    base = len(out)
    seg = np.empty(2 * n + 1, np.int64)
    seg[0:-1:2], seg[1::2], seg[-1] = lens, matches, len(literals) - nlit
    seg_start = np.concatenate([[0], np.cumsum(seg)[:-1]])
    match_start = base + seg_start[1::2]
    if np.any(offsets > match_start - frame_start):
        raise ValueError("zstd: a match before the start of the frame (libzstd: corruption detected)")
    total = int(seg_start[-1] + seg[-1])
    seg_id = np.repeat(np.arange(2 * n + 1), seg)
    at = np.arange(total)
    lit_start = np.concatenate([[0], np.cumsum(lens)])
    within = at - seg_start[seg_id]
    ptr = np.where(seg_id & 1, base + at - offsets[np.minimum(seg_id >> 1, n - 1)],
                   -(lit_start[seg_id >> 1] + within) - 1)
    while True:
        inner = np.flatnonzero(ptr >= base)
        if not len(inner):
            break
        ptr[inner] = ptr[ptr[inner] - base]
    lit = np.frombuffer(literals, np.uint8)
    vals = np.empty(total, np.uint8)
    from_lit = ptr < 0
    vals[from_lit] = lit[-ptr[from_lit] - 1]
    if not from_lit.all():
        old = np.frombuffer(out, np.uint8)
        vals[~from_lit] = old[ptr[~from_lit]]
        del old  # release the buffer before ``out`` grows
    out += vals.tobytes()


# -- frames ---------------------------------------------------------------------------------------


def _frame_header(data: bytes, pos: int) -> tuple[dict, int]:
    """A frame header at ``data[pos:]`` (after its magic) → (its fields, the
    position after it)."""
    if pos >= len(data):
        raise ValueError("zstd: a frame header past the end of the data (libzstd: srcSize wrong)")
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ValueError("zstd: the frame header's reserved bit is set (libzstd: frameParameter unsupported)")
    window = None
    if not single:
        if pos >= len(data):
            raise ValueError("zstd: a frame header past the end of the data (libzstd: srcSize wrong)")
        wd = data[pos]
        pos += 1
        log = 10 + (wd >> 3)
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
    nd = (0, 1, 2, 4)[dict_flag]
    nf = (single, 2, 4, 8)[fcs_flag]
    if pos + nd + nf > len(data):
        raise ValueError("zstd: a frame header past the end of the data (libzstd: srcSize wrong)")
    dict_id = int.from_bytes(data[pos:pos + nd], "little")
    pos += nd
    size = int.from_bytes(data[pos:pos + nf], "little") + (256 if nf == 2 else 0) if nf else None
    pos += nf
    if dict_id:
        raise ValueError(f"zstd: a frame coded with dictionary {dict_id} (libzstd: dictionary mismatch)")
    if window is None:
        window = size
    if window > 1 << WINDOW_LOG_MAX:
        raise ValueError("zstd: a window past 128 MiB (libzstd: frame requires too much memory)")
    return {"size": size, "checksum": checksum, "block_max": min(window, BLOCK_MAX)}, pos


def _frame(data: bytes, pos: int, out: bytearray, limit: int | None) -> int:
    """One frame at ``data[pos:]`` (after its magic) appended to ``out``:
    all of it, or — given ``limit``, libtiff's strip size — its blocks until
    ``out`` holds ``limit`` bytes, later blocks and the checksum then
    unread (a raw block may end early, libzstd streaming what it has). →
    the position after the frame (or where the decode stopped)."""
    head, pos = _frame_header(data, pos)
    start = len(out)
    state = {"rep": [1, 4, 8], "huffman": None, "LL": None, "OF": None, "ML": None}
    while True:
        if limit is not None and len(out) >= limit:
            return pos
        if pos + 3 > len(data):
            raise ValueError("zstd: a block header past the end of the data (libzstd: srcSize wrong)")
        bh = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
        if kind == 3:
            raise ValueError("zstd: a reserved block type (libzstd: corruption detected)")
        if size > head["block_max"]:
            raise ValueError("zstd: a block past the frame's maximum block size (libzstd: corruption detected)")
        if kind == 0:
            chunk = data[pos:pos + size]
            if len(chunk) < size and (limit is None or len(out) + len(chunk) < limit):
                raise ValueError("zstd: a raw block past the end of the data (libzstd: srcSize wrong)")
            out += chunk
        elif kind == 1:
            if pos >= len(data):
                raise ValueError("zstd: an RLE block without its byte (libzstd: srcSize wrong)")
            out += data[pos:pos + 1] * size
            size = 1
        else:
            block = data[pos:pos + size]
            if len(block) < size:
                raise ValueError("zstd: a compressed block past the end of the data (libzstd: srcSize wrong)")
            if size >= BLOCK_MAX:
                raise ValueError("zstd: a compressed block of 128 KiB (libzstd: corruption detected)")
            literals, used = _literals(block, 0, state)
            seqs = _sequences(block, used, state)
            before = len(out)
            _execute(out, start, literals, seqs)
            if len(out) - before > head["block_max"]:
                raise ValueError("zstd: a block's content past its maximum size (libzstd: corruption detected)")
        pos += size
        if last:
            break
    content = len(out) - start
    if head["size"] is not None and content != head["size"]:
        raise ValueError("zstd: a frame's content unlike its declared size (libzstd: corruption detected)")
    if head["checksum"]:
        if limit is not None and len(out) > limit:
            return pos
        stored = data[pos:pos + 4]
        if len(stored) == 4 and int.from_bytes(stored, "little") != xxh64(bytes(out[start:])) & 0xFFFFFFFF:
            raise ValueError("zstd: restored data does not match its checksum (libzstd: checksum wrong)")
        if len(stored) < 4 and limit is None:
            raise ValueError("zstd: a frame's checksum past the end of the data (libzstd: srcSize wrong)")
        pos += 4
    return pos


def decode_zstd_strip(data: bytes, size: int) -> bytes:
    """libtiff's ``ZSTDDecode`` of one strip or tile → ``size`` bytes."""
    out = bytearray()
    if len(data) >= 4 and int.from_bytes(data[:4], "little") == MAGIC:
        _frame(data, 4, out, size)
    elif len(data) < 4 or not 0x184D2A50 <= int.from_bytes(data[:4], "little") <= 0x184D2A5F:
        raise ValueError("zstd: not a Zstandard frame (libzstd: unknown frame descriptor)")
    if len(out) < size:
        raise ValueError("TIFF: Zstd data ends before its strip or tile (libtiff: not enough data)")
    return bytes(out[:size])


def decompress(data: bytes) -> bytes:
    """A whole Zstandard stream: its frames' contents one after another,
    skippable frames skipped."""
    out, pos = bytearray(), 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ValueError("zstd: trailing bytes after the last frame (libzstd: srcSize wrong)")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if 0x184D2A50 <= magic <= 0x184D2A5F:
            if pos + 8 > len(data):
                raise ValueError("zstd: a skippable frame past the end of the data (libzstd: srcSize wrong)")
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            if pos > len(data):
                raise ValueError("zstd: a skippable frame past the end of the data (libzstd: srcSize wrong)")
        elif magic == MAGIC:
            pos = _frame(data, pos + 4, out, None)
        else:
            raise ValueError("zstd: not a Zstandard frame (libzstd: unknown frame descriptor)")
    return bytes(out)


# -- XXH64 -----------------------------------------------------------------------------------------

P1, P2, P3, P4, P5 = (11400714785074694791, 14029467366897019727, 1609587929392839161, 9650029242287828579,
                      2870177450012600261)
M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * P2) & M64, 31) * P1 & M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the frame checksum keeps its low 32 bits)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v1, v2, v3, v4 = (seed + P1 + P2) & M64, (seed + P2) & M64, seed, (seed - P1) & M64
        lanes = np.frombuffer(data, "<u8", (n // 32) * 4).reshape(-1, 4).tolist()
        for a, b, c, d in lanes:
            v1 = _rotl((v1 + a * P2) & M64, 31) * P1 & M64
            v2 = _rotl((v2 + b * P2) & M64, 31) * P1 & M64
            v3 = _rotl((v3 + c * P2) & M64, 31) * P1 & M64
            v4 = _rotl((v4 + d * P2) & M64, 31) * P1 & M64
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * P1 + P4) & M64
        pos = (n // 32) * 32
    else:
        h = (seed + P5) & M64
    h = (h + n) & M64
    while pos + 8 <= n:
        h = (_rotl(h ^ _round(0, int.from_bytes(data[pos:pos + 8], "little")), 27) * P1 + P4) & M64
        pos += 8
    if pos + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[pos:pos + 4], "little") * P1 & M64), 23) * P2 + P3) & M64
        pos += 4
    while pos < n:
        h = _rotl(h ^ (data[pos] * P5 & M64), 11) * P1 & M64
        pos += 1
    h ^= h >> 33
    h = h * P2 & M64
    h ^= h >> 29
    h = h * P3 & M64
    return h ^ (h >> 32)
