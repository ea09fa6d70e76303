"""The bytes liblzma writes out of an xz stream before it meets an error —
for ``utils/_tiff.py``'s LZMA strips, where libtiff keeps a strip that
liblzma filled in the call that then failed, and Python's ``lzma`` drops
that call's output with the error.

A plain-Python xz reader for that one case: the stream and first block
headers (their CRCs, the block's filter chain: delta, then LZMA2), LZMA2
chunks (uncompressed ones, and LZMA ones that reset the state, set new
properties or reset the dictionary, each rule of ``lzma2_decoder.c``), and
the LZMA decoder itself (range decoder, literals and matched literals,
matches and the four repeated distances, ``lzma_decoder.c``'s checks: a
first range-coder byte of zero, no distance past the bytes decoded). It
stops where the output is full, as liblzma does when libtiff's buffer is,
or at the first error or the end of the input. Only the corrupt strips the
standard library refuses come here, so speed does not matter.
"""

from __future__ import annotations

import zlib


class _Error(Exception):
    """liblzma's LZMA_DATA_ERROR (or the input running out)."""


class _Range:
    """The range decoder over ``data`` from ``pos``: ``rc_read_init``'s five
    bytes (the first zero), then ``rc_normalize`` before each bit."""

    def __init__(self, data: bytes, pos: int):
        if pos + 5 > len(data) or data[pos]:
            raise _Error
        self.data, self.pos = data, pos + 5
        self.code, self.range = int.from_bytes(data[pos + 1:pos + 5], "big"), 0xFFFFFFFF

    def _normalize(self):
        if self.range < 1 << 24:
            if self.pos >= len(self.data):
                raise _Error
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.code = ((self.code << 8) | self.data[self.pos]) & 0xFFFFFFFF
            self.pos += 1

    def bit(self, probs: list, i: int) -> int:
        self._normalize()
        p = probs[i]
        bound = (self.range >> 11) * p
        if self.code < bound:
            self.range = bound
            probs[i] = p + ((2048 - p) >> 5)
            return 0
        self.range -= bound
        self.code -= bound
        probs[i] = p - (p >> 5)
        return 1

    def tree(self, probs: list, base: int, bits: int) -> int:
        m = 1
        for _ in range(bits):
            m = (m << 1) | self.bit(probs, base + m)
        return m - (1 << bits)

    def reverse(self, probs: list, base: int, bits: int) -> int:
        m, v = 1, 0
        for i in range(bits):
            b = self.bit(probs, base + m)
            m = (m << 1) | b
            v |= b << i
        return v

    def direct(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            self._normalize()
            self.range >>= 1
            c = (self.code - self.range) & 0xFFFFFFFF
            if not c >> 31:  # liblzma's unsigned test: the top bit of code − range
                self.code = c
            v = (v << 1) | (1 - (c >> 31))
        return v

    def finished(self) -> bool:
        """``rc_normalize``, then ``rc_is_finished``: a code of zero."""
        self._normalize()
        return self.code == 0


class _Lzma:
    """``lzma_decoder.c``'s state: probabilities, the state machine and the
    four repeated distances, reset at a chunk's state reset."""

    def __init__(self, lc: int, lp: int, pb: int):
        self.lc, self.lp, self.pb = lc, lp, pb
        self.literal = [1024] * (0x300 << (lc + lp))
        self.match, self.rep, self.rep0_long = [1024] * 192, [1024] * 12, [1024] * 192
        self.g0, self.g1, self.g2 = [1024] * 12, [1024] * 12, [1024] * 12
        self.slot, self.special, self.align = [1024] * 256, [1024] * 115, [1024] * 16
        self.lens = [[1024] * 514 for _ in range(2)]  # choice, choice2, low (16×8), mid (16×8), high (256)
        self.state, self.reps = 0, [0, 0, 0, 0]
        self.pending = 0  # bytes of a match still to copy where the output filled

    def _length(self, rc: _Range, probs: list, pos_state: int) -> int:
        if not rc.bit(probs, 0):
            return rc.tree(probs, 2 + pos_state * 8, 3)
        if not rc.bit(probs, 1):
            return 8 + rc.tree(probs, 130 + pos_state * 8, 3)
        return 16 + rc.tree(probs, 258, 8)

    def _distance(self, rc: _Range, length: int) -> int:
        slot = rc.tree(self.slot, min(length, 3) * 64, 6)
        if slot < 4:
            return slot
        bits = (slot >> 1) - 1
        dist = (2 | (slot & 1)) << bits
        if slot < 14:
            return dist + rc.reverse(self.special, dist - slot, bits)
        return dist + (rc.direct(bits - 4) << 4) + rc.reverse(self.align, 0, 4)

    def decode(self, rc: _Range, out: bytearray, start: int, limit: int, dict_size: int) -> None:
        """Symbols into ``out`` (the dictionary since its reset at ``start``,
        ``dict_size`` at most) until it holds ``limit`` bytes."""
        while self.pending and len(out) < limit:
            out.append(out[-self.reps[0] - 1])
            self.pending -= 1
        pb_mask, lp_mask = (1 << self.pb) - 1, (1 << self.lp) - 1
        while len(out) < limit:
            pos = len(out) - start
            ps = pos & pb_mask
            st = self.state
            if not rc.bit(self.match, (st << 4) + ps):
                prev = out[-1] if pos else 0
                base = 0x300 * (((pos & lp_mask) << self.lc) + (prev >> (8 - self.lc)))
                if st < 7:
                    sym = rc.tree(self.literal, base, 8)
                else:  # a matched literal: the byte at rep0 steers the tree until the first mismatch
                    match_byte, sym = out[-self.reps[0] - 1], 1
                    while sym < 0x100:
                        mbit = (match_byte >> 7) & 1
                        match_byte <<= 1
                        b = rc.bit(self.literal, base + 0x100 + (mbit << 8) + sym)
                        sym = (sym << 1) | b
                        if mbit != b:
                            while sym < 0x100:
                                sym = (sym << 1) | rc.bit(self.literal, base + sym)
                            break
                    sym -= 0x100
                out.append(sym)
                self.state = 0 if st < 4 else st - 3 if st < 10 else st - 6
                continue
            if rc.bit(self.rep, st):
                if not pos:  # lzma_decoder.c: no repeated match in an empty dictionary
                    raise _Error
                if not rc.bit(self.g0, st):
                    if not rc.bit(self.rep0_long, (st << 4) + ps):
                        self.state = 9 if st < 7 else 11
                        out.append(out[-self.reps[0] - 1])
                        continue
                else:
                    if not rc.bit(self.g1, st):
                        dist = self.reps.pop(1)
                    elif not rc.bit(self.g2, st):
                        dist = self.reps.pop(2)
                    else:
                        dist = self.reps.pop(3)
                    self.reps.insert(0, dist)
                length = self._length(rc, self.lens[1], ps)
                self.state = 8 if st < 7 else 11
            else:
                length = self._length(rc, self.lens[0], ps)
                self.state = 7 if st < 7 else 10
                dist = self._distance(rc, length)
                if dist >= min(pos, dict_size):  # an end marker LZMA2 does not allow, or past the dictionary
                    raise _Error
                self.reps = [dist] + self.reps[:3]
            self.pending = length + 2
            while self.pending and len(out) < limit:
                out.append(out[-self.reps[0] - 1])
                self.pending -= 1


def _varint(data: bytes, pos: int, end: int) -> tuple[int, int]:
    value = 0
    for i in range(9):
        if pos >= end:
            raise _Error
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return value, pos
    raise _Error


def _block_filters(data: bytes) -> tuple[int, int, int]:
    """The stream header and the first block header → (the delta filter's
    distance or 0, LZMA2's dictionary size, where the block's data starts)."""
    if data[:6] != b"\xfd7zXZ\x00" or len(data) < 13 or data[6] or data[7] > 15 \
            or zlib.crc32(data[6:8]) != int.from_bytes(data[8:12], "little") or not data[12]:
        raise _Error
    size = (data[12] + 1) * 4
    head = data[12:12 + size]
    if len(head) < size or zlib.crc32(head[:-4]) != int.from_bytes(head[-4:], "little") or head[1] & 0x3C:
        raise _Error
    pos, end = 2, size - 4
    for present in (head[1] & 0x40, head[1] & 0x80):
        if present:
            _, pos = _varint(head, pos, end)
    delta, dict_size = 0, None
    for k in range((head[1] & 3) + 1):
        fid, pos = _varint(head, pos, end)
        nprops, pos = _varint(head, pos, end)
        if pos + nprops > end:
            raise _Error
        last = k == head[1] & 3
        if fid == 3 and not last and nprops == 1 and not delta:
            delta = head[pos] + 1
        elif fid == 0x21 and last and nprops == 1 and head[pos] <= 40:
            d = head[pos]
            dict_size = 0xFFFFFFFF if d == 40 else (2 | (d & 1)) << (d // 2 + 11)
        else:
            raise _Error
        pos += nprops
    if any(head[pos:end]) or dict_size is None:
        raise _Error
    return delta, dict_size, 12 + size


def xz_prefix(data: bytes, size: int) -> bytes:
    """What liblzma writes of ``data``'s first block, at most ``size`` bytes,
    before an error, the block's end or the end of the input stops it."""
    out, delta = bytearray(), 0
    try:
        delta, dict_size, pos = _block_filters(data)
        start, lzma, props_needed, reset_needed = 0, None, True, True
        while len(out) < size:
            if pos >= len(data):
                raise _Error
            control = data[pos]
            pos += 1
            if control == 0:
                break
            if control >= 0xE0 or control == 1:
                props_needed, reset_needed, start = True, False, len(out)
            elif reset_needed:
                raise _Error
            if control >= 0x80:
                if pos + 4 + (control >= 0xC0) > len(data):
                    raise _Error
                unpacked = ((control & 0x1F) << 16 | data[pos] << 8 | data[pos + 1]) + 1
                packed = (data[pos + 2] << 8 | data[pos + 3]) + 1  # checked after the chunk, as liblzma does
                pos += 4
                if control >= 0xC0:
                    props = data[pos]
                    pos += 1
                    lc, lp, pb = props % 9, props // 9 % 5, props // 45
                    if props >= 225 or lc + lp > 4:
                        raise _Error
                    lzma, props_needed = _Lzma(lc, lp, pb), False
                elif props_needed:
                    raise _Error
                elif control >= 0xA0:
                    lzma = _Lzma(lzma.lc, lzma.lp, lzma.pb)
                lzma.pending = 0
                rc = _Range(data, pos)
                lzma.decode(rc, out, start, min(size, len(out) + unpacked), dict_size)
                if len(out) >= size:
                    break
                if lzma.pending or not rc.finished() or rc.pos - pos != packed:
                    raise _Error  # a match past the chunk's end, a range coder not at zero, a wrong packed size
                pos = rc.pos
            else:
                if control > 2:
                    raise _Error
                n = (data[pos] << 8 | data[pos + 1]) + 1 if pos + 2 <= len(data) else 0
                pos += 2
                chunk = data[pos:pos + n]
                out += chunk
                pos += len(chunk)
                if len(chunk) < n:
                    raise _Error
    except (_Error, IndexError):
        pass
    out = out[:size]
    if delta:  # each byte the sum of those ``delta`` apart before it
        for i in range(delta, len(out)):
            out[i] = (out[i] + out[i - delta]) & 0xFF
    return bytes(out)
