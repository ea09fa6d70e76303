"""JPEG writers for what PIL never writes, used by the tests and by
``tests/data/make_jpeg_arith_lossless_fixtures.py``:

  * ``write_arith``: arithmetic-coded JPEG (SOF9 sequential, SOF10
    progressive) from quantised coefficients, the QM-coder of T.81 Annex D
    as libjpeg's ``jcarith.c`` runs it (its own copy of Table D.2), with
    DAC conditioning, restart intervals and any scan script;
  * ``transcode_to_arith``: a Huffman-coded file's coefficients (read
    through the port's coefficient store) re-coded arithmetically;
  * ``write_lossless``: lossless JPEG (SOF3), predictors 1-7, a point
    transform, restarts, one interleaved scan or one scan a component;
  * ``split_scans`` / ``join_scans``: a file cut into its scans (each with
    the tables defined just before it), to drop, reorder or repeat them.

PIL decodes whatever these write; that decode is the oracle the port is
held to, so a slip here shows as a file PIL and the port disagree on or one
PIL refuses, never as a false pass.
"""

from __future__ import annotations

import struct

import numpy as np

# zigzag position → natural index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

# T.81 Table D.2, one state a row: Qe_Value, Next_Index_LPS, Next_Index_MPS, Switch_MPS
QE_TABLE = np.array([
    [0x5a1d, 1, 1, 1], [0x2586, 14, 2, 0], [0x1114, 16, 3, 0], [0x080b, 18, 4, 0], [0x03d8, 20, 5, 0],
    [0x01da, 23, 6, 0], [0x00e5, 25, 7, 0], [0x006f, 28, 8, 0], [0x0036, 30, 9, 0], [0x001a, 33, 10, 0],
    [0x000d, 35, 11, 0], [0x0006, 9, 12, 0], [0x0003, 10, 13, 0], [0x0001, 12, 13, 0], [0x5a7f, 15, 15, 1],
    [0x3f25, 36, 16, 0], [0x2cf2, 38, 17, 0], [0x207c, 39, 18, 0], [0x17b9, 40, 19, 0], [0x1182, 42, 20, 0],
    [0x0cef, 43, 21, 0], [0x09a1, 45, 22, 0], [0x072f, 46, 23, 0], [0x055c, 48, 24, 0], [0x0406, 49, 25, 0],
    [0x0303, 51, 26, 0], [0x0240, 52, 27, 0], [0x01b1, 54, 28, 0], [0x0144, 56, 29, 0], [0x00f5, 57, 30, 0],
    [0x00b7, 59, 31, 0], [0x008a, 60, 32, 0], [0x0068, 62, 33, 0], [0x004e, 63, 34, 0], [0x003b, 32, 35, 0],
    [0x002c, 33, 9, 0], [0x5ae1, 37, 37, 1], [0x484c, 64, 38, 0], [0x3a0d, 65, 39, 0], [0x2ef1, 67, 40, 0],
    [0x261f, 68, 41, 0], [0x1f33, 69, 42, 0], [0x19a8, 70, 43, 0], [0x1518, 72, 44, 0], [0x1177, 73, 45, 0],
    [0x0e74, 74, 46, 0], [0x0bfb, 75, 47, 0], [0x09f8, 77, 48, 0], [0x0861, 78, 49, 0], [0x0706, 79, 50, 0],
    [0x05cd, 48, 51, 0], [0x04de, 50, 52, 0], [0x040f, 50, 53, 0], [0x0363, 51, 54, 0], [0x02d4, 52, 55, 0],
    [0x025c, 53, 56, 0], [0x01f8, 54, 57, 0], [0x01a4, 55, 58, 0], [0x0160, 56, 59, 0], [0x0125, 57, 60, 0],
    [0x00f6, 58, 61, 0], [0x00cb, 59, 62, 0], [0x00ab, 61, 63, 0], [0x008f, 61, 32, 0], [0x5b12, 65, 65, 1],
    [0x4d04, 80, 66, 0], [0x412c, 81, 67, 0], [0x37d8, 82, 68, 0], [0x2fe8, 83, 69, 0], [0x293c, 84, 70, 0],
    [0x2379, 86, 71, 0], [0x1edf, 87, 72, 0], [0x1aa9, 87, 73, 0], [0x174e, 72, 74, 0], [0x1424, 72, 75, 0],
    [0x119c, 74, 76, 0], [0x0f6b, 74, 77, 0], [0x0d51, 75, 78, 0], [0x0bb6, 77, 79, 0], [0x0a40, 77, 48, 0],
    [0x5832, 80, 81, 1], [0x4d1c, 88, 82, 0], [0x438e, 89, 83, 0], [0x3bdd, 90, 84, 0], [0x34ee, 91, 85, 0],
    [0x2eae, 92, 86, 0], [0x299a, 93, 87, 0], [0x2516, 86, 71, 0], [0x5570, 88, 89, 1], [0x4ca9, 95, 90, 0],
    [0x44d9, 96, 91, 0], [0x3e22, 97, 92, 0], [0x3824, 99, 93, 0], [0x32b4, 99, 94, 0], [0x2e17, 93, 86, 0],
    [0x56a8, 95, 96, 1], [0x4f46, 101, 97, 0], [0x47e5, 102, 98, 0], [0x41cf, 103, 99, 0], [0x3c3d, 104, 100, 0],
    [0x375e, 99, 93, 0], [0x5231, 105, 102, 0], [0x4c0f, 106, 103, 0], [0x4639, 107, 104, 0], [0x415e, 103, 99, 0],
    [0x5627, 105, 106, 1], [0x50e7, 108, 107, 0], [0x4b85, 109, 103, 0], [0x5597, 110, 109, 0], [0x504f, 111, 107, 0],
    [0x5a10, 110, 111, 1], [0x5522, 112, 109, 0], [0x59eb, 112, 111, 1], [0x5a1d, 113, 113, 0],
]).tolist()


class QMEncoder:
    """``jcarith.c``'s ``arith_encode`` and ``finish_pass``: bins are
    (state, MPS) pairs in a list, ``encode(bins, i, bit)``; ``finish()``
    gives the stuffed bytes of one restart interval."""

    def __init__(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1
        self.out = bytearray()

    def _emit(self, byte: int):
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _flush_stack(self, byte: int):
        """Output the buffered byte, pending zeros and stacked 0xFF bytes."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self.out.extend(bytes(self.zc))
            self.zc = 0
            self._emit(self.buffer)
        if self.sc:
            self.out.extend(bytes(self.zc))
            self.zc = 0
            self.out.extend(b"\xff\x00" * self.sc)
            self.sc = 0
        self.buffer = byte

    def _carry(self):
        if self.buffer >= 0:
            self.out.extend(bytes(self.zc))
            self.zc = 0
            self._emit(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def encode(self, bins: list, i: int, bit: int):
        state, mps = bins[i]
        qe, next_lps, next_mps, switch = QE_TABLE[state]
        self.a -= qe
        if bit != mps:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            bins[i] = (next_lps, mps ^ switch)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            bins[i] = (next_mps, mps)
        while self.a < 0x8000:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stack(temp)
                self.c &= 0x7FFFF
                self.ct += 8

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._flush_stack(-1)
        if self.c & 0x7FFF800:
            self.out.extend(bytes(self.zc))
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _markers(jfif: bool, adobe: int | None) -> bytes:
    out = b""
    if jfif:
        out += _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([adobe]))
    return out


def _frame(marker: int, width: int, height: int, comps: list) -> bytes:
    body = struct.pack(">BHHB", 8, height, width, len(comps))
    for c in comps:
        body += bytes([c["id"], c["h"] << 4 | c["v"], c.get("tq", 0)])
    return _segment(marker, body)


def _dqt(qt: dict) -> bytes:
    return _segment(0xDB, b"".join(bytes([tid]) + bytes(np.asarray(q)[ZIGZAG].astype(np.uint8).tolist())
                                   for tid, q in sorted(qt.items())))


def _scan_order(comps: list, members: list, width: int, height: int) -> list:
    """(component index, block row, block column) of each block of a scan,
    in its order: MCU by MCU over the padded grid when interleaved, the
    component's real blocks row by row when not."""
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    if len(members) == 1:
        c = comps[members[0]]
        bw = -(-(-(-width * c["h"] // hmax)) // 8)
        bh = -(-(-(-height * c["v"] // vmax)) // 8)
        return [(members[0], y, x) for y in range(bh) for x in range(bw)]
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    return [(ci, my * comps[ci]["v"] + by, mx * comps[ci]["h"] + bx) for my in range(mcuy) for mx in range(mcux)
            for ci in members for by in range(comps[ci]["v"]) for bx in range(comps[ci]["h"])]


def _mcu_size(comps: list, members: list) -> int:
    return 1 if len(members) == 1 else sum(comps[ci]["h"] * comps[ci]["v"] for ci in members)


def _encode_dc(enc: QMEncoder, bins: list, ctx: int, v: int, lower: int, upper: int) -> int:
    """``encode_mcu``'s DC difference ``v`` in context ``ctx`` → the next context."""
    if v == 0:
        enc.encode(bins, ctx, 0)
        return 0
    enc.encode(bins, ctx, 1)
    sign = int(v < 0)
    v = abs(v)
    enc.encode(bins, ctx + 1, sign)
    st = ctx + 2 + sign
    m = 0
    v -= 1
    if v:
        enc.encode(bins, st, 1)
        m = 1
        v2 = v
        st = 20
        v2 >>= 1
        while v2:
            enc.encode(bins, st, 1)
            m <<= 1
            st += 1
            v2 >>= 1
    enc.encode(bins, st, 0)
    nxt = 4 + 4 * sign
    if m < (1 << lower) >> 1:
        nxt = 0
    elif m > (1 << upper) >> 1:
        nxt += 8
    st += 14
    m >>= 1
    while m:
        enc.encode(bins, st, int(bool(m & v)))
        m >>= 1
    return nxt


def _encode_magnitude(enc: QMEncoder, bins: list, st: int, v: int, k: int, kx: int):
    """AC magnitude |v| ≥ 1 from bin ``st`` (3·(k − 1) + 2): category, then bits."""
    m = 0
    v -= 1
    if v:
        enc.encode(bins, st, 1)
        m = 1
        v2 = v >> 1
        if v2:
            enc.encode(bins, st, 1)
            m <<= 1
            st = 189 if k <= kx else 217
            v2 >>= 1
            while v2:
                enc.encode(bins, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
    enc.encode(bins, st, 0)
    st += 14
    m >>= 1
    while m:
        enc.encode(bins, st, int(bool(m & v)))
        m >>= 1


def _shifted(v: int, al: int) -> int:
    """An AC coefficient under the point transform: |v| >> al, its sign kept."""
    return -((-v) >> al) if v < 0 else v >> al


def _encode_block(enc, block, dc_bins, ac_bins, fixed, state, ci, kind, ss, se, ah, al, cond, overflow=False):
    """One block of one scan (``encode_mcu`` / ``encode_mcu_*``); ``state``
    holds each scan component's last DC value and context."""
    lower, upper, kx = cond
    if kind == "dc_first" or kind == "sequential":
        dc = block[0] >> al if kind == "dc_first" else block[0]
        diff = dc - state["last"][ci]
        state["last"][ci] = dc
        state["ctx"][ci] = _encode_dc(enc, dc_bins, state["ctx"][ci], diff, lower, upper)
        if kind == "dc_first":
            return
        ss, se = 1, 63
    if kind == "dc_refine":
        enc.encode(fixed, 0, (block[0] >> al) & 1)
        return
    if overflow:  # a zero run past the band: libjpeg's "bad arithmetic code"
        enc.encode(ac_bins, 3 * (ss - 1), 0)
        for k in range(ss, se + 1):
            enc.encode(ac_bins, 3 * (k - 1) + 1, 0)
        return
    vals = [_shifted(int(block[k]), al) for k in range(64)]
    ke = max((k for k in range(1, se + 1) if vals[k]), default=0)
    kex = 0
    if kind == "ac_refine":
        kex = max((k for k in range(1, ke + 1) if _shifted(int(block[k]), ah)), default=0)
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        if kind != "ac_refine" or k > kex:
            enc.encode(ac_bins, st, 0)
        while True:
            v = vals[k]
            if v:
                if kind == "ac_refine" and abs(v) >> 1:
                    enc.encode(ac_bins, st + 2, abs(v) & 1)
                else:
                    enc.encode(ac_bins, st + 1, 1)
                    enc.encode(fixed, 0, int(v < 0))
                    if kind != "ac_refine":
                        _encode_magnitude(enc, ac_bins, st + 2, abs(v), k, kx)
                break
            enc.encode(ac_bins, st + 1, 0)
            st += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(ac_bins, 3 * (k - 1), 1)


def write_arith(width: int, height: int, comps: list, qt: dict, script: list | None = None, restart: int = 0,
                dac: dict | None = None, jfif: bool = True, adobe: int | None = None, overflow: tuple = ()) -> bytes:
    """An arithmetic-coded JPEG. ``comps``: dicts of id, h, v, tq, dc / ac
    (table numbers) and ``blocks``, the quantised coefficients (padded block
    rows, padded block columns, 64) in zigzag order; ``qt``: table → 64
    natural-order quantisers. ``script``: None for one interleaved
    sequential scan (SOF9), else progressive scans (SOF10) as (component
    indices, Ss, Se, Ah, Al). ``restart``: MCUs an interval (DRI).
    ``dac``: {("DC", t): (L, U)} / {("AC", t): Kx} (written as a DAC
    marker; the defaults are L 0, U 1, Kx 5). ``overflow``: (scan, block)
    pairs whose AC data is a zero run past the band instead."""
    progressive = script is not None
    scans = script if progressive else [(tuple(range(len(comps))), 0, 63, 0, 0)]
    dac = dac or {}
    cond_l = {t: dac.get(("DC", t), (0, 1)) for t in range(16)}
    cond_k = {t: dac.get(("AC", t), 5) for t in range(16)}
    out = b"\xff\xd8" + _markers(jfif, adobe) + _dqt(qt) + _frame(0xCA if progressive else 0xC9, width, height, comps)
    if dac:
        body = b""
        for (kind, t), val in sorted(dac.items()):
            body += bytes([t, val[1] << 4 | val[0]]) if kind == "DC" else bytes([16 + t, val])
        out += _segment(0xCC, body)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    for s, (members, ss, se, ah, al) in enumerate(scans):
        body = bytes([len(members)]) + b"".join(bytes([comps[ci]["id"], comps[ci]["dc"] << 4 | comps[ci]["ac"]])
                                                for ci in members)
        out += _segment(0xDA, body + bytes([ss, se, ah << 4 | al]))
        kind = ("sequential" if not progressive else
                ("dc_first" if ah == 0 else "dc_refine") if ss == 0 else ("ac_first" if ah == 0 else "ac_refine"))
        order = _scan_order(comps, list(members), width, height)
        per = _mcu_size(comps, list(members))
        n_mcu = len(order) // per
        interval = restart or n_mcu
        data = b""
        for i0 in range(0, n_mcu, interval):
            enc = QMEncoder()
            dc_bins = {t: [(0, 0)] * 64 for t in range(16)}
            ac_bins = {t: [(0, 0)] * 256 for t in range(16)}
            fixed = [(113, 0)]
            state = {"last": {ci: 0 for ci in members}, "ctx": {ci: 0 for ci in members}}
            for j in range(i0 * per, min(i0 + interval, n_mcu) * per):
                ci, by, bx = order[j]
                c = comps[ci]
                _encode_block(enc, c["blocks"][by, bx], dc_bins[c["dc"]], ac_bins[c["ac"]], fixed, state, ci, kind,
                              ss, se, ah, al, (*cond_l[c["dc"]], cond_k[c["ac"]]), overflow=(s, j) in overflow)
            if i0:
                data += bytes([0xFF, 0xD0 + (i0 // interval - 1) % 8])
            data += enc.finish()
        out += data
    return out + b"\xff\xd9"


def read_coefficients(data: bytes) -> tuple[int, int, list, dict, int | None, bool]:
    """A Huffman-coded JPEG's quantised coefficients through the port's
    coefficient store → (width, height, comps as ``write_arith`` takes them
    (table numbers 0 for the first component, 1 for the others), the
    quantisation tables, the Adobe transform, whether it has a JFIF
    marker)."""
    from physically_based_renderer_tpu_torch.utils import _jpeg

    frame, adobe = _jpeg._read_stream(data, {}, {}, {})
    comps, qt = [], {}
    for i, c in enumerate(frame["comps"]):
        blocks = frame["coefs"][c["offset"]:c["offset"] + c["bw"] * c["bh"]].reshape(c["bh"], c["bw"], 64)
        qt[c["tq"]] = c["quant"]
        t = int(i > 0)
        comps.append(dict(id=c["id"], h=c["h"], v=c["v"], tq=c["tq"], dc=t, ac=t, blocks=blocks.astype(np.int64)))
    return frame["width"], frame["height"], comps, qt, adobe, frame["jfif"]


def scan_script(data: bytes, comps: list) -> list:
    """A progressive file's scans as (component indices, Ss, Se, Ah, Al)."""
    ids = [c["id"] for c in comps]
    script = []
    pos = 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDA:
            ns = body[0]
            members = tuple(ids.index(body[1 + 2 * k]) for k in range(ns))
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            script.append((members, ss, se, ahal >> 4, ahal & 15))
            while not (data[pos] == 0xFF and data[pos + 1] not in (0, *range(0xD0, 0xD8))):
                pos += 1
    return script


def transcode_to_arith(data: bytes, progressive: bool = False, script: list | None = None, **kw) -> bytes:
    """A Huffman-coded file re-coded arithmetically with its coefficients,
    tables, markers and sampling: one sequential scan, or (``progressive``)
    its own scan script or ``script``."""
    width, height, comps, qt, adobe, jfif = read_coefficients(data)
    if progressive and script is None:
        script = scan_script(data, comps)
    kw.setdefault("jfif", jfif)
    kw.setdefault("adobe", adobe)
    return write_arith(width, height, comps, qt, script=script if progressive else None, **kw)


# -- lossless -------------------------------------------------------------------------------


def optimal_huffman(freq: dict) -> tuple[list, list]:
    """``jchuff.c``'s ``jpeg_gen_optimal_table`` over symbols 0-255 →
    (BITS: codes of each length 1-16, HUFFVAL)."""
    f = [0] * 257
    for s, n in freq.items():
        f[s] = n
    f[256] = 1  # a reserved code point, so that no code is all ones
    codesize, others = [0] * 257, [-1] * 257
    while True:
        c1 = min((i for i in range(257) if f[i]), key=lambda i: (f[i], -i), default=-1)
        c2 = min((i for i in range(257) if f[i] and i != c1), key=lambda i: (f[i], -i), default=-1)
        if c2 < 0:
            break
        f[c1] += f[c2]
        f[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved code point
    vals = [s for size in range(1, 33) for s in range(256) if codesize[s] == size]
    return bits[1:17], vals


class BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code: int, length: int):
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def finish(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _codes(bits: list, vals: list) -> dict:
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def lossless_differences(plane: np.ndarray, psv: int, pt: int, first_rows) -> np.ndarray:
    """T.81 H.1.2's differences of one component's samples (after the point
    transform), rows in ``first_rows`` predicted as a scan's first row;
    each modulo 2^16 in −32767..32768."""
    x = plane.astype(np.int64) >> pt
    ra = np.pad(x, ((0, 0), (1, 0)))[:, :-1]
    rb = np.pad(x, ((1, 0), (0, 0)))[:-1]
    rc = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]
    pred = [ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1), (ra + rb) >> 1][psv - 1].copy()
    pred[:, 0] = rb[:, 0]  # the first column: the sample above
    first = sorted(first_rows)
    pred[first] = ra[first]  # a first row: the sample to the left
    pred[first, 0] = 1 << (7 - pt)
    d = (x - pred) & 0xFFFF
    return np.where(d > 32768, d - 65536, d)


def write_lossless(planes: list, sampling: list, psv: int = 1, pt: int = 0, restart_rows: int = 0,
                   ids: tuple | None = None, interleaved: bool = True, jfif: bool = False,
                   adobe: int | None = None, width: int | None = None, height: int | None = None,
                   diffs: list | None = None) -> bytes:
    """A lossless JPEG (SOF3). ``planes``: each component's samples at its
    own (downsampled) size; ``sampling``: (h, v) each; ``restart_rows``:
    MCU rows a restart interval; one interleaved scan, or one scan a
    component. ``diffs`` replaces the computed differences (each at its
    component's padded size) to write what no image gives."""
    n = len(planes)
    ids = ids or tuple(range(1, n + 1))
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    height = height or planes[0].shape[0] * vmax // sampling[0][1]
    width = width or planes[0].shape[1] * hmax // sampling[0][0]
    comps = [dict(id=ids[i], h=sampling[i][0], v=sampling[i][1]) for i in range(n)]
    out = b"\xff\xd8" + _markers(jfif, adobe) + _frame(0xC3, width, height, comps)
    groups = [list(range(n))] if interleaved and n > 1 else [[i] for i in range(n)]
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    scans_out = []
    for members in groups:
        per_row = mcux if len(members) > 1 else planes[members[0]].shape[1]
        rows = mcuy if len(members) > 1 else planes[members[0]].shape[0]
        interval = restart_rows or rows
        samples = []  # (component, difference plane, MCU width, MCU height)
        for ci in members:
            h, v = sampling[ci] if len(members) > 1 else (1, 1)
            cv = sampling[ci][1] if len(members) > 1 else 1
            first = {r * cv for r in range(0, rows, interval)}
            plane = planes[ci]
            ph, pw = rows * v, per_row * h
            padded = np.pad(plane, ((0, ph - plane.shape[0]), (0, pw - plane.shape[1])), mode="edge")
            d = diffs[ci] if diffs is not None else lossless_differences(padded, psv, pt, first)
            samples.append((ci, d, h, v))
        seq = []
        for my in range(rows):
            for mx in range(per_row):
                for ci, d, h, v in samples:
                    for by in range(v):
                        for bx in range(h):
                            seq.append((ci, int(d[my * v + by, mx * h + bx])))
        freq = {}
        cats = []
        for ci, d in seq:
            s = 16 if d == 32768 else abs(d).bit_length()
            cats.append(s)
            freq[s] = freq.get(s, 0) + 1
        bits, vals = optimal_huffman(freq)
        codes = _codes(bits, vals)
        dht = _segment(0xC4, bytes([0]) + bytes(bits) + bytes(vals))
        data = b""
        per_mcu = len(seq) // (rows * per_row)
        for r0 in range(0, rows, interval):
            bw = BitWriter()
            for j in range(r0 * per_row * per_mcu, min(r0 + interval, rows) * per_row * per_mcu):
                d, s = seq[j][1], cats[j]
                bw.put(*codes[s])
                if 0 < s < 16:
                    bw.put(d if d > 0 else d + (1 << s) - 1, s)
            if r0:
                data += bytes([0xFF, 0xD0 + (r0 // interval - 1) % 8])
            data += bw.finish()
        sos = bytes([len(members)]) + b"".join(bytes([ids[ci], 0]) for ci in members) + bytes([psv, 0, pt])
        scans_out.append(dht + _segment(0xDA, sos) + data)
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * (mcux if interleaved and n > 1 else
                                                                 planes[0].shape[1])))
    return out + b"".join(scans_out) + b"\xff\xd9"


# -- the scan editor --------------------------------------------------------------------------


def split_scans(data: bytes) -> tuple[bytes, list, bytes]:
    """(everything through the frame header, the scans — each with the
    markers since the previous scan's data —, the rest)."""
    pos, start, head, units = 2, None, None, []
    while True:
        marker = data[pos + 1]
        if marker == 0xD9:
            return head, units, data[pos:]
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        pos += 2 + length
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            head, start = data[:pos], pos
        elif marker == 0xDA:
            while not (data[pos] == 0xFF and data[pos + 1] not in (0, *range(0xD0, 0xD8))):
                pos += 1
            units.append(data[start:pos])
            start = pos


def join_scans(head: bytes, units: list, tail: bytes = b"\xff\xd9") -> bytes:
    return head + b"".join(units) + tail
