"""Arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive): the entropy
decoding of ``utils/_jpeg.py``'s frames whose scans are coded by the
QM-coder of ITU-T T.81 Annex D, as libjpeg's ``jdarith.c`` runs it.

The decoder: the A and C registers with their renormalisation (two bytes
read to start, then one each 8 shifts), byte stuffing removed beforehand by
``_jpeg._scan_data``, zeros fed past the end of a restart interval's data
(libjpeg feeds zeros once it meets a marker), and T.81 Table D.2's 113
probability states (``QE``, ``NEXT_LPS``, ``NEXT_MPS``; state 113 the fixed
½ bin of signs and DC refinement). Each statistics bin is one int: its state
index, its more probable symbol in bit 7. Each DC table has 64 bins and each
AC table 256, all zero at the start of a scan and of each restart interval.

Decisions (``jdarith.c``): DC in the context of the previous difference's
class (zero, small ±, large ± by the DAC marker's L and U), AC by an end-of-
block decision at each position, a zero-run decision per zero, the
magnitude's category on bins that switch at the DAC's Kx. Progressive scans:
DC first (the sum shifted by Al), DC refine (one fixed-bin decision a block),
AC first, AC refine (the end of the previously nonzero coefficients, a
correction decision for each coefficient already nonzero). Where libjpeg
finds a bad code ("Corrupt JPEG data: bad arithmetic code": a magnitude past
2^15 or a run past the band) it leaves the rest of the restart interval as
it was; so does this. ``_jpeg`` stores every decoded value as libjpeg's
16-bit ``JCOEF``. Each scan function returns the bytes its decoder fetched (libjpeg
reads them one at a time, and cannot wait for more: see ``_jpeg``'s
``PIL_BLOCK``).

Bit-serial: one Python loop over decisions, each decision one call of
``_Decoder.bit`` with the registers in slots.
"""

from __future__ import annotations

# T.81 Table D.2 (libjpeg's jaricom.c): Qe, the next state after an LPS, the
# next state after an MPS, and whether an LPS switches the MPS. State 113 is
# the fixed ½ bin.
_TABLE = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0),
    (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0), (0x001A, 33, 10, 0),
    (0x000D, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0), (0x0406, 49, 25, 0),
    (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0),
    (0x002C, 33, 9, 0), (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0), (0x0861, 78, 49, 0), (0x0706, 79, 50, 0),
    (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0),
    (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1),
    (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0),
    (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0), (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0), (0x34EE, 91, 85, 0),
    (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0),
    (0x56A8, 95, 96, 1), (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0), (0x5597, 110, 109, 0), (0x504F, 111, 107, 0),
    (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
)
QE = tuple(t[0] for t in _TABLE)
NEXT_LPS = tuple(t[1] | t[3] << 7 for t in _TABLE)  # bit 7: an LPS here switches the MPS
NEXT_MPS = tuple(t[2] for t in _TABLE)
FIXED = 113
DC_BINS, AC_BINS = 64, 256


class _Decoder:
    """One restart interval's QM decoder (``jdarith.c``'s ``arith_decode``);
    ``bad`` is set where libjpeg finds a bad code and stops the interval."""

    __slots__ = ("data", "n", "pos", "a", "c", "ct", "bad")

    def __init__(self, segment: bytes):
        self.data, self.n, self.pos = segment, len(segment), 0
        self.a, self.c, self.ct = 0, 0, -16  # two bytes are read before the first decision
        self.bad = False

    def bit(self, st: list, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                pos = self.pos
                c = (c << 8) | (self.data[pos] if pos < self.n else 0)
                self.pos = pos + 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        s = sv & 0x7F
        qe = QE[s]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ NEXT_MPS[s]
            else:
                st[i] = (sv & 0x80) ^ NEXT_LPS[s]
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ NEXT_LPS[s]
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ NEXT_MPS[s]
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _dc_diff(d: _Decoder, st: list, ctx: int, lower: int, upper: int) -> tuple[int, int]:
    """One DC difference (T.81 F.1.4.4.1 / ``decode_mcu``'s DC part) in the
    conditioning context ``ctx`` → (difference, the next context); ``d.bad``
    on a magnitude past 2^15."""
    bit = d.bit
    if not bit(st, ctx):
        return 0, 0
    sign = bit(st, ctx + 1)
    i = ctx + 2 + sign
    m = bit(st, i)
    if m:
        i = 20
        while bit(st, i):
            m <<= 1
            if m == 0x8000:
                d.bad = True
                return 0, 0
            i += 1
    if m < (1 << lower) >> 1:
        nxt = 0
    elif m > (1 << upper) >> 1:
        nxt = 12 + 4 * sign
    else:
        nxt = 4 + 4 * sign
    v = m
    i += 14
    m >>= 1
    while m:
        if bit(st, i):
            v |= m
        m >>= 1
    v += 1
    return (-v if sign else v), nxt


def _ac_value(d: _Decoder, st: list, fixed: list, i: int, k: int, kx: int) -> int:
    """The nonzero AC value whose zero-run decision at bin ``i`` (3·(k − 1)
    + 1) said so: sign on the fixed bin, magnitude category, magnitude bits
    (``decode_mcu``'s F.21-F.24); 0 with ``d.bad`` on a magnitude past 2^15."""
    bit = d.bit
    sign = bit(fixed, 0)
    i += 1
    m = bit(st, i)
    if m and bit(st, i):
        m = 2
        i = 189 if k <= kx else 217
        while bit(st, i):
            m <<= 1
            if m == 0x8000:
                d.bad = True
                return 0
            i += 1
    v = m
    i += 14
    m >>= 1
    while m:
        if bit(st, i):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _plan_stats(scan: list, slots: list, conditioning: dict):
    """Per block of an MCU: (DC bins, AC bins, slot, L, U, Kx), one fresh set
    of bins per table (shared by the components that name it), as
    ``jdarith.c`` resets them at a scan's and a restart interval's start."""
    dc = {d: [0] * DC_BINS for _, d, _ in scan}
    ac = {a: [0] * AC_BINS for _, _, a in scan}
    return [(dc[scan[ci][1]], ac[scan[ci][2]], ci, conditioning["L"][scan[ci][1]], conditioning["U"][scan[ci][1]],
             conditioning["K"][scan[ci][2]]) for ci in slots]


def decode_sequential(segment: bytes, scan: list, slots: list, conditioning: dict, blocks: list, idx: list,
                      vals: list):
    """SOF9 (``decode_mcu``): every coefficient of ``blocks`` (flat offsets
    ×64, the MCU order of ``slots``) of one restart interval; (zigzag flat
    index, value) pairs appended to ``idx`` / ``vals``."""
    d = _Decoder(segment)
    bit = d.bit
    plan = _plan_stats(scan, slots, conditioning)
    fixed = [FIXED]
    n_plan = len(plan)
    last = [0] * len(scan)
    ctx = [0] * len(scan)
    append_i, append_v = idx.append, vals.append
    for j, base in enumerate(blocks):
        dst, ast, ci, lower, upper, kx = plan[j % n_plan]
        v, ctx[ci] = _dc_diff(d, dst, ctx[ci], lower, upper)
        if d.bad:
            return d.pos
        last[ci] = (last[ci] + v) & 0xFFFF
        append_i(base)
        append_v(last[ci])
        k = 1
        while k <= 63:
            i = 3 * k - 3
            if bit(ast, i):  # end of block
                break
            i += 1
            while not bit(ast, i):
                i += 3
                k += 1
                if k > 63:  # a run past the block
                    return d.pos
            v = _ac_value(d, ast, fixed, i, k, kx)
            if d.bad:
                return d.pos
            append_i(base + k)
            append_v(v)
            k += 1
    return d.pos


def decode_dc_first(segment: bytes, scan: list, slots: list, conditioning: dict, blocks: list, al: int, idx: list,
                    vals: list):
    """A progressive DC first scan (``decode_mcu_DC_first``) over one restart
    interval: each block's DC sum shifted left by ``al``."""
    d = _Decoder(segment)
    plan = _plan_stats(scan, slots, conditioning)
    n_plan = len(plan)
    last = [0] * len(scan)
    ctx = [0] * len(scan)
    for j, base in enumerate(blocks):
        dst, _, ci, lower, upper, _ = plan[j % n_plan]
        v, ctx[ci] = _dc_diff(d, dst, ctx[ci], lower, upper)
        if d.bad:
            return d.pos
        last[ci] = (last[ci] + v) & 0xFFFF
        idx.append(base)
        vals.append(last[ci] << al)
    return d.pos


def decode_dc_refine(segment: bytes, blocks: list, hit: list):
    """A progressive DC refine scan (``decode_mcu_DC_refine``): one fixed-bin
    decision a block; the blocks whose bit is 1 go to ``hit``."""
    d = _Decoder(segment)
    bit = d.bit
    fixed = [FIXED]
    for base in blocks:
        if bit(fixed, 0):
            hit.append(base)
    return d.pos


def decode_ac_first(segment: bytes, kx: int, blocks: list, ss: int, se: int, al: int, idx: list, vals: list):
    """A progressive AC first scan (``decode_mcu_AC_first``) of one component
    over one restart interval: coefficients ``ss``..``se`` shifted by ``al``."""
    d = _Decoder(segment)
    bit = d.bit
    ast = [0] * AC_BINS
    fixed = [FIXED]
    for base in blocks:
        k = ss
        while k <= se:
            i = 3 * k - 3
            if bit(ast, i):
                break
            i += 1
            while not bit(ast, i):
                i += 3
                k += 1
                if k > se:
                    return d.pos
            v = _ac_value(d, ast, fixed, i, k, kx)
            if d.bad:
                return d.pos
            idx.append(base + k)
            vals.append(v << al)
            k += 1
    return d.pos


def decode_ac_refine(segment: bytes, blocks: list, masks: list, ss: int, se: int, new_i: list, new_v: list,
                     fix_i: list):
    """A progressive AC refine scan (``decode_mcu_AC_refine``) of one
    component over one restart interval. ``masks[j]`` has bit k set where
    block j's zigzag coefficient k was nonzero before this scan; the end of
    those in 1..Se (``kex``) decides where end-of-block decisions start. A
    coefficient already nonzero takes one correction decision (its flat
    index to ``fix_i`` where it is 1); a zero one a run decision, a new one
    a sign (``new_i`` / ``new_v``: ±1, not yet shifted)."""
    d = _Decoder(segment)
    bit = d.bit
    ast = [0] * AC_BINS
    fixed = [FIXED]
    band = (2 << se) - 2  # bits 1..Se
    for j, base in enumerate(blocks):
        m = masks[j]
        kex = (m & band).bit_length() - 1 if m & band else 0
        k = ss
        while k <= se:
            i = 3 * k - 3
            if k > kex and bit(ast, i):
                break
            while True:
                if (m >> k) & 1:
                    if bit(ast, i + 2):
                        fix_i.append(base + k)
                    break
                if bit(ast, i + 1):
                    new_i.append(base + k)
                    new_v.append(-1 if bit(fixed, 0) else 1)
                    break
                i += 3
                k += 1
                if k > se:
                    return d.pos
            k += 1
    return d.pos

