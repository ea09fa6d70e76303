"""JPEG decoding with NumPy — the JPEG part of ``utils/image_io.load_image``:
sequential and progressive DCT frames, Huffman- (SOF0, SOF1, SOF2) or
arithmetic-coded (SOF9, SOF10: ``utils/_jpeg_arith.py``), and lossless frames
(SOF3: ``utils/_jpeg_lossless.py``), 8-bit samples.

The result is meant to equal, bit for bit, what PIL gives with libjpeg-turbo
at its defaults, so every stage after the entropy decode is libjpeg's integer
arithmetic, vectorised over all blocks:

  * the "islow" inverse DCT as libjpeg-turbo's SIMD code runs it (the
    ``jidctint.c`` algorithm, 13-bit constants, two passes, its descaling;
    16-bit dequantisation and saturation between the passes and at the end,
    which only coefficients out of range see);
  * "fancy" (triangle) upsampling of ``jdsample.c``: ``h2v1``, ``h1v2`` and
    ``h2v2`` with their rounding biases, the component's last real row and
    column repeated at the edges as ``jdmainct.c`` does; plain replication
    for other integer ratios (``int_upsample``) and for lossless frames,
    whose one-sample "blocks" take no context rows;
  * the fixed-point YCbCr → RGB tables of ``jdcolor.c``, and for four
    components its YCCK → CMYK step; then PIL's own steps: CMYK read as
    inverted (Adobe) samples, and ``convert("RGB")``'s CMYK → RGB. Three
    components are YCbCr or RGB by ``jdapimin.c``'s rules: a JFIF marker
    says YCbCr, else an Adobe marker's transform (0 RGB), else the component
    ids (1, 2, 3 YCbCr; "R", "G", "B" RGB; others YCbCr in a DCT frame, RGB
    in a lossless one).

Grayscale, YCbCr, RGB, CMYK and YCCK images, any sampling factors, restart
intervals (DRI) and sizes that are not a multiple of the MCU. Every scan of a
DCT frame updates one ``(blocks, 64)`` array of coefficients in zigzag
order, the store ``jdcoefct.c`` keeps for a multi-scan file; each
component's quantisation table is the one defined at its first scan
(``jdinput.c``'s ``latch_quant_tables``). Progressive scans follow
``jdphuff.c`` (or ``jdarith.c``): DC first and refine scans (interleaved or
not), AC first scans with EOB runs, AC refine scans with a correction bit
for each coefficient already nonzero. Scans out of their order (an AC scan
before its component's DC, a refinement whose Ah is not the bits known, a
scan sent twice) are decoded as their headers say, libjpeg's
``JWRN_BOGUS_PROGRESSION``; each coefficient's precision (``coef_bits``)
becomes the scan's Al. A progressive file that leaves some of the first
nine AC coefficients imprecise is block-smoothed as libjpeg-turbo 3.1's
``decompress_smooth_data`` does (``_smooth``).

Huffman decoding is sequential: one Python loop over symbols, each looked up
in a table indexed by the next 16 bits, which gives the code's length, its
run and, when the code and its value bits fit in 16, the value itself.
Integer arithmetic throughout, so a decode gives the same bits on every
machine. Hierarchical files, arithmetic-coded lossless ones (SOF11) and
samples of other than 8 bits, which PIL does not read, raise ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\xff\xd8"
UNREAD = "which PIL (libjpeg-turbo) does not read either"

# zigzag position k → natural (row-major) index of the 8×8 coefficient
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)
UNZIGZAG = np.argsort(ZIGZAG)  # natural index → zigzag position

SOF_UNREAD = {0xCB: "arithmetic-coded lossless (SOF11)", 0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
              0xC7: "hierarchical (SOF7)", 0xCD: "hierarchical (SOF13)", 0xCE: "hierarchical (SOF14)",
              0xCF: "hierarchical (SOF15)"}
EOB = 100  # a table entry's run at and past this is an end of band: EOB_n with n = run − EOB


class HuffmanTable(list):
    """A 16-bit lookahead table (``_huffman_table``) and the largest symbol
    of its definition (a DC table's 16 is read only in lossless frames)."""

    max_symbol = 0


def _huffman_table(counts: np.ndarray, symbols: bytes, ac: bool) -> HuffmanTable:
    """The 16-bit lookahead table of one Huffman table: entry w (the next 16
    bits) is (bits, run, value) when the code and its value bits fit in 16
    bits (an AC symbol of size 0 is ZRL, run 15, or EOB_r, run EOB + r, past
    any block's end; its r extra bits are not read); (−code length, run,
    size) when the value bits run past them (a DC size 16 among them);
    (0, 0, 0) where no code matches."""
    look_len = np.zeros(1 << 16, np.int64)
    look_sym = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    last = max((i + 1 for i in range(16) if counts[i]), default=0)
    n = sum(int(c) for c in counts)
    if n > min(256, len(symbols)) or (not ac and any(v > 16 for v in symbols[:n])):
        raise ValueError("JPEG: bogus Huffman table definition")
    for length in range(1, 17):
        for _ in range(int(counts[length - 1])):
            lo = code << (16 - length)
            look_len[lo:lo + (1 << (16 - length))] = length
            look_sym[lo:lo + (1 << (16 - length))] = symbols[k]
            code += 1
            k += 1
        if length <= last and code >= 1 << length:  # jdhuff.c: every code fits its length, none all ones
            raise ValueError("JPEG: bogus Huffman table definition")
        code <<= 1
    w = np.arange(1 << 16, dtype=np.int64)
    run = (look_sym >> 4) if ac else np.zeros_like(look_sym)
    size = (look_sym & 15) if ac else look_sym
    total = look_len + size
    fits = total <= 16
    bits = (w >> np.clip(16 - total, 0, 16)) & ((1 << size) - 1)
    value = np.where(bits < (1 << np.maximum(size - 1, 0)), bits - (1 << size) + 1, bits)
    value = np.where(size == 0, 0, value)
    if ac:
        run = np.where((size == 0) & (run != 15), EOB + run, run)  # EOB_r; ZRL keeps run 15
    first = np.where(fits, total, -look_len)
    third = np.where(fits, value, size)
    first[look_len == 0] = 0
    table = HuffmanTable(zip(first.tolist(), run.tolist(), third.tolist()))
    table.max_symbol = max(symbols[:n], default=0)
    return table


def _windows(segment: bytes) -> list:
    """The 32 bits that start at each byte of ``segment`` (zeros past its end),
    as Python ints: the next 16 bits at bit p are
    ``(W[p >> 3] >> (16 - (p & 7))) & 0xFFFF``."""
    b = np.frombuffer(segment + b"\0" * 8, np.uint8).astype(np.int64)
    return ((b[:-7] << 24) | (b[1:-6] << 16) | (b[2:-5] << 8) | b[3:-4]).tolist()


# Zero bytes read past a restart interval's data: libjpeg reads zero bits once it meets the marker, finishes
# the MCU in hand and leaves the interval's later MCUs as they are ("insufficient data"); an MCU of garbage
# reads far fewer than this.
PAST_END = 2048


def _decode_blocks(segment: bytes, plan: list, num_blocks: int, blocks: list, preds: list, idx: list, vals: list):
    """Entropy-decode ``num_blocks`` blocks of one restart interval.
    ``plan`` cycles over the blocks of an MCU: (DC table, AC table,
    component). ``blocks`` gives each block's flat offset (×64); DC
    predictors live in ``preds``; (zigzag flat index, value) pairs are
    appended to ``idx`` / ``vals``. libjpeg's leniency on corrupt data
    (``jdhuff.c``): a code that matches nothing reads as symbol 0 after 17
    bits, a run past the block lands on coefficient 63, reading past the
    data reads zeros to the end of the MCU and skips the later ones. →
    whether the data ran out (``insufficient_data``)."""
    W = _windows(segment + bytes(PAST_END))
    nbits = 8 * len(segment)
    p = 0
    n_plan = len(plan)
    append_i, append_v = idx.append, vals.append
    for j in range(num_blocks):
        if p > nbits and j % n_plan == 0:
            return True
        dct, act, comp = plan[j % n_plan]
        base = blocks[j]
        w = (W[p >> 3] >> (16 - (p & 7))) & 0xFFFF
        tl, _, v = dct[w]
        if tl > 0:
            p += tl
        elif tl < 0:
            p -= tl
            if v:
                s = v
                bits = (W[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                v = bits - (1 << s) + 1 if bits < (1 << (s - 1)) else bits
                p += s
        else:
            p += 17
        preds[comp] += v
        append_i(base)
        append_v(preds[comp])
        k = 1
        while k < 64:
            w = (W[p >> 3] >> (16 - (p & 7))) & 0xFFFF
            tl, r, v = act[w]
            if tl > 0:
                p += tl
                k += r
                if v:
                    append_i(base + min(k, 63))
                    append_v(v)
                k += 1
            elif tl < 0:
                p -= tl
                s = v
                bits = (W[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                k += r
                append_i(base + min(k, 63))
                append_v(bits - (1 << s) + 1 if bits < (1 << (s - 1)) else bits)
                k += 1
            else:  # symbol 0: end of block
                p += 17
                break
    return p > nbits


def _read_bits(W: list, p: int, n: int) -> int:
    """The ``n`` ≤ 24 bits at bit ``p`` of a segment's windows, as an unsigned int."""
    return (W[p >> 3] >> (32 - n - (p & 7))) & ((1 << n) - 1)


def _decode_dc_first(segment: bytes, plan: list, blocks: list, preds: list, al: int, idx: list, vals: list):
    """A progressive DC first scan (``decode_mcu_DC_first``) over one restart
    interval: each block's DC difference, its predictor's sum shifted left by
    ``al`` at the block's coefficient 0. ``plan`` cycles over the blocks of an
    MCU: (DC table, index of the component in the scan). Corrupt data as in
    ``_decode_blocks``."""
    W = _windows(segment + bytes(PAST_END))
    nbits = 8 * len(segment)
    p = 0
    n_plan = len(plan)
    for j, base in enumerate(blocks):
        if p > nbits and j % n_plan == 0:
            return True
        dct, comp = plan[j % n_plan]
        w = (W[p >> 3] >> (16 - (p & 7))) & 0xFFFF
        tl, _, v = dct[w]
        if tl > 0:
            p += tl
        elif tl < 0:
            p -= tl
            if v:
                s = v
                bits = _read_bits(W, p, s)
                v = bits - (1 << s) + 1 if bits < (1 << (s - 1)) else bits
                p += s
        else:
            p += 17
        preds[comp] += v
        idx.append(base)
        vals.append(preds[comp] << al)
    return p > nbits


def _decode_ac_first(segment: bytes, act: list, blocks: list, ss: int, se: int, al: int, idx: list, vals: list):
    """A progressive AC first scan (``decode_mcu_AC_first``) of one component
    over one restart interval: coefficients ``ss``..``se`` (zigzag) of each
    block, shifted left by ``al``; an EOB_r symbol ends this block and the
    next 2^r − 1 + (r extra bits). Corrupt data as in ``_decode_blocks`` (a
    run past the band lands on coefficient min(k, 63), as libjpeg's padded
    ``jpeg_natural_order`` puts it)."""
    W = _windows(segment + bytes(PAST_END))
    nbits = 8 * len(segment)
    p = 0
    eobrun = 0
    append_i, append_v = idx.append, vals.append
    for base in blocks:
        if p > nbits:
            return True
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            w = (W[p >> 3] >> (16 - (p & 7))) & 0xFFFF
            tl, r, v = act[w]
            if tl > 0:
                p += tl
                if r >= EOB:
                    r -= EOB
                    eobrun = (1 << r) - 1
                    if r:
                        eobrun += _read_bits(W, p, r)
                        p += r
                    break
                k += r
                if v:
                    append_i(base + min(k, 63))
                    append_v(v << al)
                k += 1
            elif tl < 0:
                p -= tl
                s = v
                bits = _read_bits(W, p, s)
                p += s
                k += r
                append_i(base + min(k, 63))
                append_v((bits - (1 << s) + 1 if bits < (1 << (s - 1)) else bits) << al)
                k += 1
            else:  # symbol 0: EOB0
                p += 17
                break
    return p > nbits


def _decode_ac_refine(segment: bytes, act: list, blocks: list, masks: list, ss: int, se: int, new_i: list,
                      new_v: list, fix_i: list):
    """A progressive AC refine scan (``decode_mcu_AC_refine``) of one
    component over one restart interval. ``masks[j]`` has bit k set where
    block j's zigzag coefficient k was nonzero before this scan; each such
    coefficient in ``ss``..``se`` takes one correction bit — inside a zero
    run and inside an EOB run too — and its flat index goes to ``fix_i``
    where the bit is 1. A symbol of nonzero size makes the coefficient that
    ends its run of zeros ±1 (``new_i`` / ``new_v``, not yet shifted) by one
    sign bit, whatever the size (libjpeg warns of a size other than 1).
    Corrupt data as in ``_decode_ac_first``."""
    W = _windows(segment + bytes(PAST_END))
    nbits = 8 * len(segment)
    p = 0
    eobrun = 0
    for j, base in enumerate(blocks):
        if p > nbits:
            return True
        m = masks[j]
        k = ss
        if not eobrun:
            while k <= se:
                w = (W[p >> 3] >> (16 - (p & 7))) & 0xFFFF
                tl, r, v = act[w]
                if tl > 0:
                    if v in (0, 1, -1):
                        p += tl
                    else:  # a size past 1: its code, then one sign bit
                        p += tl - abs(v).bit_length()
                        v = 1 if (W[p >> 3] >> (31 - (p & 7))) & 1 else -1
                        p += 1
                elif tl < 0:  # a 16-bit code and its sign bit
                    p -= tl
                    v = 1 if (W[p >> 3] >> (31 - (p & 7))) & 1 else -1
                    p += 1
                else:  # symbol 0: EOB0
                    p += 17
                    r = EOB
                if r >= EOB:
                    r -= EOB
                    eobrun = 1 << r
                    if r:
                        eobrun += _read_bits(W, p, r)
                        p += r
                    break
                while k <= se:  # pass r zeros, stop at the next one
                    if (m >> k) & 1:
                        if (W[p >> 3] >> (31 - (p & 7))) & 1:
                            fix_i.append(base + k)
                        p += 1
                    elif r:
                        r -= 1
                    else:
                        break
                    k += 1
                if v:
                    new_i.append(base + min(k, 63))
                    new_v.append(v)
                k += 1
        if eobrun:
            rest = (m >> k) & ((1 << max(se + 1 - k, 0)) - 1)
            while rest:
                low = rest & -rest
                if (W[p >> 3] >> (31 - (p & 7))) & 1:
                    fix_i.append(base + k + low.bit_length() - 1)
                p += 1
                rest ^= low
            eobrun -= 1
    return p > nbits


def _next_marker(data: bytes, pos: int) -> tuple[int | None, int]:
    """``jdmarker.c``'s ``next_marker`` from ``pos``: bytes up to an 0xFF
    skipped, fill 0xFF bytes swallowed, a stuffed FF 00 passed over → (the
    marker code, the position after it), or (None, len(data)) at the end."""
    n = len(data)
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            return None, n
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            return None, n
        if data[pos]:
            return data[pos], pos + 1
        pos += 1


def _segment_data(data: bytes, pos: int) -> tuple[bytes, int, int, list]:
    """The bytes an entropy decoder reads from ``pos``: FF 00 (after any
    fill bytes) is one 0xFF, and the first marker ends them → (bytes, the
    marker, the position after it, (index, file bytes) of each 0xFF that
    took more than one); a file that ends first raises."""
    out = bytearray()
    stuffed = []
    n = len(data)
    while True:
        nxt = data.find(b"\xff", pos)
        if nxt < 0:
            raise ValueError("JPEG: scan data runs past the end of the file")
        out += data[pos:nxt]
        pos = nxt
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError("JPEG: scan data runs past the end of the file")
        if data[pos]:
            return bytes(out), data[pos], pos + 1, stuffed
        stuffed.append((len(out), pos + 1 - nxt))
        out.append(0xFF)
        pos += 1


def _scan_data(data: bytes, pos: int, intervals: int) -> tuple[list, int | None, int, list]:
    """The entropy-coded data of a scan of ``intervals`` restart intervals
    from ``pos``, as libjpeg reads it → (each interval's bytes, or None
    where the restart marker was left unread, the marker that ends the scan,
    the position after it, and for each interval (where its data starts,
    libjpeg having read that far, its multi-byte 0xFFs, the position after
    the marker that ends it)). Each interval's data ends
    at the first marker; before each later interval libjpeg wants RSTn (n
    the interval's number mod 8) and, meeting another marker, resynchronises
    (``jpeg_resync_to_restart``): a marker below SOF0 or a restart two or
    one behind is passed over to the next marker, a restart one or two
    ahead or a non-restart marker is left for later (the interval reads no
    data), any other restart is taken as the one wanted."""
    segments, reads = [], []
    marker = None  # the marker read and not yet used, and the position after it
    for i in range(intervals):
        if i:
            want = i - 1 & 7
            if marker is None:
                marker, pos = _next_marker(data, pos)
            while marker is not None and marker != 0xD0 + want:
                r = marker - 0xD0
                if marker < 0xC0 or (0 <= r <= 7 and r in ((want - 1) & 7, (want - 2) & 7)):
                    marker, pos = _next_marker(data, pos)  # discarded: on to the next one
                elif not 0 <= r <= 7 or r in ((want + 1) & 7, (want + 2) & 7):
                    break  # left unread
                else:
                    marker = 0xD0 + want  # taken as the restart wanted
            if marker is None:
                raise ValueError("JPEG: scan data runs past the end of the file")
            if marker == 0xD0 + want:
                marker = None
        if marker is not None:  # the decoder meets a marker at once: no data (None)
            segments.append(None)
            reads.append((pos, [], pos))
            continue
        start = pos
        segment, marker, pos, stuffed = _segment_data(data, pos)
        segments.append(segment)
        reads.append((start, stuffed, pos))
    if marker is None:
        marker, pos = _next_marker(data, pos)
    return segments, marker, pos, reads


# PIL hands libjpeg a JPEG in 64 KB reads (ImageFile.MAXBLOCK) and reads on
# only when libjpeg suspends, which its arithmetic decoder cannot do
# (JERR_CANT_SUSPEND): an arithmetic-coded scan whose decoder wants a byte past
# the last read fails PIL's load ("broken data stream").
PIL_BLOCK = 65536


def _arith_reach(segments: list, reads: list, fetched: list) -> int:
    """How far into the file libjpeg reads while decoding an arithmetic
    scan (``_scan_data``'s ``segments`` and ``reads``): each interval's
    decoder fetched ``fetched[i]`` of its bytes — past them it has read the
    marker after them —, and the restart marker after every interval but
    the last is read before the next one."""
    reach = 0
    for i, (segment, (start, stuffed, after), n) in enumerate(zip(segments, reads, fetched)):
        reach = max(reach, start)
        if segment is None:
            continue
        if n > len(segment) or i < len(segments) - 1:
            reach = max(reach, after)
        else:
            reach = max(reach, start + n + sum(k - 1 for j, k in stuffed if j < n))
    return reach


# libjpeg's jidctint.c constants (CONST_BITS 13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(x, shift: int):
    """One pass of libjpeg-turbo's SIMD ``jsimd_idct_islow`` (SSE2 / AVX2)
    along the first axis of ``x`` (8, ...; 16-bit values): ``jidctint.c``'s
    even and odd parts with the rotations folded into pairs of products
    (``pmaddwd``), the sums in0 ± in4, in7 + in3 and in5 + in1 taken in 16
    bits, the rest in 32; then DESCALE by ``shift`` and a saturating pack to
    16 bits (``packssdw``). On coefficients in range this is ``jidctint.c``
    exactly; past it, it is what PIL gives."""
    z2, z3 = x[2], x[6]
    tmp3 = z2 * (FIX_0_541196100 + FIX_0_765366865) + z3 * FIX_0_541196100
    tmp2 = z2 * FIX_0_541196100 + z3 * (FIX_0_541196100 - FIX_1_847759065)
    tmp0 = _wrap16(x[0] + x[4]) << CONST_BITS
    tmp1 = _wrap16(x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    i7, i5, i3, i1 = x[7], x[5], x[3], x[1]
    z3, z4 = _wrap16(i7 + i3), _wrap16(i5 + i1)
    z3, z4 = (z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602,
              z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644))
    tmp0 = i7 * (FIX_0_298631336 - FIX_0_899976223) - i1 * FIX_0_899976223 + z3
    tmp3 = -i7 * FIX_0_899976223 + i1 * (FIX_1_501321110 - FIX_0_899976223) + z4
    tmp1 = i5 * (FIX_2_053119869 - FIX_2_562915447) - i3 * FIX_2_562915447 + z4
    tmp2 = -i5 * FIX_2_562915447 + i3 * (FIX_3_072711026 - FIX_2_562915447) + z3
    out = np.stack([tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
                    tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3])
    out = ((out + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)  # 32-bit lanes
    return np.clip((out + (1 << (shift - 1))) >> shift, -32768, 32767)


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) natural-order coefficients and their (64,) quantizer → (N, 8,
    8) uint8 samples, libjpeg-turbo's SIMD islow IDCT (the one PIL runs) bit
    for bit: the dequantised coefficients kept to 16 bits (``pmullw``); a
    block whose rows 1-7 are all zero takes pass 1's shortcut, row 0 shifted
    left by PASS1_BITS in 16 bits; pass 2's results saturated to 8 bits
    (``packsswb``) around 128. On coefficients in range this is
    ``jpeg_idct_islow``."""
    x = _wrap16(coefs.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)  # [block, v, u]
    ws = _idct_1d(x.transpose(1, 0, 2), CONST_BITS - PASS1_BITS)  # pass 1: columns → [v_out, block, u]
    dc_only = ~(x[:, 1:, :] != 0).any(axis=(1, 2))
    ws = np.where(dc_only[None, :, None], _wrap16(x[:, 0, :] << PASS1_BITS)[None], ws)
    out = _idct_1d(ws.transpose(2, 1, 0), CONST_BITS + PASS1_BITS + 3)  # pass 2: rows → [x, block, y]
    return (np.clip(out.transpose(1, 2, 0), -128, 127) + 128).astype(np.uint8)


def _edge_rows(plane: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(rows above, rows below) each sample row's nearer neighbour, the first
    and last real rows repeated (``jdmainct.c``'s context rows)."""
    up = np.concatenate([plane[:1], plane[:-1]], axis=0)
    down = np.concatenate([plane[1:], plane[-1:]], axis=0)
    return up, down


def _fancy_h2(colsum_like: np.ndarray, bias_l: int, bias_r: int, shift: int, edge_mul: int) -> np.ndarray:
    """Horizontal triangle step of ``h2v1`` / ``h2v2``: out[2i] from
    3·c[i] + c[i−1], out[2i+1] from 3·c[i] + c[i+1], the edge columns
    ``edge_mul``·c with the same biases."""
    c = colsum_like
    left = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
    right = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
    even = (3 * c + left + bias_l) >> shift
    odd = (3 * c + right + bias_r) >> shift
    even[:, 0] = (edge_mul * c[:, 0] + bias_l) >> shift
    odd[:, -1] = (edge_mul * c[:, -1] + bias_r) >> shift
    return np.stack([even, odd], axis=-1).reshape(c.shape[0], -1)


def upsample(plane: np.ndarray, h_expand: int, v_expand: int) -> np.ndarray:
    """One component's real samples (its downsampled size) → full
    resolution, as ``jdsample.c`` chooses with fancy upsampling on."""
    p = plane.astype(np.int64)
    if h_expand == 1 and v_expand == 1:
        return p
    width = p.shape[1]
    if h_expand == 2 and v_expand == 1 and width > 2:  # h2v1_fancy_upsample
        out = _fancy_h2(p, 1, 2, 2, 4)
        out[:, 0] = p[:, 0]  # the edge columns keep the sample itself
        out[:, -1] = p[:, -1]
        return out
    if h_expand == 1 and v_expand == 2:  # h1v2_fancy_upsample
        up, down = _edge_rows(p)
        top = (3 * p + up + 1) >> 2
        bottom = (3 * p + down + 2) >> 2
        return np.stack([top, bottom], axis=1).reshape(-1, width)
    if h_expand == 2 and v_expand == 2 and width > 2:  # h2v2_fancy_upsample
        up, down = _edge_rows(p)
        rows = [_fancy_h2(3 * p + nb, 8, 7, 4, 4) for nb in (up, down)]
        return np.stack(rows, axis=1).reshape(-1, 2 * width)
    return np.repeat(np.repeat(p, v_expand, axis=0), h_expand, axis=1)  # int_upsample


def _ycc_tables():
    """``jdcolor.c``'s build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * (1 << 16) + 0.5)  # noqa: E731
    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def cmyk_to_rgb(c: np.ndarray, m: np.ndarray, y: np.ndarray, k: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of a CMYK image (``Convert.c``'s
    ``cmyk2rgb``): each channel (255 − k) − (channel·(255 − k) / 255, rounded
    the way ``MULDIV255`` rounds), clamped."""
    nk = 255 - k.astype(np.int64)
    out = []
    for ch in (c, m, y):
        t = ch.astype(np.int64) * nk + 128
        out.append(nk - (((t >> 8) + t) >> 8))
    return np.clip(np.stack(out, axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes → (H, W, 1) uint8 (grayscale) or (H, W, 3) RGB; four
    components come out as PIL's ``convert("RGB")`` of its CMYK image."""
    if not data.startswith(SIGNATURE + b"\xff"):  # PIL's JPEG plugin takes FF D8 FF only
        raise ValueError("not a JPEG file")
    frame, adobe_transform = _read_stream(data, {}, {}, {}, pil_header=True)
    return _reconstruct(frame, adobe_transform)


def decode_abbreviated(data: bytes, tables: bytes | None, ycc: bool, sampling: tuple = (1, 1),
                       memo: dict | None = None) -> np.ndarray:
    """One strip or tile of a JPEG-compressed TIFF as libtiff's JPEG codec
    hands it to libjpeg: first the tables-only stream of the ``JPEGTables``
    tag (SOI, DQT / DHT, EOI) where the file has one, whose tables stay
    defined for the strip's own SOI…EOI stream (which may carry none, or
    redefine some). → (rows, cols, components) uint8 at the stream's own
    size. ``ycc``: libjpeg's YCbCr → RGB (``JPEGCOLORMODE_RGB``: three
    components, fancy upsampling, ``jdcolor.c``'s tables); otherwise the
    components as stored (``JCS_UNKNOWN``). libtiff's checks: the first
    component sampled at ``sampling`` (the file's ``YCbCrSubsampling``,
    1×1 when not YCbCr), every other one at 1×1. ``memo``: Huffman tables
    already built, by their DHT bytes (the strips and tiles of one file
    repeat the same tables; building one takes ~14 ms)."""
    qt: dict[int, np.ndarray] = {}
    dc_tabs: dict[int, list] = {}
    ac_tabs: dict[int, list] = {}
    if tables:
        if not tables.startswith(SIGNATURE):
            raise ValueError("TIFF: JPEGTables is not a JPEG stream (libjpeg: not a JPEG file)")
        _read_stream(tables, qt, dc_tabs, ac_tabs, tables_only=True, memo=memo)
    if not data.startswith(SIGNATURE):
        raise ValueError("TIFF: a JPEG strip or tile does not start with SOI (libjpeg: not a JPEG file)")
    frame, _ = _read_stream(data, qt, dc_tabs, ac_tabs, memo=memo)
    factors = [(c["h"], c["v"]) for c in frame["comps"]]
    if factors[0] != tuple(sampling) or any(f != (1, 1) for f in factors[1:]):
        raise ValueError(f"TIFF: JPEG sampling factors {factors}, where the file says {tuple(sampling)} "
                         "(libtiff: improper JPEG sampling factors)")
    if ycc:
        if len(frame["comps"]) != 3:
            raise ValueError("TIFF: YCbCr JPEG data of other than three components")
        if frame["lossless"]:
            raise ValueError(f"TIFF: lossless YCbCr JPEG data, whose colour conversion libjpeg-turbo refuses in "
                             f"lossless mode: {UNREAD}")
        return ycc_to_rgb(*_planes(frame))
    return np.stack(_planes(frame), axis=-1).astype(np.uint8)


def decode_raw_planes(data: bytes) -> tuple[list, list, tuple]:
    """A JPEG stream's components as libjpeg's raw-data interface gives them
    (``jpeg_read_raw_data``: inverse-transformed, neither upsampled nor
    colour-converted) → (each component's samples over its whole padded
    block grid, each one's (h, v) sampling factors, the frame's (height,
    width)). libtiff's old-style JPEG codec reads a file so."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a JPEG stream")
    frame, _ = _read_stream(data, {}, {}, {})
    if frame["progressive"] or frame["arithmetic"] or frame["lossless"]:
        raise ValueError("TIFF: an old-style JPEG stream other than sequential Huffman (libtiff's old-style reader "
                         f"takes SOF0 and SOF1 only), {UNREAD}")
    return _samples(frame), [(c["h"], c["v"]) for c in frame["comps"]], (frame["height"], frame["width"])


def _read_stream(data: bytes, qt: dict, dc_tabs: dict, ac_tabs: dict, tables_only: bool = False,
                 memo: dict | None = None, pil_header: bool = False):
    """Read one SOI…EOI stream into ``qt`` / ``dc_tabs`` / ``ac_tabs`` (the
    tables defined so far; Huffman tables as their DHT bytes, built at the
    scans that use them, into ``memo``) → (frame with its coefficients, or a
    lossless frame's samples, decoded; Adobe transform). ``tables_only``: a
    stream with no frame (libjpeg's ``JPEG_HEADER_TABLES_ONLY``).

    The markers as ``jdmarker.c`` reads them: bytes between markers skipped,
    FF 00 passed over, an unknown marker, a second SOI or SOF, a segment of
    the wrong length, a table number past 3 refused; APPn, COM, DNL, RSTn
    and TEM skipped. ``pil_header``: PIL's own parse up to the first scan
    too (``JpegImagePlugin``): it refuses TEM and the reserved markers there,
    and a JFIF or Adobe segment too short for its version field. The colour
    markers count where libjpeg reads them, before the first scan. The end:
    a file of one scan may end anywhere after it (libjpeg has its rows; PIL
    ignores the suspended ``jpeg_finish_decompress``), a multi-scan file
    must reach EOI, and a second scan in a one-scan file is refused
    (``JERR_EOI_EXPECTED``). With ``pil_header`` an arithmetic-coded scan
    that reads past PIL's last 64 KB read is refused (``PIL_BLOCK``)."""
    memo = {} if memo is None else memo
    frame = None
    restart = 0
    adobe_transform = None
    jfif = False
    colour = None  # (JFIF, Adobe transform) as libjpeg has them at the first scan
    multi_scan = None  # None before the first scan
    conditioning = {"L": [0] * 16, "U": [1] * 16, "K": [5] * 16}  # DAC's defaults, reset by SOI
    window = PIL_BLOCK  # how far PIL has read (its reads go on while libjpeg suspends in the markers)
    marker, pos = _next_marker(data, 2)
    while True:
        if marker is None:
            if frame is not None and multi_scan is False:
                break  # libjpeg suspends, PIL has every row
            raise ValueError("JPEG ends before EOI")
        if marker == 0xD9:  # EOI
            break
        if marker == 0xD8:
            raise ValueError("JPEG: a second SOI (libjpeg: invalid JPEG file structure)")
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # parameterless
            if marker == 0x01 and pil_header and multi_scan is None:
                raise ValueError("JPEG: a TEM marker before the first scan, where PIL finds no marker")
            marker, pos = _next_marker(data, pos)
            continue
        if not (0xC0 <= marker <= 0xCF or 0xDA <= marker <= 0xDD or 0xE0 <= marker <= 0xEF or marker == 0xFE):
            raise ValueError(f"JPEG: marker 0x{marker:02X}, which libjpeg does not know")
        if marker in SOF_UNREAD or marker == 0xC8:
            raise ValueError(f"{SOF_UNREAD.get(marker, 'JPG (0xC8)')} JPEG, {UNREAD}")
        if marker in SOF_KINDS and frame is not None:
            raise ValueError("JPEG: a second frame header (libjpeg: invalid JPEG file structure)")
        if pos + 2 > len(data):
            marker = None
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        if pos + max(length, 2) > len(data):  # libjpeg refuses what it could read, or waits for more
            _check_cut_segment(marker, data[pos:], frame, multi_scan)
            if frame is not None and multi_scan is False:
                break
            raise ValueError("JPEG: a marker segment runs past the end of the file")
        body = data[pos + 2:pos + length]
        pos += max(length, 2)
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                prec, tid = body[i] >> 4, body[i] & 15
                n = 128 if prec else 64
                if tid > 3 or i + 1 + n > len(body):
                    raise ValueError("JPEG: bogus DQT marker")
                raw = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if prec else np.uint8).astype(np.int64)
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = raw
                qt[tid] = q
                i += 1 + n
        elif marker == 0xC4:  # DHT (jdmarker.c's get_dht; jdhuff.c checks a table where a scan uses it)
            i = 0
            while len(body) - i > 16:
                index = body[i]
                counts = body[i + 1:i + 17]
                n = sum(counts)
                if n > 256 or n > len(body) - i - 17 or (index & ~0x10) > 3:
                    raise ValueError("JPEG: bogus DHT marker")
                (ac_tabs if index & 0x10 else dc_tabs)[index & 3] = body[i + 1:i + 17 + n]
                i += 17 + n
            if i != len(body):
                raise ValueError("JPEG: bogus DHT marker length")
        elif marker == 0xCC:  # DAC: arithmetic conditioning (jdmarker.c's get_dac)
            if len(body) % 2 or len(body) != length - 2:
                raise ValueError("JPEG: bogus DAC marker length")
            for i in range(0, len(body), 2):
                index, val = body[i], body[i + 1]
                if index >= 32:
                    raise ValueError(f"JPEG: bogus DAC index {index}")
                if index >= 16:
                    conditioning["K"][index - 16] = val
                else:
                    if val & 15 > val >> 4:
                        raise ValueError(f"JPEG: bogus DAC value 0x{val:02x}")
                    conditioning["L"][index], conditioning["U"][index] = val & 15, val >> 4
        elif marker in SOF_KINDS:
            frame = _frame_header(body, *SOF_KINDS[marker])
        elif marker == 0xDD:  # DRI
            if length != 4:
                raise ValueError("JPEG: bogus DRI marker length")
            (restart,) = struct.unpack(">H", body[:2])
        elif 0xE0 <= marker <= 0xEF or marker in (0xFE, 0xDC):  # APPn, COM, DNL
            if pil_header and multi_scan is None and ((marker == 0xE0 and body[:4] == b"JFIF")
                                                      or (marker == 0xEE and body[:5] == b"Adobe")) and len(body) < 7:
                raise ValueError("JPEG: a JFIF or Adobe segment too short for PIL")
            if marker == 0xE0 and body[:5] == b"JFIF\0" and len(body) >= 14:
                jfif = True
            elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                adobe_transform = body[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG: scan before frame header")
            ns = body[0] if body else 0
            if not 1 <= ns <= 4 or length != 6 + 2 * ns:
                raise ValueError("JPEG: bogus SOS marker length")
            if multi_scan is False:
                raise ValueError("JPEG: a second scan in a file of one scan (libjpeg: EOI expected)")
            scan = _scan_components(frame, body, qt)
            ss, se, ah_al = body[1 + 2 * ns:4 + 2 * ns]
            if multi_scan is None:
                colour = (jfif, adobe_transform)
                multi_scan = frame["progressive"] or len(scan) < len(frame["comps"])
                if not (frame["progressive"] or frame["arithmetic"] or frame["lossless"]):
                    for tid in (0, 1):  # jinit_huff_decoder's std_huff_tables
                        dc_tabs.setdefault(tid, _STD_DC[tid])
                        ac_tabs.setdefault(tid, _STD_AC[tid])
            window = max(window, -(-pos // PIL_BLOCK) * PIL_BLOCK)
            marker, pos, reach = _decode_scan_data(frame, scan, data, pos, restart, ss, se, ah_al, dc_tabs, ac_tabs,
                                                   conditioning, memo)
            if pil_header and reach is not None and reach > window:
                raise ValueError(f"JPEG: an arithmetic-coded scan reading to byte {reach} past PIL's read to "
                                 f"{window} (PIL reads {PIL_BLOCK} bytes at a time and libjpeg's arithmetic decoder "
                                 f"cannot wait for more), {UNREAD}")
            continue
        marker, pos = _next_marker(data, pos)
    if tables_only:
        if frame is not None:
            raise ValueError("TIFF: JPEGTables holds a frame (libjpeg: bogus DQT / DHT stream)")
        return None, None
    if frame is None:
        raise ValueError("JPEG has no frame header")
    if multi_scan is None:
        raise ValueError("JPEG has no scan")
    for c in frame["comps"]:
        if not c["scanned"] and frame["lossless"]:
            raise ValueError(f"JPEG: component {c['id']} is in no scan")
    frame["jfif"] = colour[0]
    return frame, colour[1]


def _check_cut_segment(marker: int, rest: bytes, frame: dict | None, multi_scan: bool | None):
    """A marker segment the file ends inside (``rest``: from its length
    field): raise where libjpeg, reading it field by field, refuses it before
    the bytes run out (``get_dqt``, ``get_dht``, ``get_dri``, ``get_dac``,
    ``get_sof``, ``get_sos``)."""
    length = int.from_bytes(rest[:2], "big")
    body = rest[2:]
    if marker == 0xDD or (marker in (0xDB, 0xC4, 0xCC) and length < 2) or (marker == 0xC4 and 2 < length <= 18):
        raise ValueError("JPEG: bogus marker length")
    if marker == 0xDB:
        i = 0
        while i < len(body):
            if body[i] & 15 > 3:
                raise ValueError("JPEG: bogus DQT marker")
            i += 1 + (128 if body[i] >> 4 else 64)
    elif marker == 0xC4 and len(body) >= 17:
        count = sum(body[1:17])
        if count > 256 or count > length - 2 - 17 or (len(body) > 17 + count and body[0] & ~0x10 > 3):
            raise ValueError("JPEG: bogus DHT marker")
    elif marker == 0xCC:
        for i in range(0, len(body) - 1, 2):
            if body[i] >= 32 or (body[i] < 16 and body[i + 1] & 15 > body[i + 1] >> 4):
                raise ValueError("JPEG: bogus DAC marker")
    elif marker == 0xDA and body:
        if frame is None or not 1 <= body[0] <= 4 or length != 6 + 2 * body[0]:
            raise ValueError("JPEG: bogus SOS marker")
        for k in range(min(body[0], (len(body) - 1) // 2)):
            if all(c["id"] != body[1 + 2 * k] for c in frame["comps"]):
                raise ValueError(f"JPEG: a scan names component {body[1 + 2 * k]}, which the frame does not have")
    elif marker in SOF_KINDS and len(body) >= 6 and (body[0] != 8 or body[5] not in (1, 3, 4)):
        raise ValueError("JPEG: a frame header PIL and libjpeg refuse")


def _scan_components(frame: dict, body: bytes, qt: dict) -> list:
    """An SOS header's components → (component, DC table, AC table) each,
    its quantisation table latched at its first scan (``latch_quant_tables``;
    a lossless frame has none). Each id names the first component of that
    id the scan has not taken yet (``get_sos``)."""
    ns = body[0]
    scan = []
    for k in range(ns):
        cid, tables = body[1 + 2 * k], body[2 + 2 * k]
        c = next((c for c in frame["comps"] if c["id"] == cid and all(c is not d for d, _, _ in scan)), None)
        if c is None:
            raise ValueError(f"JPEG: a scan names component {cid}, which the frame does not have")
        if c["quant"] is None and not frame["lossless"]:
            if c["tq"] not in qt:
                raise ValueError(f"JPEG: quantisation table {c['tq']} is not defined")
            c["quant"] = qt[c["tq"]].copy()
        c["scanned"] = True
        scan.append((c, tables >> 4, tables & 15))
    if ns > 1 and sum(c["h"] * c["v"] for c, _, _ in scan) > 10:
        raise ValueError("JPEG: more than 10 blocks an MCU (libjpeg: sampling factors too large)")
    return scan


def _decode_scan_data(frame: dict, scan: list, data: bytes, pos: int, restart: int, ss: int, se: int, ah_al: int,
                      dc_tabs: dict, ac_tabs: dict, conditioning: dict, memo: dict) -> tuple:
    """Read one scan's entropy-coded data from ``pos`` and decode it into the
    frame → (the marker after it, the position after that marker, and for
    an arithmetic scan how far into the file its decoding read)."""
    from . import _jpeg_arith, _jpeg_lossless

    comps = [c for c, _, _ in scan]
    if frame["lossless"]:
        per_row = comps[0]["w"] if len(comps) == 1 else frame["mcux"]
        rows = comps[0]["h_px"] if len(comps) == 1 else frame["mcuy"]
        if not 1 <= ss <= 7 or se or ah_al >> 4 or (ah_al & 15) >= 8:
            raise ValueError(f"JPEG: invalid lossless scan (Ss {ss}, Se {se}, Ah {ah_al >> 4}, Al {ah_al & 15})")
        if restart % per_row:
            raise ValueError(f"JPEG: lossless restart interval {restart}, not a multiple of the {per_row} MCUs of "
                             "a row (libjpeg: invalid restart interval)")
        mcus = per_row * rows
    else:
        order, slots = _scan_blocks(frame, comps)
        mcus = len(order) // len(slots)
    segments, marker, end, reads = _scan_data(data, pos, -(-mcus // restart) if restart else 1)
    fetched = None
    if frame["lossless"]:
        _jpeg_lossless.decode_scan(frame, [(c, _table(dc_tabs, d, "DC", memo, 16)) for c, d, _ in scan], segments,
                                   restart, ss, ah_al & 15)
    elif frame["progressive"]:
        fetched = _decode_progressive_scan(frame, scan, dc_tabs, ac_tabs, conditioning, segments, restart, ss, se,
                                           ah_al >> 4, ah_al & 15, memo)
    elif frame["arithmetic"]:
        idx, vals, fetched = [], [], []
        for segment, blocks in _intervals(order, len(slots), restart, segments):
            fetched.append(_jpeg_arith.decode_sequential(segment or b"", scan, slots, conditioning, blocks, idx,
                                                         vals))
        frame["coefs"].reshape(-1)[np.asarray(idx, np.int64)] = _jcoef(vals)
    else:
        _decode_scan(frame, [(c, _table(dc_tabs, d, "DC", memo), _table(ac_tabs, a, "AC", memo))
                             for c, d, a in scan], segments, restart)
    reach = _arith_reach(segments, reads, fetched) if fetched is not None else None
    return marker, end, reach


# T.81 Annex K.3's tables (libjpeg's std_huff_tables), as DHT bytes: the counts
# of each code length, then the symbols. jdhuff.c puts them in tables 0 and 1
# of a sequential Huffman file that has not defined those by its first scan.
_STD_DC = {0: bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]) + bytes(range(12)),
           1: bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]) + bytes(range(12))}
_STD_AC = {
    0: bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]) + bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a"
        "3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a9293"
        "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6"
        "e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    1: bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]) + bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a2627"
        "28292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788"
        "898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3"
        "e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}

# SOF marker → (progressive, arithmetic, lossless)
SOF_KINDS = {0xC0: (False, False, False), 0xC1: (False, False, False), 0xC2: (True, False, False),
             0xC3: (False, False, True), 0xC9: (False, True, False), 0xCA: (True, True, False)}


def _table(tables: dict, tid: int, kind: str, memo: dict, max_symbol: int = 15) -> list:
    """The lookahead table of Huffman table ``tid`` as a scan uses it,
    built from its DHT bytes once (``memo``), checked as ``jdhuff.c``'s
    ``jpeg_make_d_derived_tbl`` checks it then (a DC symbol past 15 only in
    a lossless frame)."""
    if tid not in tables:
        raise ValueError(f"JPEG: {kind} Huffman table {tid} is not defined")
    key = (kind, tables[tid])
    if key not in memo:
        counts = np.frombuffer(tables[tid][:16], np.uint8)
        memo[key] = _huffman_table(counts, tables[tid][16:], ac=kind == "AC")
    table = memo[key]
    if kind == "DC" and table.max_symbol > max_symbol:
        raise ValueError("JPEG: bogus Huffman table definition")
    return table


def _frame_header(body: bytes, progressive: bool, arithmetic: bool, lossless: bool) -> dict:
    """SOF0-3, SOF9, SOF10: the components, their block grids (padded to the
    MCU grid; a lossless frame's "blocks" are samples) and real sizes, and
    the zeroed coefficient store. ``get_sof``'s and ``initial_setup``'s
    checks: the length, a nonzero size up to 65,500, sampling factors 1-4
    (ids may repeat: a scan takes the first component of an id it has not
    taken yet)."""
    if len(body) < 6:
        raise ValueError("JPEG: bogus SOF marker length")
    prec, height, width, ncomp = struct.unpack(">BHHB", body[:6])
    if prec != 8:
        raise ValueError(f"{prec}-bit JPEG samples, {UNREAD}")
    if ncomp not in (1, 3, 4) or not height or not width:
        raise ValueError(f"a {width}x{height} JPEG of {ncomp} components, {UNREAD}")
    if len(body) != 6 + 3 * ncomp:
        raise ValueError("JPEG: bogus SOF marker length")
    if max(height, width) > 65500:
        raise ValueError(f"a {width}x{height} JPEG, past libjpeg's 65,500, {UNREAD}")
    comps = []
    for c in range(ncomp):
        cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
        if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
            raise ValueError(f"JPEG: sampling factors {hv >> 4}x{hv & 15} (libjpeg: bogus sampling factors)")
        comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq, quant=None, scanned=False, bits=np.full(64, -1)))
    unit = 1 if lossless else 8
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    mcux, mcuy = -(-width // (unit * hmax)), -(-height // (unit * vmax))
    offset = 0
    for c in comps:
        c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]  # blocks, padded to the MCU grid
        c["w"] = -(-width * c["h"] // hmax)  # the component's real (downsampled) size
        c["h_px"] = -(-height * c["v"] // vmax)
        c["offset"] = offset
        offset += c["bw"] * c["bh"]
    return dict(width=width, height=height, comps=comps, hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy,
                progressive=progressive, arithmetic=arithmetic, lossless=lossless,
                coefs=None if lossless else np.zeros((offset, 64), np.int32))


def _scan_blocks(frame: dict, comps: list) -> tuple[np.ndarray, list]:
    """The blocks a scan codes, in its order, and for each block of an MCU
    the index of its component in the scan."""
    if len(comps) == 1:  # non-interleaved: one block an MCU, over the component's real blocks
        c = comps[0]
        bw, bh = -(-c["w"] // 8), -(-c["h_px"] // 8)
        yy, xx = np.mgrid[0:bh, 0:bw]
        return (c["offset"] + yy * c["bw"] + xx).ravel(), [0]
    my, mx = np.mgrid[0:frame["mcuy"], 0:frame["mcux"]]
    parts, slots = [], []
    for ci, c in enumerate(comps):
        for by in range(c["v"]):
            for bx in range(c["h"]):
                parts.append(c["offset"] + (my * c["v"] + by) * c["bw"] + mx * c["h"] + bx)
                slots.append(ci)
    return np.stack([p.ravel() for p in parts], axis=-1).ravel(), slots


def _jcoef(values) -> np.ndarray:
    """Values as libjpeg's 16-bit ``JCOEF`` stores them (a DC sum, a value
    shifted by Al)."""
    v = np.asarray(values, np.int64)
    return ((v + 32768) & 0xFFFF) - 32768


def _intervals(order: np.ndarray, per_mcu: int, restart: int, segments: list) -> list:
    """(entropy-coded segment, flat offsets (block × 64) of its blocks), one
    pair a restart interval; an interval past the scan's last restart marker
    has no data (None: libjpeg reads it as zeros)."""
    bases = (order * 64).tolist()
    total_mcus = len(bases) // per_mcu
    interval = restart if restart else total_mcus
    return [(segments[s] if s < len(segments) else None, bases[start * per_mcu:(start + interval) * per_mcu])
            for s, start in enumerate(range(0, total_mcus, interval))]


def _decode_scan(frame: dict, scan: list, segments: list, restart: int):
    """A sequential scan: every coefficient of its blocks, into the store."""
    order, slots = _scan_blocks(frame, [c for c, _, _ in scan])
    plan = [(scan[ci][1], scan[ci][2], ci) for ci in slots]
    idx, vals = [], []
    out = False
    for segment, blocks in _intervals(order, len(slots), restart, segments):
        if segment is None and out:  # no data, and libjpeg's insufficient_data still set: nothing decoded
            continue
        out = _decode_blocks(segment or b"", plan, len(blocks), blocks, [0] * len(scan), idx, vals)
    frame["coefs"].reshape(-1)[np.asarray(idx, np.int64)] = _jcoef(vals)


def _decode_progressive_scan(frame: dict, scan: list, dc_tabs: dict, ac_tabs: dict, conditioning: dict,
                             segments: list, restart: int, ss: int, se: int, ah: int, al: int, memo: dict):
    """One scan of a progressive frame (``jdphuff.c``, or ``jdarith.c`` for
    SOF10): DC first or refine, AC first or refine, each updating the
    coefficient store in place; each component's per-coefficient precision
    (``coef_bits``) kept in ``c["bits"]`` (−1 unsent, else the bit a later
    refine scan sends): the scan's Al over its band, whatever it was before
    (libjpeg warns of a scan out of order and decodes it as it stands). →
    the bytes each interval's arithmetic decoder read (None if Huffman)."""
    from . import _jpeg_arith as arith

    comps = [c for c, _, _ in scan]
    dc = ss == 0
    if (se != 0 if dc else (ss > se or se > 63 or len(comps) != 1)) or (ah and al != ah - 1) or al > 13:
        raise ValueError(f"JPEG: invalid progressive scan (Ss {ss}, Se {se}, Ah {ah}, Al {al})")
    arithmetic = frame["arithmetic"]
    p1 = 1 << al
    coefs = frame["coefs"].reshape(-1)
    order, slots = _scan_blocks(frame, comps)
    # (data, blocks, no data: where the one before ran out, libjpeg's insufficient_data stays set and a
    # Huffman decoder decodes nothing)
    intervals = [(segment or b"", blocks, segment is None) for segment, blocks in
                 _intervals(order, len(slots), restart, segments)]
    fetched = [] if arithmetic else None  # the bytes each arithmetic interval's decoder read
    if dc and not ah:
        idx, vals = [], []
        if arithmetic:
            for segment, blocks, _ in intervals:
                fetched.append(arith.decode_dc_first(segment, scan, slots, conditioning, blocks, al, idx, vals))
        else:
            plan = [(_table(dc_tabs, scan[ci][1], "DC", memo), ci) for ci in slots]
            out = False
            for segment, blocks, none in intervals:
                if not (none and out):
                    out = _decode_dc_first(segment, plan, blocks, [0] * len(scan), al, idx, vals)
        coefs[np.asarray(idx, np.int64)] = _jcoef(vals)
    elif dc:  # DC refine: one raw bit (or fixed-bin decision) a block; no data reads as zeros
        hit = []
        for segment, blocks, _ in intervals:
            if arithmetic:
                fetched.append(arith.decode_dc_refine(segment, blocks, hit))
                continue
            bits = np.unpackbits(np.frombuffer(segment, np.uint8))
            bits = np.pad(bits, (0, max(len(blocks) - bits.size, 0)))  # libjpeg reads zeros past the data
            hit.extend(np.asarray(blocks, np.int64)[bits[:len(blocks)] == 1].tolist())
        coefs[np.asarray(hit, np.int64)] |= p1
    elif not ah:
        idx, vals = [], []
        if arithmetic:
            for segment, blocks, _ in intervals:
                fetched.append(arith.decode_ac_first(segment, conditioning["K"][scan[0][2]], blocks, ss, se, al, idx,
                                                     vals))
        else:
            act = _table(ac_tabs, scan[0][2], "AC", memo)
            out = False
            for segment, blocks, none in intervals:
                if not (none and out):
                    out = _decode_ac_first(segment, act, blocks, ss, se, al, idx, vals)
        coefs[np.asarray(idx, np.int64)] = _jcoef(vals)
    else:
        nz = frame["coefs"][order] != 0
        masks = (nz.astype(np.uint64) << np.arange(64, dtype=np.uint64)).sum(axis=1, dtype=np.uint64).tolist()
        new_i, new_v, fix_i = [], [], []
        j = 0
        act = None if arithmetic else _table(ac_tabs, scan[0][2], "AC", memo)
        out = False
        for segment, blocks, none in intervals:
            if arithmetic:
                fetched.append(arith.decode_ac_refine(segment, blocks, masks[j:j + len(blocks)], ss, se, new_i, new_v,
                                                      fix_i))
            elif not (none and out):
                out = _decode_ac_refine(segment, act, blocks, masks[j:j + len(blocks)], ss, se, new_i, new_v, fix_i)
            j += len(blocks)
        fix = np.asarray(fix_i, np.int64)
        old = coefs[fix].astype(np.int64)
        step = np.where(old >= 0, p1, -p1)
        if arithmetic:  # jdarith.c adds the correction whatever bit is there
            coefs[fix] = _jcoef(old + step)
        else:  # jdphuff.c only where that bit is still clear
            coefs[fix] = _jcoef(np.where(old & p1, old, old + step))
        coefs[np.asarray(new_i, np.int64)] = np.asarray(new_v, np.int64) * p1
    for c in comps:
        c["bits"][ss:se + 1] = al
    return fetched


# natural positions of zigzag coefficients 1-9, the ones jdcoefct.c's block smoothing estimates
SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)
def _smoothing_weights() -> tuple[dict, dict, np.ndarray]:
    """``decompress_smooth_data``'s kernels as 5×5 arrays (DC01..DC25 row by
    row): the estimate of each of SMOOTH_POS when some AC data is known, when
    none is (``change_dc``), and the DC's own estimate when none is."""
    def grid(terms: dict) -> np.ndarray:
        g = np.zeros(25, np.int64)
        for k, w in terms.items():
            g[k - 1] = w
        return g.reshape(5, 5)

    ac = {
        1: grid({11: -7, 12: 50, 14: -50, 15: 7}),
        8: grid({3: -7, 8: 50, 18: -50, 23: 7}),
        16: grid({3: -1, 8: 13, 13: -24, 18: 13, 23: -1}),
        9: grid({10: 1, 16: 1, 17: -10, 19: 10, 2: -1, 20: -1, 22: 1, 24: -1, 4: 1, 6: -1, 7: 10, 9: -10}),
        2: grid({11: -1, 12: 13, 13: -24, 14: 13, 15: -1}),
    }
    dc_only = {
        1: grid({1: -1, 2: -1, 4: 1, 5: 1, 6: -3, 7: 13, 9: -13, 10: 3, 11: -3, 12: 38, 14: -38, 15: 3, 16: -3,
                 17: 13, 19: -13, 20: 3, 21: -1, 22: -1, 24: 1, 25: 1}),
        8: grid({1: -1, 2: -3, 3: -3, 4: -3, 5: -1, 6: -1, 7: 13, 8: 38, 9: 13, 10: -1, 16: 1, 17: -13, 18: -38,
                 19: -13, 20: 1, 21: 1, 22: 3, 23: 3, 24: 3, 25: 1}),
        16: grid({3: 1, 7: 2, 8: 7, 9: 2, 12: -5, 13: -14, 14: -5, 17: 2, 18: 7, 19: 2, 23: 1}),
        9: grid({1: -1, 5: 1, 7: 9, 9: -9, 17: -9, 19: 9, 21: 1, 25: -1}),
        2: grid({7: 2, 8: -5, 9: 2, 11: 1, 12: 7, 13: -14, 14: 7, 15: 1, 17: 2, 18: -5, 19: 2}),
        3: grid({7: 1, 9: -1, 12: 2, 14: -2, 17: 1, 19: -1}),
        10: grid({7: 1, 8: -3, 9: 1, 17: -1, 18: 3, 19: -1}),
        17: grid({7: 1, 9: -1, 12: -3, 14: 3, 17: 1, 19: -1}),
        24: grid({7: 1, 8: 2, 9: 1, 17: -1, 18: -2, 19: -1}),
    }
    dc = grid({1: -2, 2: -6, 3: -8, 4: -6, 5: -2, 6: -6, 7: 6, 8: 42, 9: 6, 10: -6, 11: -8, 12: 42, 13: 152,
               14: 42, 15: -8, 16: -6, 17: 6, 18: 42, 19: 6, 20: -6, 21: -2, 22: -6, 23: -8, 24: -6, 25: -2})
    return ac, dc_only, dc


_SMOOTH_AC, _SMOOTH_DC_ONLY, _SMOOTH_DC = _smoothing_weights()


def _smoothing_ok(frame: dict) -> bool:
    """``jdcoefct.c``'s ``smoothing_ok``: a progressive frame whose every
    component has its DC at least partly known and nonzero quantisers at DC
    and SMOOTH_POS, and where some component's first nine AC coefficients
    are not all exact."""
    if not frame["progressive"]:
        return False
    useful = False
    for c in frame["comps"]:
        if c["quant"] is None or (c["quant"][[0, *SMOOTH_POS]] == 0).any() or c["bits"][0] < 0:
            return False
        useful |= bool((c["bits"][1:10] != 0).any())
    return useful


def _smooth_rows(c: dict, frame: dict) -> list:
    """For each real block row of component ``c``, the block rows that
    ``decompress_smooth_data`` takes as two above, one above, itself, one
    below and two below: clamped at the image's edges, where "the image"
    is ``image_block_rows`` = block_rows × total_iMCU_rows and the row's
    index ``output_iMCU_row`` × block_rows + block_row, block_rows being the
    real rows of the iMCU row (fewer in the last one: there both are not the
    row's true position, which libjpeg-turbo leaves so)."""
    v, total = c["v"], frame["mcuy"]
    real = -(-c["h_px"] // 8)
    out = []
    for r in range(real):
        imcu, b = divmod(r, v)
        rows = v if imcu < total - 1 else real - (total - 1) * v
        index, count = imcu * rows + b, rows * total
        prev = r - 1 if index > 0 else r
        prev2 = r - 2 if index > 1 else prev
        nxt = r + 1 if index < count - 1 else r
        nxt2 = r + 2 if index < count - 2 else nxt
        out.append((prev2, prev, r, nxt, nxt2))
    return out


def _smooth(frame: dict, c: dict, natural: np.ndarray):
    """``decompress_smooth_data`` on component ``c``'s real blocks of
    ``natural`` (its (blocks, 64) natural-order coefficients over the
    padded block grid), in place: each of the first nine AC coefficients
    still imprecise (``coef_bits`` ≠ 0) and zero takes an estimate from the
    5×5 DC values around it (rows by ``_smooth_rows``, columns clamped to
    the real blocks), rounded half away from zero, clamped to the bits not
    yet known; where no AC coefficient has been sent at all the DC value
    is estimated too."""
    bits = c["bits"]
    change_dc = bool((bits[1:10] == -1).all())
    q = c["quant"].astype(np.int64)
    bh, bw = c["bh"], c["bw"]
    real_w = -(-c["w"] // 8)
    blocks = natural[c["offset"]:c["offset"] + bw * bh].reshape(bh, bw, 64)
    dcs = blocks[..., 0].astype(np.int64)
    rows = np.asarray(_smooth_rows(c, frame), np.int64)  # (real rows, 5)
    cols = np.clip(np.arange(real_w)[:, None] + np.arange(-2, 3)[None, :], 0, real_w - 1)  # (real cols, 5)
    nb = dcs[rows[:, :, None, None], cols[None, None, :, :]]  # (real rows, 5, real cols, 5)
    nb = nb.transpose(0, 2, 1, 3)  # (row, col, 5, 5)
    real = blocks[:rows.shape[0], :real_w]
    kernels = _SMOOTH_DC_ONLY if change_dc else _SMOOTH_AC
    for k, pos in enumerate(SMOOTH_POS, start=1):
        if pos not in kernels or bits[k] == 0:
            continue
        num = q[0] * np.einsum("rcij,ij->rc", nb, kernels[pos])
        pred = (q[pos] * 128 + np.abs(num)) // (q[pos] * 256)
        if bits[k] > 0:
            pred = np.minimum(pred, (1 << int(bits[k])) - 1)
        pred = np.where(num < 0, -pred, pred)
        cur = real[..., pos]
        real[..., pos] = np.where(cur == 0, pred, cur)
    if change_dc:
        num = q[0] * np.einsum("rcij,ij->rc", nb, _SMOOTH_DC)
        pred = (q[0] * 128 + np.abs(num)) // (q[0] * 256)
        real[..., 0] = np.where(num < 0, -pred, pred)


def _samples(frame: dict) -> list:
    """Each component's samples: a DCT frame's inverse-transformed over its
    whole block grid (padded to the MCU grid), block-smoothed where libjpeg
    smooths; a lossless frame's at its real size."""
    if frame["lossless"]:
        return [c["samples"] for c in frame["comps"]]
    natural = frame["coefs"][:, UNZIGZAG]
    if _smoothing_ok(frame):
        natural = natural.astype(np.int64)
        for c in frame["comps"]:
            _smooth(frame, c, natural)
    out = []
    for c in frame["comps"]:
        blocks = natural[c["offset"]:c["offset"] + c["bw"] * c["bh"]]
        quant = c["quant"] if c["quant"] is not None else np.zeros(64, np.int64)  # in no scan: all 128
        pix = idct_islow(blocks, quant).reshape(c["bh"], c["bw"], 8, 8)
        out.append(pix.transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8))
    return out


def _planes(frame: dict) -> list:
    """Each component's samples upsampled to the frame's size (a lossless
    frame's by replication: libjpeg takes no fancy upsampling without
    context rows, which a one-sample block has not)."""
    out = []
    for plane, c in zip(_samples(frame), frame["comps"]):
        h, v = frame["hmax"] // c["h"], frame["vmax"] // c["v"]
        plane = plane[: c["h_px"], : c["w"]]
        if frame["lossless"]:
            plane = np.repeat(np.repeat(plane.astype(np.int64), v, axis=0), h, axis=1)
        else:
            plane = upsample(plane, h, v)
        out.append(plane[:frame["height"], :frame["width"]])
    return out


def _rgb_stored(frame: dict, adobe_transform) -> bool:
    """Three components: RGB as stored, else YCbCr (``jdapimin.c``'s
    ``default_decompress_parms``: a lossless frame without a JFIF or Adobe
    marker is RGB whatever its component ids)."""
    if frame["jfif"]:
        return False
    if adobe_transform is not None:
        return adobe_transform == 0
    ids = tuple(c["id"] for c in frame["comps"])
    return frame["lossless"] or ids == (82, 71, 66)


def _reconstruct(frame: dict, adobe_transform) -> np.ndarray:
    n = len(frame["comps"])
    if frame["lossless"] and ((n == 3 and not _rgb_stored(frame, adobe_transform))
                              or (n == 4 and adobe_transform not in (None, 0))):
        raise ValueError(f"a lossless JPEG stored as {'YCbCr' if n == 3 else 'YCCK'}, whose colour conversion "
                         f"libjpeg-turbo refuses in lossless mode: {UNREAD}")
    planes = _planes(frame)
    if len(planes) == 1:
        return planes[0].astype(np.uint8)[..., None]
    if len(planes) == 3:
        if _rgb_stored(frame, adobe_transform):
            return np.stack(planes, axis=-1).astype(np.uint8)
        return ycc_to_rgb(*planes)
    # Four components: libjpeg's CMYK (no Adobe marker, or transform 0) or
    # YCCK (any other transform: YCbCr → RGB, then 255 − each, K as stored).
    # PIL reads them inverted (rawmode "CMYK;I"), so its C, M, Y are
    # 255 − the CMYK samples, or the YCCK file's R, G, B themselves.
    if adobe_transform in (None, 0):
        cmy = [255 - p for p in planes[:3]]
    else:
        cmy = list(ycc_to_rgb(*planes[:3]).transpose(2, 0, 1))
    return cmyk_to_rgb(*cmy, 255 - planes[3])
