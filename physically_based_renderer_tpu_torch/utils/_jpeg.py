"""JPEG decoding (SOF0 / SOF1 sequential and SOF2 progressive, 8-bit,
Huffman) with NumPy — the JPEG part of ``utils/image_io.load_image``.

The result is meant to equal, bit for bit, what PIL gives with libjpeg(-turbo)
at its defaults, so every stage after the entropy decode is libjpeg's integer
arithmetic, vectorised over all blocks:

  * the "islow" inverse DCT of ``jidctint.c`` (13-bit constants, two passes,
    its descaling and its post-IDCT range limit, wrap-around included);
  * "fancy" (triangle) upsampling of ``jdsample.c``: ``h2v1``, ``h1v2`` and
    ``h2v2`` with their rounding biases, the component's last real row and
    column repeated at the edges as ``jdmainct.c`` does; plain replication
    for other integer ratios (``int_upsample``);
  * the fixed-point YCbCr → RGB tables of ``jdcolor.c``, and for four
    components its YCCK → CMYK step; then PIL's own steps: CMYK read as
    inverted (Adobe) samples, and ``convert("RGB")``'s CMYK → RGB.

Grayscale, YCbCr, RGB (Adobe transform 0), CMYK and YCCK images, any
sampling factors, restart intervals (DRI) and sizes that are not a multiple
of the MCU. Every scan updates one ``(blocks, 64)`` array of coefficients in
zigzag order, the store ``jdcoefct.c`` keeps for a multi-scan file; each
component's quantisation table is the one defined at its first scan
(``jdinput.c``'s ``latch_quant_tables``). Progressive scans follow
``jdphuff.c``: DC first and refine scans (interleaved or not), AC first
scans with EOB runs, AC refine scans with a correction bit for each
coefficient already nonzero. libjpeg smooths blocks (``jdcoefct.c``) only
while some coefficient is still imprecise, so a file whose scans send every
coefficient to full precision decodes unsmoothed, as PIL gives it; a file
that leaves any coefficient unsent or unrefined raises.

Huffman decoding is sequential: one Python loop over symbols, each looked up
in a table indexed by the next 16 bits, which gives the code's length, its
run and, when the code and its value bits fit in 16, the value itself.
Integer arithmetic throughout, so a decode gives the same bits on every
machine. Lossless and arithmetic-coded files, which PIL reads, raise
``NotImplementedError``; hierarchical files and samples of other than 8
bits, which it does not, raise ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\xff\xd8"
PENDING = "is not supported by the port's decoder (ROADMAP item 17)"
UNREAD = "which PIL (libjpeg-turbo) does not read either"

# zigzag position k → natural (row-major) index of the 8×8 coefficient
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)
UNZIGZAG = np.argsort(ZIGZAG)  # natural index → zigzag position

SOF_PENDING = {0xC3: "lossless (SOF3)", 0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded (SOF10)",
               0xCB: "arithmetic-coded lossless (SOF11)"}
SOF_UNREAD = {0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical (SOF7)",
              0xCD: "hierarchical (SOF13)", 0xCE: "hierarchical (SOF14)", 0xCF: "hierarchical (SOF15)"}
EOB = 100  # a table entry's run at and past this is an end of band: EOB_n with n = run − EOB


def _huffman_table(counts: np.ndarray, symbols: bytes, ac: bool) -> list:
    """The 16-bit lookahead table of one Huffman table: entry w (the next 16
    bits) is (bits, run, value) when the code and its value bits fit in 16
    bits (an AC symbol of size 0 is ZRL, run 15, or EOB_r, run EOB + r, past
    any block's end; its r extra bits are not read); (−code length, run,
    size) when the value bits run past them; (0, 0, 0) where no code
    matches."""
    look_len = np.zeros(1 << 16, np.int64)
    look_sym = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(int(counts[length - 1])):
            lo = code << (16 - length)
            look_len[lo:lo + (1 << (16 - length))] = length
            look_sym[lo:lo + (1 << (16 - length))] = symbols[k]
            code += 1
            k += 1
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
    return list(zip(first.tolist(), run.tolist(), third.tolist()))


def _windows(segment: bytes) -> list:
    """The 32 bits that start at each byte of ``segment`` (zeros past its end),
    as Python ints: the next 16 bits at bit p are
    ``(W[p >> 3] >> (16 - (p & 7))) & 0xFFFF``."""
    b = np.frombuffer(segment + b"\0" * 8, np.uint8).astype(np.int64)
    return ((b[:-7] << 24) | (b[1:-6] << 16) | (b[2:-5] << 8) | b[3:-4]).tolist()


def _decode_blocks(segment: bytes, plan: list, num_blocks: int, blocks: list, preds: list, idx: list, vals: list):
    """Entropy-decode ``num_blocks`` blocks of one restart interval.
    ``plan`` cycles over the blocks of an MCU: (DC table, AC table,
    component). ``blocks`` gives each block's flat offset (×64); DC
    predictors live in ``preds``; (zigzag flat index, value) pairs are
    appended to ``idx`` / ``vals``."""
    W = _windows(segment)
    p = 0
    n_plan = len(plan)
    append_i, append_v = idx.append, vals.append
    for j in range(num_blocks):
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
            raise ValueError("JPEG: invalid Huffman code (DC)")
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
                    append_i(base + k)
                    append_v(v)
                k += 1
            elif tl < 0:
                p -= tl
                s = v
                bits = (W[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                k += r
                append_i(base + k)
                append_v(bits - (1 << s) + 1 if bits < (1 << (s - 1)) else bits)
                k += 1
            else:
                raise ValueError("JPEG: invalid Huffman code (AC)")
        if 64 < k < EOB:  # a run past the 64th coefficient (after an EOB, k > EOB)
            raise ValueError("JPEG: AC run past the end of a block")


def _read_bits(W: list, p: int, n: int) -> int:
    """The ``n`` ≤ 24 bits at bit ``p`` of a segment's windows, as an unsigned int."""
    return (W[p >> 3] >> (32 - n - (p & 7))) & ((1 << n) - 1)


def _decode_dc_first(segment: bytes, plan: list, blocks: list, preds: list, al: int, idx: list, vals: list):
    """A progressive DC first scan (``decode_mcu_DC_first``) over one restart
    interval: each block's DC difference, its predictor's sum shifted left by
    ``al`` at the block's coefficient 0. ``plan`` cycles over the blocks of an
    MCU: (DC table, index of the component in the scan)."""
    W = _windows(segment)
    p = 0
    n_plan = len(plan)
    for j, base in enumerate(blocks):
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
            raise ValueError("JPEG: invalid Huffman code (DC)")
        preds[comp] += v
        idx.append(base)
        vals.append(preds[comp] << al)


def _decode_ac_first(segment: bytes, act: list, blocks: list, ss: int, se: int, al: int, idx: list, vals: list):
    """A progressive AC first scan (``decode_mcu_AC_first``) of one component
    over one restart interval: coefficients ``ss``..``se`` (zigzag) of each
    block, shifted left by ``al``; an EOB_r symbol ends this block and the
    next 2^r − 1 + (r extra bits)."""
    W = _windows(segment)
    p = 0
    eobrun = 0
    append_i, append_v = idx.append, vals.append
    for base in blocks:
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
                    append_i(base + k)
                    append_v(v << al)
                k += 1
            elif tl < 0:
                p -= tl
                s = v
                bits = _read_bits(W, p, s)
                p += s
                k += r
                append_i(base + k)
                append_v((bits - (1 << s) + 1 if bits < (1 << (s - 1)) else bits) << al)
                k += 1
            else:
                raise ValueError("JPEG: invalid Huffman code (AC)")
        if k > se + 1:
            raise ValueError("JPEG: AC run past the end of a spectral band")


def _decode_ac_refine(segment: bytes, act: list, blocks: list, masks: list, ss: int, se: int, new_i: list,
                      new_v: list, fix_i: list):
    """A progressive AC refine scan (``decode_mcu_AC_refine``) of one
    component over one restart interval. ``masks[j]`` has bit k set where
    block j's zigzag coefficient k was nonzero before this scan; each such
    coefficient in ``ss``..``se`` takes one correction bit — inside a zero
    run and inside an EOB run too — and its flat index goes to ``fix_i``
    where the bit is 1. A symbol of size 1 makes the coefficient that ends its
    run of zeros ±1 (``new_i`` / ``new_v``, not yet shifted)."""
    W = _windows(segment)
    p = 0
    eobrun = 0
    for j, base in enumerate(blocks):
        m = masks[j]
        k = ss
        if not eobrun:
            while k <= se:
                w = (W[p >> 3] >> (16 - (p & 7))) & 0xFFFF
                tl, r, v = act[w]
                if tl > 0:
                    p += tl
                elif tl < 0:  # a 16-bit code and its sign bit
                    p -= tl
                    v = 1 if (W[p >> 3] >> (31 - (p & 7))) & 1 else -1
                    p += 1
                else:
                    raise ValueError("JPEG: invalid Huffman code (AC refine)")
                if r >= EOB:
                    r -= EOB
                    eobrun = 1 << r
                    if r:
                        eobrun += _read_bits(W, p, r)
                        p += r
                    break
                if v not in (-1, 0, 1):
                    raise ValueError("JPEG: a refine scan's new coefficient is not ±1")
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
                    if k > se:
                        raise ValueError("JPEG: AC refine run past the end of a spectral band")
                    new_i.append(base + k)
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


def _scan_data(data: bytes, pos: int) -> tuple[list[bytes], int]:
    """The entropy-coded data of a scan from ``pos``: its restart intervals
    (byte stuffing removed) and the position of the marker that ends it."""
    segments, start = [], pos
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            raise ValueError("JPEG: scan data runs past the end of the file")
        m = data[pos + 1]
        if m == 0x00:
            pos += 2
            continue
        if m == 0xFF:  # fill byte before a marker
            pos += 1
            continue
        end = pos
        while end > start and data[end - 1] == 0xFF:  # fill bytes before the marker
            end -= 1
        segments.append(data[start:end].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= m <= 0xD7:
            pos += 2
            start = pos
            continue
        return segments, pos


# libjpeg's jidctint.c constants (CONST_BITS 13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172


def _idct_1d(x, shift: int):
    """One pass of ``jpeg_idct_islow`` along the first axis of ``x`` (8, ...):
    the even and odd parts, then DESCALE by ``shift``."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * FIX_1_175875602
    tmp0 = tmp0 * FIX_0_298631336
    tmp1 = tmp1 * FIX_2_053119869
    tmp2 = tmp2 * FIX_3_072711026
    tmp3 = tmp3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    half = 1 << (shift - 1)
    return np.stack([tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
                     tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]) + half >> shift


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) natural-order coefficients and their (64,) quantizer → (N, 8,
    8) uint8 samples, ``jpeg_idct_islow`` bit for bit."""
    x = (coefs.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)  # [block, v, u]
    ws = _idct_1d(x.transpose(1, 0, 2), CONST_BITS - PASS1_BITS)  # pass 1: columns → [v_out, block, u]
    out = _idct_1d(ws.transpose(2, 1, 0), CONST_BITS + PASS1_BITS + 3)  # pass 2: rows → [x, block, y]
    out = out.transpose(1, 2, 0)  # [block, y, x]
    # the post-IDCT range limit: index & 1023 into a table that clamps [-512, 511] + 128 to [0, 255]
    wrapped = ((out & 1023) ^ 512) - 512
    return np.clip(wrapped + 128, 0, 255).astype(np.uint8)


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
    if not data.startswith(SIGNATURE):
        raise ValueError("not a JPEG file")
    qt: dict[int, np.ndarray] = {}
    dc_tabs: dict[int, list] = {}
    ac_tabs: dict[int, list] = {}
    frame = None
    restart = 0
    adobe_transform = None
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError("JPEG ends before EOI")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                prec, tid = body[i] >> 4, body[i] & 15
                n = 128 if prec else 64
                raw = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if prec else np.uint8).astype(np.int64)
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = raw
                qt[tid] = q
                i += 1 + n
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                cls, tid = body[i] >> 4, body[i] & 15
                counts = np.frombuffer(body[i + 1:i + 17], np.uint8)
                n = int(counts.sum())
                table = _huffman_table(counts, body[i + 17:i + 17 + n], ac=bool(cls))
                (ac_tabs if cls else dc_tabs)[tid] = table
                i += 17 + n
        elif marker in (0xC0, 0xC1, 0xC2):  # baseline, extended sequential, progressive; Huffman
            frame = _frame_header(body, progressive=marker == 0xC2)
        elif marker in SOF_PENDING:
            raise NotImplementedError(f"{SOF_PENDING[marker]} JPEG {PENDING}")
        elif marker in SOF_UNREAD:
            raise ValueError(f"{SOF_UNREAD[marker]} JPEG, {UNREAD}")
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG: scan before frame header")
            ns = body[0]
            by_id = {c["id"]: c for c in frame["comps"]}
            scan = []
            for k in range(ns):
                cid, tables = body[1 + 2 * k], body[2 + 2 * k]
                if cid not in by_id:
                    raise ValueError(f"JPEG: a scan names component {cid}, which the frame does not have")
                c = by_id[cid]
                if c["quant"] is None:  # latch_quant_tables: the table as it stands at the first scan
                    if c["tq"] not in qt:
                        raise ValueError(f"JPEG: quantisation table {c['tq']} is not defined")
                    c["quant"] = qt[c["tq"]].copy()
                scan.append((c, tables >> 4, tables & 15))
            ss, se, ah_al = body[1 + 2 * ns:4 + 2 * ns]
            segments, pos = _scan_data(data, pos)
            if frame["progressive"]:
                _decode_progressive_scan(frame, scan, dc_tabs, ac_tabs, segments, restart, ss, se, ah_al >> 4,
                                         ah_al & 15)
            else:
                _decode_scan(frame, [(c, _table(dc_tabs, d, "DC"), _table(ac_tabs, a, "AC")) for c, d, a in scan],
                             segments, restart)
        # APPn, COM and others: skipped
    if frame is None:
        raise ValueError("JPEG has no frame header")
    for c in frame["comps"]:
        if c["quant"] is None:
            raise ValueError(f"JPEG: component {c['id']} is in no scan")
        if frame["progressive"] and (c["bits"] != 0).any():
            raise NotImplementedError(f"a progressive JPEG whose scans leave coefficients unsent or unrefined "
                                      f"{PENDING}")
    return _reconstruct(frame, adobe_transform)


def _table(tables: dict, tid: int, kind: str) -> list:
    if tid not in tables:
        raise ValueError(f"JPEG: {kind} Huffman table {tid} is not defined")
    return tables[tid]


def _frame_header(body: bytes, progressive: bool) -> dict:
    """SOF0 / SOF1 / SOF2: the components, their block grids (padded to the
    MCU grid) and real sizes, and the zeroed coefficient store."""
    prec, height, width, ncomp = struct.unpack(">BHHB", body[:6])
    if prec != 8:
        raise ValueError(f"{prec}-bit JPEG samples, {UNREAD}")
    if ncomp not in (1, 3, 4) or not height or not width:
        raise ValueError(f"a {width}x{height} JPEG of {ncomp} components, {UNREAD}")
    comps = []
    for c in range(ncomp):
        cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
        comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq, quant=None, bits=np.full(64, -1)))
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    offset = 0
    for c in comps:
        c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]  # blocks, padded to the MCU grid
        c["w"] = -(-width * c["h"] // hmax)  # the component's real (downsampled) size
        c["h_px"] = -(-height * c["v"] // vmax)
        c["offset"] = offset
        offset += c["bw"] * c["bh"]
    return dict(width=width, height=height, comps=comps, hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy,
                progressive=progressive, coefs=np.zeros((offset, 64), np.int32))


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


def _intervals(order: np.ndarray, per_mcu: int, restart: int, segments: list) -> list:
    """(entropy-coded segment, flat offsets (block × 64) of its blocks), one
    pair a restart interval."""
    bases = (order * 64).tolist()
    total_mcus = len(bases) // per_mcu
    interval = restart if restart else total_mcus
    out = []
    for s, start in enumerate(range(0, total_mcus, interval)):
        if s >= len(segments):
            raise ValueError("JPEG: scan ends before its last restart interval")
        out.append((segments[s], bases[start * per_mcu:(start + interval) * per_mcu]))
    return out


def _decode_scan(frame: dict, scan: list, segments: list, restart: int):
    """A sequential scan: every coefficient of its blocks, into the store."""
    order, slots = _scan_blocks(frame, [c for c, _, _ in scan])
    plan = [(scan[ci][1], scan[ci][2], ci) for ci in slots]
    idx, vals = [], []
    for segment, blocks in _intervals(order, len(slots), restart, segments):
        _decode_blocks(segment, plan, len(blocks), blocks, [0] * len(scan), idx, vals)
    frame["coefs"].reshape(-1)[np.asarray(idx, np.int64)] = vals


def _decode_progressive_scan(frame: dict, scan: list, dc_tabs: dict, ac_tabs: dict, segments: list, restart: int,
                             ss: int, se: int, ah: int, al: int):
    """One scan of a progressive frame (``jdphuff.c``): DC first or refine,
    AC first or refine, each updating the coefficient store in place; each
    component's per-coefficient precision (``coef_bits``) kept in
    ``c["bits"]`` (−1 unsent, else the bit a later refine scan sends)."""
    comps = [c for c, _, _ in scan]
    dc = ss == 0
    if (se != 0 if dc else (ss > se or se > 63 or len(comps) != 1)) or (ah and al != ah - 1) or al > 13:
        raise ValueError(f"JPEG: invalid progressive scan (Ss {ss}, Se {se}, Ah {ah}, Al {al})")
    for c in comps:  # where this raises, libjpeg warns and decodes on
        band = c["bits"][ss:se + 1]
        if (not dc and c["bits"][0] < 0) or (np.maximum(band, 0) != ah).any():
            raise NotImplementedError(f"a progressive JPEG whose scans do not follow each other {PENDING}")
    p1 = 1 << al
    coefs = frame["coefs"].reshape(-1)
    order, slots = _scan_blocks(frame, comps)
    intervals = _intervals(order, len(slots), restart, segments)
    if dc and not ah:
        plan = [(_table(dc_tabs, scan[ci][1], "DC"), ci) for ci in slots]
        idx, vals = [], []
        for segment, blocks in intervals:
            _decode_dc_first(segment, plan, blocks, [0] * len(scan), al, idx, vals)
        coefs[np.asarray(idx, np.int64)] = vals
    elif dc:  # DC refine: one raw bit a block, no Huffman code
        hit = []
        for segment, blocks in intervals:
            bits = np.unpackbits(np.frombuffer(segment, np.uint8))
            bits = np.pad(bits, (0, max(len(blocks) - bits.size, 0)))  # libjpeg reads zeros past the data
            hit.append(np.asarray(blocks, np.int64)[bits[:len(blocks)] == 1])
        coefs[np.concatenate(hit)] |= p1
    elif not ah:
        act = _table(ac_tabs, scan[0][2], "AC")
        idx, vals = [], []
        for segment, blocks in intervals:
            _decode_ac_first(segment, act, blocks, ss, se, al, idx, vals)
        coefs[np.asarray(idx, np.int64)] = vals
    else:
        act = _table(ac_tabs, scan[0][2], "AC")
        nz = frame["coefs"][order] != 0
        masks = (nz.astype(np.uint64) << np.arange(64, dtype=np.uint64)).sum(axis=1, dtype=np.uint64).tolist()
        new_i, new_v, fix_i = [], [], []
        j = 0
        for segment, blocks in intervals:
            _decode_ac_refine(segment, act, blocks, masks[j:j + len(blocks)], ss, se, new_i, new_v, fix_i)
            j += len(blocks)
        fix = np.asarray(fix_i, np.int64)
        old = coefs[fix]
        coefs[fix] = np.where(old & p1, old, old + np.where(old >= 0, p1, -p1))
        coefs[np.asarray(new_i, np.int64)] = np.asarray(new_v, np.int64) * p1
    for c in comps:
        c["bits"][ss:se + 1] = al


def _reconstruct(frame: dict, adobe_transform) -> np.ndarray:
    natural = frame["coefs"][:, UNZIGZAG]
    width, height = frame["width"], frame["height"]
    planes = []
    for c in frame["comps"]:
        blocks = natural[c["offset"]:c["offset"] + c["bw"] * c["bh"]]
        pix = idct_islow(blocks, c["quant"]).reshape(c["bh"], c["bw"], 8, 8)
        plane = pix.transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)[: c["h_px"], : c["w"]]
        full = upsample(plane, frame["hmax"] // c["h"], frame["vmax"] // c["v"])
        planes.append(full[:height, :width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)[..., None]
    if len(planes) == 3:
        if adobe_transform == 0:  # stored as RGB
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
