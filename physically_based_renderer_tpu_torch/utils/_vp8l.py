"""VP8L (WebP lossless, RFC 9649 §3-§5) decoding with NumPy — the lossless
bitstream of ``utils/_webp.py``, bit for bit what libwebp 1.6 decodes under
PIL.

The entropy-coded stage is serial and stays a lean Python loop: bits are
read least significant first from a list of 64-bit windows, one window a
byte offset, and every prefix code is one flat lookup table indexed by the
next ``max length`` bits (entry = symbol << 4 | length). The five codes of a
group (green + length + cache, red, blue, alpha, distance), meta prefix
codes through the entropy image, the colour cache (every pixel inserted,
copied ones too; key ``(0x1e35a7bd · argb) >> (32 − bits)``), LZ77 lengths
and distances with their extra bits and the 120-entry distance map. The
inverse transforms then run on whole arrays: subtract-green, the cross-colour
transform and colour indexing elementwise, the predictor on wavefronts of
equal ``x + 2y`` (pixel (y, x) needs (y, x−1), (y−1, x−1), (y−1, x) and
(y−1, x+1), or for the last column (y, 0)).

Every defect libwebp refuses raises ``ValueError``: a bad signature or
version, a transform given twice, an incomplete or over-full prefix code, a
cache size outside 1-11, a copy that reaches before the first pixel or past
the last, and reading past the end of the data (libwebp's rule: the first
64 bits of a stream shorter than 8 bytes read as zeros).
"""

from __future__ import annotations

import numpy as np

SIGNATURE = 0x2F
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_ALPHABET = (256 + 24, 256, 256, 256, 40)
# (dy << 4) | (8 − dx) of the 120 short distance codes (RFC 9649 §4.2.2).
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c58454b343c03"
    "5759131d565a232d444c555b333d68026769121e666a222e545c434d656b323e78017779535d111f"
    "646c424e767a212f757b313f636d525e00747c414f1020626e30737d515f40727e616f50717f6070")
# the 15-bit reversal of every 15-bit number (codes are read least significant bit first)
_REV15 = sum(((np.arange(1 << 15) >> b) & 1) << (14 - b) for b in range(15))


class _Reader:
    """The bit reader: ``pos`` counts bits from the start; ``win[i]`` holds
    the 64 bits from byte i on (little endian), zeros past the data."""

    def __init__(self, data: bytes):
        n = len(data)
        buf = np.frombuffer(bytes(data) + bytes(16), np.uint8).astype(np.uint64)
        win = np.zeros(n + 8, np.uint64)
        for k in range(8):
            win |= buf[k:k + n + 8] << np.uint64(8 * k)
        self.win = win.tolist()
        self.pos = 0
        self.limit = max(8 * n, 64)  # libwebp's end of stream

    def read(self, nbits: int) -> int:
        pos = self.pos
        self.pos = pos + nbits
        return (self.win[pos >> 3] >> (pos & 7)) & ((1 << nbits) - 1)

    def check(self) -> None:
        if self.pos > self.limit:
            raise ValueError("VP8L: the data ends inside the bitstream")


def _build_code(lengths: np.ndarray) -> tuple[list, int]:
    """Code lengths (one per symbol) → (table, mask) of a canonical prefix
    code read least significant bit first; a single used symbol reads zero
    bits. Raises ValueError where libwebp's BuildHuffmanTable returns 0."""
    used = np.flatnonzero(lengths)
    if len(used) == 0:
        raise ValueError("VP8L: a prefix code with no symbol")
    if len(used) == 1:
        return [int(used[0]) << 4], 0
    lens = lengths[used].astype(np.int64)
    if int((np.int64(1) << (15 - lens)).sum()) != 1 << 15:
        raise ValueError("VP8L: an incomplete or over-full prefix code")
    order = np.lexsort((used, lens))
    syms, lens = used[order], lens[order]
    counts = np.bincount(lens, minlength=16)
    first = np.zeros(16, np.int64)  # canonical first code of each length
    code = 0
    for length in range(1, 16):
        code = (code + counts[length - 1]) << 1 if length > 1 else 0
        first[length] = code
    start = np.concatenate([[0], np.cumsum(counts)])[lens]
    codes = first[lens] + np.arange(len(lens)) - start
    rev = _REV15[codes] >> (15 - lens)
    top = int(lens[-1])
    table = np.zeros(1 << top, np.int64)
    entries = (syms.astype(np.int64) << 4) | lens
    for length in np.unique(lens):
        sel = lens == length
        idx = rev[sel][:, None] + (np.arange(1 << (top - length), dtype=np.int64) << length)[None, :]
        table[idx] = entries[sel][:, None]
    return table.tolist(), (1 << top) - 1


def _read_code(br: _Reader, alphabet: int) -> tuple[list, int]:
    """One prefix code: simple (1 or 2 symbols) or normal (code lengths
    coded by the 19-symbol code-length code, repeats 16/17/18, max_symbol)."""
    lengths = np.zeros(alphabet, np.int64)
    if br.read(1):  # simple
        num = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        syms = [first] + ([br.read(8)] if num == 2 else [])
        for s in syms:
            if s < alphabet:
                lengths[s] = 1
    else:
        cl = np.zeros(19, np.int64)
        for i in range(br.read(4) + 4):
            cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
        tab, mask = _build_code(cl)
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > alphabet:
                raise ValueError("VP8L: max_symbol past the alphabet")
        else:
            max_symbol = alphabet
        sym, prev = 0, 8
        win = br.win
        while sym < alphabet:
            if max_symbol == 0:
                break
            max_symbol -= 1
            pos = br.pos
            e = tab[(win[pos >> 3] >> (pos & 7)) & mask]
            br.pos = pos + (e & 15)
            c = e >> 4
            if c < 16:
                lengths[sym] = c
                sym += 1
                if c:
                    prev = c
            else:
                extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
                repeat = br.read(extra) + offset
                if sym + repeat > alphabet:
                    raise ValueError("VP8L: a code-length repeat past the alphabet")
                lengths[sym:sym + repeat] = prev if c == 16 else 0
                sym += repeat
    br.check()
    return _build_code(lengths)


def _sub_sample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _decode_entropy_image(br: _Reader, w: int, h: int, level0: bool, alpha_8b: bool = False) -> np.ndarray:
    """The entropy-coded image of one level → (h, w) uint32 ARGB: its colour
    cache, its prefix-code groups (meta codes only at level 0) and its
    pixels. ``alpha_8b``: an ALPH plane whose only transform is colour
    indexing, which libwebp decodes on its 8-bit path when the image has no
    colour cache and every group's red, blue and alpha codes are single
    symbols; that path refuses reading past the end of the data only
    before the last pixel's symbol."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"VP8L: a colour cache of {cache_bits} bits")
    ent, ebits = None, 0
    num_groups = 1
    if level0 and br.read(1):
        ebits = br.read(3) + 2
        ew, eh = _sub_sample(w, ebits), _sub_sample(h, ebits)
        meta = _decode_entropy_image(br, ew, eh, False)
        ent = ((meta >> 8) & 0xFFFF).astype(np.int64)
        num_groups = int(ent.max()) + 1
    groups = [[_read_code(br, size + ((1 << cache_bits) if j == 0 and cache_bits else 0))
               for j, size in enumerate(_ALPHABET)] for _ in range(num_groups)]
    lenient = alpha_8b and not cache_bits and all(g[1][1] == g[2][1] == g[3][1] == 0 for g in groups)
    return _decode_pixels(br, w, h, groups, ent, ebits, cache_bits, lenient)


def _decode_pixels(br: _Reader, w: int, h: int, groups: list, ent, ebits: int, cache_bits: int,
                   lenient: bool) -> np.ndarray:
    """The LZ77 / prefix-coded pixels of one level → (h, w) uint32; with
    ``lenient``, reading past the end refused only before the last symbol."""
    n = w * h
    out = [0] * n
    win, pos = br.win, br.pos
    cache = [0] * (1 << cache_bits) if cache_bits else None
    cshift = 32 - cache_bits
    dist_map = [0] + [max(1, (c >> 4) * w + 8 - (c & 15)) for c in _CODE_TO_PLANE]
    ew = _sub_sample(w, ebits) if ent is not None else 0
    ent_flat = ent.ravel().tolist() if ent is not None else None
    emask = (1 << ebits) - 1
    (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = groups[0]
    i = x = y = 0
    last = pos
    while i < n:
        last = pos
        if ent_flat is not None and not (x & emask):
            (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = groups[ent_flat[(y >> ebits) * ew + (x >> ebits)]]
        bits = win[pos >> 3] >> (pos & 7)
        e = gt[bits & gm]
        s = e >> 4
        if s < 256:  # a literal: green, red, blue, alpha
            ln = e & 15
            bits >>= ln
            e = rt[bits & rm]
            r = e >> 4
            ln2 = e & 15
            bits >>= ln2
            e = bt[bits & bm]
            pos += ln + ln2 + (e & 15)
            b = e >> 4
            e = at[(win[pos >> 3] >> (pos & 7)) & am]
            pos += e & 15
            argb = ((e >> 4) << 24) | (r << 16) | (s << 8) | b
            out[i] = argb
            if cache is not None:
                cache[((0x1E35A7BD * argb) & 0xFFFFFFFF) >> cshift] = argb
            i += 1
            x += 1
            if x == w:
                x = 0
                y += 1
        elif s < 280:  # a backward reference: length, then distance
            pos += e & 15
            p = s - 256
            if p < 4:
                length = p + 1
            else:
                extra = (p - 2) >> 1
                length = ((2 + (p & 1)) << extra) + ((win[pos >> 3] >> (pos & 7)) & ((1 << extra) - 1)) + 1
                pos += extra
            e = dt[(win[pos >> 3] >> (pos & 7)) & dm]
            pos += e & 15
            p = e >> 4
            if p < 4:
                code = p + 1
            else:
                extra = (p - 2) >> 1
                code = ((2 + (p & 1)) << extra) + ((win[pos >> 3] >> (pos & 7)) & ((1 << extra) - 1)) + 1
                pos += extra
            dist = code - 120 if code > 120 else dist_map[code]
            if dist > i or length > n - i:
                raise ValueError("VP8L: a backward reference outside the image")
            if dist >= length:
                out[i:i + length] = out[i - dist:i - dist + length]
            else:
                seg = out[i - dist:i]
                out[i:i + length] = (seg * (length // dist + 1))[:length]
            if cache is not None:
                for v in out[i:i + length]:
                    cache[((0x1E35A7BD * v) & 0xFFFFFFFF) >> cshift] = v
            i += length
            x += length
            if x >= w:
                y += x // w
                x %= w
            if ent_flat is not None and i < n:
                (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = \
                    groups[ent_flat[(y >> ebits) * ew + (x >> ebits)]]
        else:  # a colour-cache index
            pos += e & 15
            if cache is None:
                raise ValueError("VP8L: a colour-cache code with no cache")
            out[i] = cache[s - 280]
            i += 1
            x += 1
            if x == w:
                x = 0
                y += 1
    br.pos = last if lenient else pos
    br.check()
    br.pos = pos
    return np.array(out, np.uint32).reshape(h, w)


def _channels(argb: np.ndarray) -> np.ndarray:
    """(…) uint32 ARGB → (…, 4) uint8 view, channels in memory order B, G, R, A."""
    return argb.view(np.uint8).reshape(argb.shape + (4,))


def _avg2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-channel ⌊(a + b) / 2⌋ of packed ARGB words (libwebp's Average2)."""
    return (((a ^ b) & np.uint32(0xFEFEFEFE)) >> np.uint32(1)) + (a & b)


def _add_pixels(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-channel (a + b) mod 256 of packed ARGB words."""
    m1, m2 = np.uint32(0x00FF00FF), np.uint32(0xFF00FF00)
    return (((a & m1) + (b & m1)) & m1) | (((a & m2) + (b & m2)) & m2)


def _predict(mode: int, L, T, TL, TR):
    """Predictor ``mode`` (0-13; 14 and 15 act as 0) on packed ARGB words."""
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg2(_avg2(L, TR), T)
    if mode == 6:
        return _avg2(L, TL)
    if mode == 7:
        return _avg2(L, T)
    if mode == 8:
        return _avg2(TL, T)
    if mode == 9:
        return _avg2(T, TR)
    if mode == 10:
        return _avg2(_avg2(L, TL), _avg2(T, TR))
    if mode == 11:  # Select: the one of L, T nearer (Manhattan) to L + T − TL
        cl, ct, ctl = (_channels(v).astype(np.int16) for v in (L, T, TL))
        p_l = np.abs(ct - ctl).sum(-1)
        p_t = np.abs(cl - ctl).sum(-1)
        return np.where(p_l < p_t, L, T)
    if mode == 12:
        cl, ct, ctl = (_channels(v).astype(np.int16) for v in (L, T, TL))
        return np.ascontiguousarray(np.clip(cl + ct - ctl, 0, 255).astype(np.uint8)).view(np.uint32)[..., 0]
    if mode == 13:
        ca, ctl = _channels(_avg2(L, T)).astype(np.int16), _channels(TL).astype(np.int16)
        d = ca - ctl
        half = (d + (d < 0)) >> 1  # C's truncating d / 2
        return np.ascontiguousarray(np.clip(ca + half, 0, 255).astype(np.uint8)).view(np.uint32)[..., 0]
    return np.full(L.shape, 0xFF000000, np.uint32)


def _inverse_predictor(res: np.ndarray, bits: int, modes_img: np.ndarray) -> np.ndarray:
    """Undo the predictor transform: wavefronts of equal x + 2y, each
    pixel's mode the green of its tile (the first row L, the first column T,
    the first pixel black); the last column's top-right is the row's first
    pixel. Each wavefront computes the modes it holds on all its pixels and
    keeps each pixel's own."""
    h, w = res.shape
    out = np.zeros(h * w, np.uint32)
    modes = ((modes_img >> 8) & 0xF).astype(np.int64)
    modes[modes > 13] = 0
    ys, xs = np.divmod(np.arange(h * w, dtype=np.int64), w)
    mode = modes[ys >> bits, xs >> bits]
    mode[xs == 0] = 2
    mode[ys == 0] = 1
    mode[0] = 0
    key = xs + 2 * ys
    order = np.argsort(key, kind="stable")
    ys, xs, mode, key = ys[order], xs[order], mode[order], key[order]
    flat = order
    i_l = np.maximum(flat - 1, 0)
    i_t = np.maximum(flat - w, 0)
    i_tl = np.maximum(flat - w - 1, 0)
    i_tr = np.where(xs == w - 1, ys * w, np.maximum(flat - w + 1, 0))
    res_o = res.ravel()[order]
    waves = int(key[-1]) + 1
    ends = np.searchsorted(key, np.arange(1, waves + 1)).tolist()
    present = np.zeros((waves, 16), bool)
    present[key, mode] = True
    held = [np.flatnonzero(row).tolist() for row in present]
    a = 0
    for k in range(waves):
        b = ends[k]
        L, T, TL, TR = out[i_l[a:b]], out[i_t[a:b]], out[i_tl[a:b]], out[i_tr[a:b]]
        ms = held[k]
        if len(ms) == 1:
            pred = _predict(ms[0], L, T, TL, TR)
        else:
            pred = np.empty(b - a, np.uint32)
            m = mode[a:b]
            for mm in ms:
                np.copyto(pred, _predict(mm, L, T, TL, TR), where=m == mm)
        out[flat[a:b]] = _add_pixels(res_o[a:b], pred)
        a = b
    return out.reshape(h, w)


def _inverse_cross_colour(img: np.ndarray, bits: int, data: np.ndarray) -> np.ndarray:
    """Undo the colour transform: red += g2r·g >> 5, blue += g2b·g >> 5 and
    then r2b·(new red) >> 5, all int8 products."""
    h, w = img.shape
    tiles = data[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]
    g2r = (tiles & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    g2b = ((tiles >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    r2b = ((tiles >> 16) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    green = ((img >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    red = ((img >> 16) & 0xFF).astype(np.int32)
    blue = (img & 0xFF).astype(np.int32)
    red = (red + ((g2r * green) >> 5)) & 0xFF
    blue = blue + ((g2b * green) >> 5)
    blue = (blue + ((r2b * red.astype(np.uint8).view(np.int8).astype(np.int32)) >> 5)) & 0xFF
    return (img & np.uint32(0xFF00FF00)) | (red.astype(np.uint32) << np.uint32(16)) | blue.astype(np.uint32)


def _inverse_subtract_green(img: np.ndarray) -> np.ndarray:
    g = (img >> np.uint32(8)) & np.uint32(0xFF)
    rb = ((img & np.uint32(0x00FF00FF)) + ((g << np.uint32(16)) | g)) & np.uint32(0x00FF00FF)
    return (img & np.uint32(0xFF00FF00)) | rb


def _inverse_colour_indexing(img: np.ndarray, bits: int, palette: np.ndarray, width: int) -> np.ndarray:
    """Undo colour indexing: indices bundled 2^bits to a pixel's green (least
    significant first), looked up in the palette expanded with zeros."""
    h = img.shape[0]
    idx = (img >> np.uint32(8)) & np.uint32(0xFF)
    if bits:
        per, nb = 1 << bits, 8 >> bits
        shifts = (np.arange(per, dtype=np.uint32) * np.uint32(nb))
        idx = ((idx[:, :, None] >> shifts) & np.uint32((1 << nb) - 1)).reshape(h, -1)[:, :width]
    return palette[idx]


def decode_vp8l(data: bytes, headerless: tuple[int, int] | None = None) -> np.ndarray:
    """A VP8L bitstream → (H, W) uint32 ARGB. With ``headerless=(width,
    height)`` the stream has no 5-byte header (an ALPH chunk's
    compression-1 payload)."""
    try:
        return _decode(data, headerless)
    except IndexError:  # a read far past the end of the data (the reader's window list)
        raise ValueError("VP8L: the data ends inside the bitstream") from None


def _decode(data: bytes, headerless: tuple[int, int] | None) -> np.ndarray:
    br = _Reader(data)
    if headerless is None:
        width, height, _ = vp8l_size(data)
        br.pos = 40
    else:
        width, height = headerless
    xsize = width
    transforms = []
    seen = set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise ValueError("VP8L: a transform given twice")
        seen.add(kind)
        if kind in (0, 1):  # predictor, cross-colour
            bits = br.read(3) + 2
            sub = _decode_entropy_image(br, _sub_sample(xsize, bits), _sub_sample(height, bits), False)
            transforms.append((kind, bits, sub, xsize))
        elif kind == 3:  # colour indexing
            num = br.read(8) + 1
            bits = 0 if num > 16 else 1 if num > 4 else 2 if num > 2 else 3
            colours = _decode_entropy_image(br, num, 1, False)[0]
            palette = np.zeros(1 << (8 >> bits), np.uint32)
            ch = _channels(colours).astype(np.int64).cumsum(0) & 0xFF  # delta-coded, per channel
            palette[:num] = np.ascontiguousarray(ch.astype(np.uint8)).view(np.uint32)[:, 0]
            transforms.append((kind, bits, palette, xsize))
            xsize = _sub_sample(xsize, bits)
        else:
            transforms.append((kind, 0, None, xsize))
    img = _decode_entropy_image(br, xsize, height, True, headerless is not None and [t[0] for t in transforms] == [3])
    for kind, bits, payload, tw in reversed(transforms):
        if kind == 0:
            img = _inverse_predictor(img, bits, payload)
        elif kind == 1:
            img = _inverse_cross_colour(img, bits, payload)
        elif kind == 2:
            img = _inverse_subtract_green(img)
        else:
            img = _inverse_colour_indexing(img, bits, payload, tw)
    return np.ascontiguousarray(img, np.uint32)


def vp8l_size(data: bytes) -> tuple[int, int, bool]:
    """(width, height, alpha_is_used) from a VP8L header (libwebp's
    VP8LGetInfo); ValueError where it refuses."""
    if len(data) < 5 or data[0] != SIGNATURE or data[4] >> 5:
        raise ValueError("VP8L: bad signature or version")
    v = int.from_bytes(data[1:5], "little")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, bool((v >> 28) & 1)
