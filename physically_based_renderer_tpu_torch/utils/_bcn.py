"""Block-compressed (BCn) texture decoding with NumPy — the pixel formats of
``utils/_dds.py``, bit for bit what PIL's ``bcn`` decoder gives.

Every 4×4 block of a page is decoded at once: a block is a row of a
``(blocks, 8)`` or ``(blocks, 16)`` uint8 array, a field of it one
vectorised read of its bits, and the 16 texels of all blocks one gather.

  * BC1 (DXT1), BC2 (DXT3), BC3 (DXT5): 5-6-5 endpoints widened by bit
    replication, the two interpolated colours c·2/3 + c'/3 truncated (or
    the mean and transparent black where BC1's first endpoint is not the
    larger); BC2's 4-bit alpha ×17; BC3's alpha block as BC4's. RGBA.
  * BC4 (ATI1): 8-bit endpoints and 3-bit indices, six interpolants
    truncated (or four and 0, 255 where the first endpoint is not the
    larger). L. BC5 (ATI2): two such blocks, red and green, blue 0. RGB.
    BC5S: the signed endpoints biased by 128, then as BC5, blue 128.
  * BC7: the eight modes (partitions of 1-3 subsets, anchor indices, per
    endpoint and shared p-bits, rotation, the index selector), endpoints
    widened by bit replication, weights of 64 with +32 rounding. RGBA. A
    block whose first byte is 0 (no mode) decodes to PIL's fill.
  * BC6H UF16 and SF16: the fourteen modes, their endpoint bit layouts,
    sign extension, delta endpoints, the unquantisation to 16 bits, the
    interpolation, the ·31/64 (·31/32 signed) finish to a half float, then
    PIL's 8-bit sample: the half's float value ×255 in float32, truncated,
    clamped to [0, 255]. RGB. The reserved modes decode to black. SF16 as
    PIL decodes it: a delta endpoint, once the base is added and the sum
    masked to the endpoint bits, is not sign-extended again, and every
    endpoint is read as a 16-bit signed value when it is unquantised.

The partition and anchor tables are the BPTC tables of the format's
specification. A page whose width or height is not a multiple of 4 is
decoded in whole blocks and cropped, as PIL crops it.
"""

from __future__ import annotations

import numpy as np

BLOCK_BYTES = {"BC1": 8, "BC2": 16, "BC3": 16, "BC4": 8, "BC5": 16, "BC5S": 16, "BC6H": 16, "BC6HS": 16, "BC7": 16}

# Two-subset partitions: bit n of entry p is the subset of texel n.
P2 = np.array([
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00,
    0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C,
    0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8,
    0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
    0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22], np.int64)
# Three-subset partitions: bits 2n, 2n + 1 of entry p are the subset of texel n.
P3 = np.array([
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050, 0x5555A0A0, 0x5A5A5050, 0xAA550000,
    0xAA555500, 0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4, 0xA9A59450, 0x2A0A4250, 0xA5945040, 0x0A425054,
    0xA5A5A500, 0x55A0A0A0, 0xA8A85454, 0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4, 0xAAA59090, 0x14696914,
    0x69691400, 0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050, 0x24242424,
    0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50, 0x500AA550, 0xAAAA4444, 0x66660000, 0xA5A0A5A0, 0x50A050A0,
    0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444, 0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580,
    0xAA141414, 0x96960000, 0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000, 0x40804080, 0xA9A8A9A8, 0xAAAAAA44,
    0x2A4A5254], np.int64)
# The anchor texel of subset 1 of a two-subset partition, and of subsets 1
# and 2 of a three-subset one (texel 0 anchors subset 0).
ANCHOR2 = np.array([
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15])
ANCHOR3_1 = np.array([
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
    8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3])
ANCHOR3_2 = np.array([
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
    15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8])
WEIGHTS = {2: np.array([0, 21, 43, 64]), 3: np.array([0, 9, 18, 27, 37, 46, 55, 64]),
           4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])}

# BC7 modes: subsets, partition bits, rotation bits, index-selector bits,
# colour bits, alpha bits, per-endpoint p-bits, shared p-bits, index bits,
# second index bits.
BC7_MODES = [(3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0), (3, 6, 0, 0, 5, 0, 0, 0, 2, 0),
             (2, 6, 0, 0, 7, 0, 1, 0, 2, 0), (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
             (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0)]

# BC6H modes, keyed by PIL's mode number (the 2-bit modes 0 and 1, then
# 2 + m >> 2 for the 5-bit values m ≡ 2 mod 4 and 10 + m >> 2 for m ≡ 3):
# subsets, transformed (delta) endpoints, endpoint bits, delta bits (r, g,
# b), and the header's bits after the mode bits, in the order stored, as
# "<endpoint><channel>[hi:lo]" fields of the format's specification
# (stored from lo to hi; a field [a:b] with a < b is stored reversed).
BC6_MODES = {
    0: (2, 1, 10, (5, 5, 5), "g2[4] b2[4] b3[4] r0[9:0] g0[9:0] b0[9:0] r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] "
                             "b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"),
    1: (2, 1, 7, (6, 6, 6), "g2[5] g3[4] g3[5] r0[6:0] b3[0] b3[1] b2[4] g0[6:0] b2[5] b3[2] g2[4] b0[6:0] b3[3] b3[5] "
                            "b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] r2[5:0] r3[5:0]"),
    2: (2, 1, 11, (5, 4, 4), "r0[9:0] g0[9:0] b0[9:0] r1[4:0] r0[10] g2[3:0] g1[3:0] g0[10] b3[0] g3[3:0] b1[3:0] "
                             "b0[10] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"),
    3: (2, 1, 11, (4, 5, 4), "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] g3[4] g2[3:0] g1[4:0] g0[10] g3[3:0] b1[3:0] "
                             "b0[10] b3[1] b2[3:0] r2[3:0] b3[0] b3[2] r3[3:0] g2[4] b3[3]"),
    4: (2, 1, 11, (4, 4, 5), "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] b2[4] g2[3:0] g1[3:0] g0[10] b3[0] g3[3:0] "
                             "b1[4:0] b0[10] b2[3:0] r2[3:0] b3[1] b3[2] r3[3:0] b3[4] b3[3]"),
    5: (2, 1, 9, (5, 5, 5), "r0[8:0] b2[4] g0[8:0] g2[4] b0[8:0] b3[4] r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] "
                            "b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"),
    6: (2, 1, 8, (6, 5, 5), "r0[7:0] g3[4] b2[4] g0[7:0] b3[2] g2[4] b0[7:0] b3[3] b3[4] r1[5:0] g2[3:0] g1[4:0] "
                            "b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[5:0] r3[5:0]"),
    7: (2, 1, 8, (5, 6, 5), "r0[7:0] b3[0] b2[4] g0[7:0] g2[5] g2[4] b0[7:0] g3[5] b3[4] r1[4:0] g3[4] g2[3:0] "
                            "g1[5:0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"),
    8: (2, 1, 8, (5, 5, 6), "r0[7:0] b3[1] b2[4] g0[7:0] b2[5] g2[4] b0[7:0] b3[5] b3[4] r1[4:0] g3[4] g2[3:0] "
                            "g1[4:0] b3[0] g3[3:0] b1[5:0] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"),
    9: (2, 0, 6, (6, 6, 6), "r0[5:0] g3[4] b3[0] b3[1] b2[4] g0[5:0] g2[5] b2[5] b3[2] g2[4] b0[5:0] g3[5] b3[3] "
                            "b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] r2[5:0] r3[5:0]"),
    10: (1, 0, 10, (10, 10, 10), "r0[9:0] g0[9:0] b0[9:0] r1[9:0] g1[9:0] b1[9:0]"),
    11: (1, 1, 11, (9, 9, 9), "r0[9:0] g0[9:0] b0[9:0] r1[8:0] r0[10] g1[8:0] g0[10] b1[8:0] b0[10]"),
    12: (1, 1, 12, (8, 8, 8), "r0[9:0] g0[9:0] b0[9:0] r1[7:0] r0[10:11] g1[7:0] g0[10:11] b1[7:0] b0[10:11]"),
    13: (1, 1, 16, (4, 4, 4), "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10:15] g1[3:0] g0[10:15] b1[3:0] b0[10:15]"),
}


def _bc6_layout(spec: str) -> tuple[np.ndarray, np.ndarray]:
    """A BC6H header spec → for each stored bit, its endpoint value
    (r0 g0 b0 r1 … b3 → 0 … 11) and its bit in that value."""
    slots, bits = [], []
    for field in spec.split():
        name, rng = field[:2], field[3:-1]
        slot = 3 * int(name[1]) + "rgb".index(name[0])
        hi, lo = (int(v) for v in rng.split(":")) if ":" in rng else (int(rng), int(rng))
        order = range(lo, hi + 1) if hi >= lo else range(lo, hi - 1, -1)
        for b in order:
            slots.append(slot)
            bits.append(b)
    return np.array(slots), np.array(bits)


BC6_LAYOUTS = {m: _bc6_layout(spec[4]) for m, spec in BC6_MODES.items()}


def _blocks(data: bytes, fmt: str, width: int, height: int) -> tuple[np.ndarray, int, int]:
    bw, bh = -(-width // 4), -(-height // 4)
    size = BLOCK_BYTES[fmt]
    need = bw * bh * size
    if len(data) < need:
        raise ValueError(f"DDS: {fmt} data of {len(data)} bytes for a {width}x{height} page, which needs {need} "
                         "(PIL: not enough image data)")
    return np.frombuffer(data, np.uint8, need).reshape(bw * bh, size), bw, bh


def _texels(px: np.ndarray, bw: int, bh: int, width: int, height: int) -> np.ndarray:
    """(blocks, 16, C) texels, texel n at row n // 4, column n % 4 of its
    block, blocks in rows → the (height, width, C) page, cropped."""
    c = px.shape[-1]
    page = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, c)
    return np.ascontiguousarray(page[:height, :width])


def _u16(b: np.ndarray, at: int) -> np.ndarray:
    return b[:, at].astype(np.int64) | b[:, at + 1].astype(np.int64) << 8


def _u32(b: np.ndarray, at: int) -> np.ndarray:
    return _u16(b, at) | _u16(b, at + 2) << 16


def _bc1_colour(b: np.ndarray, separate_alpha: bool) -> np.ndarray:
    """(blocks, 8) colour halves → (blocks, 16, 4) RGBA."""
    c0, c1, lut = _u16(b, 0), _u16(b, 2), _u32(b, 4)

    def rgb565(c):
        r = (c & 0xF800) >> 8
        g = (c & 0x7E0) >> 3
        bl = (c & 0x1F) << 3
        return np.stack([r | r >> 5, g | g >> 6, bl | bl >> 5], -1)

    p0, p1 = rgb565(c0), rgb565(c1)
    four = (c0 > c1)[:, None] | separate_alpha
    p2 = np.where(four, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four, (p0 + 2 * p1) // 3, 0)
    opaque = np.full(len(b), 255)
    pal = np.stack([np.concatenate([p, a[:, None]], -1) for p, a in
                    ((p0, opaque), (p1, opaque), (p2, opaque), (p3, np.where(four[:, 0], 255, 0)))], 1)
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(pal, idx[..., None], 1)


def _bc4_channel(b: np.ndarray, signed: bool = False) -> np.ndarray:
    """(blocks, 8) BC4 halves → (blocks, 16) samples."""
    if signed:
        a0 = b[:, 0].view(np.int8).astype(np.int64) + 128
        a1 = b[:, 1].view(np.int8).astype(np.int64) + 128
    else:
        a0, a1 = b[:, 0].astype(np.int64), b[:, 1].astype(np.int64)
    eight = (a0 > a1)[:, None]
    k = np.arange(1, 7)
    interp8 = ((7 - k) * a0[:, None] + k * a1[:, None]) // 7
    k4 = np.arange(1, 5)
    interp6 = np.concatenate([((5 - k4) * a0[:, None] + k4 * a1[:, None]) // 5,
                              np.tile([0, 255], (len(b), 1))], 1)
    pal = np.concatenate([a0[:, None], a1[:, None], np.where(eight, interp8, interp6)], 1) & 0xFF
    lut = _u32(b, 2) | _u16(b, 6) << 32
    idx = (lut[:, None] >> (3 * np.arange(16))) & 7
    return np.take_along_axis(pal, idx, 1)


def _bits(b: np.ndarray) -> np.ndarray:
    """(blocks, 16) bytes → (blocks, 128) bits, least significant first."""
    return np.unpackbits(b, axis=1, bitorder="little").astype(np.int64)


def _field(bits: np.ndarray, start, count: int) -> np.ndarray:
    """The ``count``-bit little-endian field at bit ``start`` (an int, or a
    per-block array) of every block."""
    if not count:
        return np.zeros(len(bits), np.int64)
    pos = np.asarray(start)[..., None] + np.arange(count)
    vals = bits[:, pos] if np.ndim(start) == 0 else np.take_along_axis(bits, pos, 1)
    return (vals << np.arange(count)).sum(-1)


def _index_fields(bits: np.ndarray, start: int, widths: np.ndarray) -> np.ndarray:
    """16 consecutive fields of per-block, per-texel ``widths`` (blocks, 16)
    from bit ``start`` → (blocks, 16) values."""
    starts = start + np.concatenate([np.zeros((len(bits), 1), np.int64), np.cumsum(widths, 1)[:, :-1]], 1)
    k = np.arange(widths.max(initial=1))
    pos = np.minimum(starts[..., None] + k, 127)
    vals = np.take_along_axis(bits, pos.reshape(len(bits), -1), 1).reshape(pos.shape)
    return ((vals << k) * (k < widths[..., None])).sum(-1)


def _subsets(ns: int, partition: np.ndarray) -> np.ndarray:
    n = np.arange(16)
    if ns == 2:
        return (P2[partition][:, None] >> n) & 1
    if ns == 3:
        return (P3[partition][:, None] >> (2 * n)) & 3
    return np.zeros((len(partition), 16), np.int64)


def _index_widths(ns: int, partition: np.ndarray, ib: int) -> np.ndarray:
    """Each texel's index bits: one fewer at texel 0 and at each subset's anchor."""
    w = np.full((len(partition), 16), ib)
    w[:, 0] -= 1
    rows = np.arange(len(partition))
    if ns == 2:
        w[rows, ANCHOR2[partition]] -= 1
    elif ns == 3:
        w[rows, ANCHOR3_1[partition]] -= 1
        w[rows, ANCHOR3_2[partition]] -= 1
    return w


def _bc7_mode(bits: np.ndarray, mode: int) -> np.ndarray:
    """The blocks of one BC7 mode → (blocks, 16, 4) RGBA."""
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = BC7_MODES[mode]
    n = len(bits)
    pos = mode + 1
    partition = _field(bits, pos, pb)
    rotation = _field(bits, pos + pb, rb)
    selector = _field(bits, pos + pb + rb, isb)
    pos += pb + rb + isb
    numep = 2 * ns
    ep = np.zeros((n, numep, 4), np.int64)
    for c in range(3):
        for e in range(numep):
            ep[:, e, c] = _field(bits, pos, cb)
            pos += cb
    for e in range(numep):
        ep[:, e, 3] = _field(bits, pos, ab) if ab else 255
        pos += ab
    cbits, abits = cb, ab
    if epb or spb:
        cbits += 1
        abits += bool(ab)
        chans = 4 if ab else 3
        for e in range(numep):
            if epb or e % 2 == 0:
                p = _field(bits, pos, 1)
                pos += 1
            ep[:, e, :chans] = ep[:, e, :chans] << 1 | p[:, None]
    ep[..., :3] <<= 8 - cbits
    ep[..., :3] |= ep[..., :3] >> cbits
    if ab:
        ep[..., 3] = (ep[..., 3] << (8 - abits)) & 0xFF
        ep[..., 3] |= ep[..., 3] >> abits
    subset = _subsets(ns, partition)
    i0 = _index_fields(bits, pos, _index_widths(ns, partition, ib))
    cw = WEIGHTS[ib][i0]
    if ab and ib2:
        w2 = np.full((n, 16), ib2)
        w2[:, 0] -= 1
        aw = WEIGHTS[ib2][_index_fields(bits, pos + 16 * ib - ns, w2)]
        sel = selector[:, None].astype(bool)
        cw, aw = np.where(sel, aw, cw), np.where(sel, cw, aw)
    else:
        aw = cw
    e0 = np.take_along_axis(ep, (2 * subset)[..., None], 1)
    e1 = np.take_along_axis(ep, (2 * subset + 1)[..., None], 1)
    w = np.stack([cw, cw, cw, aw], -1)
    px = ((64 - w) * e0 + w * e1 + 32) >> 6
    for r, c in ((1, 0), (2, 1), (3, 2)):
        sel = rotation == r
        px[sel, :, c], px[sel, :, 3] = px[sel, :, 3].copy(), px[sel, :, c].copy()
    return px & 0xFF


def _bc7(b: np.ndarray) -> np.ndarray:
    first = b[:, 0].astype(np.int64)
    mode = np.where(first == 0, 8, np.argmax((first[:, None] >> np.arange(8)) & 1, axis=1))
    px = np.zeros((len(b), 16, 4), np.int64)
    px[mode == 8, :, 3] = 255  # no mode bit: PIL's fill, opaque black
    for m in range(8):
        sel = mode == m
        if sel.any():
            px[sel] = _bc7_mode(_bits(b[sel]), m)
    return px


def _sign_extend(v: np.ndarray, bits: int) -> np.ndarray:
    v = v & ((1 << bits) - 1)
    return np.where(v & (1 << (bits - 1)), v - (1 << bits), v)


def _bc6_unquantize(v: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    if not signed:
        if bits >= 15:
            return v
        return np.where(v == 0, 0, np.where(v == (1 << bits) - 1, 0xFFFF, ((v << 16) + 0x8000) >> bits))
    v = _sign_extend(v, 16)  # PIL keeps endpoints as uint16 and reads them as int16 here
    if bits >= 16:
        return v
    x = np.abs(v)
    q = np.where(x == 0, 0, np.where(x >= (1 << (bits - 1)) - 1, 0x7FFF, ((x << 15) + 0x4000) >> (bits - 1)))
    return np.where(v < 0, -q, q)


def half_to_u8(h: np.ndarray) -> np.ndarray:
    """Half-float bit patterns → PIL's 8-bit BC6H sample: the half's value
    (exact in float32) ×255 in float32, truncated; negative values 0,
    values past 1 255."""
    f = (np.asarray(h, np.uint16).view(np.float16)).astype(np.float32)
    inside = (f >= 0) & (f <= 1)
    out = (np.where(inside, f, 0) * np.float32(255.0)).astype(np.int64)
    return np.where(inside, out, np.where(f > 1, 255, 0))


def _bc6_finish(v: np.ndarray, signed: bool) -> np.ndarray:
    """An interpolated 16-bit value → its half float's 8-bit sample."""
    if signed:
        h = np.where(v < 0, 0x8000 | ((-v) * 31 // 32), v * 31 // 32)
    else:
        h = v * 31 // 64
    return half_to_u8(h & 0xFFFF)


def _bc6_mode(bits: np.ndarray, mode: int, signed: bool) -> np.ndarray:
    ns, transformed, epb, delta, _ = BC6_MODES[mode]
    slots, bitno = BC6_LAYOUTS[mode]
    n = len(bits)
    start = 2 if mode < 2 else 5
    ep = np.zeros((n, 12), np.int64)
    stored = bits[:, start:start + len(slots)]
    np.add.at(ep.T, slots, (stored << bitno).T)
    pos = start + len(slots)
    partition = _field(bits, pos, 5 if ns == 2 else 0)
    pos += 5 if ns == 2 else 0
    numep = 6 * ns
    if signed:
        ep[:, :3] = _sign_extend(ep[:, :3], epb)
    if signed or transformed:
        for i in range(3, numep):
            ep[:, i] = _sign_extend(ep[:, i], delta[i % 3])
    if transformed:
        for i in range(3, numep):
            ep[:, i] = (ep[:, i] + ep[:, i % 3]) & ((1 << epb) - 1)  # PIL: not sign-extended again
    ep = _bc6_unquantize(ep[:, :numep], epb, signed)
    ib = 3 if ns == 2 else 4
    idx = _index_fields(bits, pos, _index_widths(ns, partition, ib))
    w = WEIGHTS[ib][idx][..., None]
    subset = _subsets(ns, partition)
    e = ep.reshape(n, ns, 2, 3)
    e0 = np.take_along_axis(e[:, :, 0], subset[..., None], 1)
    e1 = np.take_along_axis(e[:, :, 1], subset[..., None], 1)
    return _bc6_finish(((64 - w) * e0 + w * e1) >> 6, signed)


def _bc6(b: np.ndarray, signed: bool) -> np.ndarray:
    low = b[:, 0].astype(np.int64) & 0x1F
    mode = np.where((low & 3) < 2, low & 3, np.where((low & 3) == 2, 2 + (low >> 2), 10 + (low >> 2)))
    px = np.zeros((len(b), 16, 3), np.int64)  # the reserved modes (14-17): black
    for m in range(14):
        sel = mode == m
        if sel.any():
            px[sel] = _bc6_mode(_bits(b[sel]), m, signed)
    return px


def decode_bcn(data: bytes, fmt: str, width: int, height: int) -> np.ndarray:
    """The first ``width`` × ``height`` page of ``fmt`` blocks in ``data`` →
    (height, width, C) uint8: RGBA for BC1-BC3 and BC7, L for BC4, RGB for
    BC5, BC5S and BC6H."""
    b, bw, bh = _blocks(data, fmt, width, height)
    if fmt == "BC1":
        px = _bc1_colour(b, False)
    elif fmt == "BC2":
        px = _bc1_colour(b[:, 8:], True)
        nib = np.stack([b[:, :8] & 15, b[:, :8] >> 4], -1).reshape(len(b), 16).astype(np.int64)
        px[..., 3] = nib * 17
    elif fmt == "BC3":
        px = _bc1_colour(b[:, 8:], True)
        px[..., 3] = _bc4_channel(b[:, :8])
    elif fmt == "BC4":
        px = _bc4_channel(b)[..., None]
    elif fmt in ("BC5", "BC5S"):
        signed = fmt == "BC5S"
        px = np.stack([_bc4_channel(b[:, :8], signed), _bc4_channel(b[:, 8:], signed),
                       np.full((len(b), 16), 128 if signed else 0)], -1)
    elif fmt == "BC7":
        px = _bc7(b)
    else:
        px = _bc6(b, fmt == "BC6HS")
    return _texels(px.astype(np.uint8), bw, bh, width, height)
