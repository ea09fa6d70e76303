"""VP8 (WebP lossy, RFC 6386) key-frame decoding with NumPy — the lossy
bitstream of ``utils/_webp.py``, bit for bit what libwebp 1.6 gives under
PIL (``WebPAnimDecoder``'s defaults: "fancy" upsampling on, dithering off).

The frame tag and start code (the 2-bit scale fields above the 14-bit sizes
ignored); the boolean decoder (§7); the frame header (§9): segmentation
with its quantizer and filter-level updates, filter type, level and
sharpness, the loop-filter deltas, 1, 2, 4 or 8 token partitions; the
quantizer deltas over ``dc_qlookup`` / ``ac_qlookup`` (§14.1, libwebp's
y2 and uv rules); the token-probability updates (§13); per macroblock the
segment id, the skip flag and the intra modes with their fixed key-frame
probabilities (§11); the coefficient tokens with their contexts (§13). The
entropy stage is one serial Python loop with the boolean decoder inlined.

Everything after it is vectorised: dequantisation, the inverse WHT of the
Y2 block and the inverse DCT (§14.3-14.4, libwebp's 20091 / 35468
constants) of every block at once; the intra predictors (§12: 16×16, 4×4
and chroma, the fixed 127 / 129 edges, the 4×4 above-right rule and
libwebp's DC variants at the frame's edges) on wavefronts of equal
``c + 2r`` macroblocks, the 4×4 blocks of a macroblock on wavefronts of
equal ``j + 2i``; the normal and simple loop filters (§15) on the same
macroblock wavefronts, each macroblock's edges in libwebp's order (left,
inner vertical, top, inner horizontal), skipped on a macroblock with no
non-zero coefficient unless it is ``B_PRED``; the crop to the frame size;
and libwebp's YUV 4:2:0 → RGB: its "fancy" upsampler (9-3-3-1 weights by
nested shifts, its own first and last rows and columns) and its 14-bit
fixed-point conversion. Prediction reads the unfiltered reconstruction, as
libwebp's does.

A frame libwebp refuses raises ``ValueError``: a bad start code, an
inter frame, a frame not shown, a partition that does not fit, and any
partition read past its end (libwebp's end-of-data rule).
"""

from __future__ import annotations

import numpy as np

# RFC 6386 §13.5 default_coeff_probs [4][8][3][11]
_COEFF_PROBS = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080bd81f2ff"
    "e3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb"
    "80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa"
    "8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3"
    "ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ffc2e080808080800101ff808080808080"
    "8080f601ff8080808080808080ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5"
    "f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080"
    "802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9"
    "ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ff"
    "ff8080802d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080452ebeefc9daffe4"
    "80808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be"
    "24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff8080"
    "8080808080800186fcffff808080808080d53efaffff808080808080375dff8080808080808080808080808080808080"
    "808080808080808080808080808080808080808080808080ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e"
    "8adb97b2f0aaffd8800170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080"
    "801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8"
    "ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caff"
    "db8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
# RFC 6386 §13.4 coeff_update_probs [4][8][3][11]
_COEFF_UPDATE_PROBS = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffffdff1fcff"
    "fffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffff"
    "fffffffff6feffffffffffffffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffb"
    "fffefffffffffffffffffffffffffffffffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffeffff"
    "fffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefefffffffffffffffff8feffffff"
    "fffffffffff9fefffffffffffffffffffffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffff"
    "fffffffffffffffffffffffffffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefe"
    "fffffffffffffffffdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffffffffffffffffffff"
    "fffffffffefffffffffffffffffffefefffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffff8fffffffffffffffffffffafefcfefffffffffffffff8fe"
    "f9fdfffffffffffffffffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfefffffffffffffffff5fbfeffffffffffffff"
    "fffdfdfefffffffffffffffffffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcff"
    "fffffffffffffffff9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
# key-frame sub-block mode probabilities [above][left][9], libwebp's mode order
_BMODE_PROBS = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150aad791850"
    "c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d102486b759896265"
    "6aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380"
    "684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b7"
    "75552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a6240221674ce17222ba6496b36201a3301"
    "512b1f44196a1640ab24e1722213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e"
    "10ff8022c5ab29280566d3b70401dd333211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba6"
    "5d499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd"
    "2803097333c01206df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a"
    "8598740a2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a6666d522142b75140f"
    "24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113469255373e46252b259a64a3"
    "55a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928"
    "a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c5381527"
    "9b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404f6231b0a92aeab0c1a80be502363b450"
    "7e362d557e2f57b033291420654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418")
_DC_Q = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26,
    27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52,
    53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79,
    80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157)
_AC_Q = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64,
    66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185,
    189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# after a decision leaves the range at r (1-255): the left shift that brings
# it back to 128-255, and the new range − 1 (libwebp keeps range − 1)
_SHIFT = [0] + [8 - r.bit_length() for r in range(1, 256)]
_NEW_RANGE = [0] + [(r << (8 - r.bit_length())) - 1 for r in range(1, 256)]
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3  # libwebp's order; the 4x4 modes go on RD VR LD VL HD HU


def _bmode_table() -> np.ndarray:
    """(10, 16, 4): for each 4x4 mode that is an average of edge pixels, the
    four edge indices whose (sum + 2) >> 2 gives each pixel (row-major).
    Edges: I J K L (left, 0-3), X (corner, 4), A-H (above and above-right,
    5-12). DC (0) and TM (1) are computed apart."""
    I, J, K, L, X, A, B, C, D, E, F, G, H = range(13)

    def avg3(a, b, c):
        return (a, b, b, c)

    def avg2(a, b):
        return (a, a, b, b)

    t = np.zeros((10, 4, 4, 4), np.int64)  # [mode, y, x]
    top = (X, A, B, C, D, E)
    for x in range(4):
        t[2, :, x] = avg3(top[x], top[x + 1], top[x + 2])  # VE4
    for y, e in enumerate((avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L))):
        t[3, y, :] = e  # HE4
    rd = {-3: avg3(J, K, L), -2: avg3(I, J, K), -1: avg3(X, I, J), 0: avg3(A, X, I), 1: avg3(B, A, X),
          2: avg3(C, B, A), 3: avg3(D, C, B)}
    ld = [avg3(A, B, C), avg3(B, C, D), avg3(C, D, E), avg3(D, E, F), avg3(E, F, G), avg3(F, G, H), avg3(G, H, H)]
    for y in range(4):
        for x in range(4):
            t[4, y, x] = rd[x - y]  # RD4
            t[6, y, x] = ld[x + y]  # LD4

    def put(mode, value, *xy):
        for x, y in xy:
            t[mode, y, x] = value

    put(5, avg2(X, A), (0, 0), (1, 2))  # VR4
    put(5, avg2(A, B), (1, 0), (2, 2))
    put(5, avg2(B, C), (2, 0), (3, 2))
    put(5, avg2(C, D), (3, 0))
    put(5, avg3(K, J, I), (0, 3))
    put(5, avg3(J, I, X), (0, 2))
    put(5, avg3(I, X, A), (0, 1), (1, 3))
    put(5, avg3(X, A, B), (1, 1), (2, 3))
    put(5, avg3(A, B, C), (2, 1), (3, 3))
    put(5, avg3(B, C, D), (3, 1))
    put(7, avg2(A, B), (0, 0))  # VL4
    put(7, avg2(B, C), (1, 0), (0, 2))
    put(7, avg2(C, D), (2, 0), (1, 2))
    put(7, avg2(D, E), (3, 0), (2, 2))
    put(7, avg3(A, B, C), (0, 1))
    put(7, avg3(B, C, D), (1, 1), (0, 3))
    put(7, avg3(C, D, E), (2, 1), (1, 3))
    put(7, avg3(D, E, F), (3, 1), (2, 3))
    put(7, avg3(E, F, G), (3, 2))
    put(7, avg3(F, G, H), (3, 3))
    put(8, avg2(I, X), (0, 0), (2, 1))  # HD4
    put(8, avg2(J, I), (0, 1), (2, 2))
    put(8, avg2(K, J), (0, 2), (2, 3))
    put(8, avg2(L, K), (0, 3))
    put(8, avg3(A, B, C), (3, 0))
    put(8, avg3(X, A, B), (2, 0))
    put(8, avg3(I, X, A), (1, 0), (3, 1))
    put(8, avg3(J, I, X), (1, 1), (3, 2))
    put(8, avg3(K, J, I), (1, 2), (3, 3))
    put(8, avg3(L, K, J), (1, 3))
    put(9, avg2(I, J), (0, 0))  # HU4
    put(9, avg2(J, K), (2, 0), (0, 1))
    put(9, avg2(K, L), (2, 1), (0, 2))
    put(9, avg3(I, J, K), (1, 0))
    put(9, avg3(J, K, L), (3, 0), (1, 1))
    put(9, avg3(K, L, L), (3, 1), (1, 2))
    put(9, (L, L, L, L), (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    return t.reshape(10, 16, 4)


_BMODE_EDGES = _bmode_table()


class _BoolReader:
    """RFC 6386 §7's boolean decoder as libwebp runs it: ``rng`` is the
    range − 1, ``value`` holds ``bits`` bits below its top 8-bit window, and
    ``eof`` is set the first time a decision needs a byte past the end."""

    __slots__ = ("buf", "pos", "end", "value", "bits", "rng", "eof")

    def __init__(self, buf: bytes, start: int, end: int):
        self.buf, self.pos, self.end = buf, start, end
        self.value, self.bits, self.rng, self.eof = 0, -8, 254, False
        self.load()

    def load(self) -> None:
        pos, end = self.pos, self.end
        if pos + 8 <= end:
            self.value = (self.value << 56) | int.from_bytes(self.buf[pos:pos + 7], "big")
            self.pos, self.bits = pos + 7, self.bits + 56
        elif pos < end:
            self.value = (self.value << 8) | self.buf[pos]
            self.pos, self.bits = pos + 1, self.bits + 8
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self.load()
        bits = self.bits
        split = (self.rng * prob) >> 8
        if (self.value >> bits) > split:
            self.value -= (split + 1) << bits
            r, b = self.rng - split, 1
        else:
            r, b = split + 1, 0
        self.rng = _NEW_RANGE[r]
        self.bits = bits - _SHIFT[r]
        return b

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v


def _large_value(br: _BoolReader, p) -> int:
    """libwebp's GetLargeValue: a token past ONE, its extra bits included."""
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    bit1 = br.bit(p[8])
    cat = 2 * bit1 + br.bit(p[9 + bit1])
    v = 0
    for prob in _CAT_PROBS[cat]:
        v = 2 * v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _BoolReader, bands, ctx: int, dq0: int, dq1: int, n: int, out: list, base: int) -> int:
    """One block's tokens (libwebp's GetCoeffs) → the index after its last
    token; the dequantised values go to ``out[base + raster index]``. The
    boolean decoder is inlined."""
    value, bits, rng = br.value, br.bits, br.rng
    shift, new_range, zigzag = _SHIFT, _NEW_RANGE, _ZIGZAG
    p = bands[n][ctx]
    while n < 16:
        if bits < 0:
            br.value, br.bits = value, bits
            br.load()
            value, bits = br.value, br.bits
        split = (rng * p[0]) >> 8
        if (value >> bits) > split:
            value -= (split + 1) << bits
            r = rng - split
            rng, bits = new_range[r], bits - shift[r]
        else:  # end of block
            r = split + 1
            br.value, br.bits, br.rng = value, bits - shift[r], new_range[r]
            return n
        while True:  # zeros
            if bits < 0:
                br.value, br.bits = value, bits
                br.load()
                value, bits = br.value, br.bits
            split = (rng * p[1]) >> 8
            if (value >> bits) > split:
                value -= (split + 1) << bits
                r = rng - split
                rng, bits = new_range[r], bits - shift[r]
                break
            r = split + 1
            rng, bits = new_range[r], bits - shift[r]
            n += 1
            if n == 16:
                br.value, br.bits, br.rng = value, bits, rng
                return 16
            p = bands[n][0]
        if bits < 0:
            br.value, br.bits = value, bits
            br.load()
            value, bits = br.value, br.bits
        split = (rng * p[2]) >> 8
        if (value >> bits) > split:
            value -= (split + 1) << bits
            r = rng - split
            br.value, br.bits, br.rng = value, bits - shift[r], new_range[r]
            v = _large_value(br, p)
            value, bits, rng = br.value, br.bits, br.rng
            p = bands[n + 1][2]
        else:
            r = split + 1
            rng, bits = new_range[r], bits - shift[r]
            v = 1
            p = bands[n + 1][1]
        if bits < 0:
            br.value, br.bits = value, bits
            br.load()
            value, bits = br.value, br.bits
        split = rng >> 1
        if (value >> bits) > split:
            value -= (split + 1) << bits
            r = rng - split
            v = -v
        else:
            r = split + 1
        rng, bits = new_range[r], bits - shift[r]
        out[base + zigzag[n]] = v * (dq1 if n else dq0)
        n += 1
    br.value, br.bits, br.rng = value, bits, rng
    return 16


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(c: np.ndarray) -> np.ndarray:
    """libwebp's TransformOne on (N, 16) raster-order coefficients → (N, 4,
    4) residuals (the value its STORE adds, already >> 3)."""
    c = c.reshape(-1, 4, 4)  # [block, row, col]
    a = c[:, 0] + c[:, 2]
    b = c[:, 0] - c[:, 2]
    cc = _mul2(c[:, 1]) - _mul1(c[:, 3])
    d = _mul1(c[:, 1]) + _mul2(c[:, 3])
    t = np.stack([a + d, b + cc, b - cc, a - d], 1)  # [block, k, col]: the vertical pass
    dc = t[:, :, 0] + 4
    a = dc + t[:, :, 2]
    b = dc - t[:, :, 2]
    cc = _mul2(t[:, :, 1]) - _mul1(t[:, :, 3])
    d = _mul1(t[:, :, 1]) + _mul2(t[:, :, 3])
    return np.stack([a + d, b + cc, b - cc, a - d], 2) >> 3


def _iwht(c: np.ndarray) -> np.ndarray:
    """libwebp's TransformWHT on (N, 16) Y2 coefficients → (N, 16) DC values
    of the 16 luma blocks (raster order), wrapped to int16 as it stores them."""
    c = c.reshape(-1, 4, 4)
    a0 = c[:, 0] + c[:, 3]
    a1 = c[:, 1] + c[:, 2]
    a2 = c[:, 1] - c[:, 2]
    a3 = c[:, 0] - c[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], 1)  # [n, row, i]
    dc = t[:, :, 0] + 3
    a0 = dc + t[:, :, 3]
    a1 = t[:, :, 1] + t[:, :, 2]
    a2 = t[:, :, 1] - t[:, :, 2]
    a3 = dc - t[:, :, 3]
    out = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], 2) >> 3  # [n, row i, block col]
    return out.reshape(-1, 16).astype(np.int16).astype(np.int64)


def _blocks_to_plane(r: np.ndarray, k: int) -> np.ndarray:
    """(N, k*k, 4, 4) block residuals in raster order → (N, 4k, 4k)."""
    n = r.shape[0]
    return r.reshape(n, k, k, 4, 4).transpose(0, 1, 3, 2, 4).reshape(n, 4 * k, 4 * k)


def _predict_whole(p: np.ndarray, rs: np.ndarray, cs: np.ndarray, modes: np.ndarray, size: int) -> np.ndarray:
    """16×16 luma or 8×8 chroma prediction of the macroblocks (rs, cs) from
    the padded plane ``p`` (row 0 and column 0 its 127 / 129 borders):
    DC (libwebp's variants without top or left), TM, V, H."""
    ar = np.arange(size)
    top = p[(size * rs)[:, None], size * cs[:, None] + 1 + ar]
    left = p[size * rs[:, None] + 1 + ar, (size * cs)[:, None]]
    corner = p[size * rs, size * cs][:, None, None]
    log = size.bit_length() - 1
    dc = np.where(rs > 0, np.where(cs > 0, (top.sum(1) + left.sum(1) + size) >> (log + 1),
                                   (top.sum(1) + size // 2) >> log),
                  np.where(cs > 0, (left.sum(1) + size // 2) >> log, 128))
    m = modes[:, None, None]
    return np.where(m == DC_PRED, dc[:, None, None],
                    np.where(m == V_PRED, top[:, None, :],
                             np.where(m == H_PRED, left[:, :, None],
                                      np.clip(top[:, None, :] + left[:, :, None] - corner, 0, 255))))


def _put_whole(p, rs, cs, pred, res, size) -> None:
    ar = np.arange(size)
    rows = size * rs[:, None, None] + 1 + ar[None, :, None]
    cols = size * cs[:, None, None] + 1 + ar[None, None, :]
    p[rows, cols] = np.clip(pred + res, 0, 255)


def _sub_step_offsets(wy: int) -> list:
    """For each of the 10 wavefronts of equal j + 2i inside a macroblock:
    (block numbers, (blocks, 13) edge offsets, (blocks, 16) pixel offsets),
    flat indices into the padded luma plane (row length ``wy``) relative to
    the macroblock's corner (its top-left pixel's above-left neighbour).
    Edges I J K L, X, A-D, E-H; a block of the right column takes E-H from
    the row above the macroblock."""
    steps = []
    a4 = np.arange(4)
    for s in range(10):
        blocks = [(i, s - 2 * i) for i in range(4) if 0 <= s - 2 * i < 4]
        bi = np.array([i for i, _ in blocks])
        bj = np.array([j for _, j in blocks])
        y0, x0 = 4 * bi[:, None], 4 * bj[:, None]
        top_right_row = np.where(bj == 3, 0, 4 * bi)[:, None]
        edges = np.concatenate([(y0 + 1 + a4) * wy + x0, y0 * wy + x0, y0 * wy + x0 + 1 + a4,
                                top_right_row * wy + x0 + 5 + a4], 1)
        pixels = ((y0 + 1 + a4)[:, :, None] * wy + x0[:, :, None] + 1 + a4).reshape(len(blocks), 16)
        steps.append((4 * bi + bj, edges, pixels))
    return steps


def _reconstruct(mbw, mbh, is_i4, ymode, bmodes, uvmode, res):
    """Intra prediction + residual on wavefronts of equal c + 2r → the
    unfiltered Y, U and V planes."""
    py = np.zeros((16 * mbh + 1, 16 * mbw + 5), np.int64)
    py[0] = 127
    py[1:, 0] = 129
    pu = np.zeros((8 * mbh + 1, 8 * mbw + 1), np.int64)
    pu[0] = 127
    pu[1:, 0] = 129
    pv = pu.copy()
    wy = py.shape[1]
    flat = py.reshape(-1)
    res_y = res[:, :16].reshape(-1, 16, 16)
    res_u = _blocks_to_plane(res[:, 16:20], 2)
    res_v = _blocks_to_plane(res[:, 20:24], 2)
    steps = _sub_step_offsets(wy)
    for k in range(mbw + 2 * (mbh - 1)):
        rs = np.arange(max(0, (k - mbw + 2) // 2), min(mbh - 1, k // 2) + 1)
        cs = k - 2 * rs
        mb = rs * mbw + cs
        i4 = is_i4[mb]
        whole = ~i4
        if whole.any():
            r, c, m = rs[whole], cs[whole], mb[whole]
            _put_whole(py, r, c, _predict_whole(py, r, c, ymode[m], 16), _blocks_to_plane(res[m, :16], 4), 16)
        if i4.any():
            r, c, m = rs[i4], cs[i4], mb[i4]
            last = (c == mbw - 1) & (r > 0)
            if last.any():  # the last column's above-right: the pixel above its top-right, four times
                py[16 * r[last, None], 16 * mbw + 1 + np.arange(4)] = py[16 * r[last], 16 * mbw][:, None]
            origin = (16 * r * wy + 16 * c)[:, None, None]
            for blk, edge_off, pix_off in steps:
                e = flat[origin + edge_off].reshape(-1, 13)  # (macroblocks × blocks, 13)
                mode = bmodes[m[:, None], blk].ravel()
                pred = (np.take_along_axis(e, _BMODE_EDGES[mode].reshape(len(mode), 64), 1)
                        .reshape(-1, 16, 4).sum(2) + 2) >> 2
                dc = (e[:, 0:4].sum(1) + e[:, 5:9].sum(1) + 4) >> 3
                tm = np.clip(e[:, 5:9][:, None, :] + e[:, 0:4][:, :, None] - e[:, 4, None, None], 0, 255)
                pred = np.where(mode[:, None] == DC_PRED, dc[:, None],
                                np.where(mode[:, None] == TM_PRED, tm.reshape(-1, 16), pred))
                flat[origin + pix_off] = np.clip(pred.reshape(len(m), -1, 16) + res_y[m[:, None], blk], 0, 255)
        for p, rr in ((pu, res_u), (pv, res_v)):
            _put_whole(p, rs, cs, _predict_whole(p, rs, cs, uvmode[mb], 8), rr[mb], 8)
    return py[1:, 1:16 * mbw + 1], pu[1:, 1:], pv[1:, 1:]


def _filter_edge(plane: np.ndarray, q0: np.ndarray, step: int, t2, it, hev, kind: str) -> None:
    """One edge position per entry of ``q0`` (flat indices of the pixel just
    past the edge; ``step`` 1 across a vertical edge, the row length across a
    horizontal one), filtered in place as libwebp's SimpleFilter /
    FilterLoop24 (inner) / FilterLoop26 (macroblock edge) do."""
    if not len(q0):
        return
    offs = np.arange(-4, 4) * step
    idx = q0[None, :] + offs[:, None]
    v = plane[idx]
    p3, p2, p1, p0, q0v, q1, q2, q3 = v
    m = 4 * np.abs(p0 - q0v) + np.abs(p1 - q1) <= t2
    a = 3 * (q0v - p0) + np.clip(p1 - q1, -128, 127)
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    new = v.copy()
    if kind == "simple":
        new[3] = np.clip(p0 + a2, 0, 255)
        new[4] = np.clip(q0v - a1, 0, 255)
    else:
        m &= ((np.abs(p3 - p2) <= it) & (np.abs(p2 - p1) <= it) & (np.abs(p1 - p0) <= it)
              & (np.abs(q3 - q2) <= it) & (np.abs(q2 - q1) <= it) & (np.abs(q1 - q0v) <= it))
        hv = (np.abs(p1 - p0) > hev) | (np.abs(q1 - q0v) > hev)
        if kind == "inner":
            b = 3 * (q0v - p0)
            b1 = np.clip((b + 4) >> 3, -16, 15)
            b2 = np.clip((b + 3) >> 3, -16, 15)
            b3 = (b1 + 1) >> 1
            new[2] = np.where(hv, p1, np.clip(p1 + b3, 0, 255))
            new[3] = np.clip(p0 + np.where(hv, a2, b2), 0, 255)
            new[4] = np.clip(q0v - np.where(hv, a1, b1), 0, 255)
            new[5] = np.where(hv, q1, np.clip(q1 - b3, 0, 255))
        else:
            w = np.clip(3 * (q0v - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
            w1 = (27 * w + 63) >> 7
            w2 = (18 * w + 63) >> 7
            w3 = (9 * w + 63) >> 7
            new[1] = np.where(hv, p2, np.clip(p2 + w3, 0, 255))
            new[2] = np.where(hv, p1, np.clip(p1 + w2, 0, 255))
            new[3] = np.where(hv, np.clip(p0 + a2, 0, 255), np.clip(p0 + w1, 0, 255))
            new[4] = np.where(hv, np.clip(q0v - a1, 0, 255), np.clip(q0v - w1, 0, 255))
            new[5] = np.where(hv, q1, np.clip(q1 - w2, 0, 255))
            new[6] = np.where(hv, q2, np.clip(q2 - w3, 0, 255))
    plane[idx[:, m]] = new[:, m]


def _loop_filter(yuv, mbw, mbh, simple, limit, ilevel, hev, inner) -> None:
    """The loop filter over every macroblock, in place, on wavefronts of
    equal c + 2r; each macroblock's edges in libwebp's order: left, inner
    vertical, top, inner horizontal. ``yuv`` holds the luma plane above U
    and V side by side (both 16·mbw wide), so one call filters an edge of
    all three planes."""
    plane = yuv.reshape(-1)
    w = yuv.shape[1]
    a16, a8 = np.arange(16), np.arange(8)
    luma = {"left": a16 * w, "top": a16}
    chroma = {"left": a8 * w, "top": a8}
    kind_mb, kind_in = ("simple", "simple") if simple else ("mb", "inner")
    for k in range(mbw + 2 * (mbh - 1)):
        rs = np.arange(max(0, (k - mbw + 2) // 2), min(mbh - 1, k // 2) + 1)
        cs = k - 2 * rs
        mb = rs * mbw + cs
        mb = mb[limit[mb] > 0]
        if not len(mb):
            continue
        rs, cs = np.divmod(mb, mbw)
        lim, il, hv, inn = limit[mb], ilevel[mb], hev[mb], inner[mb]
        origins = [(16 * rs * w + 16 * cs, luma, 16)]
        if not simple:  # U, then V, below the luma rows
            u0 = (16 * mbh + 8 * rs) * w + 8 * cs
            origins += [(u0, chroma, 8), (u0 + 8 * mbw, chroma, 8)]

        def edge(sel, side, shift, step, t2, kind, planes=3):
            q0, t, i_, h = [], [], [], []
            for origin, off, n in origins[:planes]:
                q0.append((origin[sel, None] + shift(n) + off[side][None, :]).ravel())
                t.append(np.repeat(t2[sel], n))
                i_.append(np.repeat(il[sel], n))
                h.append(np.repeat(hv[sel], n))
            _filter_edge(plane, np.concatenate(q0), step, np.concatenate(t), np.concatenate(i_), np.concatenate(h),
                         kind)

        t2_mb, t2_in = 2 * (lim + 4) + 1, 2 * lim + 1
        edge(cs > 0, "left", lambda n: 0, 1, t2_mb, kind_mb)
        edge(inn, "left", lambda n: 4, 1, t2_in, kind_in)
        for x in (8, 12):
            edge(inn, "left", lambda n: x, 1, t2_in, kind_in, planes=1)
        edge(rs > 0, "top", lambda n: 0, w, t2_mb, kind_mb)
        edge(inn, "top", lambda n: 4 * w, w, t2_in, kind_in)
        for y in (8, 12):
            edge(inn, "top", lambda n: y * w, w, t2_in, kind_in, planes=1)


def _upsample_rows(t: np.ndarray, c: np.ndarray, top: np.ndarray, width: int) -> np.ndarray:
    """libwebp's fancy upsampler (UPSAMPLE_FUNC) for chroma row pairs: row i
    of the result interpolates chroma rows ``t[i]`` (its top) and ``c[i]``
    into the output row above (``top[i]``) or below their midline, width
    ``width``: the 9-3-3-1 weights by nested shifts, a 3-1 vertical blend at
    the first column and, for an even width, the last."""
    n = t.shape[0]
    out = np.empty((n, width), np.int64)
    tt = top[:, None]
    out[:, 0] = np.where(top, (3 * t[:, 0] + c[:, 0] + 2) >> 2, (3 * c[:, 0] + t[:, 0] + 2) >> 2)
    lp = (width - 1) >> 1
    if lp:
        a, b, cc, d = t[:, :lp], t[:, 1:lp + 1], c[:, :lp], c[:, 1:lp + 1]
        avg = a + b + cc + d + 8
        d12 = (avg + 2 * (b + cc)) >> 3
        d03 = (avg + 2 * (a + d)) >> 3
        out[:, 1:2 * lp:2] = np.where(tt, (d12 + a) >> 1, (d03 + cc) >> 1)
        out[:, 2:2 * lp + 1:2] = np.where(tt, (d03 + b) >> 1, (d12 + d) >> 1)
    if not width & 1:
        out[:, width - 1] = np.where(top, (3 * t[:, lp] + c[:, lp] + 2) >> 2, (3 * c[:, lp] + t[:, lp] + 2) >> 2)
    return out


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(H, W) luma and ((H+1)/2, (W+1)/2) chroma → (H, W, 3) uint8 RGB as
    libwebp's EmitFancyRGB gives it: output row 0 from chroma row 0 alone,
    rows 2k−1 / 2k from chroma rows k−1 and k, an even height's last row from
    the last chroma row alone; then VP8YUVToR/G/B (MultHi, >> 6, clip)."""
    h, w = y.shape
    uh = u.shape[0]
    rows = np.arange(h)
    k = (rows + 1) // 2
    tr = np.maximum(k - 1, 0)
    cr = np.minimum(k, uh - 1)
    top = (rows % 2 == 1) | (rows == 0)
    uu = _upsample_rows(u[tr], u[cr], top, w)
    vv = _upsample_rows(v[tr], v[cr], top, w)
    yy = (y.astype(np.int64) * 19077) >> 8

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))

    r = clip8(yy + ((vv * 26149) >> 8) - 14234)
    g = clip8(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708)
    b = clip8(yy + ((uu * 33050) >> 8) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _clip(v: int, top: int) -> int:
    return 0 if v < 0 else top if v > top else v


def vp8_size(data: bytes, chunk_size: int) -> tuple[int, int]:
    """(width, height) of a VP8 key frame (libwebp's VP8GetInfo);
    ValueError where it refuses the frame."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("VP8: bad start code or a frame of fewer than 10 bytes")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    w = (data[6] | (data[7] << 8)) & 0x3FFF
    h = (data[8] | (data[9] << 8)) & 0x3FFF
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= chunk_size:
        raise ValueError("VP8: not a shown key frame, or a first partition larger than the chunk")
    if not w or not h:
        raise ValueError("VP8: a frame of zero width or height")
    return w, h


def decode_vp8(data: bytes, record: list | None = None) -> np.ndarray:
    """A VP8 key frame (the payload of a ``VP8 `` chunk) → (H, W, 3) uint8
    RGB. ``record``, when given, collects the (probability, bit) decisions
    of the first partition in order."""
    if len(data) < 10:
        raise ValueError("VP8: truncated frame header")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1:
        raise ValueError("VP8: not a key frame")
    if ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1:
        raise ValueError("VP8: bad profile, or a frame not shown")
    part0 = bits >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("VP8: bad start code")
    width = (data[6] | (data[7] << 8)) & 0x3FFF
    height = (data[8] | (data[9] << 8)) & 0x3FFF
    mbw, mbh = (width + 15) >> 4, (height + 15) >> 4
    if part0 > len(data) - 10:
        raise ValueError("VP8: the first partition passes the end of the data")
    br = _BoolReader(data, 10, 10 + part0)
    if record is not None:
        br = _Recorder(br, record)
    br.bit(128)  # colour space
    br.bit(128)  # clamping type
    # segment header
    use_segment = br.bit(128)
    update_map, absolute, seg_q, seg_f = 0, 1, [0] * 4, [0] * 4
    seg_probs = [255, 255, 255]
    if use_segment:
        update_map = br.bit(128)
        if br.bit(128):
            absolute = br.bit(128)
            seg_q = [br.signed(7) if br.bit(128) else 0 for _ in range(4)]
            seg_f = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        if update_map:
            seg_probs = [br.literal(8) if br.bit(128) else 255 for _ in range(3)]
    if br.eof:
        raise ValueError("VP8: cannot parse the segment header")
    # filter header
    simple = br.bit(128)
    level = br.literal(6)
    sharpness = br.literal(3)
    ref_deltas = mode_deltas = [0] * 4  # a key frame uses the first of each
    use_delta = br.bit(128)
    if use_delta and br.bit(128):
        ref_deltas = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        mode_deltas = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
    filter_type = 0 if level == 0 else 1 if simple else 2
    if br.eof:
        raise ValueError("VP8: cannot parse the filter header")
    # token partitions
    num_parts = 1 << br.literal(2)
    start = 10 + part0
    size = len(data) - start
    if size < 3 * (num_parts - 1):
        raise ValueError("VP8: the partition sizes pass the end of the data")
    part_start = start + 3 * (num_parts - 1)
    left = size - 3 * (num_parts - 1)
    parts = []
    for p in range(num_parts - 1):
        s = data[start + 3 * p] | (data[start + 3 * p + 1] << 8) | (data[start + 3 * p + 2] << 16)
        s = min(s, left)
        parts.append(_BoolReader(data, part_start, part_start + s))
        part_start += s
        left -= s
    parts.append(_BoolReader(data, part_start, part_start + left))
    if left <= 0:
        raise ValueError("VP8: the last token partition is empty")
    # quantizers
    base_q = br.literal(7)
    dy1_dc, dy2_dc, dy2_ac, duv_dc, duv_ac = (br.signed(4) if br.bit(128) else 0 for _ in range(5))
    quant = []
    for s in range(4):
        if use_segment:
            q = seg_q[s] + (0 if absolute else base_q)
        elif s:
            quant.append(quant[0])
            continue
        else:
            q = base_q
        y2_ac = (_AC_Q[_clip(q + dy2_ac, 127)] * 101581) >> 16  # libwebp's x·155/100
        quant.append(((_DC_Q[_clip(q + dy1_dc, 127)], _AC_Q[_clip(q, 127)]),
                      (_DC_Q[_clip(q + dy2_dc, 127)] * 2, max(y2_ac, 8)),
                      (_DC_Q[_clip(q + duv_dc, 117)], _AC_Q[_clip(q + duv_ac, 127)])))
    br.bit(128)  # refresh entropy probs: ignored on a key frame
    probs = bytearray(_COEFF_PROBS)
    for i in range(len(probs)):
        if br.bit(_COEFF_UPDATE_PROBS[i]):
            probs[i] = br.literal(8)
    bands = []  # [type][position 0-16] → [ctx][11 probabilities]
    for t in range(4):
        per_band = [[list(probs[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c + 1) * 11]) for c in range(3)]
                    for b in range(8)]
        bands.append([per_band[_BANDS[n]] for n in range(17)])
    use_skip = br.bit(128)
    skip_p = br.literal(8) if use_skip else 0
    # per-macroblock modes (first partition)
    nmb = mbw * mbh
    seg = np.zeros(nmb, np.int64)
    skip = np.zeros(nmb, bool)
    is_i4 = np.zeros(nmb, bool)
    ymode = np.zeros(nmb, np.int64)
    uvmode = np.zeros(nmb, np.int64)
    bmodes = np.zeros((nmb, 16), np.int64)
    intra_t = [0] * (4 * mbw)
    bprob = _BMODE_PROBS
    for my in range(mbh):
        intra_l = [0] * 4
        for mx in range(mbw):
            i = my * mbw + mx
            if update_map:
                seg[i] = br.bit(seg_probs[1]) if not br.bit(seg_probs[0]) else 2 + br.bit(seg_probs[2])
            if use_skip:
                skip[i] = br.bit(skip_p)
            if not br.bit(145):
                is_i4[i] = True
                modes = []
                for yy in range(4):
                    m = intra_l[yy]
                    for xx in range(4):
                        o = (intra_t[4 * mx + xx] * 10 + m) * 9
                        if not br.bit(bprob[o]):
                            m = 0
                        elif not br.bit(bprob[o + 1]):
                            m = 1
                        elif not br.bit(bprob[o + 2]):
                            m = 2
                        elif not br.bit(bprob[o + 3]):
                            m = 3 if not br.bit(bprob[o + 4]) else 4 if not br.bit(bprob[o + 5]) else 5
                        else:
                            m = (6 if not br.bit(bprob[o + 6]) else 7 if not br.bit(bprob[o + 7])
                                 else 8 if not br.bit(bprob[o + 8]) else 9)
                        intra_t[4 * mx + xx] = m
                        modes.append(m)
                    intra_l[yy] = m
                bmodes[i] = modes
            else:
                m = (TM_PRED if br.bit(128) else H_PRED) if br.bit(156) else (V_PRED if br.bit(163) else DC_PRED)
                ymode[i] = m
                intra_t[4 * mx:4 * mx + 4] = [m] * 4
                intra_l = [m] * 4
            uvmode[i] = DC_PRED if not br.bit(142) else V_PRED if not br.bit(114) else (
                TM_PRED if br.bit(183) else H_PRED)
        if br.eof:
            raise ValueError("VP8: the first partition ends before the last macroblock's modes")
    # coefficient tokens
    coef = [0] * (nmb * 400)  # per macroblock: Y2, 16 Y, 4 U, 4 V blocks of 16
    big = np.zeros(nmb, bool)  # a block whose last token is past position 1
    top_nz = [[0] * 8 for _ in range(mbw)]
    top_dc = [0] * mbw
    for my in range(mbh):
        tbr = parts[my & (num_parts - 1)]
        left_nz, left_dc = [0] * 8, 0
        for mx in range(mbw):
            i = my * mbw + mx
            tnz = top_nz[mx]
            if skip[i]:
                tnz[:] = [0] * 8
                left_nz = [0] * 8
                if not is_i4[i]:
                    top_dc[mx] = left_dc = 0
            else:
                (y1, y2, uvq) = quant[seg[i]]
                base = i * 400
                many = False
                if not is_i4[i]:
                    nz = _coeffs(tbr, bands[1], top_dc[mx] + left_dc, y2[0], y2[1], 0, coef, base)
                    top_dc[mx] = left_dc = int(nz > 0)
                    many = nz > 1
                    first, ac = 1, bands[0]
                else:
                    first, ac = 0, bands[3]
                for yy in range(4):
                    lz = left_nz[yy]
                    for xx in range(4):
                        nz = _coeffs(tbr, ac, lz + tnz[xx], y1[0], y1[1], first, coef, base + 16 * (1 + 4 * yy + xx))
                        lz = int(nz > first)
                        tnz[xx] = lz
                        many = many or nz > 1
                    left_nz[yy] = lz
                for ch in (4, 6):
                    for yy in range(2):
                        lz = left_nz[ch + yy]
                        for xx in range(2):
                            blk = 17 + (ch - 4) * 2 + 2 * yy + xx
                            nz = _coeffs(tbr, bands[2], lz + tnz[ch + xx], uvq[0], uvq[1], 0, coef, base + 16 * blk)
                            lz = int(nz > 0)
                            tnz[ch + xx] = lz
                            many = many or nz > 1
                        left_nz[ch + yy] = lz
                big[i] = many
            if tbr.eof:
                raise ValueError("VP8: a token partition ends before its last macroblock")
    c = np.array(coef, np.int64).astype(np.int16).astype(np.int64).reshape(nmb, 25, 16)
    whole = ~is_i4
    if whole.any():
        c[whole, 1:17, 0] = _iwht(c[whole, 0])
    nonzero = big | (c[:, 1:, 0] != 0).any(1)
    res = _idct(c[:, 1:].reshape(-1, 16)).reshape(nmb, 24, 4, 4)
    y, u, v = _reconstruct(mbw, mbh, is_i4, ymode, bmodes, uvmode, res)
    if filter_type:
        limit = np.zeros((4, 2), np.int64)
        ilevel = np.zeros((4, 2), np.int64)
        hev_t = np.zeros((4, 2), np.int64)
        for s in range(4):
            base_level = (seg_f[s] + (0 if absolute else level)) if use_segment else level
            for i4 in (0, 1):
                lv = base_level
                if use_delta:
                    lv += ref_deltas[0] + (mode_deltas[0] if i4 else 0)
                lv = min(max(lv, 0), 63)
                if lv > 0:
                    il = lv
                    if sharpness > 0:
                        il >>= 2 if sharpness > 4 else 1
                        il = min(il, 9 - sharpness)
                    il = max(il, 1)
                    ilevel[s, i4] = il
                    limit[s, i4] = 2 * lv + il
                    hev_t[s, i4] = 2 if lv >= 40 else 1 if lv >= 15 else 0
        i4i = is_i4.astype(np.int64)
        yuv = np.concatenate([y, np.concatenate([u, v], 1)], 0)
        _loop_filter(yuv, mbw, mbh, filter_type == 1, limit[seg, i4i], ilevel[seg, i4i], hev_t[seg, i4i],
                     is_i4 | nonzero)
        y, u, v = yuv[:16 * mbh], yuv[16 * mbh:, :8 * mbw], yuv[16 * mbh:, 8 * mbw:]
    return yuv_to_rgb(y[:height, :width], u[:(height + 1) // 2, :(width + 1) // 2],
                      v[:(height + 1) // 2, :(width + 1) // 2])


class _Recorder:
    """A boolean decoder that records each (probability, bit) decision."""

    def __init__(self, br: _BoolReader, record: list):
        self._br, self._record = br, record

    @property
    def eof(self) -> bool:
        return self._br.eof

    def bit(self, prob: int) -> int:
        b = self._br.bit(prob)
        self._record.append((prob, b))
        return b

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v
