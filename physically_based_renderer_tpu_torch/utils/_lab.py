"""CIELab → sRGB as PIL converts it — ``Image.convert("RGB")`` (or
``"RGBA"``) of mode ``LAB`` is LittleCMS 2's transform from its built-in
D50 Lab profile to its built-in sRGB profile, 8 bits in and out, default
intent and flags. For ``utils/_tiff.py``'s photometric-8 files.

LittleCMS does not run its colour pipeline per pixel: it samples it once
into a 33×33×33 table of 16-bit RGB (``OptimizeByResampling``) and
interpolates that table tetrahedrally in 16.16 fixed point
(``TetrahedralInterp16``), the 8-bit inputs widened by ×257 and the 16-bit
outputs narrowed by ``(x·65281 + 2^23) >> 24``. The table is rebuilt here
from the pipeline each node evaluates in float32 stages (``_LUTeval16``):
Lab (V4 encoding) → XYZ (``cmsLab2XYZ``, D50, scaled by 1/1.99997), the
inverse of sRGB's colorant matrix (Rec. 709 primaries, D65 adapted to D50
by Bradford, built as ``cmsCreate_sRGBProfile`` builds it) times 1.99997,
then the inverse of sRGB's parametric curve (type 4: γ 2.4), each node
rounded to 16 bits. Held equal to PIL over all 2^24 triples
(``scripts/check_lab_against_pil.py``; ``tests/test_torch_image_tiff_codecs.py``
keeps a seeded subsample).

PIL keeps a TIFF's signed a* and b* as ``a + 128`` (its ``LAB`` unpacker
flips their top bit), which is LittleCMS's 8-bit Lab layout.
"""

from __future__ import annotations

import numpy as np

GRID = 33
D50 = (0.9642, 1.0, 0.8249)
BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367), (0.0389, -0.0685, 1.0296))
MAX_XYZ = 1.0 + 32767.0 / 32768.0  # LittleCMS's MAX_ENCODEABLE_XYZ
SRGB_CURVE = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)  # Build_sRGBGamma's parameters
# TetrahedralInterp16's slopes along x, y and z in each case, as (corner, corner) of (c0, c1, c2, c3)
SLOPES = (((1, 0), (2, 1), (3, 2)), ((1, 3), (2, 1), (3, 0)), ((1, 0), (2, 3), (3, 1)),
          ((1, 2), (2, 0), (3, 1)), ((1, 3), (2, 0), (3, 2)), ((1, 2), (2, 3), (3, 0)))
_TABLE = []


def _inverse(a):
    """``_cmsMAT3inverse``: the cofactors over the determinant."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det, (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det, (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det, (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _product(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)] for i in range(3)]


def _apply(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def _xyz_to_rgb() -> list:
    """The inverse of ``cmsCreate_sRGBProfile``'s colorant matrix
    (``_cmsBuildRGB2XYZtransferMatrix`` and ``_cmsAdaptMatrixToD50``)."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    coef = _apply(_inverse([[xr, xg, xb], [yr, yg, yb], [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
                  [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    rgb2xyz = [[coef[0] * xr, coef[1] * xg, coef[2] * xb], [coef[0] * yr, coef[1] * yg, coef[2] * yb],
               [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)]]
    source = [(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0]
    cone_src, cone_dst = _apply(BRADFORD, source), _apply(BRADFORD, D50)
    cone = [[cone_dst[i] / cone_src[i] if i == j else 0.0 for j in range(3)] for i in range(3)]
    adapt = _product(_inverse(BRADFORD), _product(cone, BRADFORD))
    return _inverse(_product(adapt, rgb2xyz))


def _nodes(lab16: np.ndarray) -> np.ndarray:
    """LittleCMS's pipeline on (N, 3) 16-bit Lab → (N, 3) 16-bit sRGB, in
    its float32 stages."""
    f32 = np.float32
    x = lab16.astype(f32) / f32(65535.0)
    lum = x[:, 0].astype(np.float64) * 100.0
    y = (lum + 16.0) / 116.0
    fx = y + 0.002 * (x[:, 1].astype(np.float64) * 255.0 - 128.0)
    fz = y - 0.005 * (x[:, 2].astype(np.float64) * 255.0 - 128.0)
    xyz = [(np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t) * w / MAX_XYZ).astype(f32)
           for t, w in zip((fx, y, fz), D50)]
    inv = _xyz_to_rgb()
    g, a, b, c, d = SRGB_CURVE
    disc = (a * d + b) ** g
    out = []
    for row in inv:
        lin = (xyz[0].astype(np.float64) * (row[0] * MAX_XYZ) + xyz[1].astype(np.float64) * (row[1] * MAX_XYZ)
               + xyz[2].astype(np.float64) * (row[2] * MAX_XYZ)).astype(f32).astype(np.float64)
        v = np.where(lin >= disc, (np.power(np.maximum(lin, 0.0), 1.0 / g) - b) / a, lin / c)
        out.append(np.clip(np.floor(v.astype(f32).astype(np.float64) * 65535.0 + 0.5), 0, 65535))
    return np.stack(out, 1).astype(np.int64)


def table() -> np.ndarray:
    """The 33×33×33×3 table of 16-bit sRGB, built once."""
    if not _TABLE:
        q = np.floor(np.arange(GRID) * 65535.0 / (GRID - 1) + 0.5).astype(np.int64)
        grid = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1).reshape(-1, 3)
        _TABLE.append(_nodes(grid).reshape(GRID, GRID, GRID, 3))
    return _TABLE[0]


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 Lab in LittleCMS's layout (L·255/100, a + 128, b + 128)
    → (..., 3) uint8 sRGB: ``TetrahedralInterp16`` on the table."""
    lut = table()
    flat = lab.reshape(-1, 3).astype(np.int64) * 257
    a = flat * (GRID - 1)
    f = a + (a + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
    lo, rest = f >> 16, f & 0xFFFF
    hi = np.where(flat == 0xFFFF, lo, lo + 1)
    (x0, y0, z0), (x1, y1, z1), (rx, ry, rz) = lo.T, hi.T, rest.T
    c0 = lut[x0, y0, z0]
    # the six tetrahedra (TetrahedralInterp16's cases): each the three corners it visits
    cases = [((rx >= ry) & (ry >= rz), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1)),
             ((rx >= ry) & (ry < rz) & (rz >= rx), (x1, y0, z1), (x1, y1, z1), (x0, y0, z1)),
             ((rx >= ry) & (ry < rz) & (rz < rx), (x1, y0, z0), (x1, y1, z1), (x1, y0, z1)),
             ((rx < ry) & (rx >= rz), (x1, y1, z0), (x0, y1, z0), (x1, y1, z1)),
             ((rx < ry) & (rx < rz) & (ry >= rz), (x1, y1, z1), (x0, y1, z0), (x0, y1, z1)),
             ((rx < ry) & (rx < rz) & (ry < rz), (x1, y1, z1), (x0, y1, z1), (x0, y0, z1))]
    out = np.empty_like(c0)
    for k, (m, p1, p2, p3) in enumerate(cases):
        if not m.any():
            continue
        v = (c0[m], lut[tuple(i[m] for i in p1)], lut[tuple(i[m] for i in p2)], lut[tuple(i[m] for i in p3)])
        # the slopes along x, y, z on this tetrahedron's path from c0: corner minus corner
        (a1, b1), (a2, b2), (a3, b3) = SLOPES[k]
        s = (v[a1] - v[b1]) * rx[m, None] + (v[a2] - v[b2]) * ry[m, None] + (v[a3] - v[b3]) * rz[m, None] + 0x8001
        out[m] = (v[0] + ((s + (s >> 16)) >> 16)) & 0xFFFF
    return ((out * 65281 + 8388608) >> 24).astype(np.uint8).reshape(lab.shape)
