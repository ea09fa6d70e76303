"""Triangle binning: sort triangles into per-screen-tile contiguous runs —
the counterpart of ``physically_based_renderer_tpu/ops/raster_bin.py``
(pair-major layout only, the one the row kernel reads).

  1. each valid triangle's tile-bbox span;
  2. class-based (tile, triangle) pair slots: 2 for span ≤ 2 (the bbox's
     first and last tile), ``max_span`` dense slots for a ranked block of
     bigger triangles, ``big2_span`` slots for a second ranked block of
     mid-size ones, and one front-sorting jumbo slot (tile key −1) for the
     rest or for block overflow;
  3. one sort of packed ``(tile+1, tri)`` int32 keys — within a tile the
     triangle ids ascend, which is draw order;
  4. per-tile ``[start, end)`` by searchsorted; ``[0, starts[0])`` is the
     jumbo run every tile also processes.

These are plain torch ops (sort, cumsum, searchsorted): the JAX package runs
this stage as XLA, not as a kernel. The ``starts`` and pair sets equal the
JAX function's for the same inputs.
"""

from __future__ import annotations

import dataclasses

import torch

from .raster import ScreenTris, _edge_coeffs

# Packed per-pair field layout (columns of the (PAIRS, NF) array):
# 0-2 a0..a2 edge x-coefficients; 3-5 b0..b2 edge y-coefficients;
# 6-8 c0..c2 edge values at corner 0; 9,10 x0, y0 (corner 0);
# 11-13 za, zb, zc depth plane z(p) = za·dx + zb·dy + zc;
# 14 material id as float; 15 constant 1.0.
# With ``corner_channels`` three CH-wide blocks [gx | gy | gc] of
# interpolation planes follow at 16, padded to a multiple of 8.
FIELD_MATERIAL = 14
GBUF_FIELD0 = 16
RASTER_FIELDS = 14  # fields 0-13: all the depth test reads


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class BinnedTris:
    """Sorted (tile → triangles) binning + packed per-pair kernel data."""

    packed: torch.Tensor  # (PAIRS + chunk, NF) f32, pair-major
    pair_tri: torch.Tensor  # (PAIRS + chunk,) int32 triangle ids (−1 pads)
    starts: torch.Tensor  # (ntiles + 1,) int32; [0, starts[0]) = jumbo run
    num_pairs: torch.Tensor  # () int — real pairs emitted (before the cap)
    overflowed: torch.Tensor  # () bool — pair cap exceeded, pairs dropped


def pack_triangle_fields(
    st: ScreenTris,
    face_material: torch.Tensor | None = None,
    corner_channels: torch.Tensor | None = None,
    normalize_edges: bool = False,
) -> torch.Tensor:
    """Per-triangle kernel constants, (T, 16[+3·CH, padded to 8]).

    ``corner_channels`` (T, 3, CH): per-corner values to interpolate
    linearly in screen space; each becomes a plane
    value(p) = gx·dx + gy·dy + gc relative to corner 0.

    ``normalize_edges`` scales each edge's (a, b, c0) to unit gradient
    (÷ √(a² + b²)), so that the dilated test ``e ≥ −margin`` measures the
    margin in pixels; the sign, and so the coverage at margin 0, is
    unchanged. The depth and interpolation planes keep the raw edges."""
    a, b, c0, x0, y0 = _edge_coeffs(st)
    inv_area = 1.0 / st.area.abs()
    z = st.z

    def plane(coef, vals):  # Σ_i coef_i·vals_i in a fixed order
        return coef[:, 0] * vals[:, 0] + coef[:, 1] * vals[:, 1] + coef[:, 2] * vals[:, 2]

    za = plane(a, z) * inv_area
    zb = plane(b, z) * inv_area
    zc = plane(c0, z) * inv_area
    za_src, zb_src, zc_src = a, b, c0  # the planes below use the raw edges
    if normalize_edges:
        inv_len = torch.rsqrt(torch.clamp(a * a + b * b, min=1e-20))
        a, b, c0 = a * inv_len, b * inv_len, c0 * inv_len
    mat = (
        torch.zeros_like(x0)
        if face_material is None
        else face_material.to(torch.float32)
    )
    base = torch.stack(
        [
            a[:, 0], a[:, 1], a[:, 2],
            b[:, 0], b[:, 1], b[:, 2],
            c0[:, 0], c0[:, 1], c0[:, 2],
            x0, y0, za, zb, zc,
            mat, torch.ones_like(x0),
        ],
        dim=-1,
    )
    if corner_channels is None:
        return base
    ch = corner_channels
    gx = plane(za_src[..., None], ch) * inv_area[:, None]
    gy = plane(zb_src[..., None], ch) * inv_area[:, None]
    gc = plane(zc_src[..., None], ch) * inv_area[:, None]
    out = torch.cat([base, gx, gy, gc], dim=-1)
    pad = _round_up(out.shape[-1], 8) - out.shape[-1]
    if pad:
        out = torch.nn.functional.pad(out, (0, pad))
    return out


def check_binning_invariants(binned: BinnedTris, num_tris: int) -> None:
    """Validate the binning contract on the host; raises ``RuntimeError``:
    no pair-cap overflow (dropped triangles), ``starts`` monotone and within
    the pair array, triangle ids within [−1, T)."""
    starts = binned.starts
    pairs = binned.pair_tri.shape[0]
    if bool(binned.overflowed):
        raise RuntimeError(
            "raster binning overflow: pair cap exceeded, triangles dropped "
            "(raise raster_pairs_cap)"
        )
    if not bool((starts[1:] >= starts[:-1]).all()):
        raise RuntimeError("binning run bounds corrupt: starts not monotone")
    if not (int(starts[0]) >= 0 and int(starts[-1]) <= pairs):
        raise RuntimeError(
            f"binning run bounds out of range: jumbo={int(starts[0])} "
            f"end={int(starts[-1])} pairs={pairs}"
        )
    if not bool(((binned.pair_tri >= -1) & (binned.pair_tri < num_tris)).all()):
        raise RuntimeError("binning pair payload corrupt: triangle id out of [-1, T)")


def _tile_index(coord: torch.Tensor, size: int, n: int) -> torch.Tensor:
    """floor(coord / size) as int32, clipped to [0, n-1]. Clamped in float
    before the cast so out-of-range and NaN inputs land where XLA's
    saturating float→int conversion puts them."""
    t = torch.floor(coord / size).clamp(-1.0, float(n))
    t = torch.nan_to_num(t, nan=0.0).to(torch.int32)
    return t.clamp(0, n - 1)


def bin_triangles(
    st: ScreenTris,
    *,
    width: int,
    height: int,
    rows: int | None = None,
    y_offset: int = 0,
    tile_h: int,
    tile_w: int,
    max_span: int = 8,
    pairs_cap: int | None = None,
    chunk: int = 128,
    face_material: torch.Tensor | None = None,
    corner_channels: torch.Tensor | None = None,
    big_cap: int | None = None,
    big2_span: int = 0,
    big2_cap: int | None = None,
    bbox_margin_px: float = 0.0,
) -> BinnedTris:
    """Bin into the tile grid of the row band [y_offset, y_offset+rows) of a
    width×height viewport (full frame by default). ``bbox_margin_px`` > 0
    dilates every bbox and the band cull by that many pixels, and packs
    unit-gradient edges, for the kernel's dilated edge test."""
    if rows is None:
        rows = height
    device = st.xy.device
    i32 = torch.int32
    num_t = st.xy.shape[0]
    ntx = -(-width // tile_w)
    nty = -(-rows // tile_h)
    ntiles = nty * ntx
    if pairs_cap is None:
        pairs_cap = max(num_t, 1 << 16)

    y_off = float(y_offset)
    mg = float(bbox_margin_px)
    x = st.xy[..., 0]
    y = st.xy[..., 1]
    xmin, xmax = x.amin(-1), x.amax(-1)
    ymin, ymax = y.amin(-1), y.amax(-1)
    tx0 = _tile_index(xmin - mg, tile_w, ntx)
    tx1 = _tile_index(xmax + mg, tile_w, ntx)
    ty0 = _tile_index(ymin - mg - y_off, tile_h, nty)
    ty1 = _tile_index(ymax + mg - y_off, tile_h, nty)
    on_screen = (xmax >= -mg) & (xmin < width + mg) & (ymax >= y_off - mg) & (ymin < y_off + rows + mg)
    valid = st.valid & on_screen

    span_w = tx1 - tx0 + 1
    span_h = ty1 - ty0 + 1
    span = span_w * span_h
    tri_ids = torch.arange(num_t, dtype=i32, device=device)
    sent = ntiles + 1  # sentinel tile: sorts to the tail

    small2 = valid & (span <= 2)
    big = valid & (span > 2) & (span <= max_span)
    jumbo = valid & (span > max(2, max_span))
    big2 = None
    if big2_span > max_span:
        big2 = jumbo & (span <= big2_span)
        jumbo = jumbo & (span > big2_span)

    if big_cap is None:
        if max_span >= 32:
            big_cap = max(4096, num_t // 4)
        elif num_t <= (1 << 16):
            big_cap = num_t
        else:
            big_cap = max(4096, num_t // 8)
    big_cap = min(big_cap, num_t)

    def ranked(cls: torch.Tensor, cap: int):
        """First ``cap`` ids of class ``cls`` by id (+ validity), and the
        class members past the cap (spilled to jumbo)."""
        order = torch.sort(torch.where(cls, tri_ids, tri_ids + num_t)).values[:cap]
        rank = torch.cumsum(cls.to(i32), 0, dtype=i32) - 1
        return order % num_t, order < num_t, cls & (rank >= cap)

    if big_cap < num_t:
        btri, bvalid, spilled = ranked(big, big_cap)
    else:
        btri, bvalid, spilled = tri_ids, big, torch.zeros_like(big)
    jumbo_all = jumbo | spilled

    if big2 is not None:
        bc2 = min(big2_cap if big2_cap is not None else 512, num_t)
        b2tri, b2valid, spilled2 = ranked(big2, bc2)
        jumbo_all = jumbo_all | spilled2

    tile_first = ty0 * ntx + tx0
    tile_last = ty1 * ntx + tx1
    k0_tile = torch.where(
        jumbo_all,
        torch.full_like(tile_first, -1),
        torch.where(small2, tile_first, torch.full_like(tile_first, sent - 1)),
    )
    k1_tile = torch.where(
        small2 & (span > 1), tile_last, torch.full_like(tile_last, sent - 1)
    )

    def dense_slots(tris: torch.Tensor, ok: torch.Tensor, slots: int) -> torch.Tensor:
        """Tiles of ``slots`` dense row-major bbox slots per listed triangle
        (sentinel past each triangle's span)."""
        tris = tris.long()
        ks = torch.arange(slots, dtype=i32, device=device)[None, :]
        bw = span_w[tris].clamp(min=1)[:, None]
        tile = (ty0[tris][:, None] + ks // bw) * ntx + (tx0[tris][:, None] + ks % bw)
        good = ok[:, None] & (ks < span[tris][:, None])
        return torch.where(good, tile, torch.full_like(tile, sent - 1))

    kb_tile = dense_slots(btri, bvalid, max_span)
    tile_parts = [k0_tile, k1_tile, kb_tile.reshape(-1)]
    tri_parts = [tri_ids, tri_ids, btri[:, None].expand_as(kb_tile).reshape(-1)]
    if big2 is not None:
        kb2_tile = dense_slots(b2tri, b2valid, big2_span)
        tile_parts.append(kb2_tile.reshape(-1))
        tri_parts.append(b2tri[:, None].expand_as(kb2_tile).reshape(-1))
    slot_tiles = torch.cat(tile_parts)
    slot_tris = torch.cat(tri_parts)

    total = (
        torch.where(small2, span.clamp(max=2), 0).sum()
        + torch.where(big & ~spilled, span, 0).sum()
        + jumbo_all.sum()
    )
    if big2 is not None:
        total = total + torch.where(big2 & ~spilled2, span, 0).sum()
    overflowed = total > pairs_cap

    tri_bits = max(1, (num_t - 1).bit_length()) if num_t > 1 else 1
    if ntiles + 2 <= (1 << (31 - tri_bits)):
        # One value-free sort of unique packed keys: exact, and within a tile
        # the triangle ids ascend (draw order).
        keys = ((slot_tiles + 1) << tri_bits) | slot_tris
        sorted_keys = torch.sort(keys).values[:pairs_cap]
        sorted_tile = (sorted_keys >> tri_bits) - 1
        sorted_tri = torch.where(
            sorted_tile < ntiles,
            sorted_keys & ((1 << tri_bits) - 1),
            torch.full_like(sorted_keys, -1),
        )
    else:
        # Two-key lexicographic order (tile, tri) via int64 keys.
        keys = (slot_tiles.to(torch.int64) << 32) | slot_tris.to(torch.int64)
        sorted_keys = torch.sort(keys).values[:pairs_cap]
        sorted_tile = (sorted_keys >> 32).to(i32)
        sorted_tri = torch.where(
            sorted_tile < ntiles,
            (sorted_keys & 0xFFFFFFFF).to(i32),
            torch.full_like(sorted_tile, -1),
        )

    starts = torch.searchsorted(
        sorted_tile, torch.arange(ntiles + 1, dtype=i32, device=device)
    ).to(i32)

    fields = pack_triangle_fields(st, face_material, corner_channels, normalize_edges=mg > 0.0)
    packed = fields[sorted_tri.clamp(min=0).long()]
    packed = torch.nn.functional.pad(packed, (0, 0, 0, chunk))
    pair_tri = torch.nn.functional.pad(sorted_tri, (0, chunk), value=-1)
    return BinnedTris(
        packed=packed,
        pair_tri=pair_tri,
        starts=starts,
        num_pairs=total.clamp(max=pairs_cap),
        overflowed=overflowed,
    )
