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

The JAX package runs this stage as XLA, not as a kernel. Here it has two
implementations of one function:

  * on CPU tensors, :func:`bin_triangles_plain` (and
    ``ops/raster_row.bin_for_shade_plain``, the setup and corner channels
    before it): plain torch ops (sort, cumsum, searchsorted), whose
    ``starts`` and pair sets equal the JAX function's for the same inputs;
  * on CUDA tensors, :func:`bin_triangles_cuda` and :func:`bin_clip_cuda`:
    the hand-written kernels of ``csrc/raster_bin.cu`` around one
    ``torch.sort`` of the keys, with no host sync and no shape that depends
    on data, bit for bit the plain version on the card. They raise on what
    they do not take and never fall back.

Counter (``utils/profiling``, readable and settable under this module's
name): ``launch/bin`` counts the kernel chains, one a binning.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..utils import profiling
from ..utils.cuda_build import load_library
from .raster import W_EPS, ScreenTris, _edge_coeffs

COUNTERS = {"BIN_LAUNCHES": "launch/bin"}

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


@dataclasses.dataclass(frozen=True)
class _Plan:
    """The sizes of one binning, every one a Python int from shapes."""

    num_t: int
    ntx: int
    nty: int
    pairs_cap: int
    max_span: int
    big_cap: int  # rows of the ranked big block (≤ T)
    big2_span: int
    big2_cap: int  # rows of the ranked big2 block; 0 without one
    tri_bits: int  # the triangle id's bits in a packed int32 key
    keys_i64: bool  # (tile, tri) int64 keys: the int32 packing would not fit

    @property
    def ntiles(self) -> int:
        return self.ntx * self.nty

    @property
    def num_keys(self) -> int:
        """Pair slots: k0 and k1 a triangle, then the two ranked blocks."""
        return 2 * self.num_t + self.big_cap * self.max_span + self.big2_cap * self.big2_span

    @property
    def num_slots(self) -> int:
        """Sorted slots kept: the pair arrays are this long, plus the chunk."""
        return min(self.num_keys, self.pairs_cap)


def _plan(num_t: int, *, width: int, rows: int, tile_h: int, tile_w: int, max_span: int,
          pairs_cap: int | None, big_cap: int | None, big2_span: int, big2_cap: int | None) -> _Plan:
    ntx = -(-width // tile_w)
    nty = -(-rows // tile_h)
    if pairs_cap is None:
        pairs_cap = max(num_t, 1 << 16)
    if big_cap is None:
        if max_span >= 32:
            big_cap = max(4096, num_t // 4)
        elif num_t <= (1 << 16):
            big_cap = num_t
        else:
            big_cap = max(4096, num_t // 8)
    bc2 = min(big2_cap if big2_cap is not None else 512, num_t) if big2_span > max_span else 0
    tri_bits = max(1, (num_t - 1).bit_length()) if num_t > 1 else 1
    return _Plan(num_t=num_t, ntx=ntx, nty=nty, pairs_cap=pairs_cap, max_span=max_span, big_cap=min(big_cap, num_t),
                 big2_span=big2_span, big2_cap=bc2, tri_bits=tri_bits,
                 keys_i64=ntx * nty + 2 > (1 << (31 - tri_bits)))


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
    unit-gradient edges, for the kernel's dilated edge test. CUDA tensors
    run :func:`bin_triangles_cuda` (on contiguous copies of what is not),
    CPU tensors :func:`bin_triangles_plain`."""
    fn = bin_triangles_plain
    if st.xy.device.type == "cuda":
        fn = bin_triangles_cuda
        st = ScreenTris(**{f.name: getattr(st, f.name).contiguous() for f in dataclasses.fields(st)})
        face_material, corner_channels = contiguous_or_none(face_material), contiguous_or_none(corner_channels)
    return fn(st, width=width, height=height, rows=rows, y_offset=y_offset, tile_h=tile_h, tile_w=tile_w,
              max_span=max_span, pairs_cap=pairs_cap, chunk=chunk, face_material=face_material,
              corner_channels=corner_channels, big_cap=big_cap, big2_span=big2_span, big2_cap=big2_cap,
              bbox_margin_px=bbox_margin_px)


def bin_triangles_plain(
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
    """:func:`bin_triangles` in plain torch ops, on any device."""
    if rows is None:
        rows = height
    device = st.xy.device
    i32 = torch.int32
    num_t = st.xy.shape[0]
    plan = _plan(num_t, width=width, rows=rows, tile_h=tile_h, tile_w=tile_w, max_span=max_span,
                 pairs_cap=pairs_cap, big_cap=big_cap, big2_span=big2_span, big2_cap=big2_cap)
    ntx, nty, ntiles, pairs_cap, big_cap = plan.ntx, plan.nty, plan.ntiles, plan.pairs_cap, plan.big_cap

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
        b2tri, b2valid, spilled2 = ranked(big2, plan.big2_cap)
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

    tri_bits = plan.tri_bits
    if not plan.keys_i64:
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


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/raster_bin.cu)
# ---------------------------------------------------------------------------

_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float


class _BinArgs(ctypes.Structure):
    """``BinArgs`` of ``csrc/raster_bin.cu``, field for field."""

    _fields_ = [
        *((k, _P) for k in ("clip", "tris", "xy", "z", "inv_w", "area", "valid", "tri_mask", "attrs", "channels",
                            "face_material", "fields", "info", "counts", "keys", "total", "sorted", "pair_tri",
                            "starts", "packed", "num_pairs", "overflowed")),
        *((k, _I64) for k in ("num_t", "num_keys", "num_slots", "pairs_cap")),
        *((k, _I32) for k in ("num_groups", "tris_i64", "mat_i64", "keys_i64", "num_c", "nf", "cull", "normalize",
                              "ntx", "nty", "ntiles", "tile_w", "tile_h", "max_span", "big2_span", "big_cap",
                              "big2_cap", "tri_bits", "chunk")),
        *((k, _F32) for k in ("half_w", "half_h", "w_eps", "area_eps", "len_eps", "mg", "y_off", "x_lo", "x_hi",
                              "y_lo", "y_hi")),
    ]


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/raster_bin.cu``."""
    lib = load_library("raster_bin")
    for fn in (lib.raster_bin_keys, lib.raster_bin_pack):
        fn.argtypes = [ctypes.POINTER(_BinArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.raster_bin_setup_block.restype = ctypes.c_int
    lib.raster_bin_error_string.argtypes = [ctypes.c_int]
    lib.raster_bin_error_string.restype = ctypes.c_char_p
    return lib


def _launch(fn_name: str, args: _BinArgs, device) -> None:
    lib = kernel_library()
    err = getattr(lib, fn_name)(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} ({lib.raster_bin_error_string(err).decode()})")


_INDEX = (torch.int32, torch.int64)


def contiguous_or_none(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.contiguous()


def _check(name: str, device, checks) -> None:
    """Raise ``ValueError`` unless each (key, tensor or None, dtypes, shape)
    of ``checks`` is None or a contiguous tensor of one of ``dtypes`` on
    ``device`` with that shape (None: any at that place): what the kernels
    read through raw pointers."""
    for key, t, dtypes, shape in checks:
        if t is None:
            continue
        if t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous {' or '.join(map(str, dtypes))} tensor, "
                             f"got {t.dtype} (contiguous={t.is_contiguous()})")
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, the others on {device}")
        if len(t.shape) != len(shape) or any(s is not None and s != n for s, n in zip(shape, t.shape)):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {shape}")


def _bin_cuda(name: str, geometry: dict, *, num_t: int, device, attrs, channels, face_material, tri_mask,
              cull_backface: bool, width: int, height: int, rows: int | None, y_offset: int, tile_h: int,
              tile_w: int, max_span: int, pairs_cap: int | None, chunk: int, big_cap: int | None, big2_span: int,
              big2_cap: int | None, bbox_margin_px: float) -> BinnedTris:
    """The kernel chain on checked inputs: setup and keys, ``torch.sort``,
    pack. ``geometry`` holds the clip input's tensors or the screen setup's."""
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")
    if rows is None:
        rows = height
    plan = _plan(num_t, width=width, rows=rows, tile_h=tile_h, tile_w=tile_w, max_span=max_span,
                 pairs_cap=pairs_cap, big_cap=big_cap, big2_span=big2_span, big2_cap=big2_cap)
    num_c = attrs.shape[-1] if attrs is not None else (channels.shape[-1] if channels is not None else 0)
    num_ch = num_c + 1 if attrs is not None else num_c
    nf = _round_up(GBUF_FIELD0 + 3 * num_ch, 8) if num_ch else GBUF_FIELD0
    slots = plan.num_slots
    lib = kernel_library()
    group = lib.raster_bin_setup_block()
    f32, i32 = torch.float32, torch.int32

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    keep = dict(geometry, attrs=attrs, channels=channels, face_material=face_material, tri_mask=tri_mask,
                fields=empty((num_t, nf), f32), info=empty((num_t, 4), i32),
                counts=empty((max(1, -(-num_t // group)), 2), i32),
                keys=empty(plan.num_keys, torch.int64 if plan.keys_i64 else i32), total=empty(1, torch.int64))
    args = _BinArgs()
    for key, t in keep.items():
        if t is not None:
            setattr(args, key, t.data_ptr())
    mg = float(bbox_margin_px)
    args.num_t, args.num_keys, args.num_slots, args.pairs_cap = num_t, plan.num_keys, slots, plan.pairs_cap
    args.num_groups = keep["counts"].shape[0]
    args.tris_i64 = geometry.get("tris") is not None and geometry["tris"].dtype == torch.int64
    args.mat_i64 = face_material is not None and face_material.dtype == torch.int64
    args.keys_i64, args.num_c, args.nf = plan.keys_i64, num_c, nf
    args.cull, args.normalize = cull_backface, mg > 0.0
    args.ntx, args.nty, args.ntiles, args.tile_w, args.tile_h = plan.ntx, plan.nty, plan.ntiles, tile_w, tile_h
    args.max_span, args.big2_span, args.big_cap, args.big2_cap = max_span, big2_span, plan.big_cap, plan.big2_cap
    args.tri_bits, args.chunk = plan.tri_bits, chunk
    # the plain version's Python numbers, rounded to float32 as the card's ops round a scalar operand
    args.half_w, args.half_h, args.w_eps, args.area_eps, args.len_eps = 0.5 * width, 0.5 * height, W_EPS, 1e-12, 1e-20
    args.mg, args.y_off = mg, float(y_offset)
    args.x_lo, args.x_hi, args.y_lo, args.y_hi = -mg, width + mg, y_offset - mg, y_offset + rows + mg
    _launch("raster_bin_keys", args, device)

    sorted_keys = torch.sort(keep["keys"]).values
    out = dict(pair_tri=empty(slots + chunk, i32), starts=empty(plan.ntiles + 1, i32),
               packed=empty((slots + chunk, nf), f32), num_pairs=empty((), torch.int64),
               overflowed=empty((), torch.bool))
    args.sorted = sorted_keys.data_ptr()
    for key, t in out.items():
        setattr(args, key, t.data_ptr())
    _launch("raster_bin_pack", args, device)
    profiling.count("launch/bin")
    return BinnedTris(**out)


def bin_clip_cuda(
    verts_clip: torch.Tensor,
    packed_attrs: torch.Tensor | None,
    face_material: torch.Tensor | None,
    *,
    tris: torch.Tensor | None = None,
    tri_mask: torch.Tensor | None = None,
    cull_backface: bool = True,
    width: int,
    height: int,
    rows: int | None = None,
    y_offset: int = 0,
    tile_h: int,
    tile_w: int,
    max_span: int = 8,
    pairs_cap: int | None = None,
    chunk: int = 128,
    big_cap: int | None = None,
    big2_span: int = 0,
    big2_cap: int | None = None,
    bbox_margin_px: float = 0.0,
) -> BinnedTris:
    """``ops/raster_row.bin_for_shade_plain`` (setup from clip coordinates,
    the ``[attrs·1/w, 1/w]`` corner channels, binning) by the kernels of
    ``csrc/raster_bin.cu``: corner-major ``verts_clip`` (T, 3, 4) and
    ``packed_attrs`` (T, 3, C), or with ``tris`` (T, 3) vertices (V, 4) and
    (V, C); ``packed_attrs`` None packs the 16 fields. Contiguous float32
    geometry, int32 / int64 ``tris`` and ``face_material``, bool
    ``tri_mask``, all on one CUDA device; raises ``ValueError`` otherwise."""
    name = "bin_clip_cuda"
    device = verts_clip.device
    if tris is None:
        num_t = verts_clip.shape[0] if verts_clip.dim() == 3 else -1
        _check(name, device, [("verts_clip", verts_clip, (torch.float32,), (None, 3, 4)),
                              ("packed_attrs", packed_attrs, (torch.float32,), (num_t, 3, None))])
    else:
        num_t, num_v = tris.shape[0], verts_clip.shape[0]
        _check(name, device, [("verts_clip", verts_clip, (torch.float32,), (None, 4)),
                              ("tris", tris, _INDEX, (num_t, 3)),
                              ("packed_attrs", packed_attrs, (torch.float32,), (num_v, None))])
    _check(name, device, [("face_material", face_material, _INDEX, (num_t,)),
                          ("tri_mask", tri_mask, (torch.bool,), (num_t,))])
    return _bin_cuda(name, dict(clip=verts_clip, tris=tris), num_t=num_t, device=device, attrs=packed_attrs,
                     channels=None, face_material=face_material, tri_mask=tri_mask, cull_backface=cull_backface,
                     width=width, height=height, rows=rows, y_offset=y_offset, tile_h=tile_h, tile_w=tile_w,
                     max_span=max_span, pairs_cap=pairs_cap, chunk=chunk, big_cap=big_cap, big2_span=big2_span,
                     big2_cap=big2_cap, bbox_margin_px=bbox_margin_px)


def bin_triangles_cuda(
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
    """:func:`bin_triangles_plain` by the kernels of ``csrc/raster_bin.cu``,
    on the screen setup as given (its ``xy``, ``z``, ``area``, ``valid``).
    Raises ``ValueError`` on what they do not take (see :func:`_check`)."""
    name = "bin_triangles_cuda"
    num_t, device = st.xy.shape[0], st.xy.device
    _check(name, device, [("st.xy", st.xy, (torch.float32,), (num_t, 3, 2)),
                          ("st.z", st.z, (torch.float32,), (num_t, 3)),
                          ("st.inv_w", st.inv_w, (torch.float32,), (num_t, 3)),
                          ("st.area", st.area, (torch.float32,), (num_t,)),
                          ("st.valid", st.valid, (torch.bool,), (num_t,)),
                          ("corner_channels", corner_channels, (torch.float32,), (num_t, 3, None)),
                          ("face_material", face_material, _INDEX, (num_t,))])
    geometry = dict(xy=st.xy, z=st.z, inv_w=st.inv_w, area=st.area, valid=st.valid)
    return _bin_cuda(name, geometry, num_t=num_t, device=device, attrs=None, channels=corner_channels,
                     face_material=face_material, tri_mask=None, cull_backface=True, width=width, height=height,
                     rows=rows, y_offset=y_offset, tile_h=tile_h, tile_w=tile_w, max_span=max_span,
                     pairs_cap=pairs_cap, chunk=chunk, big_cap=big_cap, big2_span=big2_span, big2_cap=big2_cap,
                     bbox_margin_px=bbox_margin_px)


profiling.counters_as_attributes(__name__, COUNTERS)
