"""Fused raster + shade, and raster + G-buffer, of binned triangles in the
row-layout contract — the counterpart of
``physically_based_renderer_tpu/ops/raster_row.py``: ``rasterize_binned_shade_row``
(shade mode, with and without IBL) and ``rasterize_binned_gbuffer_row`` (the
G-buffer mode, any attribute width C, optional ``z_floor`` peel).

The wrappers do the triangle setup, the ``[attrs·1/w, 1/w]`` corner channels,
binning, and the material-code encode/decode. The per-tile step has two
implementations of one function in each mode:

  * ``raster_shade_tiles_cuda`` / ``raster_gbuffer_tiles_cuda`` launch the
    hand-written Hopper kernels of ``csrc/raster_shade_row.cu`` (CUDA
    tensors only; they raise on anything else, and never fall back);
  * ``raster_shade_tiles_plain`` / ``raster_gbuffer_tiles_plain`` are the
    plain PyTorch versions, vectorised over chunks of (tile, pair) work
    items. The CPU path runs them, and the chip check holds the kernels
    against them.

``raster_shade_tiles`` and ``raster_gbuffer_tiles`` pick by the tensors'
device: CPU tensors take the plain version, CUDA tensors the kernel.

The IBL mode (``sh9`` given, ``ibl=True``) shades with ``shade_core``'s IBL
tail and writes its 11 HDR channels instead of RGBA, zeros at background.
The G-buffer mode shades nothing: per pixel it writes the C interpolated
attributes and the NDC depth plane, zeros at background.

Depth semantics (both versions, and the TPU kernel): the key is
``bits(z) & ~0x7F``; the minimum quantized depth wins and a tie goes to the
first pair in processing order — the jumbo run ``[0, starts[0])``, then the
tile's own run in ascending triangle id (draw order). With ``z_floor`` a
candidate must lie strictly behind the floor, ``z > z_floor``, before its key
is formed (a depth peel).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..utils.cuda_build import load_library
from .raster import setup_corners
from .raster_bin import FIELD_MATERIAL, GBUF_FIELD0, RASTER_FIELDS, BinnedTris, bin_triangles
from .shade_core import num_output_channels, pack_shading_uniforms, shade_core, uniform_count

CHUNK = 128  # the JAX binning's chunk padding, kept so pair arrays match
NUM_CH = 7  # interpolated channels of the shade mode: pos_w(3), normal_w(3), 1/w
GBUF_NUM_CH = (7, 15)  # the G-buffer mode's channel counts: C = 6 (untextured), 14 (textured), + 1/w
QMASK = ~0x7F
_NO_HIT = torch.iinfo(torch.int64).max
_PLAIN_BLOCK_ELEMS = 1 << 22  # (item, pixel) elements per step of the plain version

# Launches of the CUDA kernel since import (or since a caller reset them):
# its shade mode, its IBL mode, and its G-buffer mode under the row binning
# (kernel 2) and under the v1 binning (kernel 4, ``raster_pallas.
# rasterize_binned_gbuffer``).
KERNEL_LAUNCHES = 0
IBL_KERNEL_LAUNCHES = 0
GBUF_KERNEL_LAUNCHES = 0
GBUF_V1_KERNEL_LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class ShadeRowResult:
    rgba: torch.Tensor  # (rows, W, 4) f32 shaded foreground (the IBL mode's 11 channels), 0 at background
    tri_id: torch.Tensor  # (rows, W) int32, −1 at background
    mat_id: torch.Tensor  # (rows, W) int32
    gbuf: torch.Tensor | None  # (rows, W, 6) f32 attributes (want_gbuf)
    overflowed: torch.Tensor  # () bool: the pair cap dropped triangles
    num_pairs: torch.Tensor  # () int: (tile, triangle) pairs emitted


@dataclasses.dataclass(frozen=True)
class GBufferRowResult:
    attrs: torch.Tensor  # (rows, W, C) f32 perspective-correct attributes, 0 at background
    depth: torch.Tensor  # (rows, W) f32 NDC depth plane, 0 at background
    tri_id: torch.Tensor  # (rows, W) int32, −1 at background
    mat_id: torch.Tensor | None  # (rows, W) int32 (None without face_material)
    overflowed: torch.Tensor  # () bool: the pair cap dropped triangles
    num_pairs: torch.Tensor  # () int: (tile, triangle) pairs emitted


def material_stride(num_materials: int, num_tris: int) -> int:
    """Stride of the tri/material code ``tid·stride + mat``: the next power of
    two ≥ M (at least 2), or 1 — encoding off — when ``T·stride ≥ 2³¹``."""
    stride = 1 << max(1, (num_materials - 1).bit_length())
    return stride if num_tris * stride < (1 << 31) else 1


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/raster_shade_row.cu``."""
    lib = load_library("raster_shade_row")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.raster_shade_row_launch.argtypes = [vp] * 8 + [i] * 16 + [vp]
    lib.raster_shade_row_launch.restype = i
    lib.raster_gbuffer_row_launch.argtypes = [vp] * 6 + [i] * 10 + [vp]
    lib.raster_gbuffer_row_launch.restype = i
    lib.raster_shade_row_error_string.argtypes = [i]
    lib.raster_shade_row_error_string.restype = ctypes.c_char_p
    return lib


def _tile_grid(width: int, rows: int, tile_h: int, tile_w: int):
    tiles_x = -(-width // tile_w)
    tiles_y = -(-rows // tile_h)
    return tiles_x, tiles_y


def raster_shade_tiles(starts, packed, pair_tri, mat_table, uni, **kw):
    """The fused per-tile raster+shade → (code (rows,W) i32, rgba
    (rows,W,4) f32 or the IBL mode's (rows,W,11), gbuf (rows,W,7) f32 or
    None). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if packed.device.type == "cpu":
        return raster_shade_tiles_plain(starts, packed, pair_tri, mat_table, uni, **kw)
    return raster_shade_tiles_cuda(starts, packed, pair_tri, mat_table, uni, **kw)


def raster_shade_tiles_cuda(
    starts: torch.Tensor,
    packed: torch.Tensor,
    pair_tri: torch.Tensor,
    mat_table: torch.Tensor,
    uni: torch.Tensor,
    *,
    width: int,
    rows: int,
    y_offset: int,
    tile_h: int,
    tile_w: int,
    mat_stride: int,
    num_dir: int,
    num_point: int,
    num_spot: int,
    apply_tonemap: bool,
    want_gbuf: bool,
    ibl: bool = False,
):
    """Launch ``csrc/raster_shade_row.cu`` on the current stream. The IBL
    mode writes its channels as planes, (11, rows, W); the result is the
    (rows, W, 11) view of them."""
    global KERNEL_LAUNCHES, IBL_KERNEL_LAUNCHES
    device = packed.device
    if device.type != "cuda":
        raise ValueError(f"raster_shade_tiles_cuda needs CUDA tensors, got {device}")
    tiles_x, tiles_y = _tile_grid(width, rows, tile_h, tile_w)
    ntiles = tiles_x * tiles_y
    uni = uni.reshape(-1)
    num_lights = num_dir + num_point + num_spot
    checks = (
        (starts, torch.int32, (ntiles + 1,)),
        (packed, torch.float32, None),
        (pair_tri, torch.int32, (packed.shape[0],)),
        (mat_table, torch.float32, (mat_table.shape[0], 9)),
        (uni, torch.float32, None),
    )
    for t, dtype, shape in checks:
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"raster_shade_tiles_cuda: expected contiguous {dtype} on {device}, "
                f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"raster_shade_tiles_cuda: shape {tuple(t.shape)} != {shape}")
    if packed.ndim != 2 or packed.shape[1] < GBUF_FIELD0 + 3 * NUM_CH:
        raise ValueError(f"packed must be (PAIRS, ≥{GBUF_FIELD0 + 3 * NUM_CH}), got {tuple(packed.shape)}")
    if uni.shape[0] < uniform_count(num_lights, ibl):
        raise ValueError("uniform row shorter than the light counts (and the SH9 slots) need")
    if tile_h * tile_w > 2048:
        raise ValueError("raster_shade_tiles_cuda: tiles hold at most 2048 pixels")

    code = torch.empty((rows, width), dtype=torch.int32, device=device)
    c_out = num_output_channels(ibl)
    out_shape = (c_out, rows, width) if ibl else (rows, width, c_out)
    rgba = torch.empty(out_shape, dtype=torch.float32, device=device)
    gbuf = (
        torch.empty((rows, width, NUM_CH), dtype=torch.float32, device=device)
        if want_gbuf
        else None
    )
    lib = kernel_library()
    err = lib.raster_shade_row_launch(
        starts.data_ptr(), packed.data_ptr(), pair_tri.data_ptr(),
        mat_table.data_ptr(), uni.data_ptr(), code.data_ptr(), rgba.data_ptr(),
        gbuf.data_ptr() if gbuf is not None else None,
        packed.shape[1], mat_table.shape[0], uni.shape[0], width, rows,
        int(y_offset), tile_h, tile_w, tiles_x, ntiles, mat_stride,
        num_dir, num_point, num_spot, int(apply_tonemap), int(ibl),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        msg = lib.raster_shade_row_error_string(err).decode()
        raise RuntimeError(f"raster_shade_row kernel launch failed: CUDA error {err} ({msg})")
    if ibl:
        IBL_KERNEL_LAUNCHES += 1
        return code, rgba.permute(1, 2, 0), gbuf
    KERNEL_LAUNCHES += 1
    return code, rgba, gbuf


def raster_gbuffer_tiles(starts, packed, pair_tri, **kw):
    """The per-tile raster + G-buffer → (code (rows,W) i32, gbuf
    (rows,W,num_ch) f32). CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if packed.device.type == "cpu":
        return raster_gbuffer_tiles_plain(starts, packed, pair_tri, **kw)
    return raster_gbuffer_tiles_cuda(starts, packed, pair_tri, **kw)


def raster_gbuffer_tiles_cuda(
    starts: torch.Tensor,
    packed: torch.Tensor,
    pair_tri: torch.Tensor,
    *,
    width: int,
    rows: int,
    y_offset: int,
    tile_h: int,
    tile_w: int,
    mat_stride: int,
    num_ch: int,
    z_floor: torch.Tensor | None = None,
    v1: bool = False,
):
    """Launch the G-buffer mode of ``csrc/raster_shade_row.cu`` on the
    current stream (``num_ch`` 7 or 15: C = 6 or 14 attributes + 1/w).
    ``v1``: the pairs come from the v1 binning (kernel 4's launch count)."""
    global GBUF_KERNEL_LAUNCHES, GBUF_V1_KERNEL_LAUNCHES
    device = packed.device
    if device.type != "cuda":
        raise ValueError(f"raster_gbuffer_tiles_cuda needs CUDA tensors, got {device}")
    if num_ch not in GBUF_NUM_CH:
        raise ValueError(f"the G-buffer kernel is built for {GBUF_NUM_CH} channels, not {num_ch}")
    tiles_x, tiles_y = _tile_grid(width, rows, tile_h, tile_w)
    ntiles = tiles_x * tiles_y
    checks = [
        (starts, torch.int32, (ntiles + 1,)),
        (packed, torch.float32, None),
        (pair_tri, torch.int32, (packed.shape[0],)),
    ]
    if z_floor is not None:
        checks.append((z_floor, torch.float32, (rows, width)))
    for t, dtype, shape in checks:
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"raster_gbuffer_tiles_cuda: expected contiguous {dtype} on {device}, "
                f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"raster_gbuffer_tiles_cuda: shape {tuple(t.shape)} != {shape}")
    if packed.ndim != 2 or packed.shape[1] < GBUF_FIELD0 + 3 * num_ch:
        raise ValueError(f"packed must be (PAIRS, ≥{GBUF_FIELD0 + 3 * num_ch}), got {tuple(packed.shape)}")
    if tile_h * tile_w > 2048:
        raise ValueError("raster_gbuffer_tiles_cuda: tiles hold at most 2048 pixels")

    code = torch.empty((rows, width), dtype=torch.int32, device=device)
    gbuf = torch.empty((rows, width, num_ch), dtype=torch.float32, device=device)
    lib = kernel_library()
    err = lib.raster_gbuffer_row_launch(
        starts.data_ptr(), packed.data_ptr(), pair_tri.data_ptr(),
        None if z_floor is None else z_floor.data_ptr(), code.data_ptr(), gbuf.data_ptr(),
        packed.shape[1], num_ch, width, rows, int(y_offset), tile_h, tile_w, tiles_x, ntiles,
        mat_stride, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        msg = lib.raster_shade_row_error_string(err).decode()
        raise RuntimeError(f"raster_gbuffer_row kernel launch failed: CUDA error {err} ({msg})")
    if v1:
        GBUF_V1_KERNEL_LAUNCHES += 1
    else:
        GBUF_KERNEL_LAUNCHES += 1
    return code, gbuf


def raster_shade_tiles_plain(
    starts: torch.Tensor,
    packed: torch.Tensor,
    pair_tri: torch.Tensor,
    mat_table: torch.Tensor,
    uni: torch.Tensor,
    *,
    width: int,
    rows: int,
    y_offset: int,
    tile_h: int,
    tile_w: int,
    mat_stride: int,
    num_dir: int,
    num_point: int,
    num_spot: int,
    apply_tonemap: bool,
    want_gbuf: bool,
    ibl: bool = False,
):
    """Plain PyTorch version of the kernel's shade mode, on any device: the
    depth resolve of :func:`_resolve_plain`, then over the hit pixels the
    winner's planes, the material fetch and ``shade_core``."""
    res = _resolve_plain(starts, packed, pair_tri, width=width, rows=rows, y_offset=y_offset,
                         tile_h=tile_h, tile_w=tile_w)
    attrs = _winner_attrs(res, NUM_CH)
    code_h, mid = _winner_codes(res, pair_tri, mat_stride)
    in_table = (mid >= 0) & (mid < mat_table.shape[0])
    props = mat_table[mid.clamp(0, mat_table.shape[0] - 1).long()] * in_table[:, None]
    shaded = shade_core(
        tuple(attrs[:, c] for c in range(3)),
        tuple(attrs[:, c] for c in range(3, 6)),
        tuple(props[:, c] for c in range(9)),
        uni.reshape(1, -1),
        num_dir=num_dir,
        num_point=num_point,
        num_spot=num_spot,
        apply_tonemap=apply_tonemap,
        ibl=ibl,
    )
    code = res.to_image(code_h, -1, torch.int32)
    rgba = res.to_image(torch.stack(shaded, dim=-1), 0.0, torch.float32)
    gbuf = None
    if want_gbuf:
        gbuf = res.to_image(torch.cat([attrs, _winner_depth(res)[:, None]], dim=-1), 0.0, torch.float32)
    return code, rgba, gbuf


def raster_gbuffer_tiles_plain(
    starts: torch.Tensor,
    packed: torch.Tensor,
    pair_tri: torch.Tensor,
    *,
    width: int,
    rows: int,
    y_offset: int,
    tile_h: int,
    tile_w: int,
    mat_stride: int,
    num_ch: int,
    z_floor: torch.Tensor | None = None,
    v1: bool = False,
):
    """Plain PyTorch version of the kernel's G-buffer mode, on any device →
    (code (rows,W) i32, gbuf (rows,W,num_ch) f32: the num_ch − 1
    attributes, then the NDC depth plane; zeros at background). ``v1``
    changes nothing here (the binning is the caller's)."""
    res = _resolve_plain(starts, packed, pair_tri, width=width, rows=rows, y_offset=y_offset,
                         tile_h=tile_h, tile_w=tile_w, z_floor=z_floor)
    code_h, _ = _winner_codes(res, pair_tri, mat_stride)
    gb = torch.cat([_winner_attrs(res, num_ch), _winner_depth(res)[:, None]], dim=-1)
    return res.to_image(code_h, -1, torch.int32), res.to_image(gb, 0.0, torch.float32)


@dataclasses.dataclass(frozen=True)
class _Resolved:
    """The plain version's depth resolve: per hit pixel (tile-major index
    ``hit_idx``) its winning pair's record ``rec`` and index ``pair``, and
    the pixel centre's offset (dxp, dyp) from the record's corner 0."""

    hit_idx: torch.Tensor
    pair: torch.Tensor
    rec: torch.Tensor
    dxp: torch.Tensor
    dyp: torch.Tensor
    shape: tuple  # (tiles_y, tiles_x, tile_h, tile_w, rows, width)

    def to_image(self, values, fill, dtype):
        """Scatter per-hit values into tile-major pixels, then image layout."""
        tiles_y, tiles_x, tile_h, tile_w, rows, width = self.shape
        flat = torch.full((tiles_y * tiles_x * tile_h * tile_w, *values.shape[1:]), fill,
                          dtype=dtype, device=values.device)
        flat = flat.index_put((self.hit_idx,), values.to(dtype))
        img = flat.reshape(tiles_y, tiles_x, tile_h, tile_w, *values.shape[1:])
        img = img.transpose(1, 2).reshape(tiles_y * tile_h, tiles_x * tile_w, *values.shape[1:])
        return img[:rows, :width].contiguous()


def _resolve_plain(starts, packed, pair_tri, *, width, rows, y_offset, tile_h, tile_w, z_floor=None):
    """The depth resolve both modes share. Work items are (tile, pair): every
    tile takes the jumbo run, then its own run. For each chunk of items the
    (item, tile-pixel) edge, depth and ``ok`` tensors are formed, and an
    int64 key ``(zq << 32) | pair`` — the pair index is the processing
    order — is min-reduced per pixel with ``scatter_reduce_(amin)``. The
    winner's record is then read by index. ``z_floor`` (rows, W) is padded
    with −inf to whole tiles, as the JAX wrapper pads it."""
    device = packed.device
    tiles_x, tiles_y = _tile_grid(width, rows, tile_h, tile_w)
    ntiles = tiles_x * tiles_y
    npix = tile_h * tile_w
    st = starts.long()
    g_end = int(st[0])
    tiles = torch.arange(ntiles, device=device)
    own_tile = torch.repeat_interleave(tiles, st[1:] - st[:-1])
    own_pair = torch.arange(g_end, g_end + own_tile.shape[0], device=device)
    item_tile = torch.cat([tiles.repeat_interleave(g_end), own_tile])
    item_pair = torch.cat([torch.arange(g_end, device=device).repeat(ntiles), own_pair])

    pix = torch.arange(npix, device=device)
    zf = None
    if z_floor is not None:
        zf = torch.nn.functional.pad(
            z_floor.detach().to(torch.float32),
            (0, tiles_x * tile_w - width, 0, tiles_y * tile_h - rows), value=-float("inf"),
        )
        zf = zf.reshape(tiles_y, tile_h, tiles_x, tile_w).transpose(1, 2).reshape(-1)

    def centres(tile, p):  # pixel centres, formed exactly as the kernel forms them
        ty, tx = tile // tiles_x, tile % tiles_x
        x_base = (tx * tile_w).to(torch.float32)
        y_base = (ty * tile_h + y_offset).to(torch.float32)
        return (x_base + (p % tile_w).to(torch.float32)) + 0.5, (
            y_base + (p // tile_w).to(torch.float32)
        ) + 0.5

    fields = packed[:, :RASTER_FIELDS].detach()
    best = torch.full((ntiles * npix,), _NO_HIT, dtype=torch.int64, device=device)
    step = max(1, _PLAIN_BLOCK_ELEMS // npix)
    for s in range(0, item_tile.shape[0], step):
        t = item_tile[s : s + step]
        q = item_pair[s : s + step]
        f = fields[q]
        px, py = centres(t[:, None], pix)
        dx = px - f[:, 9:10]
        dy = py - f[:, 10:11]
        e0 = dx * f[:, 0:1] + dy * f[:, 3:4] + f[:, 6:7]
        e1 = dx * f[:, 1:2] + dy * f[:, 4:5] + f[:, 7:8]
        e2 = dx * f[:, 2:3] + dy * f[:, 5:6] + f[:, 8:9]
        z = dx * f[:, 11:12] + dy * f[:, 12:13] + f[:, 13:14]
        ok = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (z >= 0.0) & (z <= 1.0)
        ok &= (pair_tri[q] >= 0)[:, None]
        slots = t[:, None] * npix + pix
        if zf is not None:
            ok &= z > zf[slots]  # depth peeling: strictly behind the floor
        zq = z.contiguous().view(torch.int32) & QMASK
        key = torch.where(ok, (zq.to(torch.int64) << 32) | q[:, None], _NO_HIT)
        best.scatter_reduce_(0, slots.reshape(-1), key.reshape(-1), "amin")

    hit_idx = torch.nonzero(best != _NO_HIT).squeeze(1)
    bp = (best[hit_idx] & 0xFFFFFFFF).long()
    rec = packed[bp]
    px, py = centres(hit_idx // npix, hit_idx % npix)
    return _Resolved(hit_idx=hit_idx, pair=bp, rec=rec, dxp=px - rec[:, 9], dyp=py - rec[:, 10],
                     shape=(tiles_y, tiles_x, tile_h, tile_w, rows, width))


def _winner_attrs(res: _Resolved, num_ch: int) -> torch.Tensor:
    """The winners' num_ch interpolation planes [attr·1/w …, 1/w] at the
    pixel centres → the num_ch − 1 perspective-correct attributes."""
    rec, g0 = res.rec, GBUF_FIELD0
    planes = (
        rec[:, g0 : g0 + num_ch] * res.dxp[:, None]
        + rec[:, g0 + num_ch : g0 + 2 * num_ch] * res.dyp[:, None]
        + rec[:, g0 + 2 * num_ch : g0 + 3 * num_ch]
    )
    invw = planes[:, num_ch - 1 : num_ch]
    return planes[:, : num_ch - 1] / torch.where(invw.abs() > 1e-20, invw, 1.0)


def _winner_depth(res: _Resolved) -> torch.Tensor:
    """The winners' NDC depth plane at the pixel centres."""
    return res.rec[:, 11] * res.dxp + res.rec[:, 12] * res.dyp + res.rec[:, 13]


def _winner_codes(res: _Resolved, pair_tri: torch.Tensor, mat_stride: int):
    """The winners' tri/material codes and material ids."""
    tid = pair_tri[res.pair]
    matf = res.rec[:, FIELD_MATERIAL].detach().to(torch.int32)
    if mat_stride > 1:
        code = tid * mat_stride + matf
        return code, code % mat_stride
    return tid, matf


def bin_for_shade(
    verts_clip: torch.Tensor,
    packed_attrs: torch.Tensor,
    face_material: torch.Tensor,
    *,
    width: int,
    height: int,
    rows: int,
    y_offset: int,
    tile_h: int,
    tile_w: int,
    max_span: int,
    pairs_cap: int | None,
    big_cap: int | None,
    big2_span: int,
    big2_cap: int | None,
    cull_backface: bool,
) -> BinnedTris:
    """Triangle setup, the ``[attrs·1/w, 1/w]`` corner channels (C + 1 of
    them for (T, 3, C) ``packed_attrs``) and binning: everything the per-tile
    step reads, in either mode."""
    st = setup_corners(verts_clip, width, height, cull_backface, None)
    corner_channels = torch.cat(
        [packed_attrs * st.inv_w[..., None], st.inv_w[..., None]], dim=-1
    )
    return bin_triangles(
        st,
        width=width,
        height=height,
        rows=rows,
        y_offset=y_offset,
        tile_h=tile_h,
        tile_w=tile_w,
        max_span=max_span,
        pairs_cap=pairs_cap,
        big_cap=big_cap,
        big2_span=big2_span,
        big2_cap=big2_cap,
        chunk=CHUNK,
        face_material=face_material,
        corner_channels=corner_channels,
    )


def decode_codes(code: torch.Tensor, mat_stride: int, face_material: torch.Tensor):
    """tri/material code → (tri_id, mat_id); background is tri −1, mat 0
    (mat ``face_material[0]`` when encoding is off, as in the JAX package)."""
    if mat_stride > 1:
        bg = code < 0
        return torch.where(bg, -1, code // mat_stride), torch.where(bg, 0, code % mat_stride)
    return code, face_material[code.clamp(min=0).long()].to(torch.int32)


def rasterize_binned_shade_row(
    verts_clip: torch.Tensor,  # (T, 3, 4) corner-major clip coords
    packed_attrs: torch.Tensor,  # (T, 3, 6) [pos_w, normal_w] corner attrs
    face_material: torch.Tensor,  # (T,) int
    mat_props: torch.Tensor,  # (M, ≥9)
    light_strength: torch.Tensor,
    light_direction: torch.Tensor,
    light_position: torch.Tensor,
    light_spot_power: torch.Tensor,
    ambient: torch.Tensor,
    eye: torch.Tensor,
    sh9: torch.Tensor | None = None,  # (9, 3): the IBL mode
    **kw,
) -> ShadeRowResult:
    """Fused raster + interpolate + shade (+ tonemap) of the row band
    [y_offset, y_offset+rows) of a width×height viewport; the keywords are
    :func:`shade_row_packed`'s. With ``sh9`` the IBL mode: the 11 HDR
    channels, no tonemap."""
    uni = pack_shading_uniforms(
        light_strength, light_direction, light_position, light_spot_power, ambient, eye, sh9
    )
    return shade_row_packed(verts_clip, packed_attrs, face_material, mat_props, uni,
                            ibl=sh9 is not None, **kw)


def shade_row_packed(
    verts_clip: torch.Tensor,  # (T, 3, 4) corner-major clip coords
    packed_attrs: torch.Tensor,  # (T, 3, 6) [pos_w, normal_w] corner attrs
    face_material: torch.Tensor,  # (T,) int
    mat_props: torch.Tensor,  # (M, ≥9)
    uni: torch.Tensor,  # (1, U) pack_shading_uniforms row
    *,
    width: int,
    height: int,
    rows: int | None = None,
    y_offset: int = 0,
    tile_h: int = 4,
    tile_w: int = 128,
    max_span: int = 16,
    pairs_cap: int | None = None,
    big_cap: int | None = None,
    big2_span: int = 0,
    big2_cap: int | None = None,
    cull_backface: bool = True,
    num_materials: int = 0,
    num_dir: int = 0,
    num_point: int = 0,
    num_spot: int = 0,
    apply_tonemap: bool = True,
    want_gbuf: bool = False,
    ibl: bool = False,
) -> ShadeRowResult:
    """:func:`rasterize_binned_shade_row` with the shading uniforms already
    packed: the forward that ``ops/raster_pallas.raster_shade`` runs, with
    ``want_gbuf=True`` for the backward's residual attributes. ``ibl``
    selects the IBL mode (``uni`` then carries the SH9 slots; its channels
    are HDR whatever ``apply_tonemap`` says)."""
    if rows is None:
        rows = height
    if num_materials <= 0:
        raise ValueError("num_materials must be positive")
    if packed_attrs.shape[-1] != NUM_CH - 1:
        raise ValueError("the shade mode interpolates [pos_w, normal_w]: 6 attrs per corner")
    mat_stride = material_stride(num_materials, verts_clip.shape[0])
    binned = bin_for_shade(
        verts_clip,
        packed_attrs,
        face_material,
        width=width,
        height=height,
        rows=rows,
        y_offset=y_offset,
        tile_h=tile_h,
        tile_w=tile_w,
        max_span=max_span,
        pairs_cap=pairs_cap,
        big_cap=big_cap,
        big2_span=big2_span,
        big2_cap=big2_cap,
        cull_backface=cull_backface,
    )
    code, rgba, gbuf = raster_shade_tiles(
        binned.starts,
        binned.packed,
        binned.pair_tri,
        mat_props[:, :9].contiguous(),
        uni,
        width=width,
        rows=rows,
        y_offset=y_offset,
        tile_h=tile_h,
        tile_w=tile_w,
        mat_stride=mat_stride,
        num_dir=num_dir,
        num_point=num_point,
        num_spot=num_spot,
        apply_tonemap=apply_tonemap,
        want_gbuf=want_gbuf,
        ibl=ibl,
    )
    tri_id, mat_id = decode_codes(code, mat_stride, face_material)
    return ShadeRowResult(
        rgba=rgba,
        tri_id=tri_id,
        mat_id=mat_id,
        gbuf=None if gbuf is None else gbuf[..., : NUM_CH - 1],
        overflowed=binned.overflowed,
        num_pairs=binned.num_pairs,
    )


def rasterize_binned_gbuffer_row(
    verts_clip: torch.Tensor,  # (T, 3, 4) corner-major clip coords
    packed_attrs: torch.Tensor,  # (T, 3, C) corner attrs, C = 6 or 14
    face_material: torch.Tensor | None = None,  # (T,) int
    *,
    width: int,
    height: int,
    rows: int | None = None,
    y_offset: int = 0,
    tile_h: int = 4,
    tile_w: int = 128,
    max_span: int = 16,
    pairs_cap: int | None = None,
    big_cap: int | None = None,
    big2_span: int = 0,
    big2_cap: int | None = None,
    cull_backface: bool = True,
    num_materials: int = 0,
    z_floor: torch.Tensor | None = None,  # (rows, W): keep only z > z_floor
) -> GBufferRowResult:
    """Fused raster + G-buffer of the row band [y_offset, y_offset+rows) of
    a width×height viewport: per pixel the winning triangle's C
    perspective-correct attributes and its NDC depth, zeros at background.
    With ``face_material`` (and ``num_materials``) the material ids come
    from the same code as the shade mode's (``tid·stride + mat``); without
    it ``mat_id`` is None. ``z_floor`` peels: only candidates strictly
    behind it are kept (−inf accepts everything). Not differentiable: see
    ``ops/raster_pallas.raster_gbuffer``."""
    return gbuffer_pass(verts_clip, packed_attrs, face_material, v1=False, width=width, height=height,
                        rows=rows, y_offset=y_offset, tile_h=tile_h, tile_w=tile_w, max_span=max_span,
                        pairs_cap=pairs_cap, big_cap=big_cap, big2_span=big2_span, big2_cap=big2_cap,
                        cull_backface=cull_backface, num_materials=num_materials, z_floor=z_floor)


def gbuffer_pass(verts_clip, packed_attrs, face_material, *, v1: bool, width: int, height: int,
                 rows: int | None, y_offset: int, tile_h: int, tile_w: int, max_span: int,
                 pairs_cap: int | None, big_cap: int | None, big2_span: int, big2_cap: int | None,
                 cull_backface: bool, num_materials: int, z_floor: torch.Tensor | None) -> GBufferRowResult:
    """Setup, binning, the G-buffer step and the code decode: the body of
    :func:`rasterize_binned_gbuffer_row` (kernel 2) and of
    ``raster_pallas.rasterize_binned_gbuffer`` (kernel 4, ``v1``), which
    differ only in their binning parameters."""
    if rows is None:
        rows = height
    mat_stride = 1
    if face_material is not None:
        if num_materials <= 0:
            raise ValueError("pass num_materials with face_material")
        mat_stride = material_stride(num_materials, verts_clip.shape[0])
    binned = bin_for_shade(
        verts_clip,
        packed_attrs,
        face_material,
        width=width,
        height=height,
        rows=rows,
        y_offset=y_offset,
        tile_h=tile_h,
        tile_w=tile_w,
        max_span=max_span,
        pairs_cap=pairs_cap,
        big_cap=big_cap,
        big2_span=big2_span,
        big2_cap=big2_cap,
        cull_backface=cull_backface,
    )
    num_ch = packed_attrs.shape[-1] + 1
    code, gb = raster_gbuffer_tiles(
        binned.starts,
        binned.packed,
        binned.pair_tri,
        width=width,
        rows=rows,
        y_offset=y_offset,
        tile_h=tile_h,
        tile_w=tile_w,
        mat_stride=mat_stride,
        num_ch=num_ch,
        z_floor=None if z_floor is None else z_floor.contiguous(),
        v1=v1,
    )
    if face_material is None:
        tri_id, mat_id = code, None
    else:
        tri_id, mat_id = decode_codes(code, mat_stride, face_material)
    return GBufferRowResult(
        attrs=gb[..., : num_ch - 1],
        depth=gb[..., num_ch - 1],
        tri_id=tri_id,
        mat_id=mat_id,
        overflowed=binned.overflowed,
        num_pairs=binned.num_pairs,
    )
