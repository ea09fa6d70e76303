"""Fused raster + shade of binned triangles, row-layout contract — the
counterpart of ``physically_based_renderer_tpu/ops/raster_row.py``
(``rasterize_binned_shade_row``, shade mode, ``ibl=False``).

``rasterize_binned_shade_row`` is the wrapper: triangle setup, the
``[attrs·1/w, 1/w]`` corner channels, binning, and the material-code
encode/decode. The fused per-tile step has two implementations of one
function:

  * ``raster_shade_tiles_cuda`` launches the hand-written Hopper kernel
    ``csrc/raster_shade_row.cu`` (CUDA tensors only; it raises on anything
    else, and never falls back);
  * ``raster_shade_tiles_plain`` is the plain PyTorch version, vectorised
    over chunks of (tile, pair) work items. The CPU path runs it, and the
    chip check holds the kernel against it.

``raster_shade_tiles`` picks by the tensors' device: CPU tensors take the
plain version, CUDA tensors the kernel.

Depth semantics (both versions, and the TPU kernel): the key is
``bits(z) & ~0x7F``; the minimum quantized depth wins and a tie goes to the
first pair in processing order — the jumbo run ``[0, starts[0])``, then the
tile's own run in ascending triangle id (draw order).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..utils.cuda_build import load_library
from .raster import setup_corners
from .raster_bin import FIELD_MATERIAL, GBUF_FIELD0, RASTER_FIELDS, BinnedTris, bin_triangles
from .shade_core import pack_shading_uniforms, shade_core

CHUNK = 128  # the JAX binning's chunk padding, kept so pair arrays match
NUM_CH = 7  # interpolated channels: pos_w(3), normal_w(3), 1/w
QMASK = ~0x7F
_NO_HIT = torch.iinfo(torch.int64).max
_PLAIN_BLOCK_ELEMS = 1 << 22  # (item, pixel) elements per step of the plain version

# Launches of the CUDA kernel since import (or since a caller reset it).
KERNEL_LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class ShadeRowResult:
    rgba: torch.Tensor  # (rows, W, 4) f32 shaded foreground, 0 at background
    tri_id: torch.Tensor  # (rows, W) int32, −1 at background
    mat_id: torch.Tensor  # (rows, W) int32
    gbuf: torch.Tensor | None  # (rows, W, 6) f32 attributes (want_gbuf)
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
    lib.raster_shade_row_launch.argtypes = [vp] * 8 + [i] * 15 + [vp]
    lib.raster_shade_row_launch.restype = i
    lib.raster_shade_row_error_string.argtypes = [i]
    lib.raster_shade_row_error_string.restype = ctypes.c_char_p
    return lib


def _tile_grid(width: int, rows: int, tile_h: int, tile_w: int):
    tiles_x = -(-width // tile_w)
    tiles_y = -(-rows // tile_h)
    return tiles_x, tiles_y


def raster_shade_tiles(starts, packed, pair_tri, mat_table, uni, **kw):
    """The fused per-tile raster+shade → (code (rows,W) i32, rgba
    (rows,W,4) f32, gbuf (rows,W,7) f32 or None). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
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
):
    """Launch ``csrc/raster_shade_row.cu`` on the current stream."""
    global KERNEL_LAUNCHES
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
    if uni.shape[0] < 8 + 10 * num_lights:
        raise ValueError("uniform row shorter than the light counts need")
    if tile_h * tile_w > 2048:
        raise ValueError("raster_shade_tiles_cuda: tiles hold at most 2048 pixels")

    code = torch.empty((rows, width), dtype=torch.int32, device=device)
    rgba = torch.empty((rows, width, 4), dtype=torch.float32, device=device)
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
        num_dir, num_point, num_spot, int(apply_tonemap),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        msg = lib.raster_shade_row_error_string(err).decode()
        raise RuntimeError(f"raster_shade_row kernel launch failed: CUDA error {err} ({msg})")
    KERNEL_LAUNCHES += 1
    return code, rgba, gbuf


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
):
    """Plain PyTorch version of the kernel, on any device.

    Work items are (tile, pair): every tile takes the jumbo run, then its
    own run. For each chunk of items the (item, tile-pixel) edge, depth and
    ``ok`` tensors are formed, and an int64 key ``(zq << 32) | pair`` —
    the pair index is the processing order — is min-reduced per pixel with
    ``scatter_reduce_(amin)``. The winner's record is then read by index."""
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
        zq = z.contiguous().view(torch.int32) & QMASK
        key = torch.where(ok, (zq.to(torch.int64) << 32) | q[:, None], _NO_HIT)
        best.scatter_reduce_(0, (t[:, None] * npix + pix).reshape(-1), key.reshape(-1), "amin")

    # Epilogue over the hit pixels: winner record by index, interpolation,
    # material fetch, shading.
    hit_idx = torch.nonzero(best != _NO_HIT).squeeze(1)
    bp = (best[hit_idx] & 0xFFFFFFFF).long()
    rec = packed[bp]
    px, py = centres(hit_idx // npix, hit_idx % npix)
    dxp = px - rec[:, 9]
    dyp = py - rec[:, 10]
    g0 = GBUF_FIELD0
    planes = (
        rec[:, g0 : g0 + NUM_CH] * dxp[:, None]
        + rec[:, g0 + NUM_CH : g0 + 2 * NUM_CH] * dyp[:, None]
        + rec[:, g0 + 2 * NUM_CH : g0 + 3 * NUM_CH]
    )
    invw = planes[:, NUM_CH - 1 : NUM_CH]
    attrs = planes[:, : NUM_CH - 1] / torch.where(invw.abs() > 1e-20, invw, 1.0)

    tid = pair_tri[bp]
    matf = rec[:, FIELD_MATERIAL].detach().to(torch.int32)
    if mat_stride > 1:
        code_h = tid * mat_stride + matf
        mid = code_h % mat_stride
    else:
        code_h = tid
        mid = matf
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
    )

    def to_image(values, fill, dtype):
        """Scatter per-hit values into tile-major pixels, then image layout."""
        flat = torch.full((ntiles * npix, *values.shape[1:]), fill, dtype=dtype, device=device)
        flat = flat.index_put((hit_idx,), values.to(dtype))
        img = flat.reshape(tiles_y, tiles_x, tile_h, tile_w, *values.shape[1:])
        img = img.transpose(1, 2).reshape(tiles_y * tile_h, tiles_x * tile_w, *values.shape[1:])
        return img[:rows, :width].contiguous()

    code = to_image(code_h, -1, torch.int32)
    rgba = to_image(torch.stack(shaded, dim=-1), 0.0, torch.float32)
    gbuf = None
    if want_gbuf:
        depth = rec[:, 11] * dxp + rec[:, 12] * dyp + rec[:, 13]
        gbuf = to_image(torch.cat([attrs, depth[:, None]], dim=-1), 0.0, torch.float32)
    return code, rgba, gbuf


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
    """Triangle setup, the ``[attrs·1/w, 1/w]`` corner channels and binning:
    everything the fused step reads."""
    if packed_attrs.shape[-1] != NUM_CH - 1:
        raise ValueError("the shade kernel interpolates [pos_w, normal_w]: 6 attrs per corner")
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
) -> ShadeRowResult:
    """Fused raster + interpolate + shade (+ tonemap) of the row band
    [y_offset, y_offset+rows) of a width×height viewport."""
    if rows is None:
        rows = height
    if num_materials <= 0:
        raise ValueError("num_materials must be positive")
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
    uni = pack_shading_uniforms(
        light_strength, light_direction, light_position, light_spot_power, ambient, eye
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
