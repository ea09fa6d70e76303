"""The differentiable fused raster+shade path — the counterpart of
``raster_shade``, ``raster_shade_ibl`` and their backward in
``physically_based_renderer_tpu/ops/raster_pallas.py`` (the v1 binning by
default, kernel 7; ``row_layout=True``: the row binning, kernel 1) — the id
raster ``rasterize_binned`` (kernel 5, the depth peels of the render
modes), and the deferred pair: ``raster_gbuffer`` (raster + G-buffer, differentiable
through a recompute of the interpolation; in the v1 binning,
``rasterize_binned_gbuffer`` — kernel 4, the textured path of ``render`` —
or the row binning of the triangle-sharded ring, kernel 2) and
``shade_fused`` (shading of a resolved G-buffer band, ``shade_forward``
forward and ``shade_backward`` adjoint).

``raster_shade`` and ``raster_shade_ibl`` run one ``torch.autograd.Function``
(the IBL mode writes the 11 HDR channels of ``shade_core(ibl=True)`` and
its uniform row carries the 27 SH9 slots). Its forward is the fused
step (``ops/raster_row.shade_row_packed`` with ``want_gbuf=True``: the
CUDA kernel ``csrc/raster_shade_row.cu`` on CUDA tensors, in either
binning); it keeps the
triangle and material ids and the six interpolated attributes per pixel. Its
backward, in the JAX package's order:

  1. the output cotangent, masked to hit pixels with ``torch.where`` (the
     IBL mode's background reflect direction is 0, where the env gather's
     ``atan2`` backward is 0/0);
  2. ``shade_backward``, the adjoint of ``shade_core`` per pixel →
     ``g_uni`` summed over the band, and ``g_attrs (rows,W,6)`` only when
     geometry requires grad (``g_props`` is never asked for: the table
     below is all the step needs of it);
  3. the ``(M, 9)`` table cotangent, ``g_props`` summed by material id: the
     kernel sums it itself, in a fixed order; the plain version runs
     ``_scatter_props_by_id`` (the JAX package's step, XLA there);
  4. ``g_uni`` back to lights, ambient, eye (and SH9) by autograd through
     ``pack_shading_uniforms`` (the Function takes the packed row);
  5. only when geometry requires grad, a VJP through a recompute of
     ``ops/raster.interpolate_corners`` from ``g_attrs`` to the clip
     coordinates and corner attributes.

``shade_backward`` has two implementations of one function:

  * ``shade_backward_cuda`` launches the hand-written Hopper kernel
    ``csrc/shade_backward.cu`` (CUDA tensors only; it raises on anything
    else and never falls back);
  * ``shade_backward_plain`` is ``torch.autograd.grad`` over the port's
    ``shade_core`` on the hit pixels, the role ``jax.vjp`` plays inside the
    TPU kernel. CPU tensors run it, and the chip check holds the kernel
    against it.

``shade_forward`` likewise: ``shade_forward_cuda`` launches
``csrc/shade_forward.cu`` (``shade_core.cuh`` over a band), and
``shade_forward_plain`` is ``shade_core`` over the band in PyTorch.

CPU and CUDA tensors go through the same Functions; only the kernels inside
switch to their plain versions on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..utils.cuda_build import load_library
from .raster import interpolate_corners
from .raster_row import (
    GBufferRowResult,
    ShadeRowResult,
    bin_for_shade,
    decode_codes,
    gbuffer_pass,
    material_stride,
    raster_ids_tiles,
    rasterize_binned_gbuffer_row,
    shade_row_packed,
)
from .shade_core import (
    num_output_channels,
    pack_shading_uniforms,
    shade_core,
    uniform_count,
    unpack_uniform_grads,
)

# Launches of the backward kernel and of the G-buffer shading kernel (each
# in its shade mode and its IBL mode), and geometry-gradient recomputes,
# since import (or since a caller reset them).
SHADE_BWD_LAUNCHES = 0
SHADE_BWD_IBL_LAUNCHES = 0
SHADE_FWD_LAUNCHES = 0
SHADE_FWD_IBL_LAUNCHES = 0
GEOMETRY_RECOMPUTES = 0


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/shade_backward.cu``."""
    lib = load_library("shade_backward")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.shade_backward_launch.argtypes = [vp] * 10 + [i] * 11 + [vp]
    lib.shade_backward_launch.restype = i
    lib.shade_backward_blocks.argtypes = [i]
    lib.shade_backward_blocks.restype = i
    lib.shade_backward_error_string.argtypes = [i]
    lib.shade_backward_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def shade_forward_library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/shade_forward.cu``."""
    lib = load_library("shade_forward")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.shade_forward_launch.argtypes = [vp] * 6 + [i] * 9 + [vp]
    lib.shade_forward_launch.restype = i
    lib.shade_forward_error_string.argtypes = [i]
    lib.shade_forward_error_string.restype = ctypes.c_char_p
    return lib


def _band_inputs(name, attrs, mat_id, hit, mat_props, uni, num_lights, ibl):
    """Check a G-buffer band's shading inputs for the CUDA kernels → (table
    (M, 9), flat uniform row, mat_id, hit, the attributes' pixel stride).
    ``attrs`` may be the ``[..., :6]`` view of a (rows, W, S) buffer."""
    device = attrs.device
    rows, width = mat_id.shape
    table = mat_props[:, :9].contiguous()
    uni = uni.reshape(-1).contiguous()
    if uni.shape[0] < uniform_count(num_lights, ibl):
        raise ValueError("uniform row shorter than the light counts (and the SH9 slots) need")
    for t, dtype in ((attrs, torch.float32), (mat_id, torch.int32), (hit, torch.bool),
                     (table, torch.float32), (uni, torch.float32)):
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} on {device}, got {t.dtype} on {t.device}")
    if tuple(attrs.shape) != (rows, width, 6):
        raise ValueError(f"attrs shape {tuple(attrs.shape)} != {(rows, width, 6)}")
    stride = attrs.stride(1)
    if attrs.stride(2) != 1 or attrs.stride(0) != width * stride or stride < 6:
        raise ValueError(f"attrs must be rows of a (rows, W, S≥6) buffer, strides {attrs.stride()}")
    if hit.shape != (rows, width):
        raise ValueError("mat_id and hit must be (rows, W)")
    return table, uni, mat_id.contiguous(), hit.contiguous(), stride


def shade_backward(g_chan, attrs, mat_id, hit, mat_props, uni, **kw):
    """Adjoint of ``shade_core`` per pixel → (g_attrs (rows,W,6), g_props
    (rows,W,9), g_uni (1,U), g_table), the first two zero off-hit; g_table
    is the cotangent of ``mat_props`` (g_props summed by material id).
    ``want_attrs=False`` / ``want_props=False`` skip a per-pixel output
    (None in its place; the kernel then does not write it). ``ibl=True``
    differentiates the IBL mode (an 11-channel cotangent, 27 SH9 slots in
    g_uni). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if g_chan.device.type == "cpu":
        return shade_backward_plain(g_chan, attrs, mat_id, hit, mat_props, uni, **kw)
    return shade_backward_cuda(g_chan, attrs, mat_id, hit, mat_props, uni, **kw)


def shade_backward_cuda(
    g_chan: torch.Tensor,  # (rows, W, C) cotangent of the shader's C channels
    attrs: torch.Tensor,  # (rows, W, 6) residual [pos_w, normal_w], last-dim stride 1
    mat_id: torch.Tensor,  # (rows, W) int32
    hit: torch.Tensor,  # (rows, W) bool
    mat_props: torch.Tensor,  # (M, ≥9)
    uni: torch.Tensor,  # (1, U)
    *,
    num_dir: int,
    num_point: int,
    num_spot: int,
    apply_tonemap: bool,
    ibl: bool = False,
    want_attrs: bool = True,
    want_props: bool = True,
):
    """Launch ``csrc/shade_backward.cu`` on the current stream. ``attrs`` may
    be the ``[..., :6]`` view of the forward's (rows, W, 7) G-buffer: the
    kernel reads it with its row stride. The IBL mode reads ``g_chan`` with
    its pixel and channel strides (pixel-major or planar alike). The kernel
    sums g_uni and the table cotangent without float atomics: the same bits
    on every run."""
    global SHADE_BWD_LAUNCHES, SHADE_BWD_IBL_LAUNCHES
    device = g_chan.device
    if device.type != "cuda":
        raise ValueError(f"shade_backward_cuda needs CUDA tensors, got {device}")
    rows, width, c_out = g_chan.shape
    if c_out != num_output_channels(ibl):
        raise ValueError(f"g_chan has {c_out} channels, the shader {num_output_channels(ibl)}")
    npix = rows * width
    if mat_id.shape != (rows, width):
        raise ValueError("mat_id and hit must be (rows, W)")
    table, uni, mat_id, hit, stride = _band_inputs(
        "shade_backward_cuda", attrs, mat_id, hit, mat_props, uni, num_dir + num_point + num_spot, ibl
    )
    if ibl:
        if g_chan.stride(0) != width * g_chan.stride(1):
            g_chan = g_chan.contiguous()
        g_flat = g_chan.view(npix, c_out)
    else:
        g_chan = g_chan.contiguous()
        if g_chan.data_ptr() % 16:  # the shade mode reads one float4 per pixel
            g_chan = g_chan.clone()
        g_flat = g_chan.view(npix, c_out)
    if g_chan.device != device or g_chan.dtype != torch.float32:
        raise ValueError(f"shade_backward_cuda: expected float32 on {device}, got {g_chan.dtype} on {g_chan.device}")

    lib = kernel_library()
    g_attrs = torch.empty((rows, width, 6), dtype=torch.float32, device=device) if want_attrs else None
    g_props = torch.empty((rows, width, 9), dtype=torch.float32, device=device) if want_props else None
    num_uni, num_materials = uni.shape[0], table.shape[0]
    sums = torch.empty((num_uni + 9 * num_materials,), dtype=torch.float32, device=device)
    partials = torch.empty((max(lib.shade_backward_blocks(npix), 1), sums.shape[0]),
                           dtype=torch.float32, device=device)
    err = lib.shade_backward_launch(
        g_flat.data_ptr(), attrs.data_ptr(), mat_id.data_ptr(), hit.data_ptr(), table.data_ptr(),
        uni.data_ptr(), None if g_attrs is None else g_attrs.data_ptr(),
        None if g_props is None else g_props.data_ptr(), partials.data_ptr(),
        sums.data_ptr(), npix, g_flat.stride(0), g_flat.stride(1), stride, num_materials,
        num_uni, num_dir, num_point, num_spot, int(apply_tonemap), int(ibl),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        msg = lib.shade_backward_error_string(err).decode()
        raise RuntimeError(f"shade_backward kernel launch failed: CUDA error {err} ({msg})")
    if ibl:
        SHADE_BWD_IBL_LAUNCHES += 1
    else:
        SHADE_BWD_LAUNCHES += 1
    g_table = sums[num_uni:].reshape(num_materials, 9)
    if mat_props.shape[1] > 9:
        g_table = torch.nn.functional.pad(g_table, (0, mat_props.shape[1] - 9))
    return g_attrs, g_props, sums[None, :num_uni], g_table


def shade_backward_plain(
    g_chan: torch.Tensor,
    attrs: torch.Tensor,
    mat_id: torch.Tensor,
    hit: torch.Tensor,
    mat_props: torch.Tensor,
    uni: torch.Tensor,
    *,
    num_dir: int,
    num_point: int,
    num_spot: int,
    apply_tonemap: bool,
    ibl: bool = False,
    want_attrs: bool = True,
    want_props: bool = True,
):
    """Plain PyTorch version, on any device and in the inputs' float type:
    ``torch.autograd.grad`` of ``shade_core`` on the hit pixels, with the
    material row fetched as the kernel fetches it (out-of-table ids read
    zeros), and ``_scatter_props_by_id`` for the table cotangent; None for a
    per-pixel output not asked for."""
    rows, width, c_out = g_chan.shape
    dtype = attrs.dtype
    idx = torch.nonzero(hit.reshape(-1)).squeeze(1)
    m = mat_props.shape[0]
    mid = mat_id.reshape(-1)[idx].long()
    in_table = ((mid >= 0) & (mid < m))[:, None]
    with torch.enable_grad():
        a = attrs.reshape(rows * width, -1)[idx, :6].detach().requires_grad_()
        pr = (mat_props[mid.clamp(0, m - 1), :9] * in_table).to(dtype).detach().requires_grad_()
        u = uni.reshape(1, -1).to(dtype).detach().requires_grad_()
        outs = shade_core(
            tuple(a[:, c] for c in range(3)),
            tuple(a[:, c] for c in range(3, 6)),
            tuple(pr[:, c] for c in range(9)),
            u,
            num_dir=num_dir,
            num_point=num_point,
            num_spot=num_spot,
            apply_tonemap=apply_tonemap,
            ibl=ibl,
        )
        g = g_chan.reshape(rows * width, c_out)[idx].to(dtype)
        ga, gp, gu = torch.autograd.grad(
            outs, (a, pr, u), tuple(g[:, c] for c in range(c_out)), allow_unused=True
        )
    ga = torch.zeros_like(a) if ga is None else ga
    gp = torch.zeros_like(pr) if gp is None else gp
    gu = torch.zeros_like(u) if gu is None else gu

    def to_image(values):
        out = torch.zeros((rows * width, values.shape[-1]), dtype=dtype, device=values.device)
        return out.index_copy_(0, idx, values).reshape(rows, width, -1)

    g_table = _scatter_props_by_id(gp, mid, m, mat_props.shape[1])
    return to_image(ga) if want_attrs else None, to_image(gp) if want_props else None, gu, g_table


def _scatter_props_by_id(
    g_props: torch.Tensor, mat_id: torch.Tensor, num_materials: int, matk: int
) -> torch.Tensor:
    """Per-pixel property cotangents → per-material table cotangent (M, matk):
    one weighted ``bincount`` over the bins ``mat_id·K + k``, the plain
    version of the sum the backward kernel forms itself. (The JAX package
    contracts a one-hot matrix instead, ~400 MB at 1080p.) Ids outside
    [0, M) add nothing."""
    k = g_props.shape[-1]
    gf = g_props.reshape(-1, k)
    mid = mat_id.reshape(-1).long()
    ok = ((mid >= 0) & (mid < num_materials))[:, None]
    bins = mid.clamp(0, num_materials - 1)[:, None] * k + torch.arange(k, device=mid.device)
    out = torch.bincount(
        bins.reshape(-1), torch.where(ok, gf, 0.0).reshape(-1), minlength=num_materials * k
    ).reshape(num_materials, k)
    if matk > out.shape[-1]:
        out = torch.nn.functional.pad(out, (0, matk - out.shape[-1]))
    return out[:, :matk]


def shade_forward(attrs, mat_id, hit, mat_props, uni, **kw):
    """``shade_core`` over a resolved G-buffer band → (rows, W, C_out):
    (r, g, b, opacity), or the IBL mode's 11 channels (``ibl=True``), zeros
    at background. CPU tensors take the plain version; CUDA tensors launch
    the kernel. Not differentiable: see :func:`shade_fused`."""
    if attrs.device.type == "cpu":
        return shade_forward_plain(attrs, mat_id, hit, mat_props, uni, **kw)
    return shade_forward_cuda(attrs, mat_id, hit, mat_props, uni, **kw)


def shade_forward_cuda(
    attrs: torch.Tensor,  # (rows, W, 6) [pos_w, normal_w], last-dim stride 1
    mat_id: torch.Tensor,  # (rows, W) int32
    hit: torch.Tensor,  # (rows, W) bool
    mat_props: torch.Tensor,  # (M, ≥9)
    uni: torch.Tensor,  # (1, U)
    *,
    num_dir: int,
    num_point: int,
    num_spot: int,
    ibl: bool = False,
    apply_tonemap: bool = True,
):
    """Launch ``csrc/shade_forward.cu`` on the current stream. The IBL mode
    writes its channels as planes, (11, rows, W); the result is the (rows,
    W, 11) view of them."""
    global SHADE_FWD_LAUNCHES, SHADE_FWD_IBL_LAUNCHES
    device = attrs.device
    if device.type != "cuda":
        raise ValueError(f"shade_forward_cuda needs CUDA tensors, got {device}")
    rows, width = mat_id.shape
    table, uni, mat_id, hit, stride = _band_inputs(
        "shade_forward_cuda", attrs, mat_id, hit, mat_props, uni, num_dir + num_point + num_spot, ibl
    )
    c_out = num_output_channels(ibl)
    out = torch.empty((c_out, rows, width) if ibl else (rows, width, c_out), dtype=torch.float32, device=device)
    lib = shade_forward_library()
    err = lib.shade_forward_launch(
        attrs.data_ptr(), mat_id.data_ptr(), hit.data_ptr(), table.data_ptr(), uni.data_ptr(),
        out.data_ptr(), rows * width, stride, table.shape[0], uni.shape[0], num_dir, num_point,
        num_spot, int(apply_tonemap), int(ibl), torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        msg = lib.shade_forward_error_string(err).decode()
        raise RuntimeError(f"shade_forward kernel launch failed: CUDA error {err} ({msg})")
    if ibl:
        SHADE_FWD_IBL_LAUNCHES += 1
        return out.permute(1, 2, 0)
    SHADE_FWD_LAUNCHES += 1
    return out


def shade_forward_plain(
    attrs: torch.Tensor,
    mat_id: torch.Tensor,
    hit: torch.Tensor,
    mat_props: torch.Tensor,
    uni: torch.Tensor,
    *,
    num_dir: int,
    num_point: int,
    num_spot: int,
    ibl: bool = False,
    apply_tonemap: bool = True,
):
    """Plain PyTorch version, on any device: ``shade_core`` over every pixel
    of the band with the material row fetched as the kernel fetches it
    (out-of-table ids read zeros), then zeros where ``hit`` is false."""
    m = mat_props.shape[0]
    mid = mat_id.long()
    in_table = ((mid >= 0) & (mid < m))[..., None]
    props = mat_props[mid.clamp(0, m - 1), :9] * in_table
    outs = shade_core(
        tuple(attrs[..., c] for c in range(3)),
        tuple(attrs[..., c] for c in range(3, 6)),
        tuple(props[..., c] for c in range(9)),
        uni.reshape(1, -1),
        num_dir=num_dir,
        num_point=num_point,
        num_spot=num_spot,
        apply_tonemap=apply_tonemap,
        ibl=ibl,
    )
    return torch.where(hit[..., None], torch.stack(outs, dim=-1), 0.0)


def _interpolation_vjp(vc, pa, tri_id, g_attrs, g_depth, need, *, width, height, y_offset):
    """Pull the attribute (and depth) cotangents of fixed winners back to the
    clip coordinates and corner attributes through a recompute of
    ``interpolate_corners`` → (g_vc or None, g_pa or None), as ``need`` asks.
    Depth depends on the clip coordinates only."""
    global GEOMETRY_RECOMPUTES
    GEOMETRY_RECOMPUTES += 1
    with torch.enable_grad():
        vc_ = vc.detach().requires_grad_(need[0])
        pa_ = pa.detach().requires_grad_(need[1])
        a, d, _ = interpolate_corners(pa_, vc_, tri_id, width=width, height=height, y_offset=y_offset)
        outs, cots = [a], [g_attrs]
        if g_depth is not None and need[0]:
            outs.append(d)
            cots.append(g_depth)
        wrt = [t for t in (vc_, pa_) if t.requires_grad]
        grads = list(torch.autograd.grad(outs, wrt, cots))
    return (grads.pop(0) if need[0] else None), (grads.pop(0) if need[1] else None)


class _RasterShade(torch.autograd.Function):
    """(verts_clip, packed_attrs, face_material, mat_props, uni) → (rgba or
    the IBL channels, tri_id, mat_id, overflowed, num_pairs); gradients to
    verts_clip, packed_attrs, mat_props and uni."""

    @staticmethod
    def forward(ctx, verts_clip, packed_attrs, face_material, mat_props, uni, kw):
        out = shade_row_packed(
            verts_clip, packed_attrs, face_material, mat_props, uni, want_gbuf=True, **kw
        )
        ctx.kw = kw
        ctx.save_for_backward(verts_clip, packed_attrs, mat_props, uni, out.tri_id, out.mat_id, out.gbuf)
        ctx.mark_non_differentiable(out.tri_id, out.mat_id, out.overflowed, out.num_pairs)
        return out.rgba, out.tri_id, out.mat_id, out.overflowed, out.num_pairs

    @staticmethod
    def backward(ctx, g_rgba, *_):
        vc, pa, table, uni, tri_id, mat_id, attrs = ctx.saved_tensors
        kw = ctx.kw
        hit = tri_id >= 0
        g = torch.where(hit[..., None], g_rgba, 0.0)  # never a multiply: background may be NaN
        need = ctx.needs_input_grad
        g_attrs, _, g_uni, g_table = shade_backward(
            g, attrs, mat_id, hit, table, uni,
            num_dir=kw["num_dir"], num_point=kw["num_point"], num_spot=kw["num_spot"],
            apply_tonemap=kw["apply_tonemap"], ibl=kw["ibl"], want_attrs=need[0] or need[1], want_props=False,
        )
        g_table = g_table if need[3] else None
        g_uni = g_uni.reshape(uni.shape) if need[4] else None
        g_vc = g_pa = None
        if need[0] or need[1]:
            g_vc, g_pa = _interpolation_vjp(vc, pa, tri_id, g_attrs, None, need, width=kw["width"],
                                            height=kw["height"], y_offset=kw["y_offset"])
        return g_vc, g_pa, None, g_table, g_uni, None


def raster_shade(
    verts_clip: torch.Tensor,  # (T, 3, 4) corner-major clip coords
    packed_attrs: torch.Tensor,  # (T, 3, 6) [pos_w, normal_w]
    face_material: torch.Tensor,  # (T,) int
    mat_props: torch.Tensor,  # (M, 9)
    light_strength: torch.Tensor,
    light_direction: torch.Tensor,
    light_position: torch.Tensor,
    light_spot_power: torch.Tensor,
    ambient: torch.Tensor,
    eye: torch.Tensor,
    sh9: torch.Tensor | None = None,  # (9, 3): the IBL mode (raster_shade_ibl)
    *,
    width: int,
    height: int,
    rows: int | None = None,
    y_offset: int = 0,
    tile_h: int = 4,
    tile_w: int = 128,
    max_span: int = 16,
    big_cap: int | None = None,
    big2_span: int = 0,
    big2_cap: int | None = None,
    cull_backface: bool = True,
    num_materials: int = 0,
    num_dir: int = 0,
    num_point: int = 0,
    num_spot: int = 0,
    apply_tonemap: bool = True,
    pairs_cap: int | None = None,
    row_layout: bool = False,
) -> ShadeRowResult:
    """Differentiable fused raster+shade of the band [y_offset, y_offset+rows)
    → ``ShadeRowResult`` (``gbuf`` None): display-encoded foreground RGBA,
    ids, and the binning's overflow flag. Without gradients it runs the
    forward alone and writes no G-buffer.

    The defaults are the JAX function's: the v1 binning at 4×128 tiles, max
    span 16, no big2 class — kernel 7 (``rasterize_binned_shade``), which on
    CUDA tensors is the shade mode of ``csrc/raster_shade_row.cu`` at these
    tiles, counted in ``raster_row.SHADE_V1_KERNEL_LAUNCHES`` (IBL:
    ``SHADE_V1_IBL_KERNEL_LAUNCHES``). ``row_layout=True`` with the row
    parameters (``render``: 8-row tiles, ``binning_params``) is kernel 1.
    The two compute one function and differ only in their binning, so at
    quantized-depth ties only. The backward is the same for both."""
    ibl = sh9 is not None
    kw = dict(
        width=width, height=height, rows=height if rows is None else rows, y_offset=int(y_offset),
        tile_h=tile_h, tile_w=tile_w, max_span=max_span, pairs_cap=pairs_cap, big_cap=big_cap,
        big2_span=big2_span, big2_cap=big2_cap, cull_backface=cull_backface,
        num_materials=num_materials, num_dir=num_dir, num_point=num_point, num_spot=num_spot,
        apply_tonemap=apply_tonemap and not ibl, ibl=ibl, v1=not row_layout,
    )
    uni = pack_shading_uniforms(
        light_strength, light_direction, light_position, light_spot_power, ambient, eye, sh9
    )
    inputs = (verts_clip, packed_attrs, mat_props, uni)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in inputs)):
        return shade_row_packed(verts_clip, packed_attrs, face_material, mat_props, uni, **kw)
    rgba, tri_id, mat_id, overflowed, num_pairs = _RasterShade.apply(
        verts_clip, packed_attrs, face_material, mat_props, uni, kw
    )
    return ShadeRowResult(rgba=rgba, tri_id=tri_id, mat_id=mat_id, gbuf=None,
                          overflowed=overflowed, num_pairs=num_pairs)


def raster_shade_ibl(verts_clip, packed_attrs, face_material, mat_props, light_strength,
                     light_direction, light_position, light_spot_power, ambient, eye,
                     sh9: torch.Tensor, **kw) -> ShadeRowResult:
    """:func:`raster_shade` in the IBL mode (its arguments, with ``sh9`` (9,
    3) and no tonemap): ``rgba`` holds the 11 HDR channels of
    ``shade_core(ibl=True)`` — direct + SH9 diffuse, the env-BRDF factor, the
    reflect direction, roughness and opacity — that the env-gather epilogue
    completes as hdr + sf·prefiltered(r, roughness). Differentiable w.r.t.
    geometry, materials, lights, the eye and ``sh9``."""
    return raster_shade(verts_clip, packed_attrs, face_material, mat_props, light_strength,
                        light_direction, light_position, light_spot_power, ambient, eye, sh9,
                        apply_tonemap=False, **kw)


@dataclasses.dataclass(frozen=True)
class RasterIdsResult:
    """What JAX ``rasterize_binned`` returns — ``img`` (here ``tri_id``), or
    ``(tri_id, mat_id)`` with ``face_material``, each with ``depth`` under
    ``return_depth`` — and the binning's overflow flag."""

    tri_id: torch.Tensor  # (rows, W) int32 triangle ids, −1 at background
    mat_id: torch.Tensor | None  # (rows, W) int32 (None without face_material)
    depth: torch.Tensor | None  # (rows, W) f32 NDC depth, +inf at background (return_depth)
    overflowed: torch.Tensor  # () bool: the pair cap dropped triangles
    num_pairs: torch.Tensor  # () int: (tile, triangle) pairs emitted


def rasterize_binned(
    verts_clip: torch.Tensor,  # (T, 3, 4) corner-major clip coords, or (V, 4) with tris
    tris: torch.Tensor | None = None,  # (T, 3) int: indexed input
    *,
    width: int,
    height: int,
    rows: int | None = None,
    y_offset: int = 0,
    tile_h: int = 16,
    tile_w: int = 128,
    max_span: int = 8,
    pairs_cap: int | None = None,
    big_cap: int | None = None,
    big2_span: int = 0,
    big2_cap: int | None = None,
    cull_backface: bool = True,
    tri_mask: torch.Tensor | None = None,  # (T,) bool: only these triangles
    face_material: torch.Tensor | None = None,  # (T,) int
    num_materials: int = 0,
    z_floor: torch.Tensor | None = None,  # (rows, W): keep only z > z_floor
    return_depth: bool = False,
    edge_margin_px: float = 0.0,
) -> RasterIdsResult:
    """Binned id raster of the band [y_offset, y_offset+rows) — the
    counterpart of the JAX ``rasterize_binned`` (kernel 5,
    ``_raster_tile_kernel``), with its defaults: 16×128 tiles, max span 8,
    no big2 class. Corner-major ``verts_clip`` (T, 3, 4), or with ``tris``
    (T, 3) indexed vertices (V, 4): projected once, gathered to the corners,
    then the same binning and kernel (the same codes as on
    ``verts_clip[tris]``). ``tri_mask`` drops triangles
    in the setup; ``z_floor`` peels (only candidates strictly behind it;
    −inf accepts everything); ``face_material`` + ``num_materials`` resolve
    the material ids through the same ``tid·stride + mat`` code as the
    other kernels. The depth test is exact (not the quantized key of the
    fused kernels): the nearest candidate wins, a tie goes to the first
    drawn. On CUDA tensors: the ids mode of ``csrc/raster_shade_row.cu``,
    counted in ``raster_row.IDS_KERNEL_LAUNCHES``; CPU tensors take
    ``raster_ids_tiles_plain``. As for kernel 4, the TPU kernel's leading
    pairs (runs aligned down to 128) can move an id at exact depth ties
    only. Not differentiable (the JAX kernel has no VJP): ids and depth
    carry no gradient.

    ``edge_margin_px`` > 0 dilates every triangle by that many pixels (the
    soft raster's near-miss capture, kernel 5b): the binning grows each bbox
    by the margin and packs unit-gradient edges, and coverage is
    ``e_i ≥ −margin``. As on the TPU, only the tiles that bbox + margin
    touches bound a sliver's dilated wedge (no bbox clip, no z clamp: the
    JAX package's jnp rasterizer has those, its kernel not). On CUDA
    tensors: the ids mode's dilated instantiation, counted in
    ``raster_row.IDS_MARGIN_KERNEL_LAUNCHES``. Here a TPU leading pair can
    cover, and win, a pixel outside its own tiles' runs, which the port
    never tests; the parity tests count such pixels."""
    if rows is None:
        rows = height
    mat_stride = 1
    if face_material is not None:
        if num_materials <= 0:
            raise ValueError("pass num_materials with face_material")
        mat_stride = material_stride(num_materials, verts_clip.shape[0] if tris is None else tris.shape[0])
    with torch.no_grad():
        binned = bin_for_shade(
            verts_clip, None, face_material if mat_stride > 1 else None, width=width, height=height,
            rows=rows, y_offset=y_offset, tile_h=tile_h, tile_w=tile_w, max_span=max_span,
            pairs_cap=pairs_cap, big_cap=big_cap, big2_span=big2_span, big2_cap=big2_cap,
            cull_backface=cull_backface, tri_mask=tri_mask, bbox_margin_px=edge_margin_px, tris=tris,
        )
        code, depth = raster_ids_tiles(
            binned.starts, binned.packed, binned.pair_tri, width=width, rows=rows, y_offset=y_offset,
            tile_h=tile_h, tile_w=tile_w, mat_stride=mat_stride,
            z_floor=None if z_floor is None else z_floor.to(torch.float32).contiguous(),
            want_depth=return_depth, margin=float(edge_margin_px),
        )
    tri_id, mat_id = code, None
    if face_material is not None:
        tri_id, mat_id = decode_codes(code, mat_stride, face_material)
    return RasterIdsResult(tri_id=tri_id, mat_id=mat_id, depth=depth, overflowed=binned.overflowed,
                           num_pairs=binned.num_pairs)


def rasterize_binned_gbuffer(
    verts_clip: torch.Tensor,  # (T, 3, 4) corner-major clip coords, or (V, 4) with tris
    packed_attrs: torch.Tensor,  # (T, 3, C) corner attrs, C = 6 or 14; (V, C) with tris
    face_material: torch.Tensor | None = None,  # (T,) int
    *,
    tris: torch.Tensor | None = None,  # (T, 3) int: indexed input
    tri_mask: torch.Tensor | None = None,  # (T,) bool: only these triangles
    width: int,
    height: int,
    rows: int | None = None,
    y_offset: int = 0,
    tile_h: int = 16,
    tile_w: int = 128,
    max_span: int = 8,
    pairs_cap: int | None = None,
    big_cap: int | None = None,
    big2_span: int = 0,
    big2_cap: int | None = None,
    cull_backface: bool = True,
    num_materials: int = 0,
    z_floor: torch.Tensor | None = None,
) -> GBufferRowResult:
    """Raster + G-buffer in the v1 binning — the counterpart of the JAX
    ``rasterize_binned_gbuffer`` (kernel 4, ``_raster_tile_gbuf_kernel``):
    16×128 tiles, no big2 class (triangles past ``max_span`` tiles go to the
    jumbo run), ``z_floor``, material codes. Kernel 4 computes what kernel 2
    computes (the same quantized key, first-processed wins, jumbo run first,
    planes ÷ 1/w, the same peel); only the binning and the TPU's field-major
    layout differ. So on CUDA tensors it is the G-buffer mode of
    ``csrc/raster_shade_row.cu`` at these tiles (``PPT = 8`` at 16×128),
    counted in ``raster_row.GBUF_V1_KERNEL_LAUNCHES``; CPU tensors take
    ``raster_gbuffer_tiles_plain``. One difference, at exact quantized-depth
    ties only: the TPU kernel starts each run at a multiple of 128 pairs and
    so also evaluates up to 127 pairs before it; the port evaluates the run.
    With ``tris`` the input is indexed (vertices and their attributes,
    projected once and gathered to the corners, ``packed_attrs[tris]`` as
    the JAX function does): the same records, the same kernel. The JAX
    function takes ``(verts_clip, tris, packed_attrs)`` positionally; the
    port keeps ``tris`` a keyword. ``tri_mask`` drops triangles in the
    setup. Not differentiable: see :func:`raster_gbuffer`."""
    return gbuffer_pass(verts_clip, packed_attrs, face_material, v1=True, width=width, height=height,
                        rows=rows, y_offset=y_offset, tile_h=tile_h, tile_w=tile_w, max_span=max_span,
                        pairs_cap=pairs_cap, big_cap=big_cap, big2_span=big2_span, big2_cap=big2_cap,
                        cull_backface=cull_backface, num_materials=num_materials, z_floor=z_floor,
                        tris=tris, tri_mask=tri_mask)


class _RasterGBuffer(torch.autograd.Function):
    """(verts_clip, packed_attrs, face_material, z_floor) → (attrs, depth,
    tri_id, code-decoded mat_id, overflowed, num_pairs); gradients to
    verts_clip and packed_attrs."""

    @staticmethod
    def forward(ctx, verts_clip, packed_attrs, face_material, z_floor, kw):
        out = _gbuffer_forward(verts_clip, packed_attrs, face_material, z_floor, kw)
        ctx.kw = kw
        ctx.save_for_backward(verts_clip, packed_attrs, out.tri_id)
        ints = [t for t in (out.tri_id, out.mat_id, out.overflowed, out.num_pairs) if t is not None]
        ctx.mark_non_differentiable(*ints)
        return out.attrs, out.depth, out.tri_id, out.mat_id, out.overflowed, out.num_pairs

    @staticmethod
    def backward(ctx, g_attrs, g_depth, *_):
        vc, pa, tri_id = ctx.saved_tensors
        kw = ctx.kw
        need = ctx.needs_input_grad
        # Background pixels are exact zeros in the forward, but the recompute
        # interpolates triangle 0 there: mask their cotangents out first.
        hit = tri_id >= 0
        g_vc, g_pa = _interpolation_vjp(
            vc, pa, tri_id, torch.where(hit[..., None], g_attrs, 0.0), torch.where(hit, g_depth, 0.0),
            need, width=kw["width"], height=kw["height"], y_offset=kw["y_offset"],
        )
        return g_vc, g_pa, None, None, None


def _gbuffer_forward(verts_clip, packed_attrs, face_material, z_floor, kw) -> GBufferRowResult:
    kw = dict(kw)
    fn = rasterize_binned_gbuffer_row if kw.pop("row_layout") else rasterize_binned_gbuffer
    return fn(verts_clip, packed_attrs, face_material, z_floor=z_floor, **kw)


def raster_gbuffer(
    verts_clip: torch.Tensor,  # (T, 3, 4) corner-major clip coords, or (V, 4) with tris
    packed_attrs: torch.Tensor,  # (T, 3, C) corner attrs, C = 6 or 14; (V, C) with tris
    face_material: torch.Tensor | None = None,  # (T,) int
    *,
    tris: torch.Tensor | None = None,  # (T, 3) int: indexed input (the v1 binning only)
    width: int,
    height: int,
    rows: int | None = None,
    y_offset: int = 0,
    tile_h: int = 16,
    tile_w: int = 128,
    max_span: int = 8,
    pairs_cap: int | None = None,
    big_cap: int | None = None,
    big2_span: int = 0,
    big2_cap: int | None = None,
    cull_backface: bool = True,
    num_materials: int = 0,
    z_floor: torch.Tensor | None = None,
    row_layout: bool = False,
) -> GBufferRowResult:
    """Differentiable raster + G-buffer of the band [y_offset, y_offset+rows)
    (the JAX function). Its defaults are the JAX
    ``pallas_gbuf`` backend's v1 parameters (16×128 tiles, max span 8, no
    big2 class): :func:`rasterize_binned_gbuffer`, kernel 4, the textured
    path of ``render``. ``row_layout=True`` with the row parameters (8-row
    tiles, max span 16, as the triangle-sharded ring passes them) gives
    ``ops/raster_row.rasterize_binned_gbuffer_row``, kernel 2. Both run the
    CUDA kernel's G-buffer mode on CUDA tensors.

    Backward: the winning triangles are fixed (hard visibility has no
    gradient) and the attribute and depth cotangents, masked to covered
    pixels, are pulled back to ``verts_clip`` and ``packed_attrs`` through a
    recompute of ``ops/raster.interpolate_corners`` — only when one of them
    requires grad. ``z_floor`` and ``face_material`` get no gradient.

    ``tris`` (T, 3): indexed input, vertices (V, 4) and their attributes
    (V, C), gathered to the corners (one gather each, whose backward sums
    each corner's gradient into its vertex), then the corner-major path:
    the same records and kernel as ``rasterize_binned_gbuffer(tris=)``. As
    in the JAX package (``raster_pallas.py:2184``) the row layout takes
    corner-major input only. The JAX function takes ``(verts_clip,
    packed_attrs, tris, face_material)`` positionally; the port keeps
    ``tris`` a keyword."""
    if tris is not None:
        if row_layout:
            raise ValueError("raster_gbuffer(row_layout=True) takes corner-major input (tris=None)")
        idx = tris.long()
        verts_clip, packed_attrs = verts_clip[idx], packed_attrs[idx]
    kw = dict(
        width=width, height=height, rows=height if rows is None else rows, y_offset=int(y_offset),
        tile_h=tile_h, tile_w=tile_w, max_span=max_span, pairs_cap=pairs_cap, big_cap=big_cap,
        big2_span=big2_span, big2_cap=big2_cap, cull_backface=cull_backface,
        num_materials=num_materials, row_layout=row_layout,
    )
    if not (torch.is_grad_enabled() and (verts_clip.requires_grad or packed_attrs.requires_grad)):
        return _gbuffer_forward(verts_clip, packed_attrs, face_material, z_floor, kw)
    attrs, depth, tri_id, mat_id, overflowed, num_pairs = _RasterGBuffer.apply(
        verts_clip, packed_attrs, face_material, z_floor, kw
    )
    return GBufferRowResult(attrs=attrs, depth=depth, tri_id=tri_id, mat_id=mat_id,
                            overflowed=overflowed, num_pairs=num_pairs)


class _ShadeFused(torch.autograd.Function):
    """(attrs, mat_id, hit, mat_props, lights…, ambient, eye) → (rows, W, 4);
    gradients to attrs, mat_props, the lights, ambient and the eye."""

    @staticmethod
    def forward(ctx, attrs, mat_id, hit, mat_props, ls, ld, lp, lsp, amb, eye, kw):
        uni = pack_shading_uniforms(ls, ld, lp, lsp, amb, eye)
        ctx.kw = kw
        ctx.num_lights = ls.shape[0]
        ctx.save_for_backward(attrs, mat_id, hit, mat_props, uni)
        return shade_forward(attrs, mat_id, hit, mat_props, uni, ibl=False, **kw)

    @staticmethod
    def backward(ctx, g):
        attrs, mat_id, hit, table, uni = ctx.saved_tensors
        g_chan = torch.where(hit[..., None], g, 0.0)  # never a multiply: background may be NaN
        need = ctx.needs_input_grad
        g_attrs, _, g_uni, g_table = shade_backward(g_chan, attrs, mat_id, hit, table, uni, ibl=False,
                                                    want_attrs=need[0], want_props=False, **ctx.kw)
        g_lights = unpack_uniform_grads(g_uni, ctx.num_lights, False)[:6]
        g_lights = tuple(t if n else None for t, n in zip(g_lights, need[4:10]))
        return (g_attrs if need[0] else None, None, None, g_table if need[3] else None, *g_lights, None)


def shade_fused(
    attrs: torch.Tensor,  # (rows, W, 6) [pos_w, normal_w] — differentiable
    mat_id: torch.Tensor,  # (rows, W) int
    hit: torch.Tensor,  # (rows, W) bool
    mat_props: torch.Tensor,  # (M, 9) — differentiable
    light_strength: torch.Tensor,
    light_direction: torch.Tensor,
    light_position: torch.Tensor,
    light_spot_power: torch.Tensor,
    ambient: torch.Tensor,
    eye: torch.Tensor,
    *,
    num_dir: int,
    num_point: int,
    num_spot: int,
    apply_tonemap: bool = True,
) -> torch.Tensor:
    """Differentiable shading of a resolved G-buffer band (untextured, no
    IBL) → (rows, W, 4) RGBA, display encoded when ``apply_tonemap``, zeros
    at background. Forward: :func:`shade_forward` (the CUDA kernel on CUDA
    tensors). Backward: :func:`shade_backward` on the cotangent masked to
    ``hit`` (the kernel sums the material-table cotangent itself), the
    uniform cotangent unpacked to lights, ambient and eye; ``g_attrs``
    carries on to whatever resolved the attributes (``raster_gbuffer``'s
    backward for geometry)."""
    kw = dict(num_dir=num_dir, num_point=num_point, num_spot=num_spot, apply_tonemap=apply_tonemap)
    return _ShadeFused.apply(
        attrs, mat_id.to(torch.int32), hit.to(torch.bool), mat_props, light_strength,
        light_direction, light_position, light_spot_power, ambient, eye, kw,
    )
