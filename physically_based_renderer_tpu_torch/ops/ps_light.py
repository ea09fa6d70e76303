"""The PS stage's material blend and lighting: everything
``renderer.shade_pixels`` does after the texel taps.

:func:`shade_material` takes the G-buffer slices, the fetched material
columns and (textured scenes) the sampled texels, blends the material by its
has-texture flags, lights it (``ops/brdf.compute_lighting``), and adds the
ambient term, or the IBL split's SH9 diffuse and env-BRDF factor, or the
non-split IBL ambient (``ops/ibl.ambient_ibl``). It has two implementations
of one function:

  * on CUDA tensors, one launch of the hand-written kernel
    ``csrc/ps_light.cu`` inside a ``torch.autograd.Function`` whose backward
    is one launch of its hand-written adjoint; it raises on what it does not
    take and never falls back. The non-split IBL ambient, which samples the
    environment maps, stays eager: the kernel then also writes the blended
    material, and the ambient is added to its direct term;
  * on CPU tensors, :func:`shade_material_plain`, the eager code (the JAX
    package's ``shade_pixels`` lines, formula for formula), with autograd's
    backward. The chip check holds the kernel against it on the card.

Counters (``utils/profiling``, readable and settable under these module
names): ``launch/ps_light`` counts forward launches, ``launch/ps_light_bwd``
adjoint launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import math3d
from ..models.material import SLOT_DIFFUSE, SLOT_METALLIC, SLOT_NORMAL, SLOT_OPACITY, SLOT_ROUGHNESS
from ..models.material import SLOT_SPECULAR
from ..utils import profiling
from ..utils.cuda_build import load_library
from .brdf import Lights, MaterialSample, compute_lighting, normal_sample_to_world_space
from .ibl import IBLMaps, ambient_ibl, env_brdf_approx, sh9_irradiance
from .shade_core import pack_shading_uniforms

COUNTERS = {"PS_LIGHT_LAUNCHES": "launch/ps_light", "PS_LIGHT_BWD_LAUNCHES": "launch/ps_light_bwd"}

HAS = 16  # first has-texture column of the textured props row (models/material.props_table)
# The kernel's modes and each one's outputs' channels: hdr, opacity, then
# the split's spec_f, rdir, roughness, or the blended albedo, F0, metallic,
# roughness and normal the non-split IBL ambient needs.
MODES = {"ambient": (3, 1), "split": (3, 1, 3, 3, 1), "material": (3, 1, 3, 3, 1, 1, 3)}


def shade_material_plain(
    *,
    pos_w: torch.Tensor,  # (..., 3)
    normal_w: torch.Tensor,  # (..., 3)
    tangent_w: torch.Tensor,  # (..., 3)
    bitangent_w: torch.Tensor,  # (..., 3)
    props: torch.Tensor,  # (..., 28) textured, else (..., 9)
    texels: torch.Tensor | None,  # (..., ≥12) or None (untextured)
    lights: Lights,
    ambient: torch.Tensor,  # (3,)
    eye: torch.Tensor,  # (3,)
    ibl: IBLMaps | None = None,
    ibl_split: bool = False,
) -> tuple:
    """The plain version, on any device → (hdr, opacity), or with
    ``ibl_split`` (hdr, opacity, spec_f, rdir, roughness)."""
    n_geom = math3d.normalize(normal_w)  # Default.hlsl:50; the tangent frame stays raw
    v = math3d.normalize(eye - pos_w)
    c_diffuse, c_metallic, c_f0 = props[..., 0:3], props[..., 3], props[..., 4:7]
    c_roughness, c_opacity = props[..., 7], props[..., 8]
    if texels is not None:
        has = props[..., HAS : HAS + 12]
        # sample_any's channel order
        t_diffuse, t_specular, t_metallic = texels[..., 0:3], texels[..., 3:6], texels[..., 6:7]
        t_roughness, t_normal, t_opacity = texels[..., 7:8], texels[..., 8:11], texels[..., 11:12]
        h = lambda s: has[..., s : s + 1]  # noqa: E731
        albedo = h(SLOT_DIFFUSE) * t_diffuse + (1.0 - h(SLOT_DIFFUSE)) * c_diffuse
        metallic = has[..., SLOT_METALLIC] * t_metallic[..., 0] + (1.0 - has[..., SLOT_METALLIC]) * c_metallic
        # No specular map: F0 = lerp(const F0, albedo, metallic) (Default.hlsl:94-96).
        f0_const = math3d.lerp(c_f0, albedo, metallic[..., None])
        f0 = h(SLOT_SPECULAR) * t_specular + (1.0 - h(SLOT_SPECULAR)) * f0_const
        roughness = has[..., SLOT_ROUGHNESS] * t_roughness[..., 0] + (1.0 - has[..., SLOT_ROUGHNESS]) * c_roughness
        n_mapped = normal_sample_to_world_space(t_normal, n_geom, tangent_w, bitangent_w)
        n = h(SLOT_NORMAL) * n_mapped + (1.0 - h(SLOT_NORMAL)) * n_geom  # not renormalised
        opacity = has[..., SLOT_OPACITY] * t_opacity[..., 0] + (1.0 - has[..., SLOT_OPACITY]) * c_opacity
    else:
        albedo, metallic, roughness, n, opacity = c_diffuse, c_metallic, c_roughness, n_geom, c_opacity
        f0 = math3d.lerp(c_f0, albedo, metallic[..., None])

    mat = MaterialSample(diffuse_albedo=albedo, metallic=metallic, fresnel_r0=f0, roughness=roughness)
    direct = compute_lighting(lights, mat, pos_w, n, v)
    if ibl is not None and ibl_split:
        if ibl.irradiance_sh9 is None:
            raise ValueError("ibl_split needs the SH9 irradiance")
        n_unit = math3d.normalize(n)
        ndotv = math3d.maximum(math3d.dot(n_unit, v), 0.0)
        ks = f0 + (1.0 - f0) * torch.pow(1.0 - ndotv, 5.0)[..., None]
        kd = (1.0 - ks) * (1.0 - metallic)[..., None]
        ab = env_brdf_approx(ndotv, roughness)
        spec_f = f0 * ab[..., 0:1] + ab[..., 1:2]
        rdir = math3d.normalize(2.0 * ndotv[..., None] * n_unit - v)
        lit = direct + kd * sh9_irradiance(ibl.irradiance_sh9, n_unit) * albedo
        return lit, opacity, spec_f, rdir, roughness
    if ibl is not None:
        amb = ambient_ibl(ibl, math3d.normalize(n), v, albedo, f0, metallic, roughness)
    else:
        amb = ambient * albedo  # g_AmbientLight·albedo (Default.hlsl:150)
    return amb + direct, opacity


# ---------------------------------------------------------------------------
# The CUDA kernel and its adjoint
# ---------------------------------------------------------------------------

_NUM_IN, _NUM_OUT = 6, 7  # pos, normal, tangent, bitangent, props, texels; the outputs of the widest mode


class _Args(ctypes.Structure):
    """``PsLightArgs`` of ``csrc/ps_light.cu``, field for field."""

    _fields_ = [
        ("inp", ctypes.c_void_p * _NUM_IN),
        ("in_stride", ctypes.c_int64 * _NUM_IN),
        ("uni", ctypes.c_void_p),
        ("out", ctypes.c_void_p * _NUM_OUT),
        ("g_out", ctypes.c_void_p * _NUM_OUT),
        ("g_stride", ctypes.c_int64 * _NUM_OUT),
        ("g_in", ctypes.c_void_p * _NUM_IN),
        ("partials", ctypes.c_void_p),
        ("npix", ctypes.c_int64),
        ("props_cols", ctypes.c_int64),
        ("tex_cols", ctypes.c_int64),
        ("num_uni", ctypes.c_int64),
        ("num_dir", ctypes.c_int64),
        ("num_point", ctypes.c_int64),
        ("num_spot", ctypes.c_int64),
        ("mode", ctypes.c_int64),
    ]


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/ps_light.cu``."""
    lib = load_library("ps_light")
    for fn in (lib.ps_light_forward, lib.ps_light_backward):
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.ps_light_blocks.argtypes = [ctypes.c_int64]
    lib.ps_light_blocks.restype = ctypes.c_int
    lib.ps_light_error_string.argtypes = [ctypes.c_int]
    lib.ps_light_error_string.restype = ctypes.c_char_p
    return lib


def _pixel_stride(x: torch.Tensor, nbatch: int) -> int | None:
    """The stride at which the first ``nbatch`` dims of ``x`` step through its
    pixels in row-major order (a (rows, W, 14) G-buffer's ``[..., 0:3]`` steps
    by 14), or None where those dims do not collapse to one stride."""
    stride = expect = None
    for size, st in reversed(list(zip(x.shape[:nbatch], x.stride()[:nbatch]))):
        if size == 1:
            continue
        if expect is not None and st != expect:
            return None
        if stride is None:
            stride = st
        expect = st * size
    return 0 if stride is None else stride


def _pixels(x: torch.Tensor, nbatch: int) -> tuple[torch.Tensor, int]:
    """``x`` and its pixel stride, read in place where its pixels lie at one
    stride and its channels at stride 1, else a contiguous copy."""
    stride = _pixel_stride(x, nbatch)
    if stride is None or (x.dim() > nbatch and x.shape[-1] > 1 and x.stride(-1) != 1):
        x = x.contiguous()
        stride = _pixel_stride(x, nbatch)
    return x, stride


def _check(name: str, tensors: dict, batch: tuple, device) -> None:
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32 on {device}, got {t.dtype} on {t.device}")
        if tuple(t.shape[: len(batch)]) != batch:
            raise ValueError(f"{name}: {key} has pixel dims {tuple(t.shape[:len(batch)])}, expected {batch}")


def _require_cuda(name: str, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")


def _launch(fn_name: str, args: _Args, device) -> None:
    lib = kernel_library()
    err = getattr(lib, fn_name)(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} ({lib.ps_light_error_string(err).decode()})")


def _input_args(name, pos_w, normal_w, tangent_w, bitangent_w, props, texels, uni, num_dir, num_point, num_spot,
                mode) -> tuple[_Args, tuple, list]:
    """The argument block's inputs → (args, pixel dims, the tensors it points
    at: the caller holds them until the launch is enqueued)."""
    device = pos_w.device
    _require_cuda(name, device)
    batch = tuple(pos_w.shape[:-1])
    ins = [pos_w, normal_w, tangent_w, bitangent_w, props, texels]
    _check(name, dict(zip(("pos_w", "normal_w", "tangent_w", "bitangent_w", "props", "texels"), ins)), batch, device)
    if uni.device != device or uni.dtype != torch.float32:
        raise ValueError(f"{name}: uni must be float32 on {device}, got {uni.dtype} on {uni.device}")
    if texels is not None and (tangent_w is None or bitangent_w is None or texels.shape[-1] < 12
                               or props.shape[-1] < HAS + 12):
        raise ValueError(f"{name}: a textured call needs the tangent frame, ≥12 texel and ≥28 props channels")
    if props.shape[-1] < 9:
        raise ValueError(f"{name}: props needs ≥9 columns, got {props.shape[-1]}")
    args = _Args()
    keep = []
    for k, t in enumerate(ins):
        if t is None:
            continue
        t, stride = _pixels(t, len(batch))
        keep.append(t)
        args.inp[k], args.in_stride[k] = t.data_ptr(), stride
    uni = uni.reshape(-1).contiguous()
    keep.append(uni)
    args.uni = uni.data_ptr()
    args.npix = math.prod(batch)
    args.props_cols = props.shape[-1]
    args.tex_cols = 0 if texels is None else texels.shape[-1]
    args.num_uni = uni.shape[0]
    args.num_dir, args.num_point, args.num_spot = num_dir, num_point, num_spot
    args.mode = list(MODES).index(mode)
    return args, batch, keep


def shade_material_cuda(pos_w, normal_w, tangent_w, bitangent_w, props, texels, uni, *, num_dir: int,
                        num_point: int, num_spot: int, mode: str) -> tuple:
    """Launch ``csrc/ps_light.cu``'s forward on the current stream → the
    mode's outputs (:data:`MODES`), each (..., 3) or (...,). ``uni`` is
    ``pack_shading_uniforms``' row (with the SH9 slots in the split mode);
    ``tangent_w``, ``bitangent_w`` and ``texels`` are None for an untextured
    call."""
    args, batch, keep = _input_args("shade_material_cuda", pos_w, normal_w, tangent_w, bitangent_w, props, texels,
                                    uni, num_dir, num_point, num_spot, mode)
    outs = tuple(torch.empty(batch + ((3,) if ch == 3 else ()), dtype=torch.float32, device=pos_w.device)
                 for ch in MODES[mode])
    for k, o in enumerate(outs):
        args.out[k] = o.data_ptr()
    _launch("ps_light_forward", args, pos_w.device)
    profiling.count("launch/ps_light")
    return outs


def shade_material_backward_cuda(pos_w, normal_w, tangent_w, bitangent_w, props, texels, uni, grads, *,
                                 num_dir: int, num_point: int, num_spot: int, mode: str, want) -> tuple:
    """Launch the adjoint on the current stream: the outputs' cotangents
    ``grads`` (None: zero) → the gradients of (pos_w, normal_w, tangent_w,
    bitangent_w, props, texels, uni), each only where ``want`` (7 flags)
    asks, else None. The uniform row's cotangent is the sum, in a fixed
    order, of one partial row a block of the launch."""
    device = pos_w.device
    args, batch, keep = _input_args("shade_material_backward_cuda", pos_w, normal_w, tangent_w, bitangent_w, props,
                                    texels, uni, num_dir, num_point, num_spot, mode)
    for k, g in enumerate(grads):
        if g is None:
            continue
        _check("shade_material_backward_cuda", {f"grad {k}": g}, batch, device)
        g, stride = _pixels(g, len(batch))
        keep.append(g)
        args.g_out[k], args.g_stride[k] = g.data_ptr(), stride
    ins = (pos_w, normal_w, tangent_w, bitangent_w, props, texels)
    g_in = [torch.empty(t.shape, dtype=torch.float32, device=device) if w and t is not None else None
            for t, w in zip(ins, want[:6])]
    for k, g in enumerate(g_in):
        args.g_in[k] = None if g is None else g.data_ptr()
    partials = None
    if want[6]:
        blocks = kernel_library().ps_light_blocks(args.npix)
        partials = torch.empty((blocks, args.num_uni), dtype=torch.float32, device=device)
        args.partials = partials.data_ptr()
    _launch("ps_light_backward", args, device)
    profiling.count("launch/ps_light_bwd")
    g_uni = None if partials is None else partials.sum(0).reshape(uni.shape)
    return (*g_in, g_uni)


class _ShadeMaterial(torch.autograd.Function):
    """(pos_w, normal_w, tangent_w, bitangent_w, props, texels, uni) → the
    mode's outputs, by the kernel; the backward is its adjoint. It saves
    its inputs only."""

    @staticmethod
    def forward(ctx, pos_w, normal_w, tangent_w, bitangent_w, props, texels, uni, kw):
        ctx.set_materialize_grads(False)
        ctx.kw = kw
        ctx.save_for_backward(pos_w, normal_w, tangent_w, bitangent_w, props, texels, uni)
        return shade_material_cuda(pos_w, normal_w, tangent_w, bitangent_w, props, texels, uni, **kw)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[:7]
        if not any(need):
            return (None,) * 8
        return (*shade_material_backward_cuda(*ctx.saved_tensors, grads, want=need, **ctx.kw), None)


def shade_material(
    *,
    pos_w: torch.Tensor,
    normal_w: torch.Tensor,
    tangent_w: torch.Tensor,
    bitangent_w: torch.Tensor,
    props: torch.Tensor,
    texels: torch.Tensor | None,
    lights: Lights,
    ambient: torch.Tensor,
    eye: torch.Tensor,
    ibl: IBLMaps | None = None,
    ibl_split: bool = False,
) -> tuple:
    """The blend and the lighting → (hdr, opacity), or with ``ibl_split``
    (hdr, opacity, spec_f, rdir, roughness). Arguments as
    :func:`shade_material_plain`. CUDA tensors launch the kernel (its
    adjoint in the backward); CPU tensors run the plain version."""
    kw = dict(pos_w=pos_w, normal_w=normal_w, tangent_w=tangent_w, bitangent_w=bitangent_w, props=props,
              texels=texels, lights=lights, ambient=ambient, eye=eye, ibl=ibl, ibl_split=ibl_split)
    if pos_w.device.type != "cuda":
        return shade_material_plain(**kw)
    return _shade_material_kernel(**kw)


def _shade_material_kernel(*, pos_w, normal_w, tangent_w, bitangent_w, props, texels, lights, ambient, eye, ibl,
                           ibl_split) -> tuple:
    """:func:`shade_material` through the kernel and its adjoint."""
    split = ibl is not None and ibl_split
    if split and ibl.irradiance_sh9 is None:
        raise ValueError("ibl_split needs the SH9 irradiance")
    mode = "split" if split else ("material" if ibl is not None else "ambient")
    uni = pack_shading_uniforms(lights.strength, lights.direction, lights.position, lights.spot_power, ambient, eye,
                                ibl.irradiance_sh9 if split else None)
    frame = (tangent_w, bitangent_w) if texels is not None else (None, None)
    kw = dict(num_dir=lights.num_dir, num_point=lights.num_point, num_spot=lights.num_spot, mode=mode)
    outs = _ShadeMaterial.apply(pos_w, normal_w, *frame, props, texels, uni, kw)
    if mode != "material":
        return outs
    direct, opacity, albedo, f0, metallic, roughness, n = outs
    v = math3d.normalize(eye - pos_w)
    return ambient_ibl(ibl, math3d.normalize(n), v, albedo, f0, metallic, roughness) + direct, opacity


profiling.counters_as_attributes(__name__, COUNTERS)
