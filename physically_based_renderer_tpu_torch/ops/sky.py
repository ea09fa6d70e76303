"""Equirect sky / environment lookup — the counterpart of
``physically_based_renderer_tpu/ops/sky.py`` (the reference's
``Skybox.hlsl``): every background pixel samples the equirect map along its
world-space view ray, unprojected analytically.
"""

from __future__ import annotations

import torch

from .. import math3d
from .texture import sample_equirect, sample_sky_u8

INV_2PI = 0.1591  # the reference's literal constants (LightingUtil.hlsl:219)
INV_PI = 0.3183


def _sky_uv(d: torch.Tensor) -> torch.Tensor:
    u = torch.atan2(d[..., 2], d[..., 0]) * INV_2PI + 0.5
    v = torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) * INV_PI + 0.5
    v = 1.0 - v
    u = 1.0 - u
    u = u + 0.25
    return torch.stack([u, v], dim=-1)


class _WorldToSkyUV(torch.autograd.Function):
    """The mapping with its analytic derivative, 0 where it has none."""

    @staticmethod
    def forward(ctx, d):
        ctx.save_for_backward(d)
        return _sky_uv(d)

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        x, y, z = d[..., 0], d[..., 1], d[..., 2]
        # u = 0.75 − atan2(z, x)·INV_2PI, v = 0.5 − asin(y)·INV_PI; the products
        # in autograd's order (atan2's 1/(z² + x²), asin's rsqrt(1 − y²))
        recip = torch.reciprocal(z * z + x * x)
        off_axis = torch.isfinite(recip) & torch.isfinite(x) & torch.isfinite(z)
        ga = g[..., 0] * -INV_2PI
        gx = torch.where(off_axis, ga * -z * recip, 0.0)
        gz = torch.where(off_axis, ga * x * recip, 0.0)
        gy = torch.where(torch.abs(y) < 1.0, g[..., 1] * -INV_PI * torch.rsqrt(1.0 - y * y), 0.0)
        return torch.stack([gx, gy, gz], dim=-1)


def world_to_sky_uv(direction: torch.Tensor) -> torch.Tensor:
    """Equirect direction → uv with ``WorldToSkyUV``'s semantics
    (LightingUtil.hlsl:216-225): atan2/asin scaled by the truncated 1/2π and
    1/π, v flip, u flip, +0.25 on u. u may leave [0, 1]; samplers wrap.

    The gradient is the derivative of ``atan2`` and ``asin`` wherever the
    mapping has one, and 0 where it has none: ``v``'s where |y| ≥ 1 (the
    poles, and the clamp's zero beyond them), ``u``'s where 1/(x² + z²) is
    not finite (the y axis) or x or z is not finite. Only at those points
    does the port depart from the JAX package, whose gradient there is inf
    or NaN; a reflect direction that lands on a pole then leaves an SGD step
    finite. The forward is the plain formula, the same bits and launches;
    without a gradient to track it runs as it is."""
    if direction.requires_grad and torch.is_grad_enabled():
        return _WorldToSkyUV.apply(direction)
    return _sky_uv(direction)


def camera_ray_directions(
    inv_view_proj: torch.Tensor, width: int, height: int, rows: int | None = None, y_offset: int = 0
) -> torch.Tensor:
    """World-space unit view ray of every pixel centre (rows, W, 3) of the
    band [y_offset, y_offset+rows) of a width×height viewport.

    The NDC points at z=0 and z=0.5 go through the row-vector inverse
    view-projection as explicit float32 sums (never a TF32 matmul). z=0.5,
    not the far plane: w at z=1 is a near-total cancellation that float32
    resolves to noise, and reduced precision there turned every sky pixel NaN
    on the TPU; mid-depth w is O(1)."""
    if rows is None:
        rows = height
    dev = inv_view_proj.device
    py = float(y_offset) + torch.arange(rows, dtype=torch.float32, device=dev)[:, None] + 0.5
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
    ndc_x = (px / width * 2.0 - 1.0).expand(rows, width)
    ndc_y = (1.0 - py / height * 2.0).expand(rows, width)
    m = inv_view_proj

    def unproject(z: float) -> torch.Tensor:
        col = lambda j: ndc_x * m[0, j] + ndc_y * m[1, j] + z * m[2, j] + m[3, j]
        return torch.stack([col(0), col(1), col(2)], dim=-1) / col(3)[..., None]

    return math3d.normalize(unproject(0.5) - unproject(0.0))


def sample_sky(env: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Radiance of the equirect map along unit directions (..., 3): a uint8
    LDR background through its u8 taps, a float map (the HDR environment)
    through its f32 texels."""
    uv = world_to_sky_uv(directions)
    if env.dtype == torch.uint8:
        return sample_sky_u8(env, uv)
    return sample_equirect(env, uv)[..., :3]
