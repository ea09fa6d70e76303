"""Per-triangle screen-space setup and the differentiable interpolation of
the winning triangles — the counterpart of the setup and
``interpolate_corners`` parts of ``physically_based_renderer_tpu/ops/raster.py``.

Conventions (parity with the reference pipeline): clip = [x,y,z,w] from
row-vector ``posW @ ViewProj``; NDC z ∈ [0,1]; pixel x = (ndc.x+1)/2·W,
pixel y = (1−ndc.y)/2·H (y down), centres at +0.5. Front faces are clockwise,
which in y-down pixel coordinates is a positive signed area. Triangles with
any corner at w ≤ eps are rejected whole; near clipping is per pixel (z ≥ 0).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import math3d

W_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ScreenTris:
    """Per-triangle screen-space setup (all (T, …) tensors)."""

    xy: torch.Tensor  # (T, 3, 2) pixel coords of the 3 corners
    z: torch.Tensor  # (T, 3) NDC depth
    inv_w: torch.Tensor  # (T, 3) 1/w
    area: torch.Tensor  # (T,) signed area ×2 (positive = front/CW)
    valid: torch.Tensor  # (T,) bool: in front, non-degenerate, not culled


def project_corners(corner_clip: torch.Tensor, width: int, height: int):
    """Corner-major clip (T,3,4) → pixel xy (T,3,2), depth (T,3), 1/w (T,3)."""
    w = corner_clip[..., 3]
    inv_w = torch.where(w.abs() > W_EPS, 1.0 / w, torch.zeros_like(w))
    ndc = corner_clip[..., :3] * inv_w[..., None]
    px = (ndc[..., 0] + 1.0) * (0.5 * width)
    py = (1.0 - ndc[..., 1]) * (0.5 * height)
    return torch.stack([px, py], dim=-1), ndc[..., 2], inv_w


def _setup_from_corner_data(xy, z, inv_w, w, cull_backface, tri_mask) -> ScreenTris:
    """Signed area and facing / in-front validity."""
    e01 = xy[:, 1] - xy[:, 0]
    e02 = xy[:, 2] - xy[:, 0]
    area = e01[:, 0] * e02[:, 1] - e01[:, 1] * e02[:, 0]
    in_front = (w > W_EPS).all(dim=-1)
    facing = area > 1e-12 if cull_backface else area.abs() > 1e-12
    valid = in_front & facing
    if tri_mask is not None:
        valid = valid & tri_mask
    return ScreenTris(xy=xy, z=z, inv_w=inv_w, area=area, valid=valid)


def setup_corners(
    corner_clip: torch.Tensor,
    width: int,
    height: int,
    cull_backface: bool = True,
    tri_mask: torch.Tensor | None = None,
) -> ScreenTris:
    """Setup from corner-major clip coordinates (T,3,4): no gathers."""
    xy, z, inv_w = project_corners(corner_clip, width, height)
    return _setup_from_corner_data(xy, z, inv_w, corner_clip[..., 3], cull_backface, tri_mask)


def interpolate_corners(
    corner_attrs: torch.Tensor,  # (T, 3, C) corner-major attributes
    corner_clip: torch.Tensor,  # (T, 3, 4) corner-major clip coords
    tri_id: torch.Tensor,  # (rows, W) int, −1 at background
    *,
    width: int,
    height: int,
    y_offset: int = 0,
    clamp: bool = False,
):
    """Differentiable perspective-correct interpolation of the winning
    triangles' corner attributes at the pixel centres of the band
    [y_offset, y_offset+rows). Gradients reach ``corner_attrs`` and
    ``corner_clip`` through plain autograd; ``tri_id`` contributes none.

    Background pixels read triangle 0's corners, as in the JAX package, but
    give it no gradient. ``clamp`` (the soft raster's dilated pixels, which
    lie outside their triangle): the barycentrics are clipped to [0, 1] and
    renormalised, so attributes do not extrapolate off the face.

    Returns (attrs (rows,W,C), depth (rows,W), mask (rows,W))."""
    xy_c, z_c, invw_c = project_corners(corner_clip, width, height)
    c = corner_attrs.shape[-1]
    packed = torch.cat([corner_attrs, xy_c, z_c[..., None], invw_c[..., None]], dim=-1)
    hit = tri_id >= 0
    # A gather's backward adds each run of equal indices serially, and most
    # of a frame is background: gather it from rows spread over the table,
    # then replace it. (The 1080p grid's geometry-gradient step on an H100:
    # 468 ms with one run of index 0, 13.9 ms spread.)
    spread = torch.arange(tri_id.numel(), device=tri_id.device).reshape(tri_id.shape) % packed.shape[0]
    data = packed[torch.where(hit, tri_id.long(), spread)]  # (rows, W, 3, C+4)
    data = torch.where(hit[..., None, None], data, packed[0].detach())
    return _interp_from_rows(data, c, tri_id, y_offset, clamp)


def _interp_from_rows(data, c, tri_id, y_offset, clamp=False):
    """Per-pixel interpolation tail: edge and barycentric math on gathered
    corner rows ``data`` (..., 3, C+4) laid out [attrs(C), xy, z, 1/w]. Pixel
    centres are (x + 0.5, y_offset + y + 0.5), as the raster step forms them."""
    xy = data[..., c : c + 2]
    z = data[..., c + 2]
    inv_w = data[..., c + 3]
    rows, width = tri_id.shape
    dev = data.device
    py = (float(y_offset) + torch.arange(rows, dtype=torch.float32, device=dev) + 0.5)[:, None]
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    p = torch.stack(torch.broadcast_tensors(px, py), dim=-1).to(data.dtype)

    def edge(pa, pb, pt):
        return (pt[..., 0] - pa[..., 0]) * (pb[..., 1] - pa[..., 1]) - (pt[..., 1] - pa[..., 1]) * (
            pb[..., 0] - pa[..., 0]
        )

    e0 = edge(xy[..., 1, :], xy[..., 2, :], p)
    e1 = edge(xy[..., 2, :], xy[..., 0, :], p)
    e2 = edge(xy[..., 0, :], xy[..., 1, :], p)
    area = e0 + e1 + e2
    area = torch.where(area.abs() < 1e-12, 1e-12, area)
    bary = torch.stack([e0, e1, e2], dim=-1) / area[..., None]
    if clamp:  # math3d's clip and maximum split a tie's gradient as jnp's do
        bary = math3d.clip(bary, 0.0, 1.0)
        bary = bary / math3d.maximum(bary.sum(dim=-1, keepdim=True), 1e-12)

    depth = (bary * z).sum(dim=-1)
    pw = bary * inv_w
    denom = pw.sum(dim=-1, keepdim=True)
    bary_persp = pw / torch.where(denom.abs() < 1e-20, 1e-20, denom)

    attrs = (bary_persp[..., None] * data[..., :c]).sum(dim=-2)
    return attrs, depth, tri_id >= 0


def _edge_coeffs(st: ScreenTris):
    """Edge functions in a frame relative to corner 0:
    e_i(p) = A_i·(px−x0) + B_i·(py−y0) + C0_i, e_i opposite corner i
    (bary_i = e_i/|area|). Every term is a coordinate difference: the global
    constant x_j·y_k − x_k·y_j cancels at screen coordinates ~10³ and punched
    speckle holes through thin silhouette triangles at 1200×800.
    Returns (a, b, c0, x0, y0)."""
    x, y = st.xy[..., 0], st.xy[..., 1]
    j = [1, 2, 0]
    k = [2, 0, 1]
    xj, xk, yj, yk = x[:, j], x[:, k], y[:, j], y[:, k]
    a = yj - yk
    b = xk - xj
    c0 = (xk - xj) * (y[:, 0:1] - yj) - (yk - yj) * (x[:, 0:1] - xj)
    s = torch.sign(st.area)[:, None]  # inside ⇒ e_i ≥ 0 for either winding
    return a * s, b * s, c0 * s, x[:, 0], y[:, 0]
