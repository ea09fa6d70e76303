"""Per-triangle screen-space setup — the counterpart of the setup half of
``physically_based_renderer_tpu/ops/raster.py``.

Conventions (parity with the reference pipeline): clip = [x,y,z,w] from
row-vector ``posW @ ViewProj``; NDC z ∈ [0,1]; pixel x = (ndc.x+1)/2·W,
pixel y = (1−ndc.y)/2·H (y down), centres at +0.5. Front faces are clockwise,
which in y-down pixel coordinates is a positive signed area. Triangles with
any corner at w ≤ eps are rejected whole; near clipping is per pixel (z ≥ 0).
"""

from __future__ import annotations

import dataclasses

import torch

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
