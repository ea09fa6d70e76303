"""The signed pixel distance to a winning triangle's boundary — the
counterpart of ``signed_distance_px`` in
``physically_based_renderer_tpu/ops/raster_soft.py`` (corner-major input).
``render_wireframe`` marks the pixels within a line width of it; the soft
raster's coverage weights (``peel_layers``, ``soft_composite``) come with a
later slice.

Plain PyTorch, differentiable through autograd with respect to the clip
coordinates. The ``min``/``max`` of the edge distances and the ``clip`` of
the segment projection split a tie's gradient as JAX's do
(``torch.minimum``/``torch.maximum``, ``math3d.clip``).
"""

from __future__ import annotations

import torch

from .. import math3d
from .raster import project_corners


def _length(v: torch.Tensor) -> torch.Tensor:
    """Length along the last axis (size 2), floored at √1e-12 as JAX's."""
    return torch.sqrt(math3d.maximum(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1], 1e-12))


def signed_distance_px(
    verts_clip: torch.Tensor,  # (T, 3, 4) corner-major clip coords
    tris: torch.Tensor | None,
    tri_id: torch.Tensor,  # (rows, W) int, −1 at background
    *,
    width: int,
    height: int,
    y_offset: int = 0,
) -> torch.Tensor:
    """Signed distance in pixels from each pixel centre of the band
    [y_offset, y_offset + rows) to its winning triangle's boundary, positive
    inside → (rows, W). Background pixels read triangle 0. Inside, the
    nearest edge line (its far side for a back-facing triangle); outside,
    minus the distance to the nearest edge segment."""
    if tris is not None:
        raise NotImplementedError("signed_distance_px takes corner-major input (tris=None); the indexed "
                                  "input comes with ROADMAP item 14")
    xy_c, _, _ = project_corners(verts_clip, width, height)  # (T, 3, 2)
    xy = xy_c[tri_id.clamp(min=0).long()]  # (rows, W, 3, 2)
    rows = tri_id.shape[0]
    dev = xy.device
    py = (float(y_offset) + torch.arange(rows, dtype=torch.float32, device=dev) + 0.5)[:, None]
    px = (torch.arange(tri_id.shape[1], dtype=torch.float32, device=dev) + 0.5)[None, :]
    p = torch.stack(torch.broadcast_tensors(px, py), dim=-1)

    def edge_line_dist(a, b):
        ab = b - a
        # cross((b − a), (p − a)) / |b − a|: positive on the interior side of
        # a CW (positive-area) triangle in y-down pixel coordinates
        cr = ab[..., 0] * (p - a)[..., 1] - ab[..., 1] * (p - a)[..., 0]
        return cr / _length(ab)

    def seg_dist(a, b):  # unsigned distance to the segment ab
        ab = b - a
        pa = p - a
        t = (pa[..., 0] * ab[..., 0] + pa[..., 1] * ab[..., 1]) / math3d.maximum(
            ab[..., 0] * ab[..., 0] + ab[..., 1] * ab[..., 1], 1e-12)
        closest = a + math3d.clip(t, 0.0, 1.0)[..., None] * ab
        return _length(p - closest)

    c0, c1, c2 = xy[..., 0, :], xy[..., 1, :], xy[..., 2, :]
    d0, d1, d2 = edge_line_dist(c0, c1), edge_line_dist(c1, c2), edge_line_dist(c2, c0)
    d_line = torch.minimum(torch.minimum(d0, d1), d2)
    e01, e02 = c1 - c0, c2 - c0
    area = e01[..., 0] * e02[..., 1] - e01[..., 1] * e02[..., 0]
    # a back-facing (negative-area) triangle has its interior on the other side
    d_line = torch.where(area >= 0, d_line, -torch.maximum(torch.maximum(d0, d1), d2))
    # Outside, the nearest edge LINE is wrong past the edge endpoints (a
    # degenerate sliver would claim its whole line): the segments instead.
    d_out = -torch.minimum(torch.minimum(seg_dist(c0, c1), seg_dist(c1, c2)), seg_dist(c2, c0))
    return torch.where(d_line >= 0.0, d_line, d_out)
