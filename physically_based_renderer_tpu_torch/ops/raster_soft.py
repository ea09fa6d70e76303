"""Soft (differentiable-visibility) rasterization by depth peeling — the
counterpart of ``physically_based_renderer_tpu/ops/raster_soft.py``
(corner-major input, or indexed with ``tris``):

  1. :func:`peel_layers`: K id rasters, each strictly behind the previous
     layer's depth, every one kernel 5 with dilated edges (kernel 5b,
     ``raster_pallas.rasterize_binned(edge_margin_px=)``), so that pixels
     within the margin of a triangle are captured — or, by name, the jnp
     oracle ``raster.rasterize``; ids and depths carry no gradient;
  2. per layer, :func:`signed_distance_px` to the triangle's boundary gives
     a sigmoid coverage, and the caller shades the layer;
  3. :func:`soft_composite` blends the layers with a softmax over depth and
     the maximum coverage over the background.

``render_wireframe`` also reads :func:`signed_distance_px`. Plain PyTorch
around the kernel, differentiable through autograd with respect to the clip
coordinates. Every ``min``/``max`` and ``clip`` splits a tie's gradient as
JAX's does (``torch.minimum``/``torch.maximum``, ``torch.amax``,
``math3d.clip``/``maximum``).
"""

from __future__ import annotations

import torch

from .. import math3d
from .raster import project_corners, rasterize
from .raster_pallas import rasterize_binned

BIG_Z = 1.0  # depth of an empty layer in the composite's softmax (the far plane)


def _length(v: torch.Tensor) -> torch.Tensor:
    """Length along the last axis (size 2), floored at √1e-12 as JAX's."""
    return torch.sqrt(math3d.maximum(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1], 1e-12))


def signed_distance_px(
    verts_clip: torch.Tensor,  # (T, 3, 4) corner-major clip coords, or (V, 4) with tris
    tris: torch.Tensor | None,  # (T, 3) int: indexed input
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
    minus the distance to the nearest edge segment. Indexed input (``tris``)
    projects each vertex once and gathers the corners: the same values and
    gradients as the corner-major ``verts_clip[tris]``."""
    xy_c, _, _ = project_corners(verts_clip, width, height)  # (T, 3, 2), or (V, 2) with tris
    if tris is not None:
        xy_c = xy_c[tris.long()]
    # Background pixels read triangle 0 (with its gradient, as in JAX) through
    # a broadcast, whose backward is a sum: a gather's backward adds one run
    # of equal indices serially on the card (render_soft's 1080p geometry
    # step took 1261 ms with the background gathered from row 0).
    hit = tri_id >= 0
    spread = torch.arange(tri_id.numel(), device=tri_id.device).reshape(tri_id.shape) % xy_c.shape[0]
    xy = xy_c[torch.where(hit, tri_id.long(), spread)]  # (rows, W, 3, 2)
    xy = torch.where(hit[..., None, None], xy, xy_c[0])
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


def peel_layers(
    verts_clip: torch.Tensor,  # (T, 3, 4) corner-major clip coords, or (V, 4) with tris
    tris: torch.Tensor | None,  # (T, 3) int: indexed input
    *,
    width: int,
    height: int,
    num_layers: int,
    rows: int | None = None,
    y_offset: int = 0,
    cull_backface: bool = True,
    edge_margin_px: float = 0.0,
    backend: str = "auto",
    **raster_kwargs,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``num_layers`` nearest fragments per pixel of the band, nearest
    first → (ids (K, rows, W) int32, −1 where empty; depths (K, rows, W),
    +inf where empty), each peel behind the previous layer's depth, the
    first behind −inf. No gradient reaches the peels; the caller recomputes
    depth differentiably from the ids.

    ``backend``: ``"auto"`` or ``"pallas"``, every peel
    ``rasterize_binned`` (kernel 5, with ``edge_margin_px`` kernel 5b) on
    either device — the JAX package's accelerator path (its ``"auto"`` on
    the CPU is ``"jnp"``); ``"pallas_interpret"``, the same on CPU tensors
    (the plain version) and refused on CUDA tensors, where no name runs a
    plain version; ``"jnp"``, the oracle ``raster.rasterize``, which also
    clips a dilated triangle to its bbox + margin and clamps its depth to
    the vertex range (``raster_kwargs`` then go to it: ``tile_h``,
    ``tile_w``, ``tri_block``). Raises ``RuntimeError`` when a kernel peel's
    binning overflowed its pair cap."""
    if backend == "pallas_interpret" and verts_clip.is_cuda:
        raise ValueError("backend 'pallas_interpret' names the plain version, which runs on CPU tensors only")
    if backend not in ("auto", "pallas", "pallas_interpret", "jnp"):
        raise ValueError(f"unknown backend {backend!r}")
    if rows is None:
        rows = height
    ids, zs, outs = [], [], []
    with torch.no_grad():
        z_floor = verts_clip.new_full((rows, width), -torch.inf)
        for _ in range(num_layers):
            kw = dict(width=width, height=height, rows=rows, y_offset=y_offset, cull_backface=cull_backface,
                      z_floor=z_floor, return_depth=True, edge_margin_px=edge_margin_px, **raster_kwargs)
            if backend == "jnp":
                tid, z = rasterize(verts_clip.detach(), tris, **kw)
            else:
                out = rasterize_binned(verts_clip.detach(), tris, **kw)
                tid, z = out.tri_id, out.depth
                outs.append(out)
            ids.append(tid)
            zs.append(z)
            z_floor = torch.where(torch.isfinite(z), z, z_floor)
    for out in outs:
        if bool(out.overflowed):
            raise RuntimeError(f"raster binning overflow in a soft-raster peel: {int(out.num_pairs)} (tile, "
                               "triangle) pairs hit the pair cap; triangles would be missing")
    return torch.stack(ids), torch.stack(zs)


def soft_composite(
    layer_colors: torch.Tensor,  # (K, H, W, 3) shaded layer colours
    layer_depth: torch.Tensor,  # (K, H, W), +inf where empty
    layer_signed_dist: torch.Tensor,  # (K, H, W) pixel distance to the silhouette
    layer_valid: torch.Tensor,  # (K, H, W) bool
    background: torch.Tensor,  # (H, W, 3), or (3,) the clear colour
    *,
    sigma: float = 1.0,  # silhouette softness in pixels
    gamma: float = 1e-2,  # depth softmax temperature (NDC units)
) -> torch.Tensor:
    """SoftRas aggregation in two stages (the JAX function's):

      1. a depth resolve among the fragments only: w_k ∝ σ(d_k/sigma)·
         exp(−z_k/gamma), a softmax over the K layers;
      2. alpha-compose over the background with the maximum coverage
         A = max_k cov_k: C = A·C_frag + (1 − A)·C_bg.

    Invalid layers are masked with ``torch.where``, never a multiply: an
    empty layer's depth is +inf and its shade may be NaN. ``torch.amax``
    (not ``max(dim=)``) splits a tie's gradient evenly, as ``jnp.max``."""
    cov = torch.where(layer_valid, torch.sigmoid(layer_signed_dist / sigma), 0.0)
    z = torch.where(layer_valid, layer_depth, BIG_Z)
    logit = -z / gamma
    logit = logit - torch.amax(logit, dim=0, keepdim=True)
    w = cov * torch.exp(logit)
    denom = w.sum(dim=0, keepdim=True)
    w = w / math3d.maximum(denom, 1e-12)
    colors = torch.where(layer_valid[..., None], layer_colors, 0.0)
    c_frag = (w[..., None] * colors).sum(dim=0)
    alpha = torch.amax(cov, dim=0)[..., None]
    return alpha * c_frag + (1.0 - alpha) * background
