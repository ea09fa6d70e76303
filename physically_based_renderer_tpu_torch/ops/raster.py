"""Per-triangle screen-space setup, the differentiable interpolation of the
winning triangles, and the CPU raster oracles — the counterpart of
``physically_based_renderer_tpu/ops/raster.py``.

Geometry comes corner-major (clip coordinates (T, 3, 4): ``setup_corners``,
``interpolate_corners``, the hot path) or indexed (vertices (V, 4) and
``tris`` (T, 3): ``project_to_screen``, ``setup_triangles``,
``compute_barycentrics``, ``interpolate_packed``, ``interpolate``). The
interpolations are differentiable to the clip coordinates and the
attributes by autograd.

:func:`rasterize` (tiles of ``tile_h × tile_w`` pixels, triangle blocks of
``tri_block``) and :func:`rasterize_brute` (every pixel against every
triangle) are the JAX package's jnp rasterizers, kept as explicit oracles:
they run on whatever device their tensors are on, and no kernel falls back
to them. With ``edge_margin_px`` the tiled oracle keeps the jnp path's clip
of a dilated triangle to its bbox + margin and its clamp of z to the vertex
range, which kernel 5b does not have.

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
from ..utils import profiling

W_EPS = 1e-6
BACKGROUND = -1  # the id of a pixel nothing covers


@dataclasses.dataclass(frozen=True)
class ScreenTris:
    """Per-triangle screen-space setup (all (T, …) tensors)."""

    xy: torch.Tensor  # (T, 3, 2) pixel coords of the 3 corners
    z: torch.Tensor  # (T, 3) NDC depth
    inv_w: torch.Tensor  # (T, 3) 1/w
    area: torch.Tensor  # (T,) signed area ×2 (positive = front/CW)
    valid: torch.Tensor  # (T,) bool: in front, non-degenerate, not culled


def project_to_screen(verts_clip: torch.Tensor, width: int, height: int):
    """Clip-space vertices (V,4) → pixel xy (V,2), depth (V,), 1/w (V,): the
    arithmetic of :func:`project_corners`, one vertex at a time."""
    return project_corners(verts_clip, width, height)


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


def setup_triangles(
    verts_clip: torch.Tensor,
    tris: torch.Tensor,
    width: int,
    height: int,
    cull_backface: bool = True,
    tri_mask: torch.Tensor | None = None,
) -> ScreenTris:
    """Setup from indexed geometry: each vertex projected once, then one
    corner gather by ``tris`` (T, 3). The same floats as
    :func:`setup_corners` on ``verts_clip[tris]``."""
    xy, z, inv_w = project_to_screen(verts_clip, width, height)
    idx = tris.long()
    return _setup_from_corner_data(xy[idx], z[idx], inv_w[idx], verts_clip[:, 3][idx], cull_backface, tri_mask)


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


def _pixel_centres(shape, y_offset, device) -> torch.Tensor:
    """(rows, W, 2) pixel centres (x + 0.5, y_offset + y + 0.5) of a band."""
    rows, width = shape
    py = (float(y_offset) + torch.arange(rows, dtype=torch.float32, device=device) + 0.5)[:, None]
    px = (torch.arange(width, dtype=torch.float32, device=device) + 0.5)[None, :]
    return torch.stack(torch.broadcast_tensors(px, py), dim=-1)


def _edge(pa, pb, pt):
    return (pt[..., 0] - pa[..., 0]) * (pb[..., 1] - pa[..., 1]) - (pt[..., 1] - pa[..., 1]) * (pb[..., 0] - pa[..., 0])


def _barycentrics(xy, z, inv_w, p, clamp):
    """(perspective barycentrics, screen barycentrics, depth) at pixel
    centres ``p`` of corners ``xy`` (..., 3, 2), depth ``z`` and 1/w."""
    e0 = _edge(xy[..., 1, :], xy[..., 2, :], p)
    e1 = _edge(xy[..., 2, :], xy[..., 0, :], p)
    e2 = _edge(xy[..., 0, :], xy[..., 1, :], p)
    area = e0 + e1 + e2
    area = torch.where(area.abs() < 1e-12, 1e-12, area)
    bary = torch.stack([e0, e1, e2], dim=-1) / area[..., None]
    if clamp:  # math3d's clip and maximum split a tie's gradient as jnp's do
        bary = math3d.clip(bary, 0.0, 1.0)
        bary = bary / math3d.maximum(bary.sum(dim=-1, keepdim=True), 1e-12)
    depth = (bary * z).sum(dim=-1)
    pw = bary * inv_w
    denom = pw.sum(dim=-1, keepdim=True)
    return pw / torch.where(denom.abs() < 1e-20, 1e-20, denom), bary, depth


def compute_barycentrics(
    verts_clip: torch.Tensor,  # (V, 4) clip coords
    tris: torch.Tensor,  # (T, 3) int
    tri_id: torch.Tensor,  # (rows, W) int, −1 at background
    *,
    width: int,
    height: int,
    y_offset: int = 0,
    clamp: bool = False,
):
    """Per-pixel barycentrics of the winning triangles, differentiable to
    ``verts_clip`` → (bary_persp (rows,W,3), bary_screen (rows,W,3), depth
    (rows,W), mask (rows,W)). Background pixels read triangle 0 (and give it
    their gradient), as in the JAX package. ``clamp`` clips the barycentrics
    to [0, 1] and renormalises (a dilated pixel outside its triangle)."""
    xy_all, z_all, invw_all = project_to_screen(verts_clip, width, height)
    corner = tris.long()[tri_id.clamp(min=0).long()]  # (rows, W, 3)
    p = _pixel_centres(tri_id.shape, y_offset, verts_clip.device).to(verts_clip.dtype)
    bary_p, bary, depth = _barycentrics(xy_all[corner], z_all[corner], invw_all[corner], p, clamp)
    return bary_p, bary, depth, tri_id >= 0


def interpolate_packed(
    packed_attrs: torch.Tensor,  # (V, C) vertex attributes
    verts_clip: torch.Tensor,  # (V, 4) clip coords
    tris: torch.Tensor,  # (T, 3) int
    tri_id: torch.Tensor,  # (rows, W) int, −1 at background
    *,
    width: int,
    height: int,
    y_offset: int = 0,
    clamp: bool = False,
):
    """Indexed twin of :func:`interpolate_corners`: the vertices' attributes
    and screen data are packed per triangle (one ``tris`` gather), then
    fetched one row a pixel → (attrs (rows,W,C), depth (rows,W), mask
    (rows,W)). Background pixels read triangle 0, as in the JAX package."""
    xy_all, z_all, invw_all = project_to_screen(verts_clip, width, height)
    packed = torch.cat([packed_attrs, xy_all, z_all[:, None], invw_all[:, None]], dim=-1)  # (V, C+4)
    tri_table = packed[tris.long()]  # (T, 3, C+4)
    data = tri_table[tri_id.clamp(min=0).long()]
    return _interp_from_rows(data, packed_attrs.shape[-1], tri_id, y_offset, clamp)


def interpolate(attr: torch.Tensor, tris: torch.Tensor, tri_id: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of vertex attributes ``attr`` (V, C) over
    the winning triangles with weights ``bary`` (rows, W, 3) → (rows, W, C);
    background pixels hold triangle 0's (mask them)."""
    vals = attr[tris.long()[tri_id.clamp(min=0).long()]]  # (rows, W, 3, C)
    return (bary[..., None] * vals).sum(dim=-2)


def _interp_from_rows(data, c, tri_id, y_offset, clamp=False):
    """Per-pixel interpolation tail: edge and barycentric math on gathered
    corner rows ``data`` (..., 3, C+4) laid out [attrs(C), xy, z, 1/w]. Pixel
    centres are (x + 0.5, y_offset + y + 0.5), as the raster step forms them."""
    p = _pixel_centres(tri_id.shape, y_offset, data.device).to(data.dtype)
    bary_persp, _, depth = _barycentrics(data[..., c : c + 2], data[..., c + 2], data[..., c + 3], p, clamp)
    attrs = (bary_persp[..., None] * data[..., :c]).sum(dim=-2)
    return attrs, depth, tri_id >= 0


def _columns(t: torch.Tensor, cols: list) -> torch.Tensor:
    """``t[:, cols]``: the index list is copied to the tensor's device, which
    on the card waits for the stream (a host sync)."""
    with profiling.sync("edge_index"):
        return t[:, cols]


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
    xj, xk, yj, yk = _columns(x, j), _columns(x, k), _columns(y, j), _columns(y, k)
    a = yj - yk
    b = xk - xj
    c0 = (xk - xj) * (y[:, 0:1] - yj) - (yk - yj) * (x[:, 0:1] - xj)
    s = torch.sign(st.area)[:, None]  # inside ⇒ e_i ≥ 0 for either winding
    return a * s, b * s, c0 * s, x[:, 0], y[:, 0]


def _setup(verts_clip, tris, width, height, cull_backface, tri_mask) -> ScreenTris:
    if tris is None:  # corner-major: verts_clip is (T, 3, 4)
        return setup_corners(verts_clip, width, height, cull_backface, tri_mask)
    return setup_triangles(verts_clip, tris, width, height, cull_backface, tri_mask)


def _depth_at(px, py, ea, eb, ec, ex0, ey0, area, z, margin):
    """Per (pixel, triangle): the edge test and the plane depth in the jnp
    rasterizer's arithmetic → (inside, z). ``px``/``py`` (..., 1) and the
    per-triangle fields (TB, …) broadcast to (..., TB)."""
    e = (px[..., None] - ex0[:, None]) * ea + (py[..., None] - ey0[:, None]) * eb + ec  # (..., TB, 3)
    inside = (e >= -margin).all(dim=-1)
    bary = e / area.abs()[:, None]
    return inside, (bary * z).sum(dim=-1)


def rasterize(
    verts_clip: torch.Tensor,
    tris: torch.Tensor | None,
    *,
    width: int,
    height: int,
    rows: int | None = None,
    y_offset: int = 0,
    tile_h: int = 32,
    tile_w: int = 128,
    tri_block: int = 128,
    cull_backface: bool = True,
    tri_mask: torch.Tensor | None = None,
    z_floor: torch.Tensor | None = None,
    return_depth: bool = False,
    edge_margin_px: float = 0.0,
):
    """The JAX package's tiled jnp rasterizer, an oracle: the winning
    triangle id a pixel of the band [y_offset, y_offset+rows) → (rows, W)
    int32, −1 where nothing is drawn; with ``return_depth`` also its depth
    (+inf at background). Depth test LESS with z in [0, 1]; of equal depths
    the first triangle wins. ``tris`` None: ``verts_clip`` is corner-major
    (T, 3, 4).

    The band is cut into ``tile_h × tile_w`` tiles (padded to whole tiles,
    then cropped) and the triangles into blocks of ``tri_block``: a block
    runs only on the tiles its triangles' bboxes (+ margin) overlap, as in
    the JAX scan, with all of those tiles at once. ``z_floor`` (rows, W)
    keeps only fragments strictly behind it (the depth peel).
    ``edge_margin_px`` > 0 dilates each triangle (e_i ≥ −margin·|∇e_i|),
    clips the capture to its bbox + margin and clamps its depth to the
    vertex range: the jnp path's semantics, not kernel 5b's."""
    if rows is None:
        rows = height
    st = _setup(verts_clip, tris, width, height, cull_backface, tri_mask)
    dev = st.xy.device
    ea, eb, ec, ex0, ey0 = _edge_coeffs(st)
    margin = edge_margin_px * torch.sqrt(ea * ea + eb * eb) if edge_margin_px > 0.0 else torch.zeros_like(ea)
    big = 1e30
    x, y = st.xy[..., 0], st.xy[..., 1]
    x_min = torch.where(st.valid, x.amin(-1), big)
    x_max = torch.where(st.valid, x.amax(-1), -big)
    y_min = torch.where(st.valid, y.amin(-1), big)
    y_max = torch.where(st.valid, y.amax(-1), -big)

    tiles_y, tiles_x = -(-rows // tile_h), -(-width // tile_w)
    ty = torch.arange(tiles_y, device=dev).repeat_interleave(tiles_x)  # tile-major order
    tx = torch.arange(tiles_x, device=dev).repeat(tiles_y)
    tile_x0 = (tx * tile_w).to(torch.float32)
    tile_y0 = (float(y_offset) + ty * tile_h).to(torch.float32)
    # pixel centres of every tile: (ntiles, tile_h, tile_w, 1)
    py = (float(y_offset) + (ty[:, None] * tile_h + torch.arange(tile_h, device=dev)).to(torch.float32)) + 0.5
    px = ((tx[:, None] * tile_w + torch.arange(tile_w, device=dev)).to(torch.float32)) + 0.5
    py = py[:, :, None, None].expand(-1, -1, tile_w, 1)
    px = px[:, None, :, None].expand(-1, tile_h, -1, 1)
    zf = None
    if z_floor is not None:
        pad = torch.full((tiles_y * tile_h, tiles_x * tile_w), -torch.inf, device=dev)
        pad[:rows, :width] = z_floor
        zf = pad.reshape(tiles_y, tile_h, tiles_x, tile_w).permute(0, 2, 1, 3).reshape(-1, tile_h, tile_w)

    num_t = st.xy.shape[0]
    starts = list(range(0, num_t, tri_block))
    if starts:  # block bboxes against tile bounds, every (tile, block) at once: one host sync
        pad = (-num_t) % tri_block
        bb = [torch.nn.functional.pad(v, (0, pad), value=big if i % 2 == 0 else -big).reshape(-1, tri_block)
              for i, v in enumerate((x_min, x_max, y_min, y_max))]
        bb = [v.amin(-1) if i % 2 == 0 else v.amax(-1) for i, v in enumerate(bb)]
        mg = edge_margin_px
        overlaps = ((bb[0][None] <= (tile_x0 + tile_w + mg)[:, None]) & (bb[1][None] >= (tile_x0 - mg)[:, None])
                    & (bb[2][None] <= (tile_y0 + tile_h + mg)[:, None])
                    & (bb[3][None] >= (tile_y0 - mg)[:, None])).cpu()

    best_z = torch.full((tiles_y * tiles_x, tile_h, tile_w), torch.inf, device=dev)
    best_id = torch.full((tiles_y * tiles_x, tile_h, tile_w), BACKGROUND, dtype=torch.int32, device=dev)
    for k, s in enumerate(starts):
        sel = torch.nonzero(overlaps[:, k]).flatten().to(dev)
        if sel.numel() == 0:
            continue
        blk = slice(s, s + tri_block)
        pxs, pys = px[sel], py[sel]
        inside, zpix = _depth_at(pxs, pys, ea[blk], eb[blk], ec[blk], ex0[blk], ey0[blk], st.area[blk], st.z[blk],
                                 margin[blk])
        inside = inside & st.valid[blk]
        if edge_margin_px > 0.0:
            # a dilated sliver's band runs far along its line: clip to bbox + margin,
            # and clamp its extrapolated depth to the vertex range
            inside = (inside & (pxs >= x_min[blk] - edge_margin_px) & (pxs <= x_max[blk] + edge_margin_px)
                      & (pys >= y_min[blk] - edge_margin_px) & (pys <= y_max[blk] + edge_margin_px))
            zk = st.z[blk]
            zpix = torch.minimum(torch.maximum(zpix, zk.amin(-1)), zk.amax(-1))
        ok = inside & (zpix >= 0.0) & (zpix <= 1.0)
        if zf is not None:
            ok = ok & (zpix > zf[sel][..., None])
        zpix = torch.where(ok, zpix, torch.inf)
        zk, arg = zpix.min(dim=-1)  # the first of equal minima: the lower triangle id
        better = zk < best_z[sel]
        best_z[sel] = torch.where(better, zk, best_z[sel])
        best_id[sel] = torch.where(better, (arg + s).to(torch.int32), best_id[sel])

    def untile(t):
        return t.reshape(tiles_y, tiles_x, tile_h, tile_w).permute(0, 2, 1, 3).reshape(
            tiles_y * tile_h, tiles_x * tile_w)[:rows, :width]

    if return_depth:
        return untile(best_id), untile(best_z)
    return untile(best_id)


def rasterize_brute(
    verts_clip: torch.Tensor,
    tris: torch.Tensor | None,
    *,
    width: int,
    height: int,
    cull_backface: bool = True,
    tri_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """The brute oracle: every pixel of the frame against every triangle →
    (H, W) int32 ids, −1 at background; the argmin of depth, the first
    triangle on a tie. Must agree exactly with :func:`rasterize`. Rows go in
    chunks of ~2²⁴ (pixel, triangle, edge) values; each pixel still takes
    the argmin over every triangle."""
    st = _setup(verts_clip, tris, width, height, cull_backface, tri_mask)
    dev = st.xy.device
    ea, eb, ec, ex0, ey0 = _edge_coeffs(st)
    num_t = st.xy.shape[0]
    rows_per_chunk = max(1, (1 << 24) // max(1, width * num_t * 3))
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    out = []
    for r0 in range(0, height, rows_per_chunk):
        r1 = min(height, r0 + rows_per_chunk)
        py = (torch.arange(r0, r1, dtype=torch.float32, device=dev) + 0.5)[:, None, None]
        inside, z = _depth_at(px, py, ea, eb, ec, ex0, ey0, st.area, st.z, torch.zeros_like(ea))
        ok = inside & st.valid & (z >= 0.0) & (z <= 1.0)
        z = torch.where(ok, z, torch.inf)
        zmin, best = z.min(dim=-1)
        out.append(torch.where(torch.isfinite(zmin), best.to(torch.int32), BACKGROUND))
    return torch.cat(out)
