"""The plain reference renderer: the frame that the renderer under test should
produce, worked out again from the scene description and the seeded inputs.

Plain PyTorch, float32, no custom autograd functions and no kernels. It
imports nothing of the program under test. Where it must agree with the
program to the last bit for the comparison to mean anything (the
left-handed camera, the sphere mesh, the edge functions that decide which
pixel centre a triangle covers, the sampler's texel and weight arithmetic,
the IBL quadratures, the shading formulas of ``Default.hlsl`` and
``LightingUtil.hlsl``) it is a frozen copy of the plain arithmetic the
port documents, written out here.

It differs from the program in how it gets there:

* a z-buffer over each triangle's pixel bounding box (a scatter-min of
  ``(depth bits << 32) | triangle id``), not a tile binning;
* barycentric interpolation of the winner's corners, not plane records;
* per-slot sampling of the seeded pages and of a mip chain it builds
  itself, not the program's combined quad pages;
* IBL maps it builds itself from the environment.

``tf32=True`` computes the reference one precision step lower: the
operands of every product that a matrix multiply would form (the instance
transform, the view-projection, the uv transform and the IBL quadratures)
rounded to TF32's 10-bit mantissa. That is the control that the comparison
has to fail.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

PI_HLSL = 3.14159265359  # LightingUtil.hlsl:59,103
MIN_ROUGHNESS = 0.05
W_EPS = 1e-6
INV_2PI = 0.1591  # LightingUtil.hlsl:219's truncated constants
INV_PI = 0.3183
SH_COEFFS = (0.429043, 0.511664, 0.743125, 0.886227, 0.247708)
NO_HIT = torch.iinfo(torch.int64).max
CANDIDATE_BLOCK = 1 << 23  # (triangle, pixel) candidates a raster step holds

SLOTS = ("diffuse", "specular", "metallic", "roughness", "normal", "displacement", "bump",
         "ambient_occlusion", "cavity", "sheen", "emissive", "opacity")
SLOT = {name: i for i, name in enumerate(SLOTS)}
BANK_FLOAT_FIELDS = ("diffuse", "metallic", "fresnel_r0", "roughness", "opacity", "height_scale",
                     "uv_transform", "has_tex")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest value with a 10-bit mantissa (TF32's operand
    rounding), differentiable straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def sphere_arrays(radius: float, slices: int, stacks: int):
    """The reference's UV sphere (Mesh.h:489-565): north pole, rings of
    slices+1 columns (seam duplicated), south pole; tangent = dP/dθ,
    bitangent = normal × tangent, uv = (θ/2π, φ/π)."""
    ring_count, ring_verts = stacks - 1, slices + 1
    nv = 2 + ring_count * ring_verts
    phi = (np.arange(1, stacks)[:, None]) * (math.pi / stacks)
    theta = (np.arange(ring_verts)[None, :]) * (2.0 * math.pi / slices)
    sp, cp, st, ct = np.sin(phi), np.cos(phi), np.sin(theta), np.cos(theta)
    pos, nrm, tan, bit = (np.zeros((nv, 3), np.float32) for _ in range(4))
    uv = np.zeros((nv, 2), np.float32)
    pos[0], nrm[0], tan[0], bit[0] = (0.0, radius, 0.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, -1.0)
    pos[-1], nrm[-1], tan[-1], bit[-1] = (0.0, -radius, 0.0), (0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)
    uv[-1] = (0.0, 1.0)
    ring_pos = np.stack([radius * sp * ct, np.broadcast_to(radius * cp, (ring_count, ring_verts)),
                         radius * sp * st], axis=-1).reshape(-1, 3)
    ring_nrm = ring_pos / np.linalg.norm(ring_pos, axis=-1, keepdims=True)
    ring_tan = np.stack([-radius * sp * st, np.zeros((ring_count, ring_verts)), radius * sp * ct],
                        axis=-1).reshape(-1, 3)
    pos[1:-1], nrm[1:-1], tan[1:-1] = ring_pos, ring_nrm, ring_tan
    bit[1:-1] = np.cross(ring_nrm, ring_tan)
    uv[1:-1] = np.stack([np.broadcast_to(theta / (2.0 * math.pi), (ring_count, ring_verts)),
                         np.broadcast_to(phi / math.pi, (ring_count, ring_verts))], axis=-1).reshape(-1, 2)
    tris = [(0, i + 1, i) for i in range(1, slices + 1)]
    for i in range(stacks - 2):
        for j in range(slices):
            a = 1 + i * ring_verts + j
            c = 1 + (i + 1) * ring_verts + j
            tris += [(a, a + 1, c), (c, a + 1, c + 1)]
    south = nv - 1
    tris += [(south, south - ring_verts + i, south - ring_verts + i + 1) for i in range(slices)]
    return pos, nrm, tan, bit, uv, np.asarray(tris, np.int64)


def corner_attrs(slices: int, stacks: int, translations, material_ids, device, tf32: bool = False):
    """World-space corner attributes (T, 3, 14) [pos, normal, tangent,
    bitangent, uv] of unit spheres translated to ``translations`` (I, 3),
    instance-major, and the face material (T,). Directions take the 3x3
    (here the identity) without inverse-transpose, as Default.hlsl:27-35."""
    pos, nrm, tan, bit, uv, tris = sphere_arrays(1.0, slices, stacks)
    f = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    blocks = torch.stack([f(pos), f(nrm), f(tan), f(bit)], dim=-2)[f(tris)]  # (Tb, 3, 4, 3)
    worlds = torch.zeros((len(translations), 4, 4), dtype=torch.float32, device=device)
    worlds[:, 0, 0] = worlds[:, 1, 1] = worlds[:, 2, 2] = worlds[:, 3, 3] = 1.0
    worlds[:, 3, :3] = torch.as_tensor(np.asarray(translations, np.float32), device=device)
    rot = worlds[:, :3, :3].reshape(-1, 1, 1, 1, 3, 3)
    lb = blocks[None]
    if tf32:
        rot, lb = round_tf32(rot), round_tf32(lb)
    wb = lb[..., 0:1] * rot[..., 0, :] + lb[..., 1:2] * rot[..., 1, :] + lb[..., 2:3] * rot[..., 2, :]
    trans = worlds[:, 3, :3].reshape(-1, 1, 1, 3)
    wb = torch.cat([wb[..., 0:1, :] + trans[..., None, :], wb[..., 1:, :]], dim=-2)
    num_i, tb = worlds.shape[0], tris.shape[0]
    world = wb.reshape(num_i, tb, 3, 12)
    uv_c = f(uv)[f(tris)]
    attrs = torch.cat([world, uv_c[None].expand(num_i, tb, 3, 2)], dim=-1).reshape(-1, 3, 14)
    mats = torch.as_tensor(np.asarray(material_ids, np.int64), device=device)[:, None].expand(num_i, tb)
    return attrs.contiguous(), mats.reshape(-1)


def _normalize(v, eps=1e-20):
    n2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return v * torch.rsqrt(torch.clamp(n2, min=eps))[..., None]


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _max(x, c: float):
    return torch.maximum(x, x.new_full((), c))


def _clip(x, lo: float, hi: float):
    return torch.minimum(_max(x, lo), x.new_full((), hi))


def view_proj(position, yaw, pitch, aspect: float, fov_y: float = math.pi / 4.0, near: float = 0.1,
              far: float = 100.0) -> torch.Tensor:
    """Row-vector LH view × perspective (XMMatrixLookToLH, PerspectiveFovLH),
    forward from yaw and pitch (MathUtil.h:349-364), as explicit sums."""
    dev = position.device
    cp = torch.cos(pitch)
    fwd = torch.stack([cp * torch.sin(yaw), torch.sin(pitch), cp * torch.cos(yaw)], dim=-1)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    f = _normalize(fwd)
    s = _normalize(torch.linalg.cross(up, f, dim=-1))
    u = torch.linalg.cross(f, s, dim=-1)
    rot = torch.stack([s, u, f], dim=-1)
    top = torch.cat([rot, torch.zeros((3, 1), dtype=rot.dtype, device=dev)], dim=1)
    last = torch.cat([torch.stack([-_dot(s, position), -_dot(u, position), -_dot(f, position)]),
                      torch.ones((1,), dtype=rot.dtype, device=dev)])
    view = torch.cat([top, last[None, :]], dim=0)
    h = 1.0 / torch.tan(torch.tensor(fov_y * 0.5, dtype=torch.float32))
    zr = far / (far - near)
    proj = torch.zeros((4, 4), dtype=torch.float32)
    proj[0, 0], proj[1, 1], proj[2, 2], proj[2, 3], proj[3, 2] = h / aspect, h, zr, 1.0, -near * zr
    proj = proj.to(dev)
    return (view[:, 0:1] * proj[0:1, :] + view[:, 1:2] * proj[1:2, :] + view[:, 2:3] * proj[2:3, :]
            + view[:, 3:4] * proj[3:4, :])


def to_clip(points: torch.Tensor, m: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    if tf32:
        points, m = round_tf32(points), round_tf32(m)
    return points[..., 0:1] * m[0] + points[..., 1:2] * m[1] + points[..., 2:3] * m[2] + m[3]


def project(clip: torch.Tensor, width: int, height: int):
    w = clip[..., 3]
    inv_w = torch.where(w.abs() > W_EPS, 1.0 / w, torch.zeros_like(w))
    ndc = clip[..., :3] * inv_w[..., None]
    px = (ndc[..., 0] + 1.0) * (0.5 * width)
    py = (1.0 - ndc[..., 1]) * (0.5 * height)
    return torch.stack([px, py], dim=-1), ndc[..., 2], inv_w


def front_triangles(clip: torch.Tensor, width: int, height: int):
    """Screen setup → (xy (T,3,2), z (T,3), area (T,), valid (T,) bool): in
    front (every w > eps) and front-facing (clockwise, area > 1e-12)."""
    xy, z, _ = project(clip, width, height)
    e01, e02 = xy[:, 1] - xy[:, 0], xy[:, 2] - xy[:, 0]
    area = e01[:, 0] * e02[:, 1] - e01[:, 1] * e02[:, 0]
    valid = (clip[..., 3] > W_EPS).all(dim=-1) & (area > 1e-12)
    return xy, z, area, valid


def rasterize(clip: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(H, W) winning triangle id, −1 at background: each front-facing
    triangle tests the pixel centres of its bounding box (+1 pixel) with
    edge functions relative to corner 0, e_i = dx·a_i + dy·b_i + c_i ≥ 0,
    and depth in [0, 1] from its plane; the least depth wins, then the
    lower id."""
    dev = clip.device
    xy, z, area, valid = front_triangles(clip, width, height)
    x, y = xy[..., 0], xy[..., 1]
    j, k = [1, 2, 0], [2, 0, 1]
    a = y[:, j] - y[:, k]
    b = x[:, k] - x[:, j]
    c0 = (x[:, k] - x[:, j]) * (y[:, 0:1] - y[:, j]) - (y[:, k] - y[:, j]) * (x[:, 0:1] - x[:, j])
    inv_area = 1.0 / area.abs()
    plane = lambda coef: (coef[:, 0] * z[:, 0] + coef[:, 1] * z[:, 1] + coef[:, 2] * z[:, 2]) * inv_area  # noqa: E731
    za, zb, zc = plane(a), plane(b), plane(c0)
    ids = torch.nonzero(valid).squeeze(1)
    x0p = torch.floor(x[ids].amin(-1) - 0.5).clamp(0, width - 1).long() - 1
    x1p = torch.ceil(x[ids].amax(-1) - 0.5).clamp(0, width - 1).long() + 1
    y0p = torch.floor(y[ids].amin(-1) - 0.5).clamp(0, height - 1).long() - 1
    y1p = torch.ceil(y[ids].amax(-1) - 0.5).clamp(0, height - 1).long() + 1
    x0p, y0p = x0p.clamp(min=0), y0p.clamp(min=0)
    x1p, y1p = x1p.clamp(max=width - 1), y1p.clamp(max=height - 1)
    bw = (x1p - x0p + 1).clamp(min=0)
    count = bw * (y1p - y0p + 1).clamp(min=0)
    best = torch.full((height * width,), NO_HIT, dtype=torch.int64, device=dev)
    ends = torch.cumsum(count, 0)
    total = int(ends[-1]) if ends.numel() else 0
    lo = 0
    while lo < total:
        # triangles whose candidates start in [lo, lo + CANDIDATE_BLOCK)
        t0 = int(torch.searchsorted(ends, torch.tensor(lo, device=dev), right=True))
        t1 = max(t0 + 1, int(torch.searchsorted(ends, torch.tensor(lo + CANDIDATE_BLOCK, device=dev))))
        sel = slice(t0, t1)
        cnt = count[sel]
        start = ends[sel] - cnt
        lo = int(ends[t1 - 1])
        owner = torch.repeat_interleave(torch.arange(t1 - t0, device=dev), cnt)
        off = torch.arange(owner.numel(), device=dev) - (start - start[0])[owner]
        tid = ids[sel][owner]
        ix = x0p[sel][owner] + off % bw[sel][owner]
        iy = y0p[sel][owner] + off // bw[sel][owner]
        dx = (ix.to(torch.float32) + 0.5) - x[tid, 0]
        dy = (iy.to(torch.float32) + 0.5) - y[tid, 0]
        ok = torch.ones_like(dx, dtype=torch.bool)
        for i in range(3):
            ok &= dx * a[tid, i] + dy * b[tid, i] + c0[tid, i] >= 0.0
        zp = dx * za[tid] + dy * zb[tid] + zc[tid]
        ok &= (zp >= 0.0) & (zp <= 1.0)
        key = ((zp + 0.0).view(torch.int32).to(torch.int64) << 32) | tid
        best.scatter_reduce_(0, (iy * width + ix)[ok], key[ok], "amin")
    tri_id = torch.where(best == NO_HIT, -1, best & 0xFFFFFFFF)
    return tri_id.reshape(height, width)


def interpolate(attrs: torch.Tensor, clip: torch.Tensor, tri_id: torch.Tensor, width: int, height: int):
    """Perspective-correct barycentric interpolation of the winners' corner
    attributes at the pixel centres → (H, W, C), zeros at background (the
    G-buffer's background)."""
    xy, z, inv_w = project(clip, width, height)
    hit = tri_id >= 0
    t = tri_id.clamp(min=0)
    cxy, cinv = xy[t], inv_w[t]  # (H, W, 3, 2), (H, W, 3)
    py = (torch.arange(height, dtype=torch.float32, device=clip.device) + 0.5)[:, None]
    px = (torch.arange(width, dtype=torch.float32, device=clip.device) + 0.5)[None, :]
    p = torch.stack(torch.broadcast_tensors(px, py), dim=-1)

    def edge(pa, pb):
        return (p[..., 0] - pa[..., 0]) * (pb[..., 1] - pa[..., 1]) - (p[..., 1] - pa[..., 1]) * (pb[..., 0] - pa[..., 0])

    e = torch.stack([edge(cxy[..., 1, :], cxy[..., 2, :]), edge(cxy[..., 2, :], cxy[..., 0, :]),
                     edge(cxy[..., 0, :], cxy[..., 1, :])], dim=-1)
    area = e.sum(-1)
    area = torch.where(area.abs() < 1e-12, 1e-12, area)
    pw = e / area[..., None] * cinv
    denom = pw.sum(-1, keepdim=True)
    bary = pw / torch.where(denom.abs() < 1e-20, 1e-20, denom)
    out = (bary[..., None] * attrs[t]).sum(dim=-2)
    return torch.where(hit[..., None], out, 0.0)


# ---------------------------------------------------------------------------
# Textures
# ---------------------------------------------------------------------------


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4))


@dataclasses.dataclass(frozen=True)
class Pages:
    """Texture pages (N, S, S, 4) linear float32 and their 2×2 box mip
    chain, stacked level-major into one (R, 4) table."""

    stack: torch.Tensor
    num_pages: int
    size: int
    num_levels: int

    @staticmethod
    def build(pages_u8: torch.Tensor, srgb: list[bool]) -> "Pages":
        """``pages_u8`` (N, S, S, 3) uint8; sRGB pages decoded before the filter."""
        lin = pages_u8.to(torch.float32) / 255.0
        flags = torch.as_tensor(srgb, device=lin.device)[:, None, None, None]
        lin = torch.where(flags, srgb_to_linear(lin), lin)
        level = torch.cat([lin, torch.ones_like(lin[..., :1])], dim=-1)
        n, s = level.shape[0], level.shape[1]
        levels = [level]
        while levels[-1].shape[1] > 1:
            prev = levels[-1]
            h = prev.shape[1]
            levels.append(prev.reshape(n, h // 2, 2, h // 2, 2, 4).mean(dim=(2, 4)))
        return Pages(stack=torch.cat([m.reshape(-1, 4) for m in levels]), num_pages=n, size=s,
                     num_levels=len(levels))

    def sample_level(self, page, uv, level) -> torch.Tensor:
        """Bilinear, u and v wrapping, at an integer level (tensor) → (..., 4)."""
        n, s = self.num_pages, self.size
        sl = torch.bitwise_right_shift(torch.full_like(level, s), level)
        base = (4 * n * (s * s - sl * sl)) // 3 + page * (sl * sl)
        slf = sl.to(torch.float32)
        xf, yf = uv[..., 0] * slf - 0.5, uv[..., 1] * slf - 0.5
        x0f, y0f = torch.floor(xf), torch.floor(yf)
        fx, fy = (xf - x0f)[..., None], (yf - y0f)[..., None]
        x0, y0 = x0f.detach().to(torch.int64), y0f.detach().to(torch.int64)
        m = sl - 1
        x0w, x1w, y0w, y1w = x0 & m, (x0 + 1) & m, y0 & m, (y0 + 1) & m
        tap = lambda iy, ix: self.stack[base + iy * sl + ix]  # noqa: E731
        top = tap(y0w, x0w) * (1.0 - fx) + tap(y0w, x1w) * fx
        bot = tap(y1w, x0w) * (1.0 - fx) + tap(y1w, x1w) * fx
        return top * (1.0 - fy) + bot * fy

    def sample(self, page, uv, lod=None) -> torch.Tensor:
        """Bilinear at level 0, or trilinear at ``lod``."""
        if lod is None:
            return self.sample_level(page, uv, torch.zeros_like(page))
        lodc = _clip(lod, 0.0, self.num_levels - 1.0)
        l0 = torch.floor(lodc)
        frac = (lodc - l0)[..., None]
        l0i = l0.detach().to(torch.int64)
        l1i = torch.clamp(l0i + 1, max=self.num_levels - 1)
        return self.sample_level(page, uv, l0i) * (1.0 - frac) + self.sample_level(page, uv, l1i) * frac


def screen_space_lod(uv: torch.Tensor, tex_size: int) -> torch.Tensor:
    """log2 of the larger screen-space texel footprint axis; forward
    differences, the last column and row replicating their neighbour's."""
    ddx = uv[:, 1:, :] - uv[:, :-1, :]
    ddx = torch.cat([ddx, ddx[:, -1:, :]], dim=1)
    ddy = uv[1:, :, :] - uv[:-1, :, :]
    ddy = torch.cat([ddy, ddy[-1:, :, :]], dim=0)
    r2 = torch.maximum(torch.sum(ddx * ddx, dim=-1), torch.sum(ddy * ddy, dim=-1)) * float(tex_size) ** 2
    return _max(0.5 * torch.log2(_max(r2, 1e-12)), 0.0)


# ---------------------------------------------------------------------------
# Environment: sky and image-based lighting
# ---------------------------------------------------------------------------


def world_to_sky_uv(d: torch.Tensor) -> torch.Tensor:
    """Equirect uv of a direction: ``atan2(z, x)`` and ``asin(clamp(y))``,
    the same bits at every input. The mapping has no derivative at the poles
    and on the y axis, where autograd's would be inf or NaN, so there it is 0
    and everywhere else autograd's, bit for bit: ``v``'s is 0 where |y| >= 1
    (the clamp's zero extended to its bounds), ``u``'s where 1 / (x^2 + z^2)
    is not finite (x = z = 0) or x or z is not finite."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    off_pole = torch.abs(y) < 1.0
    off_axis = torch.isfinite(torch.reciprocal(z * z + x * x)) & torch.isfinite(x) & torch.isfinite(z)
    # d with each singular component replaced by a regular one, for the gradient's path. It keeps d's
    # (..., 3) layout, and the clamp (a no-op there) hands asin a contiguous tensor, as in the plain
    # formula: CPU kernels pick their code path by layout, and only the same path gives the same bits.
    safe = torch.stack([torch.where(off_axis, x, 1.0), torch.where(off_pole, y, 0.0), torch.where(off_axis, z, 0.0)],
                       dim=-1)
    angle = torch.where(off_axis, torch.atan2(safe[..., 2], safe[..., 0]), torch.atan2(z, x).detach())
    lat = torch.where(off_pole, torch.asin(torch.clamp(safe[..., 1], -1.0, 1.0)),
                      torch.asin(torch.clamp(y, -1.0, 1.0)).detach())
    u = angle * INV_2PI + 0.5
    v = lat * INV_PI + 0.5
    return torch.stack([1.0 - u + 0.25, 1.0 - v], dim=-1)


def equirect_taps(uv: torch.Tensor, h: int, w: int):
    x, y = uv[..., 0] * w - 0.5, uv[..., 1] * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0f)[..., None], (y - y0f)[..., None]
    x0, y0 = x0f.detach().to(torch.int64), y0f.detach().to(torch.int64)
    x0w, x1w = torch.remainder(x0, w), torch.remainder(x0 + 1, w)
    y0w, y1w = torch.remainder(y0, h), torch.remainder(y0 + 1, h)
    return (y0w * w + x0w, y0w * w + x1w, y1w * w + x0w, y1w * w + x1w), fx, fy


def bilinear(taps, fx, fy):
    t00, t01, t10, t11 = taps
    return (t00 * (1.0 - fx) + t01 * fx) * (1.0 - fy) + (t10 * (1.0 - fx) + t11 * fx) * fy


def sample_equirect(env: torch.Tensor, uv: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    h, w, c = env.shape
    idx, fx, fy = equirect_taps(uv, h, w)
    flat = env.reshape(h * w, c)
    taps = [flat[i].to(torch.float32) for i in idx]
    if scale is not None:
        taps = [t * scale for t in taps]
    return bilinear(taps, fx, fy)


def ray_directions(vp: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Unit world-space view ray of each pixel centre: the NDC points at z =
    0 and 0.5 through the inverse view-projection."""
    dev = vp.device
    m = torch.linalg.inv_ex(vp).inverse
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None] + 0.5
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
    ndc_x = (px / width * 2.0 - 1.0).expand(height, width)
    ndc_y = (1.0 - py / height * 2.0).expand(height, width)

    def unproject(zv: float):
        col = lambda jj: ndc_x * m[0, jj] + ndc_y * m[1, jj] + zv * m[2, jj] + m[3, jj]  # noqa: E731
        return torch.stack([col(0), col(1), col(2)], dim=-1) / col(3)[..., None]

    return _normalize(unproject(0.5) - unproject(0.0))


def _sky_dir(u, v):
    theta, phi = (0.75 - u) / INV_2PI, (0.5 - v) / INV_PI
    c = torch.cos(phi)
    return torch.stack([c * torch.cos(theta), torch.sin(phi), c * torch.sin(theta)], dim=-1)


def _grid(h: int, w: int, device):
    v = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    u = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    solid = (torch.cos((0.5 - vv) / INV_PI) * ((1.0 / h) / INV_PI) * ((1.0 / w) / INV_2PI)).reshape(-1)
    return _sky_dir(uu, vv).reshape(-1, 3), solid


def _resize_env(env, h, w):
    eh, ew, c = env.shape
    if (eh, ew) == (h, w):
        return env
    if eh % h == 0 and ew % w == 0:
        return env.reshape(h, eh // h, w, ew // w, c).mean(dim=(1, 3))
    vs = (torch.arange(h, dtype=torch.float32, device=env.device) + 0.5) / h
    us = (torch.arange(w, dtype=torch.float32, device=env.device) + 0.5) / w
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    return sample_equirect(env, torch.stack([uu, vv], dim=-1))


def _matmul(a, b, tf32):
    return torch.matmul(round_tf32(a), round_tf32(b)) if tf32 else torch.matmul(a, b)


@dataclasses.dataclass(frozen=True)
class IBL:
    """The maps the merged-IBL tail reads: the SH9 projection of the
    environment and the GGX-prefiltered levels stacked on channels, whose
    taps are read rounded to float16."""

    sh9: torch.Tensor  # (9, 3)
    stack_f16: torch.Tensor  # (H0, W0, 15)
    num_levels: int

    @staticmethod
    def build(env: torch.Tensor, tf32: bool = False, samples: int = 64, base=(64, 128), levels: int = 5) -> "IBL":
        dev = env.device
        small = _resize_env(env, samples, samples * 2)
        l_dirs, solid = _grid(samples, samples * 2, dev)
        flat = small.reshape(-1, 3)
        out = []
        for lvl in range(levels):
            h, w = max(base[0] >> lvl, 4), max(base[1] >> lvl, 8)
            n_dirs, _ = _grid(h, w, dev)
            alpha = MIN_ROUGHNESS ** 2 if lvl == 0 else max(lvl / (levels - 1), MIN_ROUGHNESS) ** 2
            a2 = alpha * alpha
            rows = []
            for s in range(0, n_dirs.shape[0], 1024):
                n = n_dirs[s:s + 1024]
                cos_nl = n[:, 0:1] * l_dirs[:, 0] + n[:, 1:2] * l_dirs[:, 1] + n[:, 2:3] * l_dirs[:, 2]
                denom = (1.0 + cos_nl) * 0.5 * (a2 - 1.0) + 1.0
                wgt = a2 / (math.pi * denom * denom) * torch.clamp(cos_nl, min=0.0) * solid[None, :]
                wgt = wgt / torch.clamp(wgt.sum(dim=-1, keepdim=True), min=1e-12)
                rows.append(_matmul(wgt, flat, tf32))
            out.append(torch.cat(rows).reshape(h, w, 3))
        stack = torch.cat([out[0], *(_resize_env(m, out[0].shape[0], out[0].shape[1]) for m in out[1:])], dim=-1)
        x, y, z = l_dirs[:, 0], l_dirs[:, 1], l_dirs[:, 2]
        basis = torch.stack([0.282095 * torch.ones_like(x), 0.488603 * y, 0.488603 * z, 0.488603 * x,
                             1.092548 * x * y, 1.092548 * y * z, 0.315392 * (3.0 * z * z - 1.0),
                             1.092548 * x * z, 0.546274 * (x * x - y * y)])
        sh9 = _matmul(basis * solid[None, :], flat, tf32)
        return IBL(sh9=sh9, stack_f16=stack.to(torch.float16), num_levels=levels)


def sh9_irradiance(sh, n):
    c1, c2, c3, c4, c5 = SH_COEFFS
    x, y, z = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    e = (c1 * sh[8] * (x * x - y * y) + c3 * sh[6] * (z * z) + c4 * sh[0] - c5 * sh[6]
         + 2.0 * c1 * (sh[4] * x * y + sh[7] * x * z + sh[5] * y * z)
         + 2.0 * c2 * (sh[3] * x + sh[1] * y + sh[2] * z))
    return e * (1.0 / math.pi)


def env_brdf_approx(ndotv, roughness):
    r40, r41 = roughness * -1.0 + 1.0, roughness * -0.0275 + 0.0425
    r42, r43 = roughness * -0.572 + 1.04, roughness * 0.022 + -0.04
    a004 = torch.minimum(r40 * r40, torch.exp2(-9.28 * ndotv)) * r40 + r41
    return torch.stack([a004 * -1.04 + r42, a004 * 1.04 + r43], dim=-1)


def specular_levels_lerp(smp_all, roughness, num_levels):
    lod = torch.minimum(torch.maximum(roughness, roughness.new_zeros(())), roughness.new_ones(()))
    lod = lod * (num_levels - 1)
    l0 = torch.floor(lod)
    frac = (lod - l0)[..., None]
    l1 = torch.clamp(l0 + 1, 0, num_levels - 1)
    pre0 = torch.zeros(smp_all.shape[:-1] + (3,), dtype=smp_all.dtype, device=smp_all.device)
    pre1 = torch.zeros_like(pre0)
    for li in range(num_levels):
        smp = smp_all[..., 3 * li:3 * li + 3]
        pre0 = pre0 + (l0 == li).to(smp.dtype)[..., None] * smp
        pre1 = pre1 + (l1 == li).to(smp.dtype)[..., None] * smp
    return pre0 * (1.0 - frac) + pre1 * frac


def tonemap(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, min=0.0)
    return torch.pow(torch.clamp(c / (c + 1.0), min=1e-8), 1.0 / 2.2)


# ---------------------------------------------------------------------------
# Shading (Default.hlsl:47-161, LightingUtil.hlsl:35-214)
# ---------------------------------------------------------------------------


def cook_torrance(albedo, metallic, f0, rough, radiance, n, v, l, h):
    r = _max(rough, MIN_ROUGHNESS)
    a2 = (r * r) * (r * r)
    ndoth = _max(_dot(n, h), 0.0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    ndf = a2 / (PI_HLSL * denom * denom)
    k = (rough + 1.0) * (rough + 1.0) / 8.0
    ndotv, ndotl = _max(_dot(n, v), 0.0), _max(_dot(n, l), 0.0)
    g = ndotv / (ndotv * (1.0 - k) + k) * (ndotl / (ndotl * (1.0 - k) + k))
    f = f0 + (1.0 - f0) * torch.pow(1.0 - _clip(_dot(h, v)[..., None], 0.0, 1.0), 5.0)
    den = 4.0 * _max(_dot(n, v), 0.0) * _max(_dot(n, l), 0.0) + 1e-3
    spec = (ndf * g)[..., None] * f / den[..., None]
    kd = (1.0 - f) * (1.0 - metallic)[..., None]
    return (kd * albedo / PI_HLSL + spec) * radiance * _max(_dot(n, l), 0.0)[..., None]


def props_table(bank: dict) -> torch.Tensor:
    """(M, 28): diffuse, metallic, F0, roughness, opacity, height scale, the
    uv transform (6), has_tex (12)."""
    return torch.cat([bank["diffuse"], bank["metallic"][:, None], bank["fresnel_r0"], bank["roughness"][:, None],
                      bank["opacity"][:, None], bank["height_scale"][:, None], bank["uv_transform"].reshape(-1, 6),
                      bank["has_tex"]], dim=-1)


def shade(gbuf, mid, bank, tex_index, has_built, pages: Pages, lights, ambient, eye, *, mip_lod: bool,
          ibl: IBL | None, tf32: bool = False):
    """The PS stage over a (H, W) G-buffer → (hdr, opacity[, spec_f, rdir,
    roughness]). Each bound slot is sampled from its page and weighted by
    ``has_built`` (the slot bindings the scene was built with: an unbound
    slot reads 0), then blended with the constant by the bank's ``has_tex``."""
    pos_w, normal_w, tan_w, bit_w, uv = gbuf[..., 0:3], gbuf[..., 3:6], gbuf[..., 6:9], gbuf[..., 9:12], gbuf[..., 12:14]
    m = bank["diffuse"].shape[0]
    mid = mid.long().clamp(0, m - 1)
    n_geom = _normalize(normal_w)
    v = _normalize(eye - pos_w)
    props = props_table(bank)[mid]
    c_diffuse, c_metallic, c_f0 = props[..., 0:3], props[..., 3], props[..., 4:7]
    c_rough, c_opacity = props[..., 7], props[..., 8]
    has = props[..., 16:28]
    a = props[..., 10:16].reshape(*uv.shape[:-1], 3, 2)
    if tf32:
        uv, a = round_tf32(uv), round_tf32(a)
    uv_t = uv[..., 0:1] * a[..., 0, :] + uv[..., 1:2] * a[..., 1, :] + a[..., 2, :]
    lod = screen_space_lod(uv_t, pages.size) if mip_lod else None
    pidx, built = tex_index[mid], has_built[mid]

    def tex(slot, ch):
        s = SLOT[slot]
        return pages.sample(pidx[..., s], uv_t, lod)[..., :ch] * built[..., s:s + 1]

    h = lambda s: has[..., SLOT[s]:SLOT[s] + 1]  # noqa: E731
    albedo = h("diffuse") * tex("diffuse", 3) + (1.0 - h("diffuse")) * c_diffuse
    metallic = (h("metallic") * tex("metallic", 1) + (1.0 - h("metallic")) * c_metallic[..., None])[..., 0]
    f0_const = c_f0 + (albedo - c_f0) * metallic[..., None]
    f0 = h("specular") * tex("specular", 3) + (1.0 - h("specular")) * f0_const
    rough = (h("roughness") * tex("roughness", 1) + (1.0 - h("roughness")) * c_rough[..., None])[..., 0]
    nt = 2.0 * tex("normal", 3) - 1.0
    n_mapped = nt[..., 0:1] * tan_w + nt[..., 1:2] * bit_w + nt[..., 2:3] * n_geom
    n = h("normal") * n_mapped + (1.0 - h("normal")) * n_geom
    opacity = (h("opacity") * tex("opacity", 1) + (1.0 - h("opacity")) * c_opacity[..., None])[..., 0]

    direct = torch.zeros_like(albedo)
    for i in range(lights["strength"].shape[0]):
        l_dir = (-lights["direction"][i]).expand_as(v)
        direct = direct + cook_torrance(albedo, metallic, f0, rough, lights["strength"][i], n, v, l_dir,
                                        _normalize(v + l_dir))
    if ibl is None:
        return ambient * albedo + direct, opacity
    n_unit = _normalize(n)
    ndotv = _max(_dot(n_unit, v), 0.0)
    ks = f0 + (1.0 - f0) * torch.pow(1.0 - ndotv, 5.0)[..., None]
    kd = (1.0 - ks) * (1.0 - metallic)[..., None]
    ab = env_brdf_approx(ndotv, rough)
    spec_f = f0 * ab[..., 0:1] + ab[..., 1:2]
    rdir = _normalize(2.0 * ndotv[..., None] * n_unit - v)
    lit = direct + kd * sh9_irradiance(ibl.sh9, n_unit) * albedo
    return lit, opacity, spec_f, rdir, rough


# ---------------------------------------------------------------------------
# The frame
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RefScene:
    """What the reference renders: corner geometry, the material bank (its
    float fields by name, the page of each slot, the build-time bindings),
    the pages, the directional lights, ambient and clear colour, and the
    environment (its sky and IBL maps) when there is one."""

    corners: torch.Tensor  # (T, 3, 14)
    face_material: torch.Tensor  # (T,)
    bank: dict
    tex_index: torch.Tensor  # (M, 12) int64
    has_built: torch.Tensor  # (M, 12) f32
    pages: Pages
    lights: dict  # strength (L, 3), direction (L, 3)
    ambient: torch.Tensor
    clear_color: torch.Tensor
    mip_lod: bool
    sky_u8: torch.Tensor | None = None
    ibl: IBL | None = None


def render(scene: RefScene, position, yaw, pitch, width: int, height: int, bank: dict | None = None,
           tf32: bool = False):
    """One tonemapped RGBA frame (H, W, 4) at the camera pose; ``bank``
    replaces the scene's float fields (the training step's leaves)."""
    bank = scene.bank if bank is None else bank
    vp = view_proj(position, yaw, pitch, width / height)
    clip = to_clip(scene.corners[..., 0:3], vp, tf32)
    with torch.no_grad():
        tri_id = rasterize(clip.detach(), width, height)
    hit = tri_id >= 0
    gbuf = interpolate(scene.corners, clip, tri_id, width, height)
    mid = torch.where(hit, scene.face_material[tri_id.clamp(min=0)], 0)
    shaded = shade(gbuf, mid, bank, scene.tex_index, scene.has_built, scene.pages, scene.lights, scene.ambient,
                   position, mip_lod=scene.mip_lod, ibl=scene.ibl, tf32=tf32)
    hdr, opacity = shaded[0], shaded[1]
    if scene.ibl is not None:
        spec_f, rdir, rough = shaded[2:]
        idx, fx, fy = equirect_taps(world_to_sky_uv(rdir), scene.ibl.stack_f16.shape[0],
                                    scene.ibl.stack_f16.shape[1])
        flat = scene.ibl.stack_f16.reshape(-1, scene.ibl.stack_f16.shape[-1])
        smp = bilinear([flat[i].to(torch.float32) for i in idx], fx, fy)
        smp = torch.where(hit[..., None], smp, 0.0)
        hdr = hdr + spec_f * specular_levels_lerp(smp, rough, scene.ibl.num_levels)
    fg = tonemap(hdr)
    if scene.sky_u8 is not None:
        bg = tonemap(sample_equirect(scene.sky_u8, world_to_sky_uv(ray_directions(vp, width, height)),
                                     scale=1.0 / 255.0))
    else:
        bg = scene.clear_color
    mf = hit[..., None].to(torch.float32)
    rgb = mf * fg + (1.0 - mf) * bg
    alpha = mf[..., 0] * opacity + (1.0 - mf[..., 0])
    return torch.cat([rgb, alpha[..., None]], dim=-1)
