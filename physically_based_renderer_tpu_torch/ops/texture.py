"""Texture atlas, mip pyramid, bilinear/trilinear sampling, and equirect
sampling — the counterpart of ``physically_based_renderer_tpu/ops/texture.py``.

**Atlas.** Every texture page of a scene lives in one :class:`TextureAtlas`
(a mip pyramid of (N, S>>l, S>>l, 4) f32 pages, sRGB decoded at build, a 2×2
box-filter chain), sampled by (page, uv) with u and v wrapping
(``g_SamAnisotropicWrap``): bilinear at mip 0 (the reference's 1-mip loads,
``WICTextureLoader.h:78``), or trilinear at a screen-space LOD from a
level-major stack of the pyramid (``stack_mips``: per-pixel level offsets
are arithmetic). The host-side build (``build_mip_chain``, ``build_atlas``,
``_resize_area``) is NumPy, copied from the JAX package.

**Texel gradients.** Every texel fetch goes through :class:`_Taps`: the four
bilinear taps of a sample come back in one tensor, and their cotangents are
summed into the source rows by ``scatter_taps`` (``ops/fetch.index_sum``:
no float atomics, the same bits every run). Rows whose cotangent is all zero
are left out first (a background's pixels all sample one texel, and one long
run of a single index is summed serially). The taps may be read from a
packed or rounded copy of the rows (quad rows, f16 words): the gradient
then goes straight through to the f32 rows. uv gradients come from the
filter weights, outside the fetch.

**Equirect maps.** The JAX package packs them into paired or quad rows of
f16/u8 words so that a TPU bilinear sample is one gather; those layouts
count gathers on the TPU and bind nothing here. What the port keeps is their
semantics: texel selection with u and v wrapping (``g_SamLinearWrap``,
Core.hlsl:22), the bilinear weights in the JAX package's order, and the
values of the taps:

  * f32 maps (HDR environments, prefiltered levels): the f32 texels;
  * the LDR sky background: u8 texels, ``round(clip(m, 0, 1)·255)``, read as
    ``q·(1/255)`` (``quad_pack_equirect_u8`` / ``sample_equirect_quad_u8``);
  * the specular stack's forward taps: f16-rounded texels
    (``quad_pack_equirect_f16``), read from a ``torch.float16`` copy.

``pad_gather_rows`` (a TPU gather pathology) is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..math3d import clip, maximum
from .fetch import index_sum


@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    """Mip pyramid of N square texture pages: ``mips[l]`` is (N, S>>l,
    S>>l, 4) float32, linearised (sRGB decode happens at build)."""

    mips: tuple[torch.Tensor, ...]

    @property
    def num_pages(self) -> int:
        return self.mips[0].shape[0]

    @property
    def size(self) -> int:
        return self.mips[0].shape[1]

    @property
    def num_levels(self) -> int:
        return len(self.mips)

    def to(self, device) -> "TextureAtlas":
        return TextureAtlas(mips=tuple(m.to(device) for m in self.mips))


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Exact piecewise sRGB EOTF (what *_SRGB texture formats apply)."""
    return torch.where(c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4))


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def build_mip_chain(base: np.ndarray, num_levels: int | None = None) -> list[np.ndarray]:
    """2×2 box-filter mip chain of (N, S, S, C) pages (host-side NumPy)."""
    levels = [base]
    size = base.shape[1]
    if num_levels is None:
        num_levels = max(1, int(np.log2(size)) + 1)
    while len(levels) < num_levels and levels[-1].shape[1] > 1:
        prev = levels[-1]
        n, h, w, c = prev.shape
        levels.append(prev.reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4)))
    return levels


def build_atlas(
    pages: list[np.ndarray],
    srgb_flags: list[bool],
    size: int | None = None,
    num_levels: int | None = None,
    dtype=torch.float32,
    *,
    device=DEFAULT_DEVICE,
) -> TextureAtlas:
    """Pack decoded images (H, W, C uint8 or float) into a square atlas on
    ``device``: grey and RGB pages gain channels, other sizes are resized
    host-side, sRGB pages are linearised (decode before filter)."""
    if size is None:
        size = max(p.shape[0] for p in pages)
    packed = np.zeros((len(pages), size, size, 4), np.float32)
    for i, (img, srgb) in enumerate(zip(pages, srgb_flags)):
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        if img.shape[2] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=2)
        img = _resize_area(img, size, size)
        if srgb:
            rgb = img[..., :3]
            img = np.concatenate(
                [np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4), img[..., 3:]], axis=2
            )
        packed[i] = img
    mips = build_mip_chain(packed, num_levels)
    return TextureAtlas(mips=tuple(torch.as_tensor(m.astype(np.float32), device=device).to(dtype) for m in mips))


def _resize_area(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Host-side resize: integer-factor area average when shrinking by an
    exact multiple, bilinear otherwise."""
    h, w, c = img.shape
    if h == out_h and w == out_w:
        return img
    if h % out_h == 0 and w % out_w == 0:
        fh, fw = h // out_h, w // out_w
        return img.reshape(out_h, fh, out_w, fw, c).mean(axis=(1, 3))
    ys = (np.arange(out_h) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w) + 0.5) * (w / out_w) - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    a = img[y0][:, x0] * (1 - fy) * (1 - fx)
    b = img[y0][:, x1] * (1 - fy) * fx
    cc = img[y1][:, x0] * fy * (1 - fx)
    d = img[y1][:, x1] * fy * fx
    return a + b + cc + d


# ---------------------------------------------------------------------------
# Texel fetch with a deterministic texel gradient
# ---------------------------------------------------------------------------


def scatter_taps(rows: int, channels: int, idx, g) -> torch.Tensor:
    """(rows, channels) f32: Σ of the cotangent rows ``g[k]`` (..., c ≤
    channels) at the row indices ``idx[k]`` (...), the taps in order
    (``index_sum``: the same bits every run). Rows with an all-zero
    cotangent are left out."""
    c = g[0].shape[-1]
    flat_i = torch.cat([i.reshape(-1) for i in idx])
    flat_g = torch.cat([t.reshape(-1, c) for t in g]).to(torch.float32)
    live = torch.nonzero(flat_g.ne(0).any(-1)).squeeze(1)
    out = index_sum(rows, flat_i[live], flat_g[live])
    return torch.nn.functional.pad(out, (0, channels - c)) if c < channels else out


class _Taps(torch.autograd.Function):
    """The four bilinear taps that ``read()`` returns, concatenated on the
    last axis (..., 4·c): the values of rows i00, i01, i10, i11 of
    ``target`` (R, C), or of a packed or rounded copy of it. Their
    cotangents are summed into those rows of ``target`` (``scatter_taps``),
    straight through any packing or rounding of the copy."""

    @staticmethod
    def forward(ctx, target, read, i00, i01, i10, i11):
        ctx.save_for_backward(i00, i01, i10, i11)
        ctx.rows, ctx.channels = target.shape
        return read()

    @staticmethod
    def backward(ctx, g):
        g_target = None
        if ctx.needs_input_grad[0]:
            g_target = scatter_taps(ctx.rows, ctx.channels, ctx.saved_tensors, g.chunk(4, dim=-1))
        return g_target, None, None, None, None, None


def fetch_taps(target: torch.Tensor, idx, read=None) -> torch.Tensor:
    """The four taps (..., 4·c) at row indices ``idx`` = (i00, i01, i10,
    i11) of ``target`` (R, C) — or what ``read()`` returns for them —
    differentiable w.r.t. ``target`` (see :class:`_Taps`)."""
    if read is None:
        read = lambda: torch.cat([target[i] for i in idx], dim=-1)  # noqa: E731
    return _Taps.apply(target, read, *idx)


def bilinear4(q: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """The JAX package's filter over four taps concatenated on the last
    axis (..., 4·c) → (..., c): lerp in x along both rows, then in y."""
    return bilinear(q.chunk(4, dim=-1), fx, fy)


# ---------------------------------------------------------------------------
# Atlas sampling
# ---------------------------------------------------------------------------


def _weights_and_anchor(uv: torch.Tensor, s):
    """Texel-space anchor (x0, y0) int64 and filter weights (fx, fy) (..., 1)
    of a bilinear sample at a level of size ``s`` (int, or a per-pixel
    tensor); the weights carry the gradient to ``uv``."""
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    return x0f.detach().to(torch.int64), y0f.detach().to(torch.int64), fx, fy


def sample_bilinear(level: torch.Tensor, page: torch.Tensor, uv: torch.Tensor, wrap: bool = True) -> torch.Tensor:
    """Bilinear sample of one mip level (N, S, S, C) at (page, uv): uv in
    [0, 1] texture space, DirectX convention (v down, texel centres at
    (i+0.5)/S). Differentiable w.r.t. uv and the texels."""
    n, s, c = level.shape[0], level.shape[1], level.shape[-1]
    x0, y0, fx, fy = _weights_and_anchor(uv, s)
    if wrap:
        x0w, x1w = torch.remainder(x0, s), torch.remainder(x0 + 1, s)
        y0w, y1w = torch.remainder(y0, s), torch.remainder(y0 + 1, s)
    else:
        x0w, x1w = x0.clamp(0, s - 1), (x0 + 1).clamp(0, s - 1)
        y0w, y1w = y0.clamp(0, s - 1), (y0 + 1).clamp(0, s - 1)
    page = page.to(torch.int64)
    row = lambda iy, ix: (page * s + iy) * s + ix  # noqa: E731
    q = fetch_taps(level.reshape(n * s * s, c), (row(y0w, x0w), row(y0w, x1w), row(y1w, x0w), row(y1w, x1w)))
    return bilinear4(q, fx, fy)


def _screen_derivatives(uv: torch.Tensor):
    """Forward differences of a (rows, W[, …], 2) uv along x and y, the
    last column and row replicating their neighbour's (the JAX package's
    edge rule, so a band and the frame differ only on the band's last row)."""
    ddx = uv[..., 1:, :] - uv[..., :-1, :]
    ddx = torch.cat([ddx, ddx[..., -1:, :]], dim=-2)
    ddy = uv[..., 1:, :, :] - uv[..., :-1, :, :]
    ddy = torch.cat([ddy, ddy[..., -1:, :, :]], dim=-3)
    return ddx, ddy


def screen_space_lod(uv: torch.Tensor, tex_size: int) -> torch.Tensor:
    """Mip level from screen-space uv derivatives, (rows, W, 2) → (rows, W):
    log2 of the larger texel-footprint axis (the isotropic D3D formula)."""
    ddx, ddy = _screen_derivatives(uv)
    r2 = torch.maximum(torch.sum(ddx * ddx, dim=-1), torch.sum(ddy * ddy, dim=-1)) * float(tex_size) ** 2
    return maximum(0.5 * torch.log2(maximum(r2, 1e-12)), 0.0)


def screen_space_lod_aniso(uv: torch.Tensor, tex_size: int, num_taps: int):
    """Anisotropic footprint: (rows, W, 2) uv → (lod (rows, W), major-axis
    uv step (rows, W, 2)). ``num_taps`` taps cover the major axis, each at
    the minor axis's lod, widened where the axis ratio exceeds ``num_taps``."""
    ddx, ddy = _screen_derivatives(uv)
    lx2 = torch.sum(ddx * ddx, dim=-1) * float(tex_size) ** 2
    ly2 = torch.sum(ddy * ddy, dim=-1) * float(tex_size) ** 2
    major_is_x = lx2 >= ly2
    major2 = maximum(torch.maximum(lx2, ly2), 1e-12)
    minor2 = maximum(torch.minimum(lx2, ly2), 1e-12)
    ratio = torch.sqrt(clip(major2 / minor2, 1.0, float(num_taps) ** 2))
    eff_minor2 = torch.maximum(minor2, major2 / (ratio * ratio))
    lod = maximum(0.5 * torch.log2(eff_minor2), 0.0)
    return lod, torch.where(major_is_x[..., None], ddx, ddy)


def sample_atlas_aniso(atlas: TextureAtlas, page, uv, num_taps: int = 4, wrap: bool = True) -> torch.Tensor:
    """``num_taps`` trilinear taps spread along the major footprint axis,
    averaged (the ``aniso_taps=N`` mode); needs a (rows, W, …) layout."""
    lod, axis = screen_space_lod_aniso(uv, atlas.size, num_taps)
    acc = None
    for k in range(num_taps):
        f = (k + 0.5) / num_taps - 0.5
        smp = sample_atlas(atlas, page, uv + axis * f, lod=lod, wrap=wrap)
        acc = smp if acc is None else acc + smp
    return acc / num_taps


def stack_mips(mips) -> torch.Tensor:
    """A (N, S>>l, S>>l, C) mip pyramid as one level-major (R, C) table."""
    return torch.cat([m.reshape(-1, m.shape[-1]) for m in mips], dim=0)


def _stacked_level_offset(n: int, s: int, sl):
    """Row offset of the level of size ``sl`` in a :func:`stack_mips` table:
    Σ_{k<l} N·(S>>k)² = N·(4·S² − 4·sl²)/3 (exact in integers)."""
    return (4 * n * (s * s - sl * sl)) // 3


def _level_indices(n: int, s: int, sl, page, uv, wrap: bool):
    """Row indices (i00, i01, i10, i11) of a bilinear sample at a per-pixel
    level of size ``sl`` (int64 tensor) of a stacked pyramid, and its
    weights. Wrapping masks with ``sl − 1`` (sizes are powers of two)."""
    base = _stacked_level_offset(n, s, sl) + page * (sl * sl)
    x0, y0, fx, fy = _weights_and_anchor(uv, sl.to(torch.float32))
    if wrap:
        m = sl - 1
        x0w, x1w = x0 & m, (x0 + 1) & m
        y0w, y1w = y0 & m, (y0 + 1) & m
    else:
        x0w, x1w = torch.minimum(x0.clamp(min=0), sl - 1), torch.minimum((x0 + 1).clamp(min=0), sl - 1)
        y0w, y1w = torch.minimum(y0.clamp(min=0), sl - 1), torch.minimum((y0 + 1).clamp(min=0), sl - 1)
    row = lambda iy, ix: base + iy * sl + ix  # noqa: E731
    return (row(y0w, x0w), row(y0w, x1w), row(y1w, x0w), row(y1w, x1w)), fx, fy


def _sample_stacked_level(flat, n, s, level, page, uv, wrap):
    """Bilinear tap at a per-pixel integer mip level of a stacked pyramid."""
    sl = torch.bitwise_right_shift(torch.full_like(level, s), level)
    idx, fx, fy = _level_indices(n, s, sl, page.to(torch.int64), uv, wrap)
    return bilinear4(fetch_taps(flat, idx), fx, fy)


def _lod_levels(lod, num_levels: int):
    """(l0, l1) int64 levels and the lerp fraction (..., 1) of a trilinear
    sample at ``lod`` (the fraction carries the lod's gradient).

    The clip takes ±inf to the end levels; a NaN lod (a NaN uv's footprint)
    is level 0, mapped before the int cast, as XLA's conversion maps it.
    Cast as it is, NaN is an int64 out of range, a level of size 0 and tap
    rows past the table's end."""
    lodc = clip(lod, 0.0, num_levels - 1.0)
    l0 = torch.floor(lodc)
    frac = (lodc - l0)[..., None]
    l0i = torch.nan_to_num(l0.detach(), nan=0.0).to(torch.int64)
    return l0i, torch.clamp(l0i + 1, max=num_levels - 1), frac


def sample_stacked_trilinear(flat, n: int, s: int, num_levels: int, page, uv, lod, wrap: bool = True):
    """Trilinear sample from a stacked pyramid: two per-pixel-level bilinear
    taps, lerped by the lod's fraction (which carries its gradient)."""
    l0i, l1i, frac = _lod_levels(lod, num_levels)
    t0 = _sample_stacked_level(flat, n, s, l0i, page, uv, wrap)
    t1 = _sample_stacked_level(flat, n, s, l1i, page, uv, wrap)
    return t0 * (1.0 - frac) + t1 * frac


def sample_atlas(atlas: TextureAtlas, page, uv, lod=None, wrap: bool = True) -> torch.Tensor:
    """Sample the atlas: bilinear mip 0 when ``lod`` is None (or the atlas
    has one level), else trilinear between floor(lod) and floor(lod)+1."""
    if lod is None or atlas.num_levels == 1:
        return sample_bilinear(atlas.mips[0], page, uv, wrap)
    return sample_stacked_trilinear(stack_mips(atlas.mips), atlas.num_pages, atlas.size, atlas.num_levels,
                                    page, uv, lod, wrap)


# ---------------------------------------------------------------------------
# Equirect maps
# ---------------------------------------------------------------------------


def bilinear_taps(uv: torch.Tensor, h: int, w: int):
    """Texel indices and weights of a wrapped bilinear equirect sample →
    (i00, i01, i10, i11) flat (H·W) indices and (fx, fy) (..., 1) weights;
    the weights carry the gradient to ``uv``, the indices none."""
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.detach().to(torch.int64)
    y0 = y0f.detach().to(torch.int64)
    x0w, x1w = torch.remainder(x0, w), torch.remainder(x0 + 1, w)
    y0w, y1w = torch.remainder(y0, h), torch.remainder(y0 + 1, h)
    return (y0w * w + x0w, y0w * w + x1w, y1w * w + x0w, y1w * w + x1w), (fx, fy)


def bilinear(taps, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """The JAX package's filter: lerp in x along both rows, then in y."""
    t00, t01, t10, t11 = taps
    top = t00 * (1.0 - fx) + t01 * fx
    bot = t10 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_equirect(env: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an equirect map (H, W, C) at uv (..., 2), u and v
    wrapping → (..., C) in the map's float type; differentiable w.r.t. both
    the map and uv."""
    h, w, c = env.shape
    idx, (fx, fy) = bilinear_taps(uv, h, w)
    flat = env.reshape(h * w, c)
    return bilinear(tuple(flat[i] for i in idx), fx, fy)


def sample_equirect_f16(base: torch.Tensor, base_f16: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear equirect sample whose taps are the f16-rounded texels of
    ``base_f16`` (``sample_equirect_quad_f16``); tap cotangents go straight
    through to the f32 ``base`` (H, W, C), uv gradients through the weights."""
    h, w, c = base.shape
    idx, (fx, fy) = bilinear_taps(uv, h, w)
    flat16 = base_f16.reshape(h * w, c)
    read = lambda: torch.cat([flat16[i].to(torch.float32) for i in idx], dim=-1)  # noqa: E731
    return bilinear4(fetch_taps(base.reshape(h * w, c), idx, read), fx, fy)


def sky_u8(sky) -> torch.Tensor:
    """The port's LDR sky background: (H, W, 3) uint8 from either form the
    JAX package uses — the f32 source in [0, 1] (quantised as
    ``quad_pack_equirect_u8`` does, ``round(clip(m, 0, 1)·255)``) or its
    (H, W, 4) uint32 quad words (the texel's own word, RGB8 in bytes 0-2)."""
    if isinstance(sky, torch.Tensor):
        sky = sky.detach().cpu().numpy()
    sky = np.asarray(sky)
    if sky.dtype == np.uint32:
        own = sky[..., 0]
        return torch.as_tensor(np.stack([(own >> s) & 0xFF for s in (0, 8, 16)], axis=-1).astype(np.uint8))
    q = np.round(np.clip(sky[..., :3].astype(np.float32), 0.0, 1.0) * np.float32(255.0))
    return torch.as_tensor(q.astype(np.uint8))


def f16_from_quad_words(words, channels: int) -> torch.Tensor:
    """The JAX package's f16 quad words (H, W, 4·⌈C/2⌉) uint32
    (``quad_pack_equirect_f16``: two f16 lanes per word, the texel's own
    words first) → the (H, W, C) ``torch.float16`` texels they hold."""
    words = np.asarray(words, np.uint32)
    own = np.ascontiguousarray(words[..., : words.shape[-1] // 4])
    lanes = own.astype("<u4").view("<u2").view("<f2")  # lane 0 is the low half
    return torch.as_tensor(lanes[..., :channels].copy())


def sample_sky_u8(sky: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a uint8 sky (H, W, 3) → (..., 3) f32, taps
    ``q·(1/255)`` (``sample_equirect_quad_u8`` semantics; no texel
    gradient, as the reference's LDR sky has none)."""
    h, w, _ = sky.shape
    idx, (fx, fy) = bilinear_taps(uv, h, w)
    flat = sky.reshape(h * w, 3)
    return bilinear(tuple(flat[i].to(torch.float32) * (1.0 / 255.0) for i in idx), fx, fy)
