"""Combined per-material shading textures: every slot a material binds in
one page — the counterpart of
``physically_based_renderer_tpu/ops/texture_combined.py``.

Every slot samples the same transformed uv (one ``g_MatTransform`` per
material, Core.hlsl:64), so the slots' channels are baked side by side into
one page per textured material:

    channels 0-2  albedo.rgb      (sRGB-decoded)
    channels 3-5  specular.rgb    (sRGB-decoded; 0 where unbound)
    channel  6    metallic
    channel  7    roughness
    channels 8-10 normal.xyz
    channel  11   opacity
    channels 12-15 pad

The per-material ``has_tex`` masks still choose texture or constant per
slot, so the semantics equal the per-slot atlas path's. The bake is a torch
function of the atlas texels (texel gradients flow through it). Analytic
materials share page 0 (never read: masked).

Four modes:

  * ``"f32"`` (:class:`CombinedAtlas`): four f32 taps of the 16-channel
    pages, or a stacked trilinear sample of their mip pyramid;
  * ``"quad"`` (:class:`QuadCombinedAtlas`): each row holds the whole 2×2
    footprint of the 12 live channels in f32 (self | right | down |
    down-right, u and v wrapped), so a sample reads one row. The taps are
    the f32 texels themselves: the forward equals the f32 mode's bit for
    bit, and the texel gradient (summed into ``pages``, or ``mips_stack`` on
    the lod path) too, since both modes sum the same tap cotangents in the
    same order (``texture.scatter_taps``). The JAX package's tile-major row
    order (a TPU gather-locality choice) is not kept: rows are row-major.
  * ``"half"`` (:class:`HalfCombinedAtlas`): the quad footprint as f16 pairs
    in 32-bit words (held as int32: torch has little uint32 arithmetic; the
    bits equal the JAX package's uint32 words). Texel gradients go straight
    through to the f32 ``pages`` (``mips_stack`` on the lod path).
  * ``"packed"`` (:class:`PackedCombinedAtlas`): the quad footprint of the
    12 channels quantised to u8, sRGB-encoded colour, three 32-bit words a
    texel (int32 here, the bits of the JAX package's uint32 words), decoded
    per tap before filtering — the reference's RGBA8 ``*_SRGB`` texture
    units. Not differentiable in the texels; uv gradients flow through the
    bilinear weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.material import (
    SLOT_DIFFUSE,
    SLOT_METALLIC,
    SLOT_NORMAL,
    SLOT_OPACITY,
    SLOT_ROUGHNESS,
    SLOT_SPECULAR,
    MaterialBank,
)
from .texture import (
    TextureAtlas,
    _level_indices,
    _lod_levels,
    _stacked_level_offset,
    _weights_and_anchor,
    bilinear4,
    fetch_taps,
    linear_to_srgb,
    sample_stacked_trilinear,
    srgb_to_linear,
    stack_mips,
)

NUM_COMBINED = 16


def _to(x, device):
    return None if x is None else x.to(device)


@dataclasses.dataclass(frozen=True)
class CombinedAtlas:
    """(P, S, S, 16) pages and the page of each material; ``mips`` (level 0
    == ``pages``) when built with more than one level — the ``mip_lod``
    path samples it."""

    pages: torch.Tensor  # (P, S, S, 16)
    material_page: torch.Tensor  # (M,) int64, 0 for analytic materials
    mips: tuple | None = None

    @property
    def size(self) -> int:
        return self.pages.shape[1]

    @property
    def num_pages(self) -> int:
        return self.pages.shape[0]

    @property
    def num_levels(self) -> int:
        return 1 if self.mips is None else len(self.mips)

    def to(self, device) -> "CombinedAtlas":
        return CombinedAtlas(pages=self.pages.to(device), material_page=self.material_page.to(device),
                             mips=None if self.mips is None else tuple(m.to(device) for m in self.mips))


def build_combined(materials: MaterialBank, atlas: TextureAtlas, num_levels: int | None = None) -> CombinedAtlas:
    """Bake the combined pages on the atlas's device (differentiable in the
    atlas texels). ``num_levels``: combined mip levels, 2×2 box reductions of
    level 0 (None: as many as the atlas has)."""
    base = atlas.mips[0]  # (N, S, S, 4)
    s = base.shape[1]
    has = materials.has_tex.detach().cpu().numpy()
    tex_index = materials.tex_index.detach().cpu().numpy()
    textured_rows = np.nonzero(has.sum(axis=1) > 0)[0]
    material_page = np.zeros((materials.num_materials,), np.int64)
    for p, row in enumerate(textured_rows):
        material_page[row] = p

    def page_for(row):
        def slot_tex(slot, channels):
            return base[int(tex_index[row, slot])][..., :channels] * materials.has_tex[row, slot]

        pad = torch.zeros((s, s, 4), dtype=base.dtype, device=base.device)
        return torch.cat([slot_tex(SLOT_DIFFUSE, 3), slot_tex(SLOT_SPECULAR, 3), slot_tex(SLOT_METALLIC, 1),
                          slot_tex(SLOT_ROUGHNESS, 1), slot_tex(SLOT_NORMAL, 3), slot_tex(SLOT_OPACITY, 1), pad],
                         dim=-1)

    pages = torch.stack([page_for(int(r)) for r in (textured_rows if len(textured_rows) else [0])])
    if num_levels is None:
        num_levels = atlas.num_levels
    mips = None
    if num_levels > 1:
        levels = [pages]
        while len(levels) < num_levels and levels[-1].shape[1] > 1:
            prev = levels[-1]
            p_, h, w, c = prev.shape
            levels.append(prev.reshape(p_, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4)))
        mips = tuple(levels)
    return CombinedAtlas(pages=pages, material_page=torch.as_tensor(material_page, device=base.device), mips=mips)


def _row_major_indices(s: int, page, x0, y0, wrap: bool):
    """Row indices (i00, i01, i10, i11) of a level-0 bilinear sample of
    (P, S, S, ·) pages: u/v wrap, else the quad layout's clamp (the anchor
    clipped a texel early; ``_clamp_weights`` pushes the weights to the
    clamped edge)."""
    if wrap:
        x0w, x1w = torch.remainder(x0, s), torch.remainder(x0 + 1, s)
        y0w, y1w = torch.remainder(y0, s), torch.remainder(y0 + 1, s)
    else:
        x0w = x0.clamp(0, s - 2)
        x1w = x0w + 1
        y0w = y0.clamp(0, s - 2)
        y1w = y0w + 1
    row_t = (page * s + y0w) * s
    row_b = (page * s + y1w) * s
    return row_t + x0w, row_t + x1w, row_b + x0w, row_b + x1w


def _clamp_weights(x0, y0, fx, fy, hi):
    """The quad layout's clamp emulation: a weight saturates to 1 past the
    last anchor ``hi`` and to 0 before the first (the duplicate-edge-texel
    filter of the f32 mode)."""
    x0e, y0e = x0[..., None], y0[..., None]
    fx = torch.where(x0e > hi, 1.0, torch.where(x0e < 0, 0.0, fx))
    fy = torch.where(y0e > hi, 1.0, torch.where(y0e < 0, 0.0, fy))
    return fx, fy


def sample_combined(combined: CombinedAtlas, material_id, uv, wrap: bool = True, lod=None) -> torch.Tensor:
    """Bilinear sample of each pixel's material page, uv (..., 2) → (...,
    16); with ``lod`` (and baked mips) a stacked trilinear sample."""
    page = combined.material_page[material_id.long()]
    if lod is not None and combined.mips is not None:
        return sample_stacked_trilinear(stack_mips(combined.mips), combined.num_pages, combined.size,
                                        combined.num_levels, page, uv, lod, wrap)
    pages = combined.pages
    s = pages.shape[1]
    x0, y0, fx, fy = _weights_and_anchor(uv, s)
    if wrap:
        idx = _row_major_indices(s, page, x0, y0, True)
    else:
        x0w, x1w = x0.clamp(0, s - 1), (x0 + 1).clamp(0, s - 1)
        y0w, y1w = y0.clamp(0, s - 1), (y0 + 1).clamp(0, s - 1)
        row_t, row_b = (page * s + y0w) * s, (page * s + y1w) * s
        idx = (row_t + x0w, row_t + x1w, row_b + x0w, row_b + x1w)
    return bilinear4(fetch_taps(pages.reshape(-1, NUM_COMBINED), idx), fx, fy)


def _quad_pack12(level: torch.Tensor) -> torch.Tensor:
    """(P, S, S, 12) → (P, S, S, 48): the 2×2 bilinear footprint (self |
    right | down | down-right, u/v wrapped) side by side."""
    right = torch.roll(level, -1, dims=2)
    down = torch.roll(level, -1, dims=1)
    downright = torch.roll(right, -1, dims=1)
    return torch.cat([level, right, down, downright], dim=-1)


def _stack_level_rows(levels) -> torch.Tensor:
    """Per-level (P, S_l, S_l, C) arrays → one level-major (R, C) table (row
    offsets as ``texture._stacked_level_offset``)."""
    return torch.cat([m.reshape(-1, m.shape[-1]) for m in levels], dim=0)


def _level_quad_indices(n: int, s: int, sl, page, uv, wrap: bool):
    """Row indices of the 4 taps at a per-pixel level of size ``sl`` of a
    stacked quad table, and the weights; clamping as the quad layout
    emulates it.

    A non-finite uv gives rows inside the level, as the JAX package's
    clamping gathers do, with no op of its own: its anchor becomes some
    int64, and the wrap's mask by ``sl − 1`` or the clamp to [0, sl − 1]
    takes any int64 into the level (``sl`` ≥ 1, which ``_lod_levels``
    guarantees for a level from any lod). Its weights, and so its sample,
    stay non-finite."""
    sl = torch.as_tensor(sl, dtype=torch.int64, device=uv.device)
    if wrap:
        (i00, i01, i10, i11), fx, fy = _level_indices(n, s, sl, page, uv, True)
        return i00, i01, i10, i11, fx, fy
    base = _stacked_level_offset(n, s, sl) + page * (sl * sl)
    x0, y0, fx, fy = _weights_and_anchor(uv, sl.to(torch.float32))
    hi = torch.clamp(sl - 2, min=0)
    x0w = torch.minimum(x0.clamp(min=0), hi)
    x1w = torch.minimum(x0w + 1, sl - 1)
    y0w = torch.minimum(y0.clamp(min=0), hi)
    y1w = torch.minimum(y0w + 1, sl - 1)
    fx, fy = _clamp_weights(x0, y0, fx, fy, hi[..., None] if hi.ndim else hi)
    row = lambda iy, ix: base + iy * sl + ix  # noqa: E731
    return row(y0w, x0w), row(y0w, x1w), row(y1w, x0w), row(y1w, x1w), fx, fy


@dataclasses.dataclass(frozen=True)
class QuadCombinedAtlas:
    """f32 quad rows: ``taps`` (P, S, S, 48) = [t00 | t01 | t10 | t11] × 12
    channels; ``pages`` (P, S, S, 16), the texel-gradient target; with a
    pyramid, ``mips_taps`` (R, 48) stacked quad rows and ``mips_stack`` (R,
    12), the lod path's gradient target."""

    taps: torch.Tensor
    pages: torch.Tensor
    material_page: torch.Tensor
    mips_taps: torch.Tensor | None = None
    mips_stack: torch.Tensor | None = None
    num_levels: int = 1

    @property
    def size(self) -> int:
        return self.pages.shape[1]

    @property
    def num_pages(self) -> int:
        return self.pages.shape[0]

    def to(self, device) -> "QuadCombinedAtlas":
        return dataclasses.replace(self, taps=self.taps.to(device), pages=self.pages.to(device),
                                   material_page=self.material_page.to(device),
                                   mips_taps=_to(self.mips_taps, device), mips_stack=_to(self.mips_stack, device))


def build_combined_quad(materials: MaterialBank, atlas: TextureAtlas, num_levels: int | None = None
                        ) -> QuadCombinedAtlas:
    comb = build_combined(materials, atlas, num_levels)
    mips_taps = mips_stack = None
    nl = 1
    if comb.mips is not None and len(comb.mips) > 1:
        lv12 = [m[..., :12] for m in comb.mips]
        mips_taps = _stack_level_rows([_quad_pack12(m) for m in lv12])
        mips_stack = _stack_level_rows(lv12)
        nl = len(comb.mips)
    return QuadCombinedAtlas(taps=_quad_pack12(comb.pages[..., :12]), pages=comb.pages,
                             material_page=comb.material_page, mips_taps=mips_taps, mips_stack=mips_stack,
                             num_levels=nl)


def _quad_fetch_rows_st(flat48: torch.Tensor, target: torch.Tensor, idx) -> torch.Tensor:
    """The quad row at i00 of ``flat48`` (..., 48): the four 12-channel taps,
    their cotangents summed into rows i00, i01, i10, i11 of ``target``."""
    return fetch_taps(target, idx, lambda: flat48[idx[0]])


def sample_combined_quad(quad: QuadCombinedAtlas, material_id, uv, wrap: bool = True, lod=None) -> torch.Tensor:
    """Bilinear sample of the quad rows (one row a sample) → (..., 12),
    equal to :func:`sample_combined`'s first 12 channels; texel gradients
    into ``quad.pages``. With ``lod`` (and a pyramid) a stacked trilinear
    sample, texel gradients into ``quad.mips_stack``."""
    page = quad.material_page[material_id.long()]
    n, s = quad.num_pages, quad.size
    if lod is not None and quad.num_levels > 1:
        l0, l1, frac = _lod_levels(lod, quad.num_levels)

        def tap_level(li):
            sl = torch.bitwise_right_shift(torch.full_like(li, s), li)
            i00, i01, i10, i11, fx, fy = _level_quad_indices(n, s, sl, page, uv, wrap)
            return bilinear4(_quad_fetch_rows_st(quad.mips_taps, quad.mips_stack, (i00, i01, i10, i11)), fx, fy)

        return tap_level(l0) * (1.0 - frac) + tap_level(l1) * frac
    x0, y0, fx, fy = _weights_and_anchor(uv, s)
    idx = _row_major_indices(s, page, x0, y0, wrap)
    if not wrap:
        fx, fy = _clamp_weights(x0, y0, fx, fy, s - 2)
    q = _quad_fetch_rows_st(quad.taps.reshape(-1, 48), quad.pages.reshape(-1, NUM_COMBINED), idx)
    return bilinear4(q, fx, fy)


@dataclasses.dataclass(frozen=True)
class HalfCombinedAtlas:
    """f16 quad words: ``words`` (P, S, S, 24) int32 = [t00 | t01 | t10 |
    t11] × 6 words of two f16 lanes (channel 2k low, 2k+1 high); ``pages``
    (P, S, S, 16) f32, the texel-gradient target; with a pyramid,
    ``mips_words`` (R, 24) and ``mips_stack`` (R, 12)."""

    words: torch.Tensor
    pages: torch.Tensor
    material_page: torch.Tensor
    mips_words: torch.Tensor | None = None
    mips_stack: torch.Tensor | None = None
    num_levels: int = 1

    @property
    def size(self) -> int:
        return self.words.shape[1]

    @property
    def num_pages(self) -> int:
        return self.words.shape[0]

    def to(self, device) -> "HalfCombinedAtlas":
        return dataclasses.replace(self, words=self.words.to(device), pages=self.pages.to(device),
                                   material_page=self.material_page.to(device),
                                   mips_words=_to(self.mips_words, device), mips_stack=_to(self.mips_stack, device))


def _quad_pack_f16(level12: torch.Tensor) -> torch.Tensor:
    """(P, S, S, 12) f32 → (P, S, S, 24) int32 quad-f16 words (round to
    nearest even, as the JAX package's ``astype(float16)``)."""
    b = level12.detach().to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    self6 = (b[..., 0::2] | (b[..., 1::2] << 16)).to(torch.int32)  # the uint32 word's bits
    right6 = torch.roll(self6, -1, dims=2)
    down6 = torch.roll(self6, -1, dims=1)
    downright6 = torch.roll(right6, -1, dims=1)
    return torch.cat([self6, right6, down6, downright6], dim=-1)


def build_combined_half(materials: MaterialBank, atlas: TextureAtlas, num_levels: int | None = None
                        ) -> HalfCombinedAtlas:
    comb = build_combined(materials, atlas, num_levels)
    mips_words = mips_stack = None
    nl = 1
    if comb.mips is not None and len(comb.mips) > 1:
        lv12 = [m[..., :12] for m in comb.mips]
        mips_words = _stack_level_rows([_quad_pack_f16(m) for m in lv12])
        mips_stack = _stack_level_rows(lv12)
        nl = len(comb.mips)
    return HalfCombinedAtlas(words=_quad_pack_f16(comb.pages[..., :12]), pages=comb.pages,
                             material_page=comb.material_page, mips_words=mips_words, mips_stack=mips_stack,
                             num_levels=nl)


def _unpack_half_tap(w6: torch.Tensor) -> torch.Tensor:
    """(..., 6) int32 words → (..., 12) f32 (two f16 lanes a word)."""
    lo = (w6 & 0xFFFF).to(torch.int16).view(torch.float16).to(torch.float32)
    hi = ((w6 >> 16) & 0xFFFF).to(torch.int16).view(torch.float16).to(torch.float32)
    return torch.stack([lo, hi], dim=-1).reshape(*w6.shape[:-1], 12)


def _unpack_half_row(q: torch.Tensor) -> torch.Tensor:
    """A (..., 24) quad-f16 row → its four taps (..., 48) f32."""
    return torch.cat([_unpack_half_tap(t) for t in q.chunk(4, dim=-1)], dim=-1)


def _half_taps_and_weights(half: HalfCombinedAtlas, material_id, uv, wrap: bool):
    """The four taps (..., 48), unpacked from one quad-f16 row, with their
    cotangents going straight through to ``half.pages``, and the weights."""
    s = half.size
    page = half.material_page[material_id.long()]
    x0, y0, fx, fy = _weights_and_anchor(uv, s)
    idx = _row_major_indices(s, page, x0, y0, wrap)
    if not wrap:
        fx, fy = _clamp_weights(x0, y0, fx, fy, s - 2)
    flat = half.words.reshape(-1, 24)
    q = fetch_taps(half.pages.reshape(-1, NUM_COMBINED), idx, lambda: _unpack_half_row(flat[idx[0]]))
    return q, fx, fy


def sample_combined_half(half: HalfCombinedAtlas, material_id, uv, wrap: bool = True, lod=None) -> torch.Tensor:
    """Bilinear sample of the f16 quad words → (..., 12) f32; texel
    gradients straight through to ``half.pages`` (``half.mips_stack`` on the
    lod path), uv gradients through the weights."""
    if lod is not None and half.num_levels > 1:
        n, s = half.num_pages, half.size
        page = half.material_page[material_id.long()]
        l0, l1, frac = _lod_levels(lod, half.num_levels)

        def tap_level(li):
            sl = torch.bitwise_right_shift(torch.full_like(li, s), li)
            i00, i01, i10, i11, fx, fy = _level_quad_indices(n, s, sl, page, uv, wrap)
            q = fetch_taps(half.mips_stack, (i00, i01, i10, i11), lambda: _unpack_half_row(half.mips_words[i00]))
            return bilinear4(q, fx, fy)

        return tap_level(l0) * (1.0 - frac) + tap_level(l1) * frac
    q, fx, fy = _half_taps_and_weights(half, material_id, uv, wrap)
    return bilinear4(q, fx, fy)


@dataclasses.dataclass(frozen=True)
class PackedCombinedAtlas:
    """u8 quad words: ``words`` (P, S, S, 12) int32 = [self | right | down |
    down-right] × 3 words (word 0 albedo.rgb sRGB | metallic << 24, word 1
    specular.rgb sRGB | roughness << 24, word 2 normal.xyz | opacity << 24,
    little-endian u8 lanes), rows row-major as the JAX package's; with a
    pyramid, ``mips_words`` (R, 12) stacked quad rows."""

    words: torch.Tensor
    material_page: torch.Tensor
    mips_words: torch.Tensor | None = None
    num_levels: int = 1

    @property
    def size(self) -> int:
        return self.words.shape[1]

    @property
    def num_pages(self) -> int:
        return self.words.shape[0]

    def to(self, device) -> "PackedCombinedAtlas":
        return dataclasses.replace(self, words=self.words.to(device), material_page=self.material_page.to(device),
                                   mips_words=_to(self.mips_words, device))


def _quad_pack_u8(level16: torch.Tensor) -> torch.Tensor:
    """(P, S, S, ≥12) linear f32 → (P, S, S, 12) int32 quad u8 words (round
    half to even, as the JAX package's ``jnp.round``)."""
    level16 = level16.detach()

    def u8(x):
        return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.int64)

    albedo = u8(linear_to_srgb(level16[..., 0:3]))
    spec = u8(linear_to_srgb(level16[..., 3:6]))
    metal, rough = u8(level16[..., 6]), u8(level16[..., 7])
    normal, opac = u8(level16[..., 8:11]), u8(level16[..., 11])
    w0 = albedo[..., 0] | (albedo[..., 1] << 8) | (albedo[..., 2] << 16) | (metal << 24)
    w1 = spec[..., 0] | (spec[..., 1] << 8) | (spec[..., 2] << 16) | (rough << 24)
    w2 = normal[..., 0] | (normal[..., 1] << 8) | (normal[..., 2] << 16) | (opac << 24)
    self3 = torch.stack([w0, w1, w2], dim=-1).to(torch.int32)  # the uint32 word's bits
    right3 = torch.roll(self3, -1, dims=2)
    down3 = torch.roll(self3, -1, dims=1)
    downright3 = torch.roll(right3, -1, dims=1)
    return torch.cat([self3, right3, down3, downright3], dim=-1)


def build_combined_packed(materials: MaterialBank, atlas: TextureAtlas, num_levels: int | None = None
                          ) -> PackedCombinedAtlas:
    """Quantise the f32 combined pages (and their pyramid) to u8 quad words."""
    comb = build_combined(materials, atlas, num_levels)
    mips_words = None
    nl = 1
    if comb.mips is not None and len(comb.mips) > 1:
        mips_words = _stack_level_rows([_quad_pack_u8(m) for m in comb.mips])
        nl = len(comb.mips)
    return PackedCombinedAtlas(words=_quad_pack_u8(comb.pages), material_page=comb.material_page,
                               mips_words=mips_words, num_levels=nl)


def _unpack_tap(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) int32 words → (..., 12) linear f32 (sRGB decode of the colour
    lanes)."""
    lanes = torch.stack([(w >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1).to(torch.float32) * (1.0 / 255.0)
    c0, c1, c2 = lanes[..., 0, :], lanes[..., 1, :], lanes[..., 2, :]
    return torch.cat([srgb_to_linear(c0[..., 0:3]), srgb_to_linear(c1[..., 0:3]), c0[..., 3:4], c1[..., 3:4],
                      c2[..., 0:3], c2[..., 3:4]], dim=-1)


def sample_combined_packed(packed: PackedCombinedAtlas, material_id, uv, wrap: bool = True, lod=None
                           ) -> torch.Tensor:
    """Bilinear sample of the u8 quad words: one row a sample, each tap
    sRGB-decoded, then filtered in linear space → (..., 12); with ``lod`` (and
    a pyramid) a stacked trilinear sample."""
    n, s = packed.num_pages, packed.size
    page = packed.material_page[material_id.long()]

    def sample_at(flat, sl):
        i00, _, _, _, fx, fy = _level_quad_indices(n, s, sl, page, uv, wrap)
        q = flat[i00]
        t00, t01, t10, t11 = (_unpack_tap(q[..., 3 * k:3 * k + 3]) for k in range(4))
        return (t00 * (1.0 - fx) + t01 * fx) * (1.0 - fy) + (t10 * (1.0 - fx) + t11 * fx) * fy

    if lod is not None and packed.num_levels > 1:
        l0, l1, frac = _lod_levels(lod, packed.num_levels)
        size = lambda li: torch.bitwise_right_shift(torch.full_like(li, s), li)  # noqa: E731
        return sample_at(packed.mips_words, size(l0)) * (1.0 - frac) + sample_at(packed.mips_words, size(l1)) * frac
    return sample_at(packed.words.reshape(-1, 12), s)


BUILDERS = {"f32": build_combined, "quad": build_combined_quad, "half": build_combined_half,
            "packed": build_combined_packed}


def sample_any(combined, material_id, uv, lod=None) -> torch.Tensor:
    """Sample a combined atlas of any mode → (..., ≥12) channels."""
    if isinstance(combined, QuadCombinedAtlas):
        return sample_combined_quad(combined, material_id, uv, lod=lod)
    if isinstance(combined, HalfCombinedAtlas):
        return sample_combined_half(combined, material_id, uv, lod=lod)
    if isinstance(combined, PackedCombinedAtlas):
        return sample_combined_packed(combined, material_id, uv, lod=lod)
    return sample_combined(combined, material_id, uv, lod=lod)
