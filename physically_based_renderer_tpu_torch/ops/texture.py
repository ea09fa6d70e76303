"""Equirect sampling — the counterpart of the equirect half of
``physically_based_renderer_tpu/ops/texture.py``.

The JAX package packs equirect maps into paired or quad rows of f16/u8 words
so that a TPU bilinear sample is one gather; those word layouts count
gathers on the TPU and bind nothing here. What the port keeps is their
semantics: texel selection with u and v wrapping (``g_SamLinearWrap``,
Core.hlsl:22), the bilinear weights in the JAX package's order, and the
values of the taps:

  * f32 maps (HDR environments, prefiltered levels): the f32 texels;
  * the LDR sky background: u8 texels, ``round(clip(m, 0, 1)·255)``, read as
    ``q·(1/255)`` (``quad_pack_equirect_u8`` / ``sample_equirect_quad_u8``);
  * the specular stack's forward taps: f16-rounded texels
    (``quad_pack_equirect_f16``), read from a ``torch.float16`` copy.
"""

from __future__ import annotations

import numpy as np
import torch


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
