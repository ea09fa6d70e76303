"""Structural similarity (SSIM) for golden-image comparison — a copy of
``physically_based_renderer_tpu/utils/ssim.py`` (that module imports no JAX,
but the port imports nothing of the JAX package). Pure NumPy: a separable
Gaussian window and the standard Wang et al. constants.
"""

from __future__ import annotations

import numpy as np

_C1 = (0.01) ** 2
_C2 = (0.03) ** 2


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return k / k.sum()


def _blur(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' convolution along the two leading (H, W) axes."""
    pad = len(k) // 2
    out = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 0, img)
    out = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, out)
    return out[pad:-pad, pad:-pad]


def ssim(
    a: np.ndarray,
    b: np.ndarray,
    mask: np.ndarray | None = None,
    size: int = 11,
    sigma: float = 1.5,
) -> float:
    """Mean SSIM between two (H, W, C) float images in [0, 1].

    ``mask`` (H, W) bool restricts the mean to windows centred on masked
    pixels (a reference image may hold content the renderer cannot
    reproduce, such as an environment backdrop whose set is absent)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    k = _gaussian_kernel(size, sigma)
    pad = size // 2

    mu_a = _blur(a, k)
    mu_b = _blur(b, k)
    mu_a2 = mu_a * mu_a
    mu_b2 = mu_b * mu_b
    mu_ab = mu_a * mu_b
    var_a = _blur(a * a, k) - mu_a2
    var_b = _blur(b * b, k) - mu_b2
    cov = _blur(a * b, k) - mu_ab

    num = (2 * mu_ab + _C1) * (2 * cov + _C2)
    den = (mu_a2 + mu_b2 + _C1) * (var_a + var_b + _C2)
    smap = num / den
    if mask is not None:
        m = np.asarray(mask, bool)[pad:-pad, pad:-pad]
        if smap.ndim == 3:
            m = m[..., None] & np.ones(smap.shape, bool)
        return float(smap[m].mean())
    return float(smap.mean())
