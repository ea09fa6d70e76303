"""PyTorch port vs the JAX package: the texture atlas and its samplers
(``ops/texture.py``).

Same NumPy-seeded pages and uv on both sides. Tolerances: the atlas build is
the same NumPy code (mips equal to 1e-7); sampled values within 1e-6
(identical f32 taps and weights; XLA may fuse the lerps into FMAs); uv and
texel gradients within the JAX suite's gradient tolerance
(``torch_parity.grad_tolerance``: rtol 2e-3, 5e-5·max). The LOD is a log2
of float32 squared derivatives: values within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.ops import texture as jtex
from physically_based_renderer_tpu_torch.ops import texture as tex
from torch_parity import grad_tolerance

VALUE_ATOL = 1e-6


def _pages(seed=0):
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),  # sRGB colour
             rng.uniform(0, 1, (64, 64)).astype(np.float32),  # grey, area-shrunk 2×
             rng.uniform(0, 1, (48, 48, 4)).astype(np.float32),  # RGBA, bilinear resize
             rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)],
            [True, False, False, False])


def _atlases():
    pages, srgb = _pages()
    return jtex.build_atlas(pages, srgb, size=32), tex.build_atlas(pages, srgb, size=32, device="cpu")


def _uv(shape, seed=1, lo=-0.5, hi=1.5):
    return np.random.default_rng(seed).uniform(lo, hi, shape + (2,)).astype(np.float32)


def test_build_atlas_and_mips_match():
    ja, pa = _atlases()
    assert pa.num_pages == 4 and pa.size == 32 and pa.num_levels == ja.num_levels == 6
    for j, p in zip(ja.mips, pa.mips):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-7, rtol=0)


def test_srgb_transfer_functions_match():
    x = np.linspace(-0.1, 1.2, 1001).astype(np.float32)
    np.testing.assert_allclose(tex.srgb_to_linear(torch.as_tensor(x)).numpy(),
                               np.asarray(jtex.srgb_to_linear(jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tex.linear_to_srgb(torch.as_tensor(x)).numpy(),
                               np.asarray(jtex.linear_to_srgb(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("wrap", [True, False])
def test_bilinear_values_and_gradients_match(wrap):
    ja, pa = _atlases()
    uv = _uv((257,))
    page = np.random.default_rng(2).integers(0, 4, 257)
    w = np.random.default_rng(3).normal(size=(257, 4)).astype(np.float32)

    def jloss(level, uv_):
        return jnp.sum(jtex.sample_bilinear(level, jnp.asarray(page), uv_, wrap) * w)

    ref = np.asarray(jtex.sample_bilinear(ja.mips[0], jnp.asarray(page), jnp.asarray(uv), wrap))
    jg = jax.grad(jloss, argnums=(0, 1))(ja.mips[0], jnp.asarray(uv))
    level = pa.mips[0].clone().requires_grad_()
    uvt = torch.as_tensor(uv).requires_grad_()
    got = tex.sample_bilinear(level, torch.as_tensor(page), uvt, wrap)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=VALUE_ATOL, rtol=0)
    g_level, g_uv = torch.autograd.grad(torch.sum(got * torch.as_tensor(w)), (level, uvt))
    grad_tolerance(np.asarray(jg[0]), g_level.numpy())
    grad_tolerance(np.asarray(jg[1]), g_uv.numpy())


def _uv_field(rows=12, width=20, seed=4):
    """A smooth screen-space uv field (rows, W, 2) with some anisotropy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:width].astype(np.float32)
    u = 0.04 * xx + 0.006 * yy + 0.003 * rng.normal(size=xx.shape)
    v = 0.012 * xx + 0.09 * yy + 0.003 * rng.normal(size=xx.shape)
    return np.stack([u, v], -1).astype(np.float32)


def test_screen_space_lod_matches():
    uv = _uv_field()
    ref = np.asarray(jtex.screen_space_lod(jnp.asarray(uv), 32))
    got = tex.screen_space_lod(torch.as_tensor(uv), 32).numpy()
    assert ref.shape == got.shape == uv.shape[:2] and (ref > 0).mean() > 0.5
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    jg = jax.grad(lambda u: jnp.sum(jtex.screen_space_lod(u, 32)))(jnp.asarray(uv))
    uvt = torch.as_tensor(uv).requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(tex.screen_space_lod(uvt, 32)), uvt)
    grad_tolerance(np.asarray(jg), g.numpy())


@pytest.mark.parametrize("num_taps", [2, 4])
def test_aniso_footprint_and_sample_match(num_taps):
    uv = _uv_field()
    jlod, jaxis = jtex.screen_space_lod_aniso(jnp.asarray(uv), 32, num_taps)
    plod, paxis = tex.screen_space_lod_aniso(torch.as_tensor(uv), 32, num_taps)
    np.testing.assert_allclose(plod.numpy(), np.asarray(jlod), atol=1e-5, rtol=0)
    np.testing.assert_allclose(paxis.numpy(), np.asarray(jaxis), atol=1e-7, rtol=0)
    ja, pa = _atlases()
    page = np.random.default_rng(5).integers(0, 4, uv.shape[:2])
    ref = np.asarray(jtex.sample_atlas_aniso(ja, jnp.asarray(page), jnp.asarray(uv), num_taps))
    got = tex.sample_atlas_aniso(pa, torch.as_tensor(page), torch.as_tensor(uv), num_taps).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("wrap", [True, False])
def test_trilinear_values_and_gradients_match(wrap):
    """``sample_atlas`` with a lod: the stacked-pyramid trilinear sample,
    gradients to uv, to the lod and to every mip level."""
    ja, pa = _atlases()
    uv = _uv((300,), seed=6)
    rng = np.random.default_rng(7)
    page = rng.integers(0, 4, 300)
    lod = rng.uniform(-0.5, 6.5, 300).astype(np.float32)
    lod[:4] = [0.0, 5.0, 2.0, 3.0]  # clip ends and whole levels
    w = rng.normal(size=(300, 4)).astype(np.float32)

    def jloss(mips, uv_, lod_):
        a = jtex.TextureAtlas(mips=mips)
        return jnp.sum(jtex.sample_atlas(a, jnp.asarray(page), uv_, lod=lod_, wrap=wrap) * w)

    jv = jtex.sample_atlas(ja, jnp.asarray(page), jnp.asarray(uv), lod=jnp.asarray(lod), wrap=wrap)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(ja.mips, jnp.asarray(uv), jnp.asarray(lod))
    mips = tuple(m.clone().requires_grad_() for m in pa.mips)
    uvt, lodt = torch.as_tensor(uv).requires_grad_(), torch.as_tensor(lod).requires_grad_()
    got = tex.sample_atlas(tex.TextureAtlas(mips=mips), torch.as_tensor(page), uvt, lod=lodt, wrap=wrap)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jv), atol=VALUE_ATOL, rtol=0)
    grads = torch.autograd.grad(torch.sum(got * torch.as_tensor(w)), (*mips, uvt, lodt))
    for r, g in zip(list(jg[0]) + [jg[1], jg[2]], grads):
        grad_tolerance(np.asarray(r), g.numpy())


def test_texel_gradient_is_the_same_bits_twice_and_skips_zero_rows():
    """The tap scatter sums each texel's run in order (no atomics): two
    backward passes give the same bits; an all-zero cotangent row adds
    nothing."""
    _, pa = _atlases()
    uv = _uv((4096,), seed=8)
    page = torch.as_tensor(np.random.default_rng(9).integers(0, 4, 4096))
    w = torch.as_tensor(np.random.default_rng(10).normal(size=(4096, 4)).astype(np.float32))
    w[::3] = 0.0
    grads = []
    for _ in range(2):
        level = pa.mips[0].clone().requires_grad_()
        out = tex.sample_bilinear(level, page, torch.as_tensor(uv))
        (g,) = torch.autograd.grad(torch.sum(out * w), level)
        grads.append(g)
    assert torch.equal(grads[0], grads[1]) and float(grads[0].abs().sum()) > 0
    idx = tuple(torch.tensor([3, 3, 5]) for _ in range(4))
    rows = torch.tensor([[1.0, 2.0], [0.0, 0.0], [4.0, 8.0]])
    got = tex.scatter_taps(8, 3, idx, [rows] * 4)
    assert got.shape == (8, 3) and torch.equal(got[3], torch.tensor([4.0, 8.0, 0.0]))
    assert torch.equal(got[5], torch.tensor([16.0, 32.0, 0.0])) and not got[[0, 1, 2, 4, 6, 7]].any()
