"""PyTorch port vs the JAX package: the combined pages
(``ops/texture_combined.py``) in the f32, quad and half modes.

Both sides bake from the same NumPy-seeded atlas (``tests/
test_texture_combined.py``'s scene: one textured material, one analytic) and
sample the same uv. Tolerances: pages and quad taps as JAX's within 1e-7
(the same f32 copies; the mips are 2×2 means in another summation order);
the half mode's words bit-equal to JAX's uint32 words (round to nearest
even); samples within 1e-6 (the same taps and weights; XLA may fuse the
lerps into FMAs); texel and uv gradients within the JAX suite's gradient
tolerance (``torch_parity.grad_tolerance``), the half mode's texel
gradients straight through to the f32 pages as in JAX. Within the port the
quad mode equals the f32 mode bit for bit, forward and texel gradients.

The u8 packed mode (``tests/test_texture_combined.py:230-262``'s
counterparts): words and their pyramid bit-equal to JAX's uint32 words (as
int32 views), samples within 1e-6 and uv gradients within the gradient
tolerance (no texel gradient, as in JAX), its frame against the f32
combined frame under JAX's own bounds (99.5th percentile of the per-pixel
max |Δ| under 0.02, mean under 1e-3, under 0.2% of pixels past 0.05), and a
JAX scene with packed pages carried across by ``utils/convert``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.ops import texture_combined as jtc
from physically_based_renderer_tpu_torch.ops import texture_combined as tc
from test_texture_combined import H, W, _textured_scene
from torch_parity import combined_to_numpy, grad_tolerance, to_port
from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu_torch import Camera, render

VALUE_ATOL = 1e-6
JAX_SAMPLERS = {"f32": jtc.sample_combined, "quad": jtc.sample_combined_quad, "half": jtc.sample_combined_half}
PORT_SAMPLERS = {"f32": tc.sample_combined, "quad": tc.sample_combined_quad, "half": tc.sample_combined_half}
JAX_BUILDERS = {"f32": jtc.build_combined, "quad": jtc.build_combined_quad, "half": jtc.build_combined_half}
# the texel-gradient target of each mode, without and with a lod
TARGETS = {("f32", False): "pages", ("quad", False): "pages", ("half", False): "pages",
           ("f32", True): "mips", ("quad", True): "mips_stack", ("half", True): "mips_stack"}


@pytest.fixture(scope="module")
def scenes():
    jscene = _textured_scene()
    scene, _ = to_port(jscene, JCamera.create(aspect=1.0))
    return jscene, scene


def _inputs(n=257, seed=11, levels=6):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.5, 1.5, size=(n, 2)).astype(np.float32)
    mids = rng.integers(0, 2, size=n)
    lod = rng.uniform(-0.5, levels + 0.5, n).astype(np.float32)
    w = rng.normal(size=(n, 12)).astype(np.float32)
    return uv, mids, lod, w


@pytest.mark.parametrize("mode", ["f32", "quad", "half"])
def test_build_matches_jax(scenes, mode):
    jscene, scene = scenes
    jc = combined_to_numpy(JAX_BUILDERS[mode](jscene.materials, jscene.atlas))
    pc = tc.BUILDERS[mode](scene.materials, scene.atlas)
    np.testing.assert_array_equal(pc.material_page.numpy(), jc["material_page"])
    np.testing.assert_allclose(pc.pages.numpy(), jc["pages"], atol=1e-7, rtol=0)
    if mode == "f32":
        for j, p in zip(jc["mips"], pc.mips):
            np.testing.assert_allclose(p.numpy(), j, atol=1e-7, rtol=0)
    else:
        assert pc.num_levels == jc["num_levels"] == 6
        np.testing.assert_allclose(pc.mips_stack.numpy(), jc["mips_stack"], atol=1e-7, rtol=0)


def test_half_words_are_jax_bits(scenes):
    """The f16 quad words (and their pyramid) bit-equal to the JAX
    package's uint32 words, built from the same f32 pages."""
    jscene, scene = scenes
    jh = jtc.build_combined_half(jscene.materials, jscene.atlas)
    comb = tc.build_combined(scene.materials, scene.atlas)
    words = tc._quad_pack_f16(torch.as_tensor(np.array(jh.pages))[..., :12])
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jh.words))
    mips = tc._stack_level_rows([tc._quad_pack_f16(torch.as_tensor(np.array(m))[..., :12])
                                 for m in jtc.build_combined(jscene.materials, jscene.atlas).mips])
    np.testing.assert_array_equal(mips.numpy().view(np.uint32), np.asarray(jh.mips_words))
    assert comb.pages.shape == (1, 32, 32, 16)


def test_quad_taps_are_jax_taps(scenes):
    """The quad rows hold the JAX package's taps (its tile-major row order
    undone, as ``utils/convert`` does)."""
    jscene, scene = scenes
    jq = jtc.build_combined_quad(jscene.materials, jscene.atlas)
    pq = tc.build_combined_quad(scene.materials, scene.atlas)
    conv = to_port(dataclasses.replace(jscene, combined_atlas=jq), JCamera.create(aspect=1.0))[0].combined_atlas
    assert jq.tile == 16
    np.testing.assert_allclose(pq.taps.numpy(), conv.taps.numpy(), atol=1e-7, rtol=0)
    np.testing.assert_allclose(pq.mips_taps.numpy(), np.asarray(jq.mips_taps), atol=1e-7, rtol=0)


@pytest.mark.parametrize("lod", [False, True])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("mode", ["f32", "quad", "half"])
def test_sample_values_and_gradients_match(scenes, mode, wrap, lod):
    jscene, scene = scenes
    uv, mids, lods, w = _inputs()
    jc = JAX_BUILDERS[mode](jscene.materials, jscene.atlas)
    pc = tc.BUILDERS[mode](scene.materials, scene.atlas)
    target = TARGETS[(mode, lod)]
    lod_j = jnp.asarray(lods) if lod else None

    def jloss(t, uv_):
        c = dataclasses.replace(jc, **{target: t})
        return jnp.sum(JAX_SAMPLERS[mode](c, jnp.asarray(mids), uv_, wrap=wrap, lod=lod_j)[..., :12] * w)

    ref = JAX_SAMPLERS[mode](jc, jnp.asarray(mids), jnp.asarray(uv), wrap=wrap, lod=lod_j)[..., :12]
    jg = jax.grad(jloss, argnums=(0, 1))(getattr(jc, target), jnp.asarray(uv))
    t = getattr(pc, target)
    t = tuple(m.clone().requires_grad_() for m in t) if isinstance(t, tuple) else t.clone().requires_grad_()
    uvt = torch.as_tensor(uv).requires_grad_()
    got = PORT_SAMPLERS[mode](dataclasses.replace(pc, **{target: t}), torch.as_tensor(mids), uvt, wrap=wrap,
                              lod=torch.as_tensor(lods) if lod else None)[..., :12]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=VALUE_ATOL, rtol=0)
    leaves = list(t) if isinstance(t, tuple) else [t]
    grads = torch.autograd.grad(torch.sum(got * torch.as_tensor(w)), leaves + [uvt])
    refs = list(jg[0]) if isinstance(jg[0], tuple) else [jg[0]]
    for r, g in zip(refs + [jg[1]], grads):
        grad_tolerance(np.asarray(r), g.numpy())
    assert float(grads[-1].abs().sum()) > 0 and any(float(g.abs().sum()) > 0 for g in grads[:-1])


@pytest.mark.parametrize("lod", [False, True])
def test_quad_is_bit_exact_against_f32_in_the_port(scenes, lod):
    """Forward and texel gradient: the quad row holds the f32 taps, and both
    modes sum the same tap cotangents in the same order."""
    _, scene = scenes
    uv, mids, lods, w = _inputs(n=1000, seed=12)
    comb = tc.build_combined(scene.materials, scene.atlas)
    quad = tc.build_combined_quad(scene.materials, scene.atlas)
    lod_t = torch.as_tensor(lods) if lod else None
    if lod:  # the f32 mode samples its pyramid; give both modes the same leaf rows
        stack = tc._stack_level_rows([m[..., :12] for m in comb.mips]).clone().requires_grad_()
        f32_out = tc.sample_stacked_trilinear(stack, comb.num_pages, comb.size, comb.num_levels,
                                              comb.material_page[torch.as_tensor(mids)], torch.as_tensor(uv),
                                              lod_t)
        quad_leaf = stack.detach().clone().requires_grad_()
        q_out = tc.sample_combined_quad(dataclasses.replace(quad, mips_stack=quad_leaf), torch.as_tensor(mids),
                                        torch.as_tensor(uv), lod=lod_t)
        f32_leaf = stack
    else:
        f32_leaf = comb.pages.clone().requires_grad_()
        f32_out = tc.sample_combined(dataclasses.replace(comb, pages=f32_leaf), torch.as_tensor(mids),
                                     torch.as_tensor(uv))[..., :12]
        quad_leaf = quad.pages.clone().requires_grad_()
        q_out = tc.sample_combined_quad(dataclasses.replace(quad, pages=quad_leaf), torch.as_tensor(mids),
                                        torch.as_tensor(uv))
    assert torch.equal(q_out, f32_out)
    wt = torch.as_tensor(w)
    (g_f32,) = torch.autograd.grad(torch.sum(f32_out * wt), f32_leaf)
    (g_quad,) = torch.autograd.grad(torch.sum(q_out * wt), quad_leaf)
    assert torch.equal(g_quad, g_f32) and float(g_quad.abs().sum()) > 0


def test_packed_mode_waits_for_a_later_pr(scenes):
    """The packed mode, once pending, now builds: by mode and by JAX's legacy
    ``packed=True`` flag."""
    _, scene = scenes
    for s in (scene.with_combined_textures(mode="packed"), scene.with_combined_textures(packed=True)):
        assert isinstance(s.combined_atlas, tc.PackedCombinedAtlas) and s.combined_atlas.num_levels == 6
    assert isinstance(scene.with_combined_textures().combined_atlas, tc.CombinedAtlas)


def test_packed_words_are_jax_bits(scenes):
    jscene, scene = scenes
    jp = jtc.build_combined_packed(jscene.materials, jscene.atlas)
    pp = tc.build_combined_packed(scene.materials, scene.atlas)
    assert pp.words.dtype == torch.int32 and pp.words.shape == (1, 32, 32, 12)
    np.testing.assert_array_equal(pp.words.numpy().view(np.uint32), np.asarray(jp.words))
    np.testing.assert_array_equal(pp.mips_words.numpy().view(np.uint32), np.asarray(jp.mips_words))
    np.testing.assert_array_equal(pp.material_page.numpy(), np.asarray(jp.material_page))
    assert pp.num_levels == jp.num_levels == 6


@pytest.mark.parametrize("lod", [False, True])
@pytest.mark.parametrize("wrap", [True, False])
def test_packed_sample_and_uv_gradient_match(scenes, wrap, lod):
    jscene, scene = scenes
    uv, mids, lods, w = _inputs()
    jp = jtc.build_combined_packed(jscene.materials, jscene.atlas)
    pp = tc.build_combined_packed(scene.materials, scene.atlas)
    lod_j = jnp.asarray(lods) if lod else None

    def jloss(uv_):
        out = jtc.sample_combined_packed(jp, jnp.asarray(mids), uv_, wrap=wrap, lod=lod_j)
        return jnp.sum(out * w), out

    (_, ref), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(uv))
    uvt = torch.as_tensor(uv).requires_grad_()
    got = tc.sample_combined_packed(pp, torch.as_tensor(mids), uvt, wrap=wrap,
                                    lod=torch.as_tensor(lods) if lod else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=VALUE_ATOL, rtol=0)
    (g,) = torch.autograd.grad(torch.sum(got * torch.as_tensor(w)), uvt)
    grad_tolerance(np.asarray(jg), g.numpy())
    assert float(g.abs().sum()) > 0


def test_packed_frame_close_to_f32_frame(scenes):
    """The port's packed frame against its f32 combined frame, under
    ``tests/test_texture_combined.py::test_packed_combined_render_close``'s
    bounds, at that test's 128×96."""
    _, scene = scenes
    cam = Camera.create(aspect=W / H, device="cpu")
    a = render(scene.with_combined_textures(), cam, width=W, height=H).numpy()
    b = render(scene.with_combined_textures(packed=True), cam, width=W, height=H).numpy()
    d = np.abs(a - b).max(-1)
    assert np.percentile(d, 99.5) < 0.02, np.percentile(d, 99.5)
    assert d.mean() < 1e-3, d.mean()
    assert (d > 0.05).mean() < 2e-3
    assert d.max() > 0  # the u8 quantisation shows


def test_packed_pages_carry_across(scenes):
    jscene, scene = scenes
    jp = jtc.build_combined_packed(jscene.materials, jscene.atlas)
    conv = to_port(dataclasses.replace(jscene, combined_atlas=jp), JCamera.create(aspect=1.0))[0].combined_atlas
    pp = tc.build_combined_packed(scene.materials, scene.atlas)
    assert isinstance(conv, tc.PackedCombinedAtlas) and conv.num_levels == pp.num_levels
    assert torch.equal(conv.words, pp.words) and torch.equal(conv.mips_words, pp.mips_words)
    assert torch.equal(conv.material_page, pp.material_page)


NON_FINITE = [float("nan"), float("inf"), -float("inf")]


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("bad", ["nan", "inf", "-inf"])
def test_non_finite_uv_or_lod_gives_rows_inside_the_table(scenes, bad, wrap):
    """A NaN or ±inf uv or lod (a pixel whose material went NaN) gives tap
    rows in [0, R) of the stacked quad table on the CPU, as the JAX
    package's clamping gathers keep them: the lod's level from
    ``_lod_levels``, the rows from ``_level_quad_indices``. The quad, half
    and packed samplers then gather without an index error."""
    _, scene = scenes
    x = NON_FINITE[["nan", "inf", "-inf"].index(bad)]
    quad = tc.build_combined_quad(scene.materials, scene.atlas)
    n, s, nl = quad.num_pages, quad.size, quad.num_levels
    rows = quad.mips_taps.shape[0]
    uv, mids, lods, _ = _inputs(n=64, seed=13)
    uv, lods = torch.as_tensor(uv), torch.as_tensor(lods)
    uv[0:8, 0] = x
    uv[8:16, 1] = x
    uv[16:24] = x
    lods[4:12] = x
    lods[20:28] = x
    l0, l1, frac = tc._lod_levels(lods, nl)
    assert ((l0 >= 0) & (l0 < nl) & (l1 >= l0) & (l1 < nl)).all()
    if bad == "nan":  # NaN is level 0; the clip takes ±inf to the end levels
        assert (l0[4:12] == 0).all()
    page = quad.material_page[torch.as_tensor(mids).long()]
    for li in (l0, l1):
        sl = torch.bitwise_right_shift(torch.full_like(li, s), li)
        idx = tc._level_quad_indices(n, s, sl, page, uv, wrap)[:4]
        for i in idx:
            assert ((i >= 0) & (i < rows)).all(), i
    for mode in ("quad", "half", "packed"):
        c = tc.BUILDERS[mode](scene.materials, scene.atlas)
        out = PORT_SAMPLERS.get(mode, tc.sample_combined_packed)(c, torch.as_tensor(mids), uv, wrap=wrap, lod=lods)
        assert bool(torch.isfinite(out[32:]).all())  # the finite pixels are untouched
