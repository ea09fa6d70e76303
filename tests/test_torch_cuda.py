"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: these skip where there is no GPU. They import nothing of
JAX, so on the machine with the card they run without the JAX package's
test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: triangle/material ids exactly equal; RGBA atol 2e-4 (float32
shading, the same expressions; only sqrt/div/pow rounding may differ), the
IBL mode's HDR channels atol 2e-4 + rtol 1e-4. The backward kernel (both
modes): rtol 1e-3 against the plain version on the same inputs, and the
gradient tolerance of ``tests/test_torch_backward.py`` (5e-5·scale +
2e-3·|ref|; 1e-4·scale for the env-map gradients, as
``tests/test_torch_raster_shade_ibl.py``) against float64 at sharp
highlights and for render gradients on the card against the CPU. The
G-buffer mode: ids exact, attributes atol 1e-4 and depth 1e-6 (the same
arithmetic, unfused); the G-buffer shader as the shade mode; the
triangle-sharded frame and its gradients on the card against the CPU as
``render``'s. Kernel 4 (the G-buffer mode at 16×128 tiles in the v1
binning) as the G-buffer mode; the textured frame on the card against the
CPU under the textured frame bounds of ``tests/test_raster_gbuf.py:43-63``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from physically_based_renderer_tpu_torch import Camera, Lights, render, scenes
from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
from physically_based_renderer_tpu_torch.ops.shade_core import pack_shading_uniforms
from physically_based_renderer_tpu_torch.ops.texture import sky_u8
from physically_based_renderer_tpu_torch.parallel import sharded as pbr_sharded
from physically_based_renderer_tpu_torch.renderer import binning_params
from torch_parity import cuda_device, grad_tolerance, random_gbuffer, row_args, seeded_env  # noqa: F401  (fixture)

ATOL = 2e-4
W, H = 128, 64


def _grid(device="cpu"):
    scene = scenes.red_sphere_grid_scene(8, 4, device=device)
    return scene, Camera.create(position=(0.0, -3.0, -18.0), aspect=W / H, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("bins", ["render", "jumbo"])
def test_kernel_matches_plain_version(cuda_device, bins):
    scene, cam = _grid(cuda_device)
    args = row_args(scene, cam)
    kw = dict(width=W, height=H, tile_h=8, want_gbuf=True, num_materials=49, num_dir=4)
    kw.update(binning_params(args[0].shape[0], W, H) if bins == "render" else dict(max_span=2))
    before = raster_row.KERNEL_LAUNCHES
    out = raster_row.rasterize_binned_shade_row(*args, **kw)
    assert raster_row.KERNEL_LAUNCHES == before + 1
    ref = raster_row.rasterize_binned_shade_row(*(a.cpu() for a in args), **kw)
    assert torch.equal(out.tri_id.cpu(), ref.tri_id)
    assert torch.equal(out.mat_id.cpu(), ref.mat_id)
    torch.testing.assert_close(out.rgba.cpu(), ref.rgba, atol=ATOL, rtol=0)
    torch.testing.assert_close(out.gbuf.cpu(), ref.gbuf, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_render_on_card_matches_cpu(cuda_device):
    scene, cam = _grid()
    ref = render(scene, cam, width=W, height=H)
    got = render(scene.to(cuda_device), cam.to(cuda_device), width=W, height=H)
    torch.testing.assert_close(got.cpu(), ref, atol=ATOL, rtol=0)
    band = render(scene.to(cuda_device), cam.to(cuda_device), width=W, height=H, rows=24, y_offset=20)
    torch.testing.assert_close(band.cpu(), ref[20:44], atol=ATOL, rtol=0)


def _bwd_inputs(gb, device, dtype=torch.float32):
    t = lambda x: torch.as_tensor(x, device=device)
    uni = pack_shading_uniforms(**{k: t(v) for k, v in gb["lights"].items()})
    return (t(gb["g_chan"]).to(dtype), t(gb["attrs"]).to(dtype), t(gb["mat_id"]), t(gb["hit"]),
            t(gb["mat_props"]).to(dtype), uni.to(dtype))


def _close_to_plain(got, ref, mat_id, hit):
    """The chip check's kernel tolerance: rtol 1e-3 with an absolute floor of
    1e-6·max|ref| (g_attrs, g_props); rtol 1e-3 (g_uni). The table
    cotangent: within 1e-5·Σ|g_props| per entry of a float64 sum, by
    material id, of the kernel's own g_props (f32 summation order only)."""
    for name, a, b in zip(("g_attrs", "g_props", "g_uni"), ref, got):
        atol = 1e-6 * float(a.abs().max()) if name != "g_uni" else 0.0
        torch.testing.assert_close(b, a, rtol=1e-3, atol=atol, msg=name)
    m = ref[3].shape[0]
    ok = hit & (mat_id >= 0) & (mat_id < m)
    by_material = lambda v: torch.zeros((m, 9), dtype=torch.float64, device=v.device).index_add_(
        0, mat_id[ok].long(), v[ok].double())
    err = (got[3].double() - by_material(got[1])).abs()
    assert bool((err <= 1e-5 * by_material(got[1].abs())).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("apply_tonemap", [True, False])
def test_backward_kernel_matches_plain_version(cuda_device, apply_tonemap):
    gb = random_gbuffer(5 + apply_tonemap)
    kw = dict(gb["counts"], apply_tonemap=apply_tonemap)
    args = list(_bwd_inputs(gb, cuda_device))
    args[2] = args[2].clone()
    args[2][0, :9], args[2][1, :5] = 5, -1  # out-of-table ids add nothing to the table
    before = raster_pallas.SHADE_BWD_LAUNCHES
    got = raster_pallas.shade_backward(*args, **kw)
    again = raster_pallas.shade_backward_cuda(*args, **kw)
    assert raster_pallas.SHADE_BWD_LAUNCHES == before + 2
    ref = raster_pallas.shade_backward_plain(*args, **kw)
    hit = args[3]
    _close_to_plain(got, ref, args[2], hit)
    torch.testing.assert_close(got[3], ref[3], rtol=1e-3, atol=1e-5 * float(ref[3].abs().max()))
    # no float atomics: the same bits every run
    assert torch.equal(again[2], got[2]) and torch.equal(again[3], got[3])
    assert not got[0][~hit].any() and not got[1][~hit].any()
    # Strided residual: the forward's (rows, W, 7) G-buffer viewed as 6 attributes.
    wide = torch.cat([args[1], torch.zeros_like(args[1][..., :1])], dim=-1)[..., :6]
    strided = raster_pallas.shade_backward_cuda(args[0], wide, *args[2:], **kw)
    for a, b in zip(got, strided):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_backward_kernel_at_sharp_highlights_matches_float64(cuda_device):
    gb = random_gbuffer(9, roughness=0.05, highlight_frac=0.5)
    kw = dict(gb["counts"], apply_tonemap=True)
    got = raster_pallas.shade_backward_cuda(*_bwd_inputs(gb, cuda_device), **kw)
    ref = raster_pallas.shade_backward_plain(*_bwd_inputs(gb, "cpu", torch.float64), **kw)
    for a, b in zip(ref, got):
        grad_tolerance(a.numpy(), b.cpu().numpy())


def _grads_of_bench_loss(scene, cam):
    mats = {k: getattr(scene.materials, k).clone().requires_grad_()
            for k in ("diffuse", "roughness", "metallic", "fresnel_r0")}
    strength = scene.lights.strength.clone().requires_grad_()
    eye = cam.position.clone().requires_grad_()
    worlds = scene.draws[0].worlds.clone().requires_grad_()
    s = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, **mats),
        lights=dataclasses.replace(scene.lights, strength=strength),
        draws=(dataclasses.replace(scene.draws[0], worlds=worlds),),
    )
    img = render(s, dataclasses.replace(cam, position=eye), width=W, height=H)
    torch.mean(img[..., :3] ** 2).backward()
    return {**{k: t.grad for k, t in mats.items()}, "strength": strength.grad, "eye": eye.grad,
            "worlds": worlds.grad}


@pytest.mark.cuda
def test_render_gradients_on_card_match_cpu(cuda_device):
    ref = _grads_of_bench_loss(*_grid())
    launches = raster_row.KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES
    got = _grads_of_bench_loss(*_grid(cuda_device))
    assert (raster_row.KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES) == (
        launches[0] + 1, launches[1] + 1)
    for k, a in ref.items():
        assert torch.isfinite(got[k]).all(), k
        grad_tolerance(a.numpy(), got[k].cpu().numpy())


def _ibl_grid(device="cpu"):
    """The small grid under directional, point and spot lights, a seeded HDR
    env (maps built on ``device``) and a seeded u8 background."""
    scene, cam = _grid(device)
    lights = Lights.build(
        directional=[((0.577, 0.577, 0.577), (0.3, 0.25, 0.2))],
        point=[((1.5, 1.0, -4.0), (20.0, 15.0, 10.0))],
        spot=[((0.0, 4.0, -6.0), (0.0, -0.6, 0.8), (30.0, 30.0, 30.0), 8.0)],
        device=device,
    )
    env = torch.as_tensor(seeded_env(5), device=device)
    bg = np.random.default_rng(5).uniform(0, 1, (24, 48, 3)).astype(np.float32)
    scene = dataclasses.replace(scene, lights=lights, env_map=env, sky_map=sky_u8(bg).to(device))
    return scene.with_ibl(), cam


@pytest.mark.cuda
@pytest.mark.parametrize("bins", ["render", "jumbo"])
def test_ibl_kernel_matches_plain_version(cuda_device, bins):
    scene, cam = _ibl_grid(cuda_device)
    args = (*row_args(scene, cam), scene.ibl.irradiance_sh9)
    kw = dict(width=W, height=H, tile_h=8, want_gbuf=True, num_materials=49, num_dir=1, num_point=1,
              num_spot=1)
    kw.update(binning_params(args[0].shape[0], W, H) if bins == "render" else dict(max_span=2))
    before = raster_row.IBL_KERNEL_LAUNCHES, raster_row.KERNEL_LAUNCHES
    out = raster_row.rasterize_binned_shade_row(*args, **kw)
    assert (raster_row.IBL_KERNEL_LAUNCHES, raster_row.KERNEL_LAUNCHES) == (before[0] + 1, before[1])
    ref = raster_row.rasterize_binned_shade_row(*(a.cpu() for a in args), **kw)
    assert torch.equal(out.tri_id.cpu(), ref.tri_id) and torch.equal(out.mat_id.cpu(), ref.mat_id)
    assert out.rgba.shape == (H, W, 11)
    torch.testing.assert_close(out.rgba.cpu(), ref.rgba, atol=ATOL, rtol=1e-4)
    torch.testing.assert_close(out.gbuf.cpu(), ref.gbuf, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_ibl_backward_kernel_matches_plain_version(cuda_device):
    gb = random_gbuffer(21)
    rng = np.random.default_rng(22)
    kw = dict(gb["counts"], apply_tonemap=False, ibl=True)
    args = list(_bwd_inputs(gb, cuda_device))
    args[0] = torch.as_tensor(rng.normal(size=(*gb["mat_id"].shape, 11)).astype(np.float32), device=cuda_device)
    sh9 = torch.as_tensor(rng.normal(size=(9, 3)).astype(np.float32), device=cuda_device)
    args[5] = pack_shading_uniforms(**{k: torch.as_tensor(v, device=cuda_device) for k, v in gb["lights"].items()},
                                    sh9=sh9)
    args[4] = args[4].clone()
    args[4][0, 7], args[4][1, 7] = 0.0, 1.0  # the roughness sweep's ends
    before = raster_pallas.SHADE_BWD_IBL_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES
    got = raster_pallas.shade_backward(*args, **kw)
    again = raster_pallas.shade_backward_cuda(*args, **kw)
    assert (raster_pallas.SHADE_BWD_IBL_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES) == (before[0] + 2, before[1])
    ref = raster_pallas.shade_backward_plain(*args, **kw)
    hit = args[3]
    _close_to_plain(got, ref, args[2], hit)
    torch.testing.assert_close(got[3], ref[3], rtol=1e-3, atol=1e-5 * float(ref[3].abs().max()))
    assert torch.equal(again[2], got[2]) and torch.equal(again[3], got[3])
    assert not got[0][~hit].any() and not got[1][~hit].any()
    # the cotangent as channel planes (the forward's layout) reads the same
    planar = args[0].permute(2, 0, 1).contiguous().permute(1, 2, 0)
    for a, b in zip(got, raster_pallas.shade_backward_cuda(planar, *args[1:], **kw)):
        assert torch.equal(a, b)


def _ibl_grads(scene, cam):
    mats = {k: getattr(scene.materials, k).clone().requires_grad_() for k in ("diffuse", "roughness")}
    env = scene.env_map.clone().requires_grad_()
    strength = scene.lights.strength.clone().requires_grad_()
    s = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **mats), env_map=env,
                            lights=dataclasses.replace(scene.lights, strength=strength)).with_ibl()
    torch.mean(render(s, cam, width=W, height=H)[..., :3] ** 2).backward()
    return {**{k: t.grad for k, t in mats.items()}, "strength": strength.grad, "env_map": env.grad}


@pytest.mark.cuda
def test_ibl_render_and_gradients_on_card_match_cpu(cuda_device):
    scene, cam = _ibl_grid()
    dscene, dcam = _ibl_grid(cuda_device)
    torch.testing.assert_close(render(dscene, dcam, width=W, height=H).cpu(),
                               render(scene, cam, width=W, height=H), atol=5e-4, rtol=0)
    ref = _ibl_grads(scene, cam)
    launches = raster_row.IBL_KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_IBL_LAUNCHES
    got = _ibl_grads(dscene, dcam)
    assert (raster_row.IBL_KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_IBL_LAUNCHES) == (
        launches[0] + 1, launches[1] + 1)
    for k, a in ref.items():
        assert torch.isfinite(got[k]).all(), k
        grad_tolerance(a.numpy(), got[k].cpu().numpy(), atol_frac=1e-4 if k == "env_map" else 5e-5)


def _gbuffer_case(case, device):
    """Inputs of ``rasterize_binned_gbuffer_row`` for the grid on ``device``:
    C = 6 over the frame, a band ending in a partial tile, C = 14 seeded
    attributes, and a peel behind the first layer (the back faces)."""
    scene, cam = _grid(device)
    clip, attrs, fm = row_args(scene, cam)[:3]
    kw = dict(width=W, height=H, tile_h=8, max_span=16, num_materials=49)
    if case == "band":
        kw.update(rows=20, y_offset=37)
    if case == "c14":
        rng = np.random.default_rng(3)
        extra = torch.as_tensor(rng.normal(size=(attrs.shape[0], 3, 8)).astype(np.float32), device=device)
        attrs = torch.cat([attrs, extra], dim=-1)
    if case == "z_floor":  # no culling: the layer behind the spheres' front faces is their back faces
        kw["cull_backface"] = False
        first = raster_row.rasterize_binned_gbuffer_row(clip.cpu(), attrs.cpu(), fm.cpu(), **kw)
        kw["z_floor"] = torch.where(first.tri_id >= 0, first.depth, -torch.inf).to(device)
    return clip, attrs, fm, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["frame", "band", "c14", "z_floor"])
def test_gbuffer_kernel_matches_plain_version(cuda_device, case):
    clip, attrs, fm, kw = _gbuffer_case(case, cuda_device)
    before = raster_row.GBUF_KERNEL_LAUNCHES
    out = raster_row.rasterize_binned_gbuffer_row(clip, attrs, fm, **kw)
    assert raster_row.GBUF_KERNEL_LAUNCHES == before + 1
    ref = raster_row.rasterize_binned_gbuffer_row(
        clip.cpu(), attrs.cpu(), fm.cpu(), **{k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()})
    assert torch.equal(out.tri_id.cpu(), ref.tri_id) and torch.equal(out.mat_id.cpu(), ref.mat_id)
    torch.testing.assert_close(out.attrs.cpu(), ref.attrs, atol=1e-4, rtol=0)
    torch.testing.assert_close(out.depth.cpu(), ref.depth, atol=1e-6, rtol=0)
    assert (ref.tri_id >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tonemap", "ibl"])
def test_shade_forward_kernel_matches_plain_version(cuda_device, mode):
    gb = random_gbuffer(31)
    ibl = mode == "ibl"
    t = lambda x: torch.as_tensor(x, device=cuda_device)
    sh9 = t(np.random.default_rng(4).normal(size=(9, 3)).astype(np.float32)) if ibl else None
    uni = pack_shading_uniforms(**{k: t(v) for k, v in gb["lights"].items()}, sh9=sh9)
    args = [t(gb["attrs"]), t(gb["mat_id"]), t(gb["hit"]), t(gb["mat_props"]), uni]
    args[1][0, :9], args[1][1, :5] = 5, -1  # out-of-table ids fetch zeros
    kw = dict(gb["counts"], ibl=ibl)
    counter = "SHADE_FWD_IBL_LAUNCHES" if ibl else "SHADE_FWD_LAUNCHES"
    before = getattr(raster_pallas, counter)
    got = raster_pallas.shade_forward(*args, **kw)
    assert getattr(raster_pallas, counter) == before + 1
    ref = raster_pallas.shade_forward_plain(*args, **kw)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=1e-4 if ibl else 0)
    assert not got[~args[2]].any()
    # a strided band: the first 6 channels of a (rows, W, 7) G-buffer
    wide = torch.cat([args[0], torch.zeros_like(args[0][..., :1])], dim=-1)[..., :6]
    assert torch.equal(raster_pallas.shade_forward_cuda(wide, *args[1:], **kw), got)


def _tri_sharded_grads(scene, cam):
    mats = {k: getattr(scene.materials, k).clone().requires_grad_() for k in ("diffuse", "roughness")}
    worlds = scene.draws[0].worlds.clone().requires_grad_()
    s = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **mats),
                            draws=(dataclasses.replace(scene.draws[0], worlds=worlds),))
    img = pbr_sharded.render_tri_sharded(s, cam, width=W, height=H)
    torch.mean(img[..., :3] ** 2).backward()
    return img.detach(), {**{k: t.grad for k, t in mats.items()}, "worlds": worlds.grad}


@pytest.mark.cuda
def test_tri_sharded_on_card_matches_cpu(cuda_device):
    """A world of one: kernel 2 rasterizes the band, kernel 6 shades it,
    kernel 3 differentiates it; image and gradients against the CPU."""
    img_ref, ref = _tri_sharded_grads(*_grid())
    before = raster_row.GBUF_KERNEL_LAUNCHES, raster_pallas.SHADE_FWD_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES
    img, got = _tri_sharded_grads(*_grid(cuda_device))
    after = raster_row.GBUF_KERNEL_LAUNCHES, raster_pallas.SHADE_FWD_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    torch.testing.assert_close(img.cpu(), img_ref, atol=ATOL, rtol=0)
    for k, a in ref.items():
        grad_tolerance(a.numpy(), got[k].cpu().numpy())


def _textured(device="cpu", mode="quad"):
    """``pbr_scene`` with seeded 32² pages (``chip_smoke.seeded_texture_pages``)
    and its combined pages, at the grid camera."""
    from chip_smoke import fill_asset_cache, seeded_texture_pages

    cache = fill_asset_cache(scenes.AssetCache(texture_size=32), seeded_texture_pages(5, 32))
    scene = scenes.pbr_scene(cache, texture_size=32, slices=16, stacks=8, device=device)
    return scene.with_combined_textures(mode=mode), Camera.create(position=(0.0, -3.0, -18.0), aspect=W / H,
                                                                  device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["frame", "jumbo", "z_floor"])
def test_kernel4_matches_plain_version(cuda_device, case):
    """Kernel 4: the G-buffer mode at 16×128 tiles (PPT 8) and C = 14 in the
    v1 binning; a forced jumbo run (max span 2); a peel without culling."""
    from physically_based_renderer_tpu_torch import flatten_scene_corners, math3d

    scene, cam = _textured(cuda_device)
    g = flatten_scene_corners(scene, textured=True)
    clip = math3d.transform_points_h(g.pos_w, cam.view_proj())
    kw = dict(width=W, height=H, num_materials=58, max_span=2 if case == "jumbo" else 8)
    if case == "z_floor":
        kw["cull_backface"] = False
        first = raster_pallas.rasterize_binned_gbuffer(clip.cpu(), g.attrs.cpu(), g.face_material.cpu(), **kw)
        kw["z_floor"] = torch.where(first.tri_id >= 0, first.depth, -torch.inf).to(cuda_device)
    before = raster_row.GBUF_V1_KERNEL_LAUNCHES, raster_row.GBUF_KERNEL_LAUNCHES
    out = raster_pallas.rasterize_binned_gbuffer(clip, g.attrs, g.face_material, **kw)
    assert (raster_row.GBUF_V1_KERNEL_LAUNCHES, raster_row.GBUF_KERNEL_LAUNCHES) == (before[0] + 1, before[1])
    ref = raster_pallas.rasterize_binned_gbuffer(clip.cpu(), g.attrs.cpu(), g.face_material.cpu(),
                                                 **{k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()})
    assert out.attrs.shape[-1] == 14
    assert torch.equal(out.tri_id.cpu(), ref.tri_id) and torch.equal(out.mat_id.cpu(), ref.mat_id)
    torch.testing.assert_close(out.attrs.cpu(), ref.attrs, atol=1e-4, rtol=0)
    torch.testing.assert_close(out.depth.cpu(), ref.depth, atol=1e-6, rtol=0)
    assert (ref.tri_id >= 0).any()


@pytest.mark.cuda
def test_textured_render_on_card_matches_cpu(cuda_device):
    """A textured 128×64 frame through kernel 4 on the card against the CPU
    under the textured frame bounds (``tests/test_raster_gbuf.py:43-63``);
    the material gradients of two steps the same bits."""
    scene, cam = _textured()
    ref = render(scene, cam, width=W, height=H).numpy()
    before = raster_row.GBUF_V1_KERNEL_LAUNCHES
    got = render(scene.to(cuda_device), cam.to(cuda_device), width=W, height=H).cpu().numpy()
    assert raster_row.GBUF_V1_KERNEL_LAUNCHES == before + 1
    d = np.abs(got - ref)
    assert (d > 1e-5).mean() < 5e-3 and np.median(d) < 1e-6 and np.quantile(d, 0.999) < 1e-2
    dev_scene, dev_cam = scene.to(cuda_device), cam.to(cuda_device)
    grads = []
    for _ in range(2):
        leaf = dev_scene.materials.diffuse.clone().requires_grad_()
        s = dataclasses.replace(dev_scene, materials=dataclasses.replace(dev_scene.materials, diffuse=leaf))
        (g,) = torch.autograd.grad(torch.mean(render(s, dev_cam, width=W, height=H)[..., :3] ** 2), leaf)
        grads.append(g)
    assert torch.equal(grads[0], grads[1]) and bool(grads[0].abs().sum() > 0)
