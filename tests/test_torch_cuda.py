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
Kernel 5 (the ids mode, exact depth): codes exact, depth within 1e-6 (the
same plane, unfused). Kernel 7 / 7b (the shade mode in the v1 binning) as
the shade mode. Kernel 5b (the dilated ids mode) against the plain version
on one binning: codes exact, depth bit-equal; ``render_soft`` and its
gradients on the card against the CPU as ``render``'s; the frame loop heals
its pair cap on the card. The per-warp reject of kernels 5 and 5b (their
culled resolve) against the plain version, which culls nothing, on exact
ties, ±0.0 depths, a floor equal to a candidate's depth, long and jumbo
runs, a band and dilated slivers: codes exact, depth bit-equal, the same
bits on two launches.
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ids", "z_floor", "material_mask"])
def test_kernel5_matches_plain_version(cuda_device, case):
    """Kernel 5: the ids mode at 16×128 tiles (PPT 8) on the grid at 256×128,
    against the plain version: codes exact; depth (+inf at background) the
    same plane in the same order, within 1e-6; a peel behind the first
    layer without culling; material codes under a ``tri_mask``."""
    width, height = 256, 128
    scene, cam = _grid(cuda_device)
    clip, _, fm = row_args(scene, cam)[:3]
    kw = dict(width=width, height=height, return_depth=case != "ids")
    if case == "z_floor":
        kw["cull_backface"] = False
        first = raster_pallas.rasterize_binned(clip.cpu(), None, **kw)
        kw["z_floor"] = torch.where(first.tri_id >= 0, first.depth, -torch.inf).to(cuda_device)
    if case == "material_mask":
        kw.update(face_material=fm, num_materials=49,
                  tri_mask=torch.arange(clip.shape[0], device=cuda_device) % 3 != 0)
    before = raster_row.IDS_KERNEL_LAUNCHES
    out = raster_pallas.rasterize_binned(clip, None, **kw)
    assert raster_row.IDS_KERNEL_LAUNCHES == before + 1
    ref = raster_pallas.rasterize_binned(clip.cpu(), None,
                                         **{k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()})
    assert not bool(out.overflowed) and (ref.tri_id >= 0).any()
    assert torch.equal(out.tri_id.cpu(), ref.tri_id)
    if case == "material_mask":
        assert torch.equal(out.mat_id.cpu(), ref.mat_id)
    if kw["return_depth"]:
        torch.testing.assert_close(out.depth.cpu(), ref.depth, atol=1e-6, rtol=0)
        assert bool(torch.isposinf(out.depth[out.tri_id < 0]).all())
    else:
        assert out.depth is None


@pytest.mark.cuda
@pytest.mark.parametrize("ibl", [False, True])
def test_kernel7_matches_plain_version(cuda_device, ibl):
    """Kernel 7 / 7b: ``raster_shade[_ibl]`` with the JAX defaults (the v1
    binning at 4×128 tiles, the shade mode at PPT 2) on the grid at 256×128,
    against the plain version: ids exact, RGBA within 2e-4 (the IBL
    channels within 2e-4 + 1e-4·|v|), the launch counted as kernel 7."""
    width, height = 256, 128
    scene, cam = (_ibl_grid if ibl else _grid)(cuda_device)
    args = row_args(scene, cam) + ((scene.ibl.irradiance_sh9,) if ibl else ())
    lights = scene.lights
    kw = dict(width=width, height=height, num_materials=49, num_dir=lights.num_dir, num_point=lights.num_point,
              num_spot=lights.num_spot)
    fn = raster_pallas.raster_shade_ibl if ibl else raster_pallas.raster_shade
    names = ("SHADE_V1_IBL_KERNEL_LAUNCHES", "IBL_KERNEL_LAUNCHES") if ibl else (
        "SHADE_V1_KERNEL_LAUNCHES", "KERNEL_LAUNCHES")
    before = tuple(getattr(raster_row, n) for n in names)
    out = fn(*args, **kw)
    assert tuple(getattr(raster_row, n) for n in names) == (before[0] + 1, before[1])
    ref = fn(*(a.cpu() for a in args), **kw)
    assert torch.equal(out.tri_id.cpu(), ref.tri_id) and torch.equal(out.mat_id.cpu(), ref.mat_id)
    torch.testing.assert_close(out.rgba.cpu(), ref.rgba, atol=ATOL, rtol=1e-4 if ibl else 0)
    assert (ref.tri_id >= 0).any() and out.rgba.shape == (height, width, 11 if ibl else 4)


@pytest.mark.cuda
@pytest.mark.parametrize("floor", [False, True])
def test_kernel5b_matches_plain_version(cuda_device, floor):
    """Kernel 5b, the dilated ids mode (margin 3 px, z floor and depth: the
    soft raster's peels), on the grid at 256×128 against the plain version
    on the same binning: codes exact, depth bit-equal; a second peel behind
    the first; the launch counted as the dilated mode's."""
    width, height = 256, 128
    scene, cam = _grid(cuda_device)
    clip = row_args(scene, cam)[0]
    binned = raster_row.bin_for_shade(clip, None, None, width=width, height=height, rows=height, y_offset=0,
                                      tile_h=16, tile_w=128, max_span=8, pairs_cap=None, big_cap=None, big2_span=0,
                                      big2_cap=None, cull_backface=True, bbox_margin_px=3.0)
    kw = dict(width=width, rows=height, y_offset=0, tile_h=16, tile_w=128, mat_stride=1, want_depth=True,
              z_floor=torch.full((height, width), -torch.inf, device=cuda_device), margin=3.0)
    args = (binned.starts, binned.packed, binned.pair_tri)
    if floor:
        code0, depth0 = raster_row.raster_ids_tiles_plain(*args, **kw)
        kw["z_floor"] = torch.where(code0 >= 0, depth0, -torch.inf).contiguous()
    before = (raster_row.IDS_KERNEL_LAUNCHES, raster_row.IDS_MARGIN_KERNEL_LAUNCHES)
    code, depth = raster_row.raster_ids_tiles_cuda(*args, **kw)
    assert (raster_row.IDS_KERNEL_LAUNCHES, raster_row.IDS_MARGIN_KERNEL_LAUNCHES) == (before[0], before[1] + 1)
    ref_code, ref_depth = raster_row.raster_ids_tiles_plain(*args, **kw)
    assert torch.equal(code, ref_code) and torch.equal(depth, ref_depth) and bool((code >= 0).any())
    out = raster_pallas.rasterize_binned(clip, None, width=width, height=height, edge_margin_px=3.0)
    assert raster_row.IDS_MARGIN_KERNEL_LAUNCHES == before[1] + 2 and out.depth is None  # no floor, no depth asked


@pytest.mark.cuda
def test_render_soft_on_card_matches_cpu(cuda_device):
    """``render_soft`` at 128×64 on the grid: the peels equal, the image
    within 2e-4, the gradients of mean(img²) to the world matrices and the
    bank within the gradient tolerance; 3 kernel-5b, 3 kernel-6 and 3
    kernel-3 launches."""
    from physically_based_renderer_tpu_torch.ops import raster_soft
    from physically_based_renderer_tpu_torch.renderer import render_soft

    scene, cam = _grid()
    clip = row_args(scene, cam)[0]
    kw = dict(width=W, height=H, num_layers=3, edge_margin_px=3.0)
    ids_dev, _ = raster_soft.peel_layers(clip.to(cuda_device), None, **kw)
    assert torch.equal(ids_dev.cpu(), raster_soft.peel_layers(clip, None, **kw)[0])

    def grads(s, c):
        leaves = dict(worlds=s.draws[0].worlds.clone().requires_grad_(),
                      diffuse=s.materials.diffuse.clone().requires_grad_())
        s = dataclasses.replace(s, draws=(dataclasses.replace(s.draws[0], worlds=leaves["worlds"]),),
                                materials=dataclasses.replace(s.materials, diffuse=leaves["diffuse"]))
        img = render_soft(s, c, width=W, height=H)
        return img.detach(), torch.autograd.grad(torch.mean(img**2), list(leaves.values()))

    names = ("IDS_MARGIN_KERNEL_LAUNCHES",), ("SHADE_FWD_LAUNCHES", "SHADE_BWD_LAUNCHES")
    before = [getattr(raster_row, names[0][0])] + [getattr(raster_pallas, n) for n in names[1]]
    img, g = grads(scene.to(cuda_device), cam.to(cuda_device))
    after = [getattr(raster_row, names[0][0])] + [getattr(raster_pallas, n) for n in names[1]]
    assert [a - b for a, b in zip(after, before)] == [3, 3, 3]
    ref_img, ref_g = grads(scene, cam)
    torch.testing.assert_close(img.cpu(), ref_img, atol=ATOL, rtol=0)
    for a, b in zip(ref_g, g):
        grad_tolerance(a.numpy(), b.cpu().numpy())


@pytest.mark.cuda
def test_render_loop_on_card_heals_the_pair_cap(cuda_device):
    from physically_based_renderer_tpu_torch.app import RenderLoop, turntable_inputs
    from physically_based_renderer_tpu_torch.utils.config import RenderConfig

    scene, cam = _grid(cuda_device)
    loop = RenderLoop(scene, cam, RenderConfig(width=W, height=H, raster_pairs_cap=128))
    frames = loop.run_sequence(turntable_inputs(2))
    assert loop.config.raster_pairs_cap > 128 and frames[-1].shape == (H, W, 4)
    assert np.isfinite(frames[-1]).all()


def _seeded_tris(case, width, height, device, run_rows=8):
    """Clip coordinates (w = 1), attributes and materials of seeded
    triangles on two depth levels, so that overlaps tie exactly under the
    quantized key: a few hundred over the frame, or ("long_run") 700 small
    ones inside the first ``run_rows``x128 tile, a run of three chunks."""
    rng = np.random.default_rng(17)
    n = 700 if case == "long_run" else 300
    hi = (128, run_rows) if case == "long_run" else (width, height)
    centre = rng.uniform((0, 0), hi, (n, 1, 2))
    size = rng.choice([1.5, 4.0, 12.0, 40.0], (n, 1, 1)) if case != "long_run" else 3.0
    xy = centre + rng.uniform(-1.0, 1.0, (n, 3, 2)) * size
    if case == "long_run":
        xy = np.clip(xy, 0.0, (127.9, run_rows - 0.1))
    z = np.repeat(rng.choice([0.25, 0.5], (n, 1)), 3, axis=1)
    clip = np.stack([xy[..., 0] / width * 2 - 1, 1 - xy[..., 1] / height * 2, z, np.ones_like(z)], -1)
    attrs = np.concatenate([rng.uniform(-2, 2, (n, 3, 3)), rng.normal(size=(n, 3, 3))], -1)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    return t(clip), t(attrs), t(rng.integers(0, 5, n), torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "ties_ibl", "ties_4x128", "ties_4x128_ibl", "long_run", "band",
                                  "ties_4x256"])
def test_culled_shade_kernel_matches_plain_version(cuda_device, case):
    """Kernel 1's per-warp reject against the plain version (which culls
    nothing): exact quantized-depth ties on two levels whose first-drawn
    winner misses some warps' blocks (the codes differ where the triangle
    order is reversed), the 8x128 and 4x128 tiles (PPT 4 and 2) with and
    without IBL, 4x256 tiles (the strided pixel map: 16 blocks of 16x8 do
    not fit 8 warps), a tile's run of three 256-pair chunks, a band at
    y_offset 13; codes exact, the same bits twice."""
    width, height = 256, 64
    ibl = case.endswith("ibl")
    tile_h = 4 if "4x" in case else 8
    tile_w = 256 if "x256" in case else 128
    rows, y_offset = (40, 13) if case == "band" else (height, 0)
    clip, attrs, fm = _seeded_tris(case, width, height, cuda_device)
    gb = random_gbuffer(3)
    rng = np.random.default_rng(4)
    sh9 = torch.as_tensor(rng.normal(size=(9, 3)).astype(np.float32), device=cuda_device) if ibl else None
    uni = pack_shading_uniforms(**{k: torch.as_tensor(v, device=cuda_device) for k, v in gb["lights"].items()},
                                sh9=sh9)
    table = torch.as_tensor(gb["mat_props"], device=cuda_device)
    kw = dict(width=width, rows=rows, y_offset=y_offset, tile_h=tile_h, tile_w=tile_w, mat_stride=8,
              apply_tonemap=not ibl, ibl=ibl, want_gbuf=True, **gb["counts"])

    def run(c, device, kernel):
        binned = raster_row.bin_for_shade(c, attrs.to(device), fm.to(device), width=width, height=height,
                                          rows=rows, y_offset=y_offset, tile_h=tile_h, tile_w=tile_w, max_span=16,
                                          pairs_cap=None, big_cap=None, big2_span=0, big2_cap=None,
                                          cull_backface=False)
        args = (binned.starts, binned.packed, binned.pair_tri, table.to(device), uni.to(device))
        return binned, kernel(*args, **kw)

    binned, got = run(clip, cuda_device, raster_row.raster_shade_tiles_cuda)
    _, again = run(clip, cuda_device, raster_row.raster_shade_tiles_cuda)
    _, ref = run(clip.cpu(), "cpu", raster_row.raster_shade_tiles_plain)
    if case == "long_run":
        assert int(binned.starts[1] - binned.starts[0]) > 2 * 256
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[0].cpu(), ref[0]) and bool((ref[0] >= 0).any())
    torch.testing.assert_close(got[1].cpu(), ref[1], atol=ATOL, rtol=1e-4 if ibl else 0)
    torch.testing.assert_close(got[2].cpu(), ref[2], atol=1e-4, rtol=0)
    if case.startswith("ties"):  # the ties decide pixels: drawn in reverse, other triangles win there
        _, rev = run(clip.cpu().flip(0), "cpu", raster_row.raster_shade_tiles_plain)
        n = clip.shape[0]
        rev_tri = torch.where(rev[0] >= 0, n - 1 - rev[0] // 8, -1)
        assert bool(((rev_tri != torch.where(ref[0] >= 0, ref[0] // 8, -1)) & (ref[0] >= 0)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("ibl", [False, True])
@pytest.mark.parametrize("num_materials", [5, 400])
def test_backward_kernel_without_outputs(cuda_device, ibl, num_materials):
    """Kernel 3 with its per-pixel outputs skipped (the fused step's call):
    None in their places, g_uni and the table the same bits as the full
    call's and on a second launch, the full call against the plain version;
    at 5 materials (a table a warp) and at 400 (past the per-warp tables:
    one table the warps add to in turn)."""
    gb = random_gbuffer(11)
    rng = np.random.default_rng(12)
    kw = dict(gb["counts"], apply_tonemap=not ibl, ibl=ibl)
    args = list(_bwd_inputs(gb, cuda_device))
    if ibl:
        args[0] = torch.as_tensor(rng.normal(size=(*gb["mat_id"].shape, 11)).astype(np.float32), device=cuda_device)
        sh9 = torch.as_tensor(rng.normal(size=(9, 3)).astype(np.float32), device=cuda_device)
        args[5] = pack_shading_uniforms(**{k: torch.as_tensor(v, device=cuda_device)
                                           for k, v in gb["lights"].items()}, sh9=sh9)
    if num_materials > 5:
        extra = rng.uniform(0.05, 1.0, (num_materials - 5, 9)).astype(np.float32)
        args[4] = torch.cat([args[4], torch.as_tensor(extra, device=cuda_device)])
        args[2] = torch.as_tensor(rng.integers(-1, num_materials + 1, gb["mat_id"].shape).astype(np.int32),
                                  device=cuda_device)
    full = raster_pallas.shade_backward_cuda(*args, **kw)
    lean = raster_pallas.shade_backward_cuda(*args, want_attrs=False, want_props=False, **kw)
    again = raster_pallas.shade_backward_cuda(*args, want_attrs=False, want_props=False, **kw)
    attrs_only = raster_pallas.shade_backward_cuda(*args, want_props=False, **kw)
    assert lean[0] is None and lean[1] is None and attrs_only[1] is None
    assert torch.equal(attrs_only[0], full[0])
    for a, b, c in zip(full[2:], lean[2:], again[2:]):
        assert torch.equal(a, b) and torch.equal(b, c)
    ref = raster_pallas.shade_backward_plain(*args, **kw)
    _close_to_plain(full, ref, args[2], args[3])
    torch.testing.assert_close(full[3], ref[3], rtol=1e-3, atol=1e-5 * float(ref[3].abs().max()))
    assert bool(full[3][5:].abs().sum() > 0) == (num_materials > 5)


def _ids_case(case, device):
    """The binning and ids-mode arguments of one culled-ids case at 256×64
    (16×128 tiles, material codes): ties on two exact depth levels
    (``_seeded_tris``), the same at ±0.0, a peel behind a floor equal to the
    first peel's depths, a tile's run of three 256-pair chunks, a forced
    jumbo run, a band at y_offset 13, or seeded slivers at a margin (kernel
    5b)."""
    width, height = 256, 64
    rows, y_offset = (40, 13) if case == "band" else (height, 0)
    margin = float(case.split("_")[1]) if case.startswith("slivers") else 0.0
    if margin:
        rng = np.random.default_rng(23)
        n = 300
        base = rng.uniform((0, 0), (width, height), (n, 1, 2))
        tip = base + rng.uniform(-12, 12, (n, 1, 2))
        xy = np.concatenate([base, tip, (base + tip) / 2 + rng.uniform(-0.3, 0.3, (n, 1, 2))], 1)
        z = np.repeat(rng.uniform(0.1, 0.9, (n, 1)), 3, axis=1)
        clip = torch.as_tensor(np.stack([xy[..., 0] / width * 2 - 1, 1 - xy[..., 1] / height * 2, z,
                                         np.ones_like(z)], -1), dtype=torch.float32, device=device)
        fm = torch.as_tensor(rng.integers(0, 5, n), dtype=torch.int32, device=device)
    else:
        clip, _, fm = _seeded_tris("long_run" if case == "long_run" else "ties", width, height, device)
    if case == "neg_zero":  # every depth ±0.0: -0.0 must tie +0.0, not win as the most negative key
        clip[..., 2] = torch.where(torch.arange(clip.shape[0], device=device)[:, None] % 2 == 0, -0.0, 0.0)
    binned = raster_row.bin_for_shade(clip, None, fm, width=width, height=height, rows=rows, y_offset=y_offset,
                                      tile_h=16, tile_w=128, max_span=1 if case == "jumbo" else 8, pairs_cap=None,
                                      big_cap=None, big2_span=0, big2_cap=None, cull_backface=False,
                                      bbox_margin_px=margin)
    kw = dict(width=width, rows=rows, y_offset=y_offset, tile_h=16, tile_w=128, mat_stride=8, want_depth=True,
              z_floor=torch.full((rows, width), -torch.inf, device=device), margin=margin)
    args = (binned.starts, binned.packed, binned.pair_tri)
    if case == "floor_tie":  # candidates whose depth equals the floor exactly must not pass it
        code0, depth0 = raster_row.raster_ids_tiles_plain(*args, **kw)
        kw["z_floor"] = torch.where(code0 >= 0, depth0, -torch.inf).contiguous()
    return clip, args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "neg_zero", "floor_tie", "long_run", "jumbo", "band", "slivers_3.0",
                                  "slivers_2.1"])
def test_culled_ids_kernel_matches_plain_version(cuda_device, case):
    """Kernels 5 / 5b's per-warp reject (16×16 warp blocks) against the
    plain version, which culls nothing: codes exact, depth bit-equal, the
    same bits on two launches. Ties decide pixels (drawn in reverse, other
    triangles win there); a jumbo run and a tile's run of three chunks are
    there; kernel 5b's winners cover pixels outside their boxes grown by the
    margin (a sliver's dilated wedge)."""
    clip, args, kw = _ids_case(case, cuda_device)
    got = raster_row.raster_ids_tiles_cuda(*args, **kw)
    again = raster_row.raster_ids_tiles_cuda(*args, **kw)
    cpu = lambda t: t.cpu() if torch.is_tensor(t) else t  # noqa: E731
    ref = raster_row.raster_ids_tiles_plain(*map(cpu, args), **{k: cpu(v) for k, v in kw.items()})
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    hit = ref[0] >= 0
    assert bool(hit.any())
    if case == "jumbo":
        assert int(args[0][0]) > 0
    if case == "long_run":
        assert int(args[0][1] - args[0][0]) > 2 * 256
    if case == "neg_zero":
        assert bool(torch.signbit(ref[1][hit]).any())
    if case in ("ties", "neg_zero"):  # drawn in reverse, other triangles win the tied pixels
        flipped = clip.cpu().flip(0)
        b = raster_row.bin_for_shade(flipped, None, torch.zeros(clip.shape[0], dtype=torch.int32), width=256,
                                     height=64, rows=64, y_offset=0, tile_h=16, tile_w=128, max_span=8,
                                     pairs_cap=None, big_cap=None, big2_span=0, big2_cap=None, cull_backface=False)
        rev, _ = raster_row.raster_ids_tiles_plain(b.starts, b.packed, b.pair_tri, **dict(
            {k: cpu(v) for k, v in kw.items()}, mat_stride=1))
        n = clip.shape[0]
        assert bool(((torch.where(rev >= 0, n - 1 - rev, -1) != torch.where(hit, ref[0] // 8, -1)) & hit).any())
    if case.startswith("slivers"):  # the wedge: winners outside their triangle's box grown by the margin
        from chip_smoke import screen_xy

        xy = screen_xy(clip.cpu(), 256, 64).double()
        tri = (ref[0][hit] // 8).long()
        rr, cc = torch.nonzero(hit, as_tuple=True)
        px, py = cc.double() + 0.5, rr.double() + 0.5
        lo, hi = xy.amin(1)[tri] - kw["margin"], xy.amax(1)[tri] + kw["margin"]
        assert bool(((px < lo[:, 0]) | (px > hi[:, 0]) | (py < lo[:, 1]) | (py > hi[:, 1])).any())


def _gbuffer_cull_case(case, layout, device):
    """The binning and G-buffer-mode arguments of one culled G-buffer case at
    256×64: C = 6 at 8×128 tiles (kernel 2's row binning, PPT 4), C = 6 at
    4×128 (kernel 2 under ``render(raster_backend="pallas_gbuf_row")``, PPT
    2), C = 14 at 16×128 (kernel 4's, PPT 8), or C = 6 at 8×256 (PPT 8 and
    16 blocks of 16×16 for 8 warps: the strided pixel map). Quantized-depth
    ties on two levels (``_seeded_tris``), a tile's run of three 256-pair
    chunks (inside the first tile's rows), a
    forced jumbo run, a band at y_offset 13, 250 pixels wide, that ends in
    partial tiles and partial warp blocks (rows at an offset no float4
    store takes), or a peel behind a floor equal to the first layer's
    depths."""
    width, height = (250 if case == "band" else 256), 64
    tile_h = {"c14_16x128": 16, "c6_4x128": 4}.get(layout, 8)
    tile_w = 256 if layout == "c6_8x256" else 128
    rows, y_offset = (37, 13) if case == "band" else (height, 0)
    clip, attrs, fm = _seeded_tris("long_run" if case == "long_run" else "ties", 256, height, device,
                                   run_rows=min(tile_h, 8))
    if layout == "c14_16x128":
        extra = np.random.default_rng(29).normal(size=(attrs.shape[0], 3, 8)).astype(np.float32)
        attrs = torch.cat([attrs, torch.as_tensor(extra, device=device)], dim=-1)
    binned = raster_row.bin_for_shade(clip, attrs, fm, width=width, height=height, rows=rows, y_offset=y_offset,
                                      tile_h=tile_h, tile_w=tile_w, max_span=1 if case == "jumbo" else 16,
                                      pairs_cap=None, big_cap=None, big2_span=0, big2_cap=None, cull_backface=False)
    kw = dict(width=width, rows=rows, y_offset=y_offset, tile_h=tile_h, tile_w=tile_w, mat_stride=8,
              num_ch=attrs.shape[-1] + 1)
    args = (binned.starts, binned.packed, binned.pair_tri)
    if case == "floor_tie":  # candidates whose depth equals the floor exactly must not pass it
        code0, gb0 = raster_row.raster_gbuffer_tiles_plain(*args, **kw)
        kw["z_floor"] = torch.where(code0 >= 0, gb0[..., -1], -torch.inf).contiguous()
    return clip, attrs, fm, args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["c6_8x128", "c6_4x128", "c14_16x128", "c6_8x256"])
@pytest.mark.parametrize("case", ["ties", "long_run", "jumbo", "band", "floor_tie"])
def test_culled_gbuffer_kernel_matches_plain_version(cuda_device, case, layout):
    """Kernels 2 / 4's per-warp reject (16×8 warp blocks at 8×128 tiles,
    16×4 at 4×128, 16×16 at 16×128, the strided map at 8×256) and staged stores against
    the plain version, which culls nothing: codes
    exact, the G-buffer (attributes and NDC depth) bit-equal -- the same
    planes, rounded step by step in the same order, and IEEE division on
    both sides -- and the same bits on two launches. Ties decide pixels
    (drawn in reverse, other triangles win there); a jumbo run and a tile's
    run of three chunks are there; a floor equal to the first layer's depth
    lets none of that layer through."""
    clip, attrs, fm, args, kw = _gbuffer_cull_case(case, layout, cuda_device)
    got = raster_row.raster_gbuffer_tiles_cuda(*args, **kw)
    again = raster_row.raster_gbuffer_tiles_cuda(*args, **kw)
    cpu = lambda t: t.cpu() if torch.is_tensor(t) else t  # noqa: E731
    ref = raster_row.raster_gbuffer_tiles_plain(*map(cpu, args), **{k: cpu(v) for k, v in kw.items()})
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    hit = ref[0] >= 0
    assert bool(hit.any()) and got[1].shape[-1] == attrs.shape[-1] + 1
    if case == "jumbo":
        assert int(args[0][0]) > 0
    if case == "long_run":
        assert int((args[0][1:] - args[0][:-1]).max()) > 2 * 256
    if case == "band":
        assert kw["rows"] % kw["tile_h"] != 0 and kw["width"] % 16 != 0
    if case == "floor_tie":  # the floor is the first layer's depth: that layer never passes it
        floor = cpu(kw["z_floor"])
        assert bool((ref[1][..., -1][hit] > floor[hit]).all())
    if case == "ties":  # drawn in reverse, other triangles win the tied pixels
        flipped = clip.cpu().flip(0)
        b = raster_row.bin_for_shade(flipped, attrs.cpu().flip(0), fm.cpu().flip(0), width=kw["width"], height=64,
                                     rows=kw["rows"], y_offset=0, tile_h=kw["tile_h"], tile_w=kw["tile_w"], max_span=16,
                                     pairs_cap=None, big_cap=None, big2_span=0, big2_cap=None, cull_backface=False)
        rev, _ = raster_row.raster_gbuffer_tiles_plain(b.starts, b.packed, b.pair_tri, **kw)
        n = clip.shape[0]
        rev_tri = torch.where(rev >= 0, n - 1 - rev // 8, -1)
        assert bool(((rev_tri != torch.where(hit, ref[0] // 8, -1)) & hit).any())


def _indexed_grid(device):
    """The small grid as indexed geometry on ``device``: clip (V, 4), tris,
    attrs (V, 6), face material, M."""
    from physically_based_renderer_tpu_torch import flatten_scene, math3d

    scene, cam = _grid(device)
    flat = flatten_scene(scene)
    clip = math3d.transform_points_h(flat.pos_w, cam.view_proj())
    return clip, flat.tris, torch.cat([flat.pos_w, flat.normal_w], -1), flat.face_material, \
        scene.materials.num_materials


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["5", "5_floor", "5b", "4"])
def test_indexed_input_equals_corner_major_on_card(cuda_device, kernel):
    """Kernels 5, 5b and 4 on indexed input (one vertex projection, one
    corner gather) against the corner-major ``clip[tris]``: bit for bit, and
    the launch against its plain version (codes exact, depth within 1e-6,
    attributes within 1e-4)."""
    clip, tris, attrs, fm, num_materials = _indexed_grid(cuda_device)
    idx = tris.long()
    kw = dict(width=W, height=H, face_material=fm, num_materials=num_materials)
    if kernel == "4":
        got = raster_pallas.rasterize_binned_gbuffer(clip, attrs, fm, tris=tris, width=W, height=H,
                                                     num_materials=num_materials)
        ref = raster_pallas.rasterize_binned_gbuffer(clip[idx], attrs[idx], fm, width=W, height=H,
                                                     num_materials=num_materials)
        cpu = raster_pallas.rasterize_binned_gbuffer(clip.cpu(), attrs.cpu(), fm.cpu(), tris=tris.cpu(), width=W,
                                                     height=H, num_materials=num_materials)
        assert torch.equal(got.attrs, ref.attrs) and torch.equal(got.depth, ref.depth)
        torch.testing.assert_close(got.attrs.cpu(), cpu.attrs, atol=1e-4, rtol=0)
    else:
        kw.update(return_depth=True, edge_margin_px=3.0 if kernel == "5b" else 0.0)
        if kernel == "5_floor":
            first = raster_pallas.rasterize_binned(clip, tris, **kw)
            kw.update(z_floor=torch.where(first.tri_id >= 0, first.depth, -torch.inf), cull_backface=False)
        got = raster_pallas.rasterize_binned(clip, tris, **kw)
        ref = raster_pallas.rasterize_binned(clip[idx], None, **kw)
        cpu_kw = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
        cpu = raster_pallas.rasterize_binned(clip.cpu(), tris.cpu(), **cpu_kw)
        assert torch.equal(got.depth, ref.depth)
        hit = cpu.tri_id >= 0
        torch.testing.assert_close(got.depth.cpu()[hit], cpu.depth[hit], atol=1e-6, rtol=0)
    assert torch.equal(got.tri_id, ref.tri_id) and torch.equal(got.mat_id, ref.mat_id)
    assert torch.equal(got.tri_id.cpu(), cpu.tri_id) and int((got.tri_id >= 0).sum()) > 100


ROUTE_COUNTERS = {
    "pallas_shade_row": ("raster_row", "KERNEL_LAUNCHES"),
    "pallas_shade": ("raster_row", "SHADE_V1_KERNEL_LAUNCHES"),
    "pallas_gbuf": ("raster_row", "GBUF_V1_KERNEL_LAUNCHES"),
    "pallas_gbuf_row": ("raster_row", "GBUF_KERNEL_LAUNCHES"),
    "pallas": ("raster_row", "IDS_KERNEL_LAUNCHES"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTE_COUNTERS) + ["jnp", "brute"])
def test_route_launches_its_kernel_on_card(cuda_device, route):
    """Each route of ``render(raster_backend=)`` launches its own kernel once
    a frame and no other raster kernel; the oracles launch none. The frame
    matches the CPU's route within the render tolerance; ``*_interpret``
    names are refused on the card."""
    scene, cam = _grid(cuda_device)
    names = sorted({c for _, c in ROUTE_COUNTERS.values()})
    for n in names:
        setattr(raster_row, n, 0)
    img = render(scene, cam, width=W, height=H, raster_backend=route)
    torch.cuda.synchronize()
    counts = {n: getattr(raster_row, n) for n in names}
    want = {n: int(ROUTE_COUNTERS.get(route, (None, None))[1] == n) for n in names}
    assert counts == want, counts
    cpu_scene, cpu_cam = _grid("cpu")
    ref = render(cpu_scene, cpu_cam, width=W, height=H, raster_backend=route)
    assert (((img.cpu() - ref).abs().amax(-1) > ATOL).float().mean()) <= 2e-3
    with pytest.raises(ValueError, match="CPU tensors only"):
        render(scene, cam, width=W, height=H, raster_backend="pallas_interpret")
