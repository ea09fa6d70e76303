"""PyTorch port vs the JAX package: ``render_tri_sharded(raster_backend=)``.

The port takes JAX's names (``parallel/sharded.tri_raster_route``):
``"auto"`` and ``"pallas"`` raster each band through kernel 2
(``raster_gbuffer``), bit for bit the frame they gave before the keyword
existed; ``"pallas_interpret"`` is that route on CPU tensors and refused on
CUDA tensors; ``"jnp"`` is JAX's oracle branch (``raster.rasterize`` with
the shard's padding masked, ``interpolate_corners``, the winners' face
materials). An unknown name raises ``ValueError``.

Tolerances: the ``"jnp"`` ring in a gloo world of 2 against JAX's
``raster_backend="jnp"`` ring on 2 devices, and against the port's kernel-2
ring, as ``tests/test_torch_render_backends.py`` holds the ``"jnp"`` route:
no more than 0.2% of pixels off by more than 2e-4 (JAX's jnp rasterizer
runs inside ``shard_map``, where XLA contracts FMAs and moves depths by
ulps, so an id may flip at a depth tie; the float32 shading of the two
packages differs by less than 2e-4 elsewhere).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import physically_based_renderer_tpu_torch as pbr
from physically_based_renderer_tpu.parallel import sharded as jsharded
from physically_based_renderer_tpu_torch.parallel import sharded
from test_torch_sharded import H, W, _grid, _payload
from torch_parity import to_port
from torch_sharded_workers import spawn

ATOL, TIE_SHARE = 2e-4, 2e-3


def _assert_close(got, ref):
    bad = np.abs(got - ref).max(-1) > ATOL
    assert bad.mean() <= TIE_SHARE, f"{bad.mean():.4%} of pixels off by more than {ATOL}"


def test_jnp_ring_matches_jax_jnp_ring(tmp_path):
    jscene, jcam = _grid()
    mesh = jsharded.make_tri_mesh(jax.devices()[:2])
    jimg = np.asarray(jax.jit(lambda s, c: jsharded.render_tri_sharded(  # op by op, each op compiles: ~70 s
        s, c, mesh=mesh, width=W, height=H, merge="band", raster_backend="jnp"))(jscene, jcam))
    out = spawn(tmp_path, 2, "tri_frame", dict(_payload(jscene, jcam), raster_backend="jnp"))
    frame = out[0]["frame"]
    for rank, r in enumerate(out):
        np.testing.assert_array_equal(r["band"], frame[rank * H // 2 : (rank + 1) * H // 2])
    assert frame.shape == (H, W, 4) and np.isfinite(frame).all() and (frame[..., 3] > 0).mean() > 0.05
    _assert_close(frame, jimg)
    scene, cam = to_port(jscene, jcam)
    _assert_close(frame, pbr.render_tri_sharded(scene, cam, width=W, height=H).numpy())


def test_auto_and_pallas_keep_kernel_2(monkeypatch):
    """World of one on CPU tensors: ``"auto"``, ``"pallas"`` and
    ``"pallas_interpret"`` give the default frame bit for bit, through the
    same ``raster_gbuffer`` calls (kernel 2's route: 8-row tiles, the row
    layout); ``"jnp"`` makes none."""
    scene, cam = to_port(*_grid())
    calls = []
    real = sharded.raster_gbuffer

    def counting(*a, **kw):
        calls.append((kw["tile_h"], kw["max_span"], kw["row_layout"]))
        return real(*a, **kw)

    monkeypatch.setattr(sharded, "raster_gbuffer", counting)
    ref = pbr.render_tri_sharded(scene, cam, width=W, height=H)
    assert calls == [(8, 16, True)]
    for name in ("auto", "pallas", "pallas_interpret"):
        assert torch.equal(pbr.render_tri_sharded(scene, cam, width=W, height=H, raster_backend=name), ref)
    assert len(calls) == 4
    jnp_img = pbr.render_tri_sharded(scene, cam, width=W, height=H, raster_backend="jnp")
    assert len(calls) == 4
    _assert_close(jnp_img.numpy(), ref.numpy())


def test_jnp_ring_material_gradients_match_kernel_2_ring():
    """The oracle branch is differentiable as the kernel branch is: the bench
    loss's material gradients agree within the gradient tolerance."""
    from torch_parity import grad_tolerance

    scene, cam = to_port(*_grid())
    grads = {}
    for name in ("pallas", "jnp"):
        leaf = scene.materials.diffuse.clone().requires_grad_()
        s = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, diffuse=leaf))
        img = pbr.render_tri_sharded(s, cam, width=W, height=H, raster_backend=name)
        (grads[name],) = torch.autograd.grad(torch.mean(img[..., :3] ** 2), leaf)
    grad_tolerance(grads["pallas"].numpy(), grads["jnp"].numpy())


def test_refusals():
    scene, cam = to_port(*_grid())
    for bad in ("tpu", "brute", "pallas_gbuf_row", "jnp_interpret"):
        with pytest.raises(ValueError, match="unknown raster_backend"):
            pbr.render_tri_sharded(scene, cam, width=W, height=H, raster_backend=bad)
    with pytest.raises(ValueError, match="CPU tensors only"):
        sharded.tri_raster_route("pallas_interpret", "cuda")
    assert [sharded.tri_raster_route(n, "cuda") for n in ("auto", "pallas", "jnp")] == ["pallas", "pallas", "jnp"]
    assert sharded.tri_raster_route("pallas_interpret", "cpu") == "pallas"
