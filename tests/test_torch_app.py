"""PyTorch port vs the JAX package: the binning-capacity check, the checked
render and the frame loop (``tests/test_overflow.py``, ``tests/test_app.py``),
the camera's input methods, and the utilities (``tests/test_utils.py``:
config, checkpoint, timing, device summary, HDR; ``to_uint8``, SSIM).

The capacity dict must equal JAX's for the same scene (it counts the same
binning on the host). Images hold the port's render tolerance, atol 2e-4
(``tests/test_torch_render.py``); camera poses agree within 1e-6.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.ops.tonemap import to_uint8 as jto_uint8
from physically_based_renderer_tpu.renderer import check_raster_capacity as jcheck_raster_capacity
from physically_based_renderer_tpu.renderer import render as jrender
from physically_based_renderer_tpu.utils import ssim as jssim
from physically_based_renderer_tpu_torch import Camera, render, scenes
from physically_based_renderer_tpu_torch.app import FrameInput, FrameStats, RenderLoop, turntable_inputs
from physically_based_renderer_tpu_torch.ops.tonemap import to_uint8
from physically_based_renderer_tpu_torch.renderer import check_raster_capacity, render_checked
from physically_based_renderer_tpu_torch.utils import checkpoint, image_io, ssim
from physically_based_renderer_tpu_torch.utils.config import RenderConfig, check_frame, debug_mode
from physically_based_renderer_tpu_torch.utils.profiling import TimingResult, device_summary, time_device_loop
from torch_parity import to_port

W, H = 128, 64
ATOL = 2e-4


def _grid():
    jscene = jscenes.red_sphere_grid_scene(slices=16, stacks=8)
    jcam = JCamera.create(position=(0.0, -3.0, -18.0), aspect=W / H)
    return (jscene, jcam) + to_port(jscene, jcam)


# --- tests/test_overflow.py ----------------------------------------------------------


@pytest.mark.parametrize("tile_h", [None, 16])
def test_check_raster_capacity_matches_jax(tile_h):
    """The dict equals JAX's, overflowing at cap 128 and not at the
    suggested cap; the suggestion covers the pairs and is a multiple of 128."""
    jscene, jcam, scene, cam = _grid()
    kw = dict(width=W, height=H, tile_h=tile_h)
    tiny = check_raster_capacity(scene, cam, pairs_cap=128, **kw)
    assert tiny == jcheck_raster_capacity(jscene, jcam, pairs_cap=128, **kw)
    assert tiny["overflowed"] and tiny["num_pairs"] > 128
    assert tiny["suggested_pairs_cap"] >= tiny["num_pairs"] and tiny["suggested_pairs_cap"] % 128 == 0
    ok = check_raster_capacity(scene, cam, pairs_cap=tiny["suggested_pairs_cap"], **kw)
    assert ok == jcheck_raster_capacity(jscene, jcam, pairs_cap=tiny["suggested_pairs_cap"], **kw)
    assert not ok["overflowed"] and ok["num_pairs"] == tiny["num_pairs"]
    default = check_raster_capacity(scene, cam, **kw)
    assert default == jcheck_raster_capacity(jscene, jcam, **kw) and not default["overflowed"]


def test_suggested_cap_renders_correctly():
    """Cap 128 raises (the port's render never drops triangles); the
    suggested cap renders JAX's frame."""
    jscene, jcam, scene, cam = _grid()
    ref = np.asarray(jrender(jscene, jcam, width=W, height=H))
    with pytest.raises(RuntimeError, match="overflow"):
        render(scene, cam, width=W, height=H, raster_pairs_cap=128)
    stats = check_raster_capacity(scene, cam, width=W, height=H, pairs_cap=128)
    fixed = render(scene, cam, width=W, height=H, raster_pairs_cap=stats["suggested_pairs_cap"])
    np.testing.assert_allclose(fixed.numpy(), ref, atol=ATOL, rtol=0)


def test_render_loop_autoheals_overflow():
    _, _, scene, cam = _grid()
    loop = RenderLoop(scene, cam, config=RenderConfig(width=W, height=H, raster_pairs_cap=128))
    frame = loop.step()
    assert isinstance(frame, np.ndarray) and frame.shape == (H, W, 4) and np.isfinite(frame).all()
    assert loop.config.raster_pairs_cap > 128  # raised on the first frame
    np.testing.assert_allclose(frame, render(scene, cam, width=W, height=H).numpy(), atol=0, rtol=0)


def test_render_checked_raises_on_overflow():
    """The binning's invariants are checked before the render: cap 128
    raises ``RuntimeError``; the default cap passes and renders."""
    _, _, scene, cam = _grid()
    with pytest.raises(RuntimeError, match="overflow"):
        render_checked(scene, cam, width=W, height=H, raster_pairs_cap=128)
    img = render_checked(scene, cam, width=W, height=H)
    assert img.shape == (H, W, 4) and bool(torch.isfinite(img).all())
    assert torch.equal(img, render(scene, cam, width=W, height=H))


# --- tests/test_app.py and the camera --------------------------------------------------


def test_loop_steps_and_moves_camera():
    scene = scenes.analytic_sphere_scene(slices=8, stacks=4, device="cpu")
    loop = RenderLoop(scene, Camera.create(aspect=64 / 48, device="cpu"), RenderConfig(width=64, height=48))
    f0 = loop.step(FrameInput(), dt=1 / 60)
    assert f0.shape == (48, 64, 4)
    p0 = loop.camera.position.numpy().copy()
    loop.step(FrameInput(forward=1.0), dt=1 / 60)
    assert loop.camera.position.numpy()[2] > p0[2]  # toward +z, forward
    loop.step(FrameInput(mouse_dx=40.0), dt=1 / 60)
    assert float(loop.camera.yaw) > 0.0
    assert isinstance(loop.stats, FrameStats)


def test_turntable_sequence(tmp_path):
    scene = scenes.analytic_sphere_scene(slices=8, stacks=4, device="cpu")
    loop = RenderLoop(scene, Camera.create(aspect=1.0, device="cpu"), RenderConfig(width=48, height=48))
    frames = loop.run_sequence(turntable_inputs(3), out_dir=str(tmp_path))
    assert len(frames) == 3 and os.path.exists(tmp_path / "frame_0002.png")
    np.testing.assert_allclose(float(loop.camera.yaw), np.radians(6.0), rtol=1e-5)  # 3 × 2°


def test_camera_input_matches_jax():
    """side, rotate (the pitch clamped), on_mouse_move, move, with_aspect."""
    jcam = JCamera.create(position=(0.5, -1.0, -6.0), yaw=0.3, pitch=-0.2)
    cam = Camera.create(position=(0.5, -1.0, -6.0), yaw=0.3, pitch=-0.2, device="cpu")
    np.testing.assert_allclose(cam.side.numpy(), np.asarray(jcam.side), atol=1e-6)
    for c, j in ((cam.rotate(0.1, 2.0), jcam.rotate(0.1, 2.0)), (cam.on_mouse_move(-30.0, 12.0),
                                                                jcam.on_mouse_move(-30.0, 12.0))):
        np.testing.assert_allclose([float(c.yaw), float(c.pitch)], [float(j.yaw), float(j.pitch)], atol=1e-6)
    np.testing.assert_allclose(cam.move(1.0, -0.5, dt=0.1).position.numpy(),
                               np.asarray(jcam.move(1.0, -0.5, dt=0.1).position), atol=1e-6)
    assert cam.with_aspect(640, 480).aspect == jcam.with_aspect(640, 480).aspect


# --- tests/test_utils.py -----------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    scene = scenes.analytic_sphere_scene(slices=8, stacks=4, device="cpu")
    modified = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, roughness=scene.materials.roughness * 0.123))
    path = str(tmp_path / "params.npz")
    checkpoint.save_scene_params(path, modified)
    restored = checkpoint.load_scene_params(path, scene)
    assert torch.equal(restored.materials.roughness, modified.materials.roughness)
    assert torch.equal(restored.lights.strength, scene.lights.strength) and restored.env_map is None
    assert restored.materials.tex_index.dtype == scene.materials.tex_index.dtype


def _modified_pair(env: bool):
    """(JAX scene, port scene) of the grid with a changed ambient, bank and
    lights, and a seeded environment map or none — the same values in both."""
    rng = np.random.default_rng(11)
    jscene = jscenes.red_sphere_grid_scene(slices=8, stacks=4)
    mats = dataclasses.replace(
        jscene.materials,
        diffuse=jnp.asarray(rng.uniform(0, 1, jscene.materials.diffuse.shape), jnp.float32),
        roughness=jnp.asarray(rng.uniform(0, 1, jscene.materials.roughness.shape), jnp.float32),
        tex_index=jnp.asarray(rng.integers(0, 4, jscene.materials.tex_index.shape), jnp.int32))
    lights = dataclasses.replace(jscene.lights, strength=jnp.asarray(rng.uniform(0, 2, (4, 3)), jnp.float32))
    jscene = dataclasses.replace(jscene, materials=mats, lights=lights, ambient=jnp.asarray([0.5, 0.25, 0.125]),
                                 env_map=jnp.asarray(rng.uniform(0, 4, (4, 8, 3)), jnp.float32) if env else None)
    return jscene, to_port(jscene, JCamera.create())[0]


def _assert_params_equal(jscene, scene):
    """Every optimisable field of a port scene equals a JAX scene's, bit for bit."""
    pairs = [(scene.ambient, jscene.ambient)]
    pairs += [(getattr(scene.lights, k), getattr(jscene.lights, k))
              for k in ("strength", "direction", "position", "spot_power")]
    pairs += [(getattr(scene.materials, k), getattr(jscene.materials, k)) for k in scene.materials.tensor_fields()]
    for got, ref in pairs:
        assert got.dtype == getattr(torch, str(np.asarray(ref).dtype))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (scene.env_map is None) == (jscene.env_map is None)
    if scene.env_map is not None:
        np.testing.assert_array_equal(scene.env_map.numpy(), np.asarray(jscene.env_map))


@pytest.mark.parametrize("env", [False, True])
def test_checkpoint_moves_between_the_packages(env, tmp_path):
    """A file written by either package's save_scene_params is restored
    field for field by the other's load_scene_params (the JAX layout:
    ``leaf_i`` in flatten order + a treedef/kinds manifest)."""
    from physically_based_renderer_tpu.utils import checkpoint as jcheckpoint

    jsaved, saved = _modified_pair(env)
    jbase = jscenes.red_sphere_grid_scene(slices=8, stacks=4)
    base = to_port(jbase, JCamera.create())[0]
    if env:  # JAX restores into the structure it is given: a scene holding a map
        jbase = dataclasses.replace(jbase, env_map=jnp.zeros((4, 8, 3), jnp.float32))
    # JAX writes, the port reads (into a scene without a map, whatever the file holds)
    jcheckpoint.save_scene_params(str(tmp_path / "jax.npz"), jsaved)
    _assert_params_equal(jsaved, checkpoint.load_scene_params(str(tmp_path / "jax.npz"), base))
    # the port writes, JAX reads
    checkpoint.save_scene_params(str(tmp_path / "port.npz"), saved)
    restored = jcheckpoint.load_scene_params(str(tmp_path / "port.npz"), jbase)
    _assert_params_equal(restored, saved)
    # and the port reads its own file
    _assert_params_equal(jsaved, checkpoint.load_scene_params(str(tmp_path / "port.npz"), base))


def test_tensors_none_leaves(tmp_path):
    tree = {"a": torch.ones(3), "b": None, "c": {"d": torch.arange(4, dtype=torch.int32)}}
    path = str(tmp_path / "t.npz")
    checkpoint.save_tensors(path, tree)
    out = checkpoint.load_tensors(path, {"a": torch.zeros(3), "b": torch.zeros(1), "c": {"d": None}})
    assert torch.equal(out["a"], torch.ones(3)) and out["b"] is None
    assert torch.equal(out["c"]["d"], tree["c"]["d"])


def test_render_config():
    c = RenderConfig(width=640, height=480)
    assert hash(c)
    kw = c.render_kwargs()
    assert kw["width"] == 640 and kw["raster_backend"] == "auto"
    scene = scenes.analytic_sphere_scene(slices=8, stacks=4, device="cpu")
    render(scene, Camera.create(aspect=640 / 480, device="cpu"), **RenderConfig(width=32, height=24).render_kwargs())


def test_debug_mode_checks_frames():
    bad = torch.tensor([[0.0, float("nan")]])
    check_frame(bad)  # outside debug mode: nothing
    with debug_mode():
        assert torch.is_anomaly_enabled()
        check_frame(torch.zeros(2, 2))
        with pytest.raises(FloatingPointError):
            check_frame(bad)
    assert not torch.is_anomaly_enabled()


def test_timing_result():
    t = TimingResult(ms_per_iter=20.0, iters=5, pixels=1000)
    assert abs(t.fps - 50.0) < 1e-9 and abs(t.pixels_per_s - 50000.0) < 1e-6 and "ms" in str(t)


def test_time_device_loop_needs_a_card():
    """A device time needs the card: without one the timer raises (a CPU
    time would be no device time); the card test times on it."""
    if torch.cuda.is_available():
        t = time_device_loop(lambda: torch.ones(1024, device="cuda").sum(), iters=3)
        assert t.ms_per_iter > 0
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        time_device_loop(lambda: None)


def test_device_summary():
    s = device_summary()
    assert ("backend=cuda" if torch.cuda.is_available() else "backend=cpu") in s


def test_hdr_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    img = (rng.uniform(0, 1, (8, 12, 3)) ** 2 * 50.0).astype(np.float32)
    p = str(tmp_path / "x.hdr")
    image_io.save_hdr(p, img)
    back = image_io.load_hdr(p)
    assert back.shape == img.shape
    # RGBE shares one exponent across channels: per-pixel precision is maxc/256
    assert (np.abs(back - img) <= img.max(axis=-1, keepdims=True) / 128.0 + 1e-6).all()


def test_to_uint8_and_ssim_match_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(-0.1, 1.1, (16, 20, 3)).astype(np.float32)
    img[0, :3, 0] = np.asarray([0.5, 1.5, 2.5], np.float32) / 255.0  # ties round half to even
    np.testing.assert_array_equal(to_uint8(torch.as_tensor(img)).numpy(), np.asarray(jto_uint8(jnp.asarray(img))))
    a = np.clip(img, 0, 1)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
    mask = rng.uniform(size=a.shape[:2]) > 0.3
    assert ssim.ssim(a, b) == jssim.ssim(a, b) and ssim.ssim(a, b, mask) == jssim.ssim(a, b, mask)
