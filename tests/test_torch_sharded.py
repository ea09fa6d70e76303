"""PyTorch port vs the JAX package: the row-band and triangle-sharded paths
over ``torch.distributed``.

The port's side runs in gloo worlds of 2 and 4 processes, started by
``torch.multiprocessing.spawn`` with a ``FileStore`` under ``tmp_path``
(``tests/torch_sharded_workers.py``; the workers import no JAX). The JAX side
runs here, on the 8 virtual CPU devices of ``tests/conftest.py``, and reaches
the workers as NumPy. Tolerances:

* ``render_sharded``'s frame (its bands gathered) against a one-process
  render: atol 1e-6, as ``tests/test_sharded.py``.
* ``make_train_step`` against JAX ``make_train_step`` on a 2-device mesh:
  losses rtol 1e-4, updates within ``tests/test_torch_train.py``'s tolerance.
* ``render_tri_sharded(merge="band")`` against JAX ``render_tri_sharded(merge=
  "band", raster_backend="pallas", interpret=True)`` on as many devices (the
  JAX side rasterizes each band through the row kernel's G-buffer mode in
  interpret mode, then shades through ``shade_pixels``): the frame within
  the band-compose bound of ``tests/test_torch_shade_forward.py`` (2e-5, and
  the JAX package's 3.2e-4 float32 GGX noise on the roughness-0 spheres);
  the material gradients of the whole frame's bench loss, summed over the
  ranks, within the gradient tolerance; against the port's own ``render()``
  no pixel differs by more than 1e-6 (this view has no depth tie across
  shards); the mesh-position gradient against the world of one within rtol
  1e-4 (f32 sums in another order).
* The O(T/N) shard of ``__graft_entry__.py:70-90``: each rank holds
  ceil(T/n) triangle rows and expands only the instances they come from.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import physically_based_renderer_tpu_torch as pbr
from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.parallel import sharded as jsharded
from physically_based_renderer_tpu.renderer import render as jrender
from physically_based_renderer_tpu_torch.ops import raster_row
from physically_based_renderer_tpu_torch.parallel import sharded
from torch_parity import camera_to_numpy, grad_tolerance, scene_to_numpy, to_port
from torch_sharded_workers import FIELDS, spawn

W, H = 128, 64
BAND_ATOL, JAX_GGX_NOISE = 2e-5, 3.2e-4


def _grid():
    return (jscenes.red_sphere_grid_scene(slices=8, stacks=4),
            JCamera.create(position=(0.0, -3.0, -18.0), aspect=W / H))


def _payload(scene, cam, **kw):
    return dict(scene=scene_to_numpy(scene), camera=camera_to_numpy(cam), width=W, height=H, **kw)


def test_render_sharded_matches_one_process(tmp_path):
    jscene, jcam = _grid()
    scene, cam = to_port(jscene, jcam)
    ref = pbr.render(scene, cam, width=W, height=H).numpy()
    out = spawn(tmp_path, 2, "render_sharded", _payload(jscene, jcam))
    target = np.arange(H * W * 3, dtype=np.float32).reshape(H, W, 3)
    for rank, r in enumerate(out):
        assert r["band"].shape == (H // 2, W, 4)
        np.testing.assert_allclose(r["band"], ref[rank * H // 2 : (rank + 1) * H // 2], atol=1e-6, rtol=0)
        np.testing.assert_allclose(r["frame"], ref, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(r["target_band"], target[rank * H // 2 : (rank + 1) * H // 2])


def test_train_step_matches_jax_two_device_mesh(tmp_path):
    jscene, jcam = _grid()
    target = np.asarray(jrender(jscene, jcam, width=W, height=H, raster_backend="jnp")[..., :3])
    rng = np.random.default_rng(23)
    m = jscene.materials
    start = dataclasses.replace(  # kept off the 0.05-roughness black-channel corner (test_torch_train.py)
        m,
        roughness=jnp.clip(m.roughness + rng.uniform(-0.15, 0.15, m.roughness.shape), 0.1, 1.0)
        .astype(jnp.float32),
        diffuse=jnp.clip(m.diffuse + rng.uniform(-0.2, 0.2, m.diffuse.shape), 0.05, 1.0).astype(jnp.float32),
    )
    jscene = dataclasses.replace(jscene, materials=start)
    lr, steps = 2.0, 2
    mesh = jsharded.make_render_mesh(jax.devices()[:2])
    jstep = jsharded.make_train_step(mesh=mesh, width=W, height=H, learning_rate=lr)
    jtarget = jsharded.shard_target(jnp.asarray(target), mesh)
    out = spawn(tmp_path, 2, "train", _payload(jscene, jcam, lr=lr, steps=steps, target=target))
    prev = jscene.materials
    for i in range(steps):
        jscene, jloss = jstep(jscene, jcam, jtarget)
        for r in out:
            np.testing.assert_allclose(float(r[f"loss{i}"]), float(jloss), rtol=1e-4)
        for k in FIELDS:
            new = np.asarray(getattr(jscene.materials, k))
            jd = new - np.asarray(getattr(prev, k))
            d = out[0][f"{k}{i}"] - (out[0][f"{k}{i - 1}"] if i else np.asarray(getattr(start, k)))
            np.testing.assert_array_equal(out[1][f"{k}{i}"], out[0][f"{k}{i}"])  # every rank the same step
            scale = max(float(np.abs(jd).max()), 1e-12)
            np.testing.assert_allclose(
                d, jd, rtol=2e-3, atol=5e-5 * scale + 1e-10 + 2 * float(np.spacing(np.abs(new)).max())
            )
        prev = jscene.materials


@pytest.fixture(scope="module")
def tri_runs(tmp_path_factory):
    """The port's tri-sharded band ring in gloo worlds of 2 and 4, the JAX
    one on as many devices, and the port's world of one."""
    jscene, jcam = _grid()
    runs = {}
    for n in (2, 4):
        mesh = jsharded.make_tri_mesh(jax.devices()[:n])

        def jloss(mats):
            img = jsharded.render_tri_sharded(dataclasses.replace(jscene, materials=mats), jcam, mesh=mesh,
                                              width=W, height=H, merge="band", raster_backend="pallas",
                                              interpret=True)
            return jnp.mean(img[..., :3] ** 2), img

        (_, jimg), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True, allow_int=True))(jscene.materials)
        port = spawn(tmp_path_factory.mktemp(f"tri{n}"), n, "tri", _payload(jscene, jcam, geometry=True))
        runs[n] = dict(jimg=np.asarray(jimg), jgrads={k: np.asarray(getattr(jg, k)) for k in FIELDS}, port=port)
    scene, cam = to_port(jscene, jcam)
    positions = scene.draws[0].mesh.positions.clone().requires_grad_()
    draw = dataclasses.replace(scene.draws[0], mesh=dataclasses.replace(scene.draws[0].mesh, positions=positions))
    img = pbr.render_tri_sharded(dataclasses.replace(scene, draws=(draw,)), cam, width=W, height=H)
    (g_pos,) = torch.autograd.grad(torch.mean(img[..., :3] ** 2), positions)
    runs["one"] = dict(image=img.detach().numpy(), g_positions=g_pos.numpy(),
                       render=pbr.render(scene, cam, width=W, height=H).numpy())
    return runs


@pytest.mark.parametrize("n", [2, 4])
def test_tri_sharded_frame_matches_jax(tri_runs, n):
    run = tri_runs[n]
    jimg = run["jimg"]
    for rank, r in enumerate(run["port"]):
        np.testing.assert_array_equal(r["band"], r["frame"][rank * H // n : (rank + 1) * H // n])
    frame = run["port"][0]["frame"]
    assert frame.shape == (H, W, 4)
    scene, cam = to_port(*_grid())
    sharp = _roughness0_pixels(scene, cam)
    np.testing.assert_allclose(frame[~sharp], jimg[~sharp], atol=BAND_ATOL, rtol=0)
    np.testing.assert_allclose(frame[sharp], jimg[sharp], atol=JAX_GGX_NOISE, rtol=0)


def _roughness0_pixels(scene, cam):
    """Pixels whose winning triangle has a roughness-0 material."""
    out = sharded.triangle_shard(scene, cam, 0, 1)
    g = raster_row.rasterize_binned_gbuffer_row(out.clip, out.attrs, out.face_material, width=W, height=H,
                                                num_materials=49, tile_h=8, max_span=16)
    rough = scene.materials.roughness[g.mat_id.long()]
    return ((g.tri_id >= 0) & (rough <= 0.05)).numpy()


@pytest.mark.parametrize("n", [2, 4])
def test_tri_sharded_material_gradients_match_jax(tri_runs, n):
    run = tri_runs[n]
    for k in FIELDS:
        for r in run["port"]:
            np.testing.assert_array_equal(r[f"g_{k}"], run["port"][0][f"g_{k}"])
        grad_tolerance(run["jgrads"][k], run["port"][0][f"g_{k}"])
    assert np.abs(run["port"][0]["g_diffuse"]).max() > 0


@pytest.mark.parametrize("n", [2, 4])
def test_tri_sharded_matches_render_and_world_of_one(tri_runs, n):
    one, frame = tri_runs["one"], tri_runs[n]["port"][0]["frame"]
    differing = int((np.abs(frame - one["render"]).max(-1) > 1e-6).sum())
    assert differing == 0, f"{differing} pixels differ from render()"
    np.testing.assert_allclose(frame, one["image"], atol=1e-6, rtol=0)
    grad_tolerance(one["g_positions"], tri_runs[n]["port"][0]["g_positions"], rtol=1e-4, atol_frac=1e-6)
    assert np.abs(one["g_positions"]).max() > 0


@pytest.mark.parametrize("num_draws", [1, 2])
@pytest.mark.parametrize("n", [2, 3, 4, 8, 57])  # 57: the last rank's rows lie past the last triangle
def test_triangle_shards_hold_t_over_n_rows(n, num_draws, monkeypatch):
    """``__graft_entry__.py:70-90``: each rank holds one ceil(T/n)-row shard,
    not a replica; the shards cover the triangles in order; and a rank
    expands only the instances its rows come from (its rows plus at most one
    partial instance at each end), never the whole scene. With two draws the
    grid's 49 instances are split 20 + 29, so shards cross a draw."""
    scene, cam = to_port(*_grid())
    if num_draws == 2:
        d = scene.draws[0]
        scene = dataclasses.replace(scene, draws=tuple(
            dataclasses.replace(d, worlds=d.worlds[sl], material_ids=d.material_ids[sl])
            for sl in (slice(0, 20), slice(20, None))))
    full = pbr.flatten_scene_corners(scene)
    num_t, tb = full.num_triangles, scene.draws[0].mesh.num_triangles
    rows = -(-num_t // n)
    expanded = []

    def counting_flatten(s, **kw):
        geom = pbr.flatten_scene_corners(s, **kw)
        expanded.append(geom.num_triangles)
        return geom

    monkeypatch.setattr(sharded, "flatten_scene_corners", counting_flatten)
    shards = [sharded.triangle_shard(scene, cam, r, n) for r in range(n)]
    for r, s in enumerate(shards):
        assert s.clip.shape == (rows, 3, 4) and s.attrs.shape == (rows, 3, 6) and s.face_material.shape == (rows,)
        assert s.start == r * rows
    assert rows * n < 2 * num_t + n * 4, "per-rank triangle storage is not ~T/N"
    assert len(expanded) == sum(r * rows < num_t for r in range(n))  # one expansion a rank that holds rows
    assert max(expanded) <= rows + 2 * tb < num_t, (expanded, rows, tb)
    torch.testing.assert_close(torch.cat([s.attrs for s in shards])[:num_t], full.attrs, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([s.face_material for s in shards])[:num_t], full.face_material,
                               rtol=0, atol=0)
    assert not torch.cat([s.clip for s in shards])[num_t:].any()  # zero rows: w = 0, rejected


def test_measure_scaling_runs_in_a_gloo_world(tmp_path):
    out = spawn(tmp_path, 2, "scaling", dict(_payload(*_grid()), counts=[1, 2]))
    r = out[0]
    np.testing.assert_array_equal(r["devices"], [1, 2])
    assert (r["rate"] > 0).all() and (r["ms"] > 0).all() and r["eff"][0] == 1.0
    np.testing.assert_array_equal(out[1]["devices"], [2])  # rank 1 is only in the 2-rank subgroup
    np.testing.assert_array_equal(out[1]["ms"], r["ms"][1:])  # the slowest rank's time, on both


def test_world_of_one_and_unported_merges():
    """No process group: the sharded functions run as one rank."""
    scene, cam = to_port(*_grid())
    ref = pbr.render(scene, cam, width=W, height=H)
    assert torch.equal(pbr.render_sharded(scene, cam, width=W, height=H), ref)
    assert torch.equal(pbr.fetch_image(ref), ref) and torch.equal(pbr.shard_target(ref), ref)
    assert pbr.initialize_distributed(world_size=1) is None and not torch.distributed.is_initialized()
    for merge in ("ring", "allgather"):
        with pytest.raises(ValueError, match="not ported"):
            pbr.render_tri_sharded(scene, cam, width=W, height=H, merge=merge)
