"""Worker processes of ``tests/test_torch_sharded.py``: each joins a gloo
world through a ``FileStore``, runs one job of the port's sharded paths on
CPU tensors, and writes its rank's results as a ``.npz``. The test computes
the JAX side in the parent and hands the scene to the workers as NumPy; this
module imports nothing of JAX."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

import physically_based_renderer_tpu_torch as pbr
from physically_based_renderer_tpu_torch.utils.convert import camera_from_numpy, scene_from_numpy

FIELDS = ("diffuse", "metallic", "fresnel_r0", "roughness", "opacity")


def spawn(tmp_path, world: int, job: str, payload: dict) -> list[dict]:
    """Run ``job`` in a gloo world of ``world`` processes; each rank's
    results, in rank order."""
    out = tmp_path / f"{job}-{world}"
    out.mkdir()
    torch.multiprocessing.spawn(_main, args=(world, str(tmp_path / f"store-{job}-{world}"), job, payload,
                                             str(out)), nprocs=world, join=True)
    return [dict(np.load(out / f"{rank}.npz")) for rank in range(world)]


def _main(rank, world, store_path, job, payload, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        result = JOBS[job](rank, world, payload)
        np.savez(os.path.join(out_dir, f"{rank}.npz"), **{k: np.asarray(v) for k, v in result.items()})
    finally:
        dist.destroy_process_group()


def _scene(payload):
    return (scene_from_numpy(payload["scene"], device="cpu"),
            camera_from_numpy(payload["camera"], device="cpu"))


def render_sharded_job(rank, world, payload):
    scene, cam = _scene(payload)
    w, h = payload["width"], payload["height"]
    band = pbr.render_sharded(scene, cam, width=w, height=h)
    target = torch.arange(h * w * 3, dtype=torch.float32).reshape(h, w, 3)
    return dict(band=band, frame=pbr.fetch_image(band), target_band=pbr.shard_target(target))


def train_job(rank, world, payload):
    scene, cam = _scene(payload)
    step = pbr.make_train_step(width=payload["width"], height=payload["height"], learning_rate=payload["lr"])
    target = pbr.shard_target(torch.as_tensor(payload["target"]))
    out = {}
    for i in range(payload["steps"]):
        scene, loss = step(scene, cam, target)
        out[f"loss{i}"] = loss
        for k in FIELDS:
            out[f"{k}{i}"] = getattr(scene.materials, k)
    return out


def tri_job(rank, world, payload):
    """The tri-sharded band and frame, the material gradients and (with
    ``geometry``) the mesh-position gradient of the whole frame's bench
    loss, each summed over the ranks."""
    scene, cam = _scene(payload)
    w, h = payload["width"], payload["height"]
    mats = scene.materials
    leaves = {k: getattr(mats, k).detach().clone().requires_grad_() for k in FIELDS}
    draw = scene.draws[0]
    positions = draw.mesh.positions.detach().clone().requires_grad_(payload["geometry"])
    draws = (dataclasses.replace(draw, mesh=dataclasses.replace(draw.mesh, positions=positions)),
             *scene.draws[1:])
    s = dataclasses.replace(scene, materials=dataclasses.replace(mats, **leaves), draws=draws)
    band = pbr.render_tri_sharded(s, cam, width=w, height=h)
    loss = torch.sum(band[..., :3] ** 2) / (h * w * 3)  # this rank's share of the frame's mean
    wrt = list(leaves.values()) + ([positions] if payload["geometry"] else [])
    grads = torch.autograd.grad(loss, wrt)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    out = dict(band=band.detach(), frame=pbr.fetch_image(band.detach()))
    for name, g in zip(list(FIELDS) + ["positions"], torch.split(flat, [g.numel() for g in grads])):
        out[f"g_{name}"] = g.reshape(wrt[list(FIELDS).index(name)].shape if name in FIELDS else positions.shape)
    return out


def scaling_job(rank, world, payload):
    scene, cam = _scene(payload)
    res = pbr.measure_scaling(scene, cam, width=payload["width"], height=payload["height"],
                              device_counts=payload["counts"], iters=2)
    return dict(devices=[r.devices for r in res], ms=[r.ms_per_frame for r in res],
                rate=[r.pixels_per_s for r in res], eff=[r.efficiency for r in res])


JOBS = dict(render_sharded=render_sharded_job, train=train_job, tri=tri_job, scaling=scaling_job)
