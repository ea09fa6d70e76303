"""Inverse-rendering training step — the counterpart of
``physically_based_renderer_tpu/parallel/sharded.py::make_train_step`` on one
device (the JAX step over a one-device mesh).

The row-band split over several devices, with its gradient all-reduce over
``torch.distributed``, comes with the sharding slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..camera import Camera
from ..models.scene import Scene
from ..renderer import render


def make_train_step(*, width: int, height: int, learning_rate: float = 0.1, **render_kwargs: Any):
    """Build an inverse-rendering SGD step over the material bank.

    Returns ``step(scene, camera, target_image) -> (scene, loss)``: the loss
    is ``mean((render(...)[..., :3] - target)**2)`` over the (H, W, 3)
    target, and every floating-point field of ``scene.materials`` moves by
    ``-learning_rate·grad`` (fields the render does not read have no
    gradient and stay as they are; integer fields are never touched)."""

    def step(scene: Scene, camera: Camera, target: torch.Tensor):
        mats = scene.materials
        params = {
            k: getattr(mats, k).detach().requires_grad_()
            for k in mats.tensor_fields()
            if getattr(mats, k).is_floating_point()
        }
        s = dataclasses.replace(scene, materials=dataclasses.replace(mats, **params))
        img = render(s, camera, width=width, height=height, **render_kwargs)
        loss = torch.mean((img[..., :3] - target) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        with torch.no_grad():
            new = {
                k: p.detach() if g is None else p.detach() - learning_rate * g
                for (k, p), g in zip(params.items(), grads)
            }
        return dataclasses.replace(scene, materials=dataclasses.replace(mats, **new)), loss.detach()

    return step
