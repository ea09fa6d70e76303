"""The reference of the inverse-rendering step: SGD on the material bank's
float fields toward a target frame, loss ``mean((rgb − target)²)``, the
whole frame on one process."""

from __future__ import annotations

import torch

from .render import BANK_FLOAT_FIELDS, RefScene, render


def sgd_steps(scene: RefScene, poses, targets, width: int, height: int, learning_rate: float,
              tf32: bool = False):
    """Run ``len(poses)`` steps from the scene's bank → (losses, first step's
    gradients by field, the bank after every step)."""
    bank = {k: scene.bank[k].detach().clone() for k in BANK_FLOAT_FIELDS}
    losses, first_grads, banks = [], None, []
    for pose, target in zip(poses, targets):
        leaves = {k: v.detach().requires_grad_() for k, v in bank.items()}
        img = render(scene, pose[0:3], pose[3], pose[4], width, height, bank=leaves, tf32=tf32)
        loss = torch.mean((img[..., :3] - target) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: (torch.zeros_like(leaves[k]) if g is None else g) for k, g in zip(leaves, grads)}
        if first_grads is None:
            first_grads = {k: g.detach() for k, g in grads.items()}
        with torch.no_grad():
            bank = {k: leaves[k].detach() - learning_rate * grads[k] for k in leaves}
        losses.append(float(loss.detach()))
        banks.append(bank)
        del img, loss, grads, leaves
    return losses, first_grads, banks
