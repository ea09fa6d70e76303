"""Tonemapping — the counterpart of ``physically_based_renderer_tpu/ops/tonemap.py``:
Reinhard x/(1+x) then gamma 1/2.2 (``Default.hlsl:152-155``)."""

from __future__ import annotations

import torch

INV_GAMMA = 1.0 / 2.2


def reinhard(color: torch.Tensor) -> torch.Tensor:
    """x / (1 + x) (Default.hlsl:153)."""
    return color / (color + 1.0)


def gamma_encode(color: torch.Tensor) -> torch.Tensor:
    """pow(x, 1/2.2) (Default.hlsl:155) with a 0-guard."""
    return torch.pow(torch.clamp(color, min=1e-8), INV_GAMMA)


def tonemap(color: torch.Tensor) -> torch.Tensor:
    """Reinhard + gamma, the reference's full output transform."""
    return gamma_encode(reinhard(torch.clamp(color, min=0.0)))
