"""Punctual light set — the counterpart of the ``Lights`` part of
``physically_based_renderer_tpu/ops/brdf.py``. The per-pixel BRDF of the
forward slice lives in ``ops/shade_core.py``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Lights:
    """Packed punctual lights, directional first, then point, then spot
    (``LightingUtil.hlsl:170-200``). The counts are static Python ints."""

    strength: torch.Tensor  # (L, 3)
    direction: torch.Tensor  # (L, 3) directional/spot
    position: torch.Tensor  # (L, 3) point/spot
    spot_power: torch.Tensor  # (L,)
    num_dir: int = 0
    num_point: int = 0
    num_spot: int = 0

    def to(self, device) -> "Lights":
        return dataclasses.replace(
            self,
            strength=self.strength.to(device),
            direction=self.direction.to(device),
            position=self.position.to(device),
            spot_power=self.spot_power.to(device),
        )

    @staticmethod
    def build(directional=(), point=(), spot=(), *, device="cpu") -> "Lights":
        """directional: [(direction, strength)], point: [(position, strength)],
        spot: [(position, direction, strength, spot_power)]."""
        strengths, directions, positions, powers = [], [], [], []
        for d, s in directional:
            directions.append(d), strengths.append(s)
            positions.append((0.0, 0.0, 0.0)), powers.append(0.0)
        for p, s in point:
            positions.append(p), strengths.append(s)
            directions.append((0.0, 0.0, 1.0)), powers.append(0.0)
        for p, d, s, pw in spot:
            positions.append(p), directions.append(d)
            strengths.append(s), powers.append(pw)
        if not strengths:  # the JAX bank keeps one zero row when empty
            strengths, directions, positions, powers = [(0.0,) * 3], [(0.0,) * 3], [(0.0,) * 3], [0.0]
        f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        return Lights(
            strength=f(strengths),
            direction=f(directions),
            position=f(positions),
            spot_power=f(powers),
            num_dir=len(directional),
            num_point=len(point),
            num_spot=len(spot),
        )

    @staticmethod
    def default_scene_lights(*, device="cpu") -> "Lights":
        """The four hardcoded directional lights (PBRApp.cpp:480-487)."""
        s = (0.25, 0.25, 0.25)
        c = 0.57735
        return Lights.build(
            directional=[
                ((c, c, c), s),
                ((c, -c, c), s),
                ((-c, c, c), s),
                ((-c, -c, c), s),
            ],
            device=device,
        )
