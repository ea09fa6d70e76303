"""Cook-Torrance PBR BRDF and punctual lights, elementwise over pixel batch
dims — the counterpart of ``physically_based_renderer_tpu/ops/brdf.py``
(``LightingUtil.hlsl:35-225``), formula for formula: the textured G-buffer
path shades with :func:`compute_lighting`. (The fused kernels' shader, with
its ``|n×h|²`` GGX term, is ``ops/shade_core.py``.)

Parity notes, as the HLSL: GGX roughness clamped to ≥ 0.05; Smith
k = (r+1)²/8; the specular denominator's + 1e-3; kD = (1−F)(1−metallic);
point/spot cut off past 100 units; attenuation 1/max(d, 0.01)². Maxima and
clips split a tie's gradient 0.5/0.5, as ``jnp.maximum``/``jnp.clip`` do.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import math3d
from ..device import DEFAULT_DEVICE

PI = 3.14159265359  # LightingUtil.hlsl:59,103
LIGHT_RANGE = 100.0
MIN_ROUGHNESS = 0.05
ATTEN_MIN_DIST = 0.01


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
    def build(directional=(), point=(), spot=(), *, device=DEFAULT_DEVICE) -> "Lights":
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
    def default_scene_lights(*, device=DEFAULT_DEVICE) -> "Lights":
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


@dataclasses.dataclass(frozen=True)
class MaterialSample:
    """Per-pixel shading inputs (the HLSL ``Material`` struct,
    LightingUtil.hlsl:19-33)."""

    diffuse_albedo: torch.Tensor  # (..., 3)
    metallic: torch.Tensor  # (...,)
    fresnel_r0: torch.Tensor  # (..., 3)
    roughness: torch.Tensor  # (...,)


def calc_attenuation(d: torch.Tensor) -> torch.Tensor:
    """Quadratic falloff, 1/max(d, 0.01)² (LightingUtil.hlsl:35-40)."""
    d_sat = math3d.maximum(d, ATTEN_MIN_DIST)
    return 1.0 / (d_sat * d_sat)


def fresnel_schlick(h: torch.Tensor, v: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    """F0 + (1−F0)(1−saturate(H·V))⁵ (LightingUtil.hlsl:43-47)."""
    cos_theta = math3d.saturate(math3d.dot(h, v)[..., None])
    return f0 + (1.0 - f0) * torch.pow(1.0 - cos_theta, 5.0)


def distribution_ggx(n: torch.Tensor, h: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """GGX/Trowbridge-Reitz NDF with the r ≥ 0.05 clamp (LightingUtil.hlsl:49-62)."""
    r = math3d.maximum(roughness, MIN_ROUGHNESS)
    a = r * r
    a2 = a * a
    ndoth = math3d.maximum(math3d.dot(n, h), 0.0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def geometry_schlick_ggx(ndotv: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Schlick-GGX with k = (r+1)²/8 (LightingUtil.hlsl:64-73)."""
    r = roughness + 1.0
    k = (r * r) / 8.0
    return ndotv / (ndotv * (1.0 - k) + k)


def geometry_smith(n, v, l, roughness) -> torch.Tensor:
    """LightingUtil.hlsl:75-83."""
    ndotv = math3d.maximum(math3d.dot(n, v), 0.0)
    ndotl = math3d.maximum(math3d.dot(n, l), 0.0)
    return geometry_schlick_ggx(ndotv, roughness) * geometry_schlick_ggx(ndotl, roughness)


def brdf_cook_torrance(mat: MaterialSample, radiance, n, v, l, h) -> torch.Tensor:
    """(kD·albedo/π + DGF/(4 N·V N·L + 1e-3)) · radiance · N·L
    (LightingUtil.hlsl:85-104)."""
    ndf = distribution_ggx(n, h, mat.roughness)
    g = geometry_smith(n, v, l, mat.roughness)
    f = fresnel_schlick(h, v, mat.fresnel_r0)
    denom = 4.0 * math3d.maximum(math3d.dot(n, v), 0.0) * math3d.maximum(math3d.dot(n, l), 0.0) + 1e-3
    specular = (ndf * g)[..., None] * f / denom[..., None]
    kd = (1.0 - f) * (1.0 - mat.metallic)[..., None]
    ndotl = math3d.maximum(math3d.dot(n, l), 0.0)
    return (kd * mat.diffuse_albedo / PI + specular) * radiance * ndotl[..., None]


def compute_directional_light(strength, direction, mat, n, v) -> torch.Tensor:
    """LightingUtil.hlsl:109-119."""
    l = (-direction).expand_as(v)
    h = math3d.normalize(v + l)
    return brdf_cook_torrance(mat, strength, n, v, l, h)


def compute_point_light(strength, position, mat, pos, n, v) -> torch.Tensor:
    """LightingUtil.hlsl:124-142 (hard 100-unit range cutoff)."""
    to_light = position - pos
    d = math3d.length(to_light)
    in_range = (d <= LIGHT_RANGE).to(pos.dtype)
    l = to_light / math3d.maximum(d, 1e-20)[..., None]
    h = math3d.normalize(v + l)
    radiance = strength * calc_attenuation(d)[..., None]
    return in_range[..., None] * brdf_cook_torrance(mat, radiance, n, v, l, h)


def compute_spot_light(strength, position, direction, spot_power, mat, pos, n, v) -> torch.Tensor:
    """LightingUtil.hlsl:147-167."""
    to_light = position - pos
    d = math3d.length(to_light)
    in_range = (d <= LIGHT_RANGE).to(pos.dtype)
    l = to_light / math3d.maximum(d, 1e-20)[..., None]
    h = math3d.normalize(v + l)
    cone = math3d.maximum(math3d.dot(-l, direction.expand_as(l)), 0.0)
    atten = calc_attenuation(d) * torch.pow(cone, spot_power)
    radiance = strength * atten[..., None]
    return in_range[..., None] * brdf_cook_torrance(mat, radiance, n, v, l, h)


def compute_lighting(lights: Lights, mat: MaterialSample, pos, n, v, shadow_factor=1.0) -> torch.Tensor:
    """Sum over the light list, directional, then point, then spot
    (LightingUtil.hlsl:170-200); the counts are static."""
    result = torch.zeros_like(mat.diffuse_albedo)
    i = 0
    for _ in range(lights.num_dir):
        result = result + shadow_factor * compute_directional_light(
            lights.strength[i], lights.direction[i], mat, n, v)
        i += 1
    for _ in range(lights.num_point):
        result = result + compute_point_light(lights.strength[i], lights.position[i], mat, pos, n, v)
        i += 1
    for _ in range(lights.num_spot):
        result = result + compute_spot_light(lights.strength[i], lights.position[i], lights.direction[i],
                                             lights.spot_power[i], mat, pos, n, v)
        i += 1
    return result


def normal_sample_to_world_space(normal_map_sample, n, t, b) -> torch.Tensor:
    """Tangent → world normal mapping, deliberately not renormalised, as the
    reference (LightingUtil.hlsl:203-214)."""
    nt = 2.0 * normal_map_sample - 1.0
    return nt[..., 0:1] * t + nt[..., 1:2] * b + nt[..., 2:3] * n
