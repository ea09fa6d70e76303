"""sIBL environment sets: the ``.ibl`` descriptor parser and its lights — the
counterpart of ``physically_based_renderer_tpu/models/sibl.py``, less the
LDR background decode (``load_background`` needs an image decoder; the
port's ``utils/image_io`` has none).

An sIBL set's ``.ibl`` INI descriptor names its equirect maps (LDR
background, HDR environment, HDR reflection) and places light hotspots
([Sun], [LightN]) at equirect (u, v) anchors, so a light's direction is
``sky_uv_to_direction(u, v)`` — the inverse of the sky's ``WorldToSkyUV``.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
import re

import numpy as np
import torch

from ..device import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class SIBLLight:
    """One [Sun]/[LightN] hotspot: direction FROM the light (like the
    reference's directional lights), linear RGB strength."""

    name: str
    color: tuple[float, float, float]  # 0-1 primaries
    multiplier: float
    u: float
    v: float

    @property
    def strength(self) -> tuple[float, float, float]:
        return tuple(c * self.multiplier for c in self.color)

    def direction(self) -> np.ndarray:
        """World-space direction of light travel (from the hotspot toward
        the scene origin)."""
        from ..ops.ibl import sky_uv_to_direction

        f = lambda x: torch.tensor(x, dtype=torch.float32)
        return -sky_uv_to_direction(f(self.u), f(self.v)).numpy()


@dataclasses.dataclass(frozen=True)
class SIBLSet:
    """A parsed .ibl descriptor (paths relative to the set's directory)."""

    name: str
    directory: str
    background_file: str | None  # LDR equirect (what the reference samples)
    environment_file: str | None  # low-res HDR for diffuse lighting
    environment_multiplier: float
    reflection_file: str | None  # hi-res HDR for specular
    reflection_multiplier: float
    sun: SIBLLight | None
    lights: tuple[SIBLLight, ...]

    def load_environment(self) -> np.ndarray:
        """HDR environment map (H, W, 3) float32, multiplier applied."""
        from ..utils.image_io import load_hdr

        if not self.environment_file:
            raise ValueError(f"{self.name} has no EVfile")
        img = load_hdr(os.path.join(self.directory, self.environment_file))
        return img * np.float32(self.environment_multiplier)

    def load_reflection(self) -> np.ndarray:
        from ..utils.image_io import load_hdr

        if not self.reflection_file:
            raise ValueError(f"{self.name} has no REFfile")
        img = load_hdr(os.path.join(self.directory, self.reflection_file))
        return img * np.float32(self.reflection_multiplier)

    def directional_lights(self) -> list[SIBLLight]:
        out = list(self.lights)
        if self.sun is not None:
            out.insert(0, self.sun)
        return out


def _unquote(v: str) -> str:
    return v.split(";")[0].strip().strip('"')


def _color(v: str) -> tuple[float, float, float]:
    parts = [float(x) for x in re.split(r"[,\s]+", _unquote(v)) if x]
    c = (parts + [0.0, 0.0, 0.0])[:3]
    return tuple(x / 255.0 for x in c)


def parse_ibl(path: str) -> SIBLSet:
    """Parse an sIBL .ibl descriptor file."""
    cp = configparser.ConfigParser(strict=False, inline_comment_prefixes=(";",))
    with open(path, "r", errors="replace") as f:
        cp.read_string(f.read())

    def get(section, key, default=None):
        try:
            return _unquote(cp.get(section, key))
        except (configparser.NoSectionError, configparser.NoOptionError):
            return default

    def getf(section, key, default=0.0):
        v = get(section, key)
        try:
            return float(v) if v is not None else default
        except ValueError:
            return default

    def light_from(section, prefix, fallback_name):
        if not cp.has_section(section):
            return None
        return SIBLLight(
            name=get(section, f"{prefix}name", fallback_name) or fallback_name,
            color=_color(get(section, f"{prefix}color", "255,255,255")),
            multiplier=getf(section, f"{prefix}multi", 1.0),
            u=getf(section, f"{prefix}u", 0.0),
            v=getf(section, f"{prefix}v", 0.0),
        )

    lights = []
    for i in range(1, 33):
        li = light_from(f"Light{i}", "LIGHT", f"Light{i}")
        if li is None:
            break
        lights.append(li)

    # The sIBL spec's own spelling: the section really is "Enviroment".
    env_section = "Enviroment" if cp.has_section("Enviroment") else "Environment"
    return SIBLSet(
        name=get("Header", "Name", os.path.basename(path)) or "",
        directory=os.path.dirname(os.path.abspath(path)),
        background_file=get("Background", "BGfile"),
        environment_file=get(env_section, "EVfile"),
        environment_multiplier=getf(env_section, "EVmulti", 1.0),
        reflection_file=get("Reflection", "REFfile"),
        reflection_multiplier=getf("Reflection", "REFmulti", 1.0),
        sun=light_from("Sun", "SUN", "Sun"),
        lights=tuple(lights),
    )


def find_ibl(directory: str) -> str | None:
    """The .ibl descriptor inside a set directory."""
    for f in sorted(os.listdir(directory)):
        if f.lower().endswith(".ibl"):
            return os.path.join(directory, f)
    return None


def sibl_scene_lights(s: SIBLSet, max_lights: int = 16, *, device=DEFAULT_DEVICE):
    """A renderer ``Lights`` bank from the descriptor's sun and hotspots (all
    directional, the reference's light model)."""
    from ..ops.brdf import Lights

    ls = s.directional_lights()[:max_lights]
    if not ls:
        return Lights.default_scene_lights(device=device)
    return Lights.build(directional=[(tuple(l.direction()), l.strength) for l in ls], device=device)
