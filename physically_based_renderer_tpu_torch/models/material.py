"""Material bank: structure-of-arrays material properties + texture slots —
the counterpart of ``physically_based_renderer_tpu/models/material.py``
(reference ``Material.h`` and ``cbMaterial``, ``Core.hlsl:64-81``).

Every field of the JAX bank is carried, so a bank converts either way without
loss. The fused paths read ``diffuse``, ``metallic``, ``fresnel_r0``,
``roughness`` and ``opacity``; the textured G-buffer path also reads
``height_scale``, ``uv_transform``, ``has_tex``, ``tex_index``,
``alpha_test`` and the static ``any_displacement`` / ``any_alpha_test``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE


SLOT_DIFFUSE = 0
SLOT_SPECULAR = 1
SLOT_METALLIC = 2
SLOT_ROUGHNESS = 3
SLOT_NORMAL = 4
SLOT_DISPLACEMENT = 5
SLOT_BUMP = 6
SLOT_AMBIENT_OCCLUSION = 7
SLOT_CAVITY = 8
SLOT_SHEEN = 9
SLOT_EMISSIVE = 10
SLOT_OPACITY = 11
NUM_SLOTS = 12

SLOT_NAMES = (
    "diffuse",
    "specular",
    "metallic",
    "roughness",
    "normal",
    "displacement",
    "bump",
    "ambient_occlusion",
    "cavity",
    "sheen",
    "emissive",
    "opacity",
)


@dataclasses.dataclass(frozen=True)
class MaterialBank:
    """All (M, …) tensors. Defaults mirror MaterialProperties (Material.h:10-29)."""

    diffuse: torch.Tensor  # (M, 3)
    metallic: torch.Tensor  # (M,)
    fresnel_r0: torch.Tensor  # (M, 3)
    roughness: torch.Tensor  # (M,)
    transmission: torch.Tensor  # (M, 3)
    height_scale: torch.Tensor  # (M,)
    emissive: torch.Tensor  # (M, 3)
    opacity: torch.Tensor  # (M,)
    sheen: torch.Tensor  # (M,)
    clearcoat_thickness: torch.Tensor  # (M,)
    clearcoat_roughness: torch.Tensor  # (M,)
    anisotropy: torch.Tensor  # (M,)
    anisotropy_rotation: torch.Tensor  # (M,)
    uv_transform: torch.Tensor  # (M, 3, 2)
    tex_index: torch.Tensor  # (M, 12) int32
    has_tex: torch.Tensor  # (M, 12) f32
    alpha_test: torch.Tensor  # (M,) f32
    transparent: torch.Tensor  # (M,) f32
    any_displacement: bool = False
    any_alpha_test: bool = False

    @property
    def num_materials(self) -> int:
        return self.diffuse.shape[0]

    def tensor_fields(self) -> tuple[str, ...]:
        return tuple(
            f.name for f in dataclasses.fields(self) if isinstance(getattr(self, f.name), torch.Tensor)
        )

    def to(self, device) -> "MaterialBank":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in self.tensor_fields()}
        )

    def props_table(self, textured: bool = False) -> torch.Tensor:
        """(M, 9) constant-material table: diffuse rgb, metallic, fresnel_r0
        rgb, roughness, opacity — the row the fused kernel fetches. With
        ``textured`` the (M, 28) table ``shade_pixels`` fetches
        (renderer.py:126-139): those 9, then height_scale, the uv transform
        (6) and has_tex (12)."""
        cols = [
            self.diffuse,
            self.metallic[:, None],
            self.fresnel_r0,
            self.roughness[:, None],
            self.opacity[:, None],
        ]
        if textured:
            cols += [self.height_scale[:, None], self.uv_transform.reshape(-1, 6), self.has_tex]
        return torch.cat(cols, dim=-1)


class MaterialBuilder:
    """Host-side builder: accumulate named materials, then freeze to a bank."""

    def __init__(self):
        self._rows: list[dict] = []
        self.index: dict[str, int] = {}

    def add(
        self,
        name: str,
        *,
        diffuse=(1.0, 1.0, 1.0),
        metallic=0.0,
        fresnel_r0=(0.04, 0.04, 0.04),
        roughness=1.0,
        transmission=(1.0, 1.0, 1.0),
        height_scale=1.0,
        emissive=(0.0, 0.0, 0.0),
        opacity=1.0,
        sheen=0.0,
        clearcoat_thickness=0.0,
        clearcoat_roughness=0.0,
        anisotropy=0.0,
        anisotropy_rotation=0.0,
        uv_transform=None,
        textures: dict[str, int] | None = None,
        alpha_test=False,
        transparent=False,
    ) -> int:
        """textures: slot-name → atlas page index (see SLOT_NAMES)."""
        if name in self.index:
            raise ValueError(f"duplicate material {name!r}")
        tex_index = np.zeros((NUM_SLOTS,), np.int32)
        has_tex = np.zeros((NUM_SLOTS,), np.float32)
        for slot_name, page in (textures or {}).items():
            s = SLOT_NAMES.index(slot_name)
            tex_index[s] = page
            has_tex[s] = 1.0
        row = dict(
            diffuse=diffuse,
            metallic=metallic,
            fresnel_r0=fresnel_r0,
            roughness=roughness,
            transmission=transmission,
            height_scale=height_scale,
            emissive=emissive,
            opacity=opacity,
            sheen=sheen,
            clearcoat_thickness=clearcoat_thickness,
            clearcoat_roughness=clearcoat_roughness,
            anisotropy=anisotropy,
            anisotropy_rotation=anisotropy_rotation,
            uv_transform=np.asarray(
                uv_transform if uv_transform is not None else [[1, 0], [0, 1], [0, 0]],
                np.float32,
            ),
            tex_index=tex_index,
            has_tex=has_tex,
            alpha_test=1.0 if alpha_test else 0.0,
            transparent=1.0 if transparent else 0.0,
        )
        self._rows.append(row)
        self.index[name] = len(self._rows) - 1
        return self.index[name]

    def build(self, *, device=DEFAULT_DEVICE) -> MaterialBank:
        if not self._rows:
            raise ValueError("no materials")

        def col(key, dtype=np.float32):
            return torch.as_tensor(
                np.stack([np.asarray(r[key], dtype) for r in self._rows]), device=device
            )

        return MaterialBank(
            diffuse=col("diffuse"),
            metallic=col("metallic"),
            fresnel_r0=col("fresnel_r0"),
            roughness=col("roughness"),
            transmission=col("transmission"),
            height_scale=col("height_scale"),
            emissive=col("emissive"),
            opacity=col("opacity"),
            sheen=col("sheen"),
            clearcoat_thickness=col("clearcoat_thickness"),
            clearcoat_roughness=col("clearcoat_roughness"),
            anisotropy=col("anisotropy"),
            anisotropy_rotation=col("anisotropy_rotation"),
            uv_transform=col("uv_transform"),
            tex_index=col("tex_index", np.int32),
            has_tex=col("has_tex"),
            alpha_test=col("alpha_test"),
            transparent=col("transparent"),
            any_displacement=any(r["has_tex"][SLOT_DISPLACEMENT] > 0 for r in self._rows),
            any_alpha_test=any(r["alpha_test"] > 0 for r in self._rows),
        )
