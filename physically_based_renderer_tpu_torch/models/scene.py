"""Scenes: instanced draws and their flattening to rasterizer inputs — the
counterpart of ``physically_based_renderer_tpu/models/scene.py``.

An :class:`InstancedDraw` shares one mesh across I instances with per-instance
world matrices and material ids. ``flatten_scene_corners`` expands it into a
corner-major world-space soup (no vertex indices on the hot path).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.brdf import Lights
from .material import MaterialBank
from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class InstancedDraw:
    """One shared mesh drawn I times. Materials: per-instance
    ``material_ids``, or per-triangle ``face_materials`` shared by all
    instances (multi-material meshes)."""

    mesh: Mesh
    worlds: torch.Tensor  # (I, 4, 4) row-vector world matrices
    material_ids: torch.Tensor  # (I,) int64
    face_materials: torch.Tensor | None = None  # (T,) int64

    @property
    def num_instances(self) -> int:
        return self.worlds.shape[0]

    @staticmethod
    def create(mesh: Mesh, worlds, material_ids, face_materials=None) -> "InstancedDraw":
        device = mesh.positions.device
        worlds = torch.as_tensor(np.asarray(worlds, np.float32), device=device)
        if worlds.ndim == 2:
            worlds = worlds[None]
        return InstancedDraw(
            mesh=mesh,
            worlds=worlds,
            material_ids=torch.as_tensor(
                np.atleast_1d(np.asarray(material_ids, np.int64)), device=device
            ),
            face_materials=(
                torch.as_tensor(np.asarray(face_materials, np.int64), device=device)
                if face_materials is not None
                else None
            ),
        )

    def to(self, device) -> "InstancedDraw":
        return InstancedDraw(
            mesh=self.mesh.to(device),
            worlds=self.worlds.to(device),
            material_ids=self.material_ids.to(device),
            face_materials=None if self.face_materials is None else self.face_materials.to(device),
        )


# Fields of the JAX scene that later slices of the port fill in; each must be
# None here, and ``render`` says which slice brings it.
LATER_SLICE_FIELDS = {
    "atlas": "the textured slice",
    "combined_atlas": "the textured slice",
    "env_map": "the IBL slice",
    "ibl": "the IBL slice",
    "sky_map": "the IBL slice",
}


@dataclasses.dataclass(frozen=True)
class Scene:
    draws: tuple[InstancedDraw, ...]
    materials: MaterialBank
    lights: Lights
    ambient: torch.Tensor  # (3,) g_AmbientLight.rgb
    clear_color: torch.Tensor  # (3,) PBRApp.cpp:274 (0.5 grey)
    atlas: object | None = None
    env_map: torch.Tensor | None = None
    ibl: object | None = None
    sky_map: torch.Tensor | None = None
    combined_atlas: object | None = None

    def to(self, device) -> "Scene":
        for name in LATER_SLICE_FIELDS:
            if getattr(self, name) is not None:
                raise NotImplementedError(f"Scene.{name} comes with {LATER_SLICE_FIELDS[name]}")
        return dataclasses.replace(
            self,
            draws=tuple(d.to(device) for d in self.draws),
            materials=self.materials.to(device),
            lights=self.lights.to(device),
            ambient=self.ambient.to(device),
            clear_color=self.clear_color.to(device),
        )


def default_clear_color(device="cpu") -> torch.Tensor:
    return torch.tensor([0.5, 0.5, 0.5], dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class CornerGeometry:
    """Corner-major world-space soup: every triangle's three corners stored
    contiguously. ``attrs`` is [pos_w(3), normal_w(3)] untextured, plus
    [tangent_w(3), bitangent_w(3), uv(2)] when textured."""

    attrs: torch.Tensor  # (T, 3, C), C = 6 or 14
    face_material: torch.Tensor  # (T,) int64

    @property
    def pos_w(self) -> torch.Tensor:
        return self.attrs[..., 0:3]

    @property
    def num_triangles(self) -> int:
        return self.attrs.shape[0]


def flatten_scene_corners(scene: Scene, *, textured: bool = False) -> CornerGeometry:
    """Instance-expand every draw into a corner-major world-space soup. The
    corner gather runs once per base mesh; the instance expansion is a dense
    3-term sum (positions translate, direction blocks only rotate — no
    inverse-transpose, Default.hlsl:27-35)."""
    attr_parts, mat_parts = [], []
    for draw in scene.draws:
        m = draw.mesh
        w = draw.worlds  # (I, 4, 4)
        num_i = w.shape[0]
        idx = m.tris  # (Tb, 3)
        blocks = [m.positions, m.normals]
        if textured:
            blocks += [m.tangents, m.bitangents]
        local = torch.cat(blocks, dim=-1)[idx]  # (Tb, 3, 3·nb)
        nblk = local.shape[-1] // 3
        lb = local.reshape(*local.shape[:-1], nblk, 3)[None]  # (1, Tb, 3, nb, 3)
        rot = w[:, None, None, None, :3, :3]  # (I, 1, 1, 1, 3, 3)
        wb = (
            lb[..., 0:1] * rot[..., 0, :]
            + lb[..., 1:2] * rot[..., 1, :]
            + lb[..., 2:3] * rot[..., 2, :]
        )  # (I, Tb, 3, nb, 3)
        trans = w[:, 3, :3]
        wb = torch.cat([wb[..., 0:1, :] + trans[:, None, None, None, :], wb[..., 1:, :]], dim=-2)
        world = wb.reshape(num_i, *local.shape[:-1], nblk * 3)
        if textured:
            uv_c = m.uvs[idx]
            world = torch.cat([world, uv_c[None].expand(num_i, *uv_c.shape)], dim=-1)
        attr_parts.append(world.reshape(-1, 3, world.shape[-1]))

        if draw.face_materials is not None:
            face_mat = draw.face_materials[None, :].expand(num_i, m.num_triangles)
        else:
            face_mat = draw.material_ids[:, None].expand(num_i, m.num_triangles)
        mat_parts.append(face_mat.reshape(-1))

    return CornerGeometry(attrs=torch.cat(attr_parts), face_material=torch.cat(mat_parts))


def translation_world(x, y, z) -> np.ndarray:
    """Row-vector translation matrix (host-side convenience)."""
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = (x, y, z)
    return m
