"""Scenes: instanced draws and their flattening to rasterizer inputs — the
counterpart of ``physically_based_renderer_tpu/models/scene.py``.

An :class:`InstancedDraw` shares one mesh across I instances with per-instance
world matrices and material ids. ``flatten_scene`` expands every draw into
an indexed world-space soup (``FlatGeometry``: vertices and ``tris``), and
``flatten_scene_corners`` into a corner-major one (no vertex indices on the
hot path); with
``textured`` the corners also carry tangent, bitangent and uv. A scene with
a texture ``atlas`` is textured; ``with_combined_textures`` bakes its
one-page-a-material form.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..ops.brdf import Lights
from ..ops.ibl import IBLMaps
from ..ops.texture import TextureAtlas
from ..ops.texture_combined import BUILDERS
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


@dataclasses.dataclass(frozen=True)
class Scene:
    draws: tuple[InstancedDraw, ...]
    materials: MaterialBank
    lights: Lights
    ambient: torch.Tensor  # (3,) g_AmbientLight.rgb
    clear_color: torch.Tensor  # (3,) PBRApp.cpp:274 (0.5 grey)
    atlas: TextureAtlas | None = None  # the texture pages; a scene with one is textured
    env_map: torch.Tensor | None = None  # (He, We, 3) f32 equirect HDR environment
    ibl: IBLMaps | None = None  # precomputed maps: IBL replaces the constant ambient
    # visible-sky override, the sIBL set's LDR background: (Hk, Wk, 3) uint8
    # (ops/texture.sky_u8) or f32; when None the sky samples env_map
    sky_map: torch.Tensor | None = None
    # one page per textured material (ops/texture_combined.py), built by
    # with_combined_textures; sampled instead of the atlas when set
    combined_atlas: object | None = None

    def with_ibl(self) -> "Scene":
        """Precompute the IBL maps from ``env_map`` (on its device)."""
        if self.env_map is None:
            raise ValueError("the scene has no environment map")
        return dataclasses.replace(self, ibl=IBLMaps.build(self.env_map))

    def with_combined_textures(self, packed: bool = False, mode: str | None = None) -> "Scene":
        """Bake the combined pages on the atlas's device. ``mode``
        (overrides the legacy ``packed`` flag): ``"f32"`` (default), ``"quad"``
        (one f32 row a sample, exact texel gradients) or ``"half"`` (f16
        words, texel gradients straight through to the f32 pages); see
        ``ops/texture_combined.py``."""
        if self.atlas is None:
            raise ValueError("the scene has no texture atlas")
        if mode is None:
            mode = "packed" if packed else "f32"
        if mode == "packed":
            raise NotImplementedError("the u8 'packed' combined pages are not ported yet (ROADMAP item 9, "
                                      "carried forward to a later PR)")
        return dataclasses.replace(self, combined_atlas=BUILDERS[mode](self.materials, self.atlas))

    def to(self, device) -> "Scene":
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(
            self,
            draws=tuple(d.to(device) for d in self.draws),
            materials=self.materials.to(device),
            lights=self.lights.to(device),
            ambient=self.ambient.to(device),
            clear_color=self.clear_color.to(device),
            atlas=move(self.atlas),
            env_map=move(self.env_map),
            ibl=move(self.ibl),
            sky_map=move(self.sky_map),
            combined_atlas=move(self.combined_atlas),
        )


def default_clear_color(device=DEFAULT_DEVICE) -> torch.Tensor:
    return torch.tensor([0.5, 0.5, 0.5], dtype=torch.float32, device=device)


def _world_blocks(blocks: torch.Tensor, worlds: torch.Tensor) -> torch.Tensor:
    """(..., nb, 3) local position and direction blocks through each
    instance's 3x3 → (I, ..., nb, 3): an explicit 3-term float32 sum (no
    BLAS, no TF32); block 0, the position, also translates (Default.hlsl:
    27-35; directions take no inverse-transpose, as the reference)."""
    shape = (worlds.shape[0],) + (1,) * (blocks.ndim - 1) + (3, 3)
    rot = worlds[:, :3, :3].reshape(shape)
    lb = blocks[None]
    wb = lb[..., 0:1] * rot[..., 0, :] + lb[..., 1:2] * rot[..., 1, :] + lb[..., 2:3] * rot[..., 2, :]
    trans = worlds[:, 3, :3].reshape(shape[:-2] + (3,))
    return torch.cat([wb[..., 0:1, :] + trans, wb[..., 1:, :]], dim=-2)


def _face_materials(draw: InstancedDraw) -> torch.Tensor:
    """(I·T,) material id of each instance's triangles: per face, or per draw."""
    m = draw.mesh
    if draw.face_materials is not None:
        return draw.face_materials[None, :].expand(draw.num_instances, m.num_triangles).reshape(-1)
    return draw.material_ids[:, None].expand(draw.num_instances, m.num_triangles).reshape(-1)


@dataclasses.dataclass(frozen=True)
class FlatGeometry:
    """Indexed world-space triangle soup: every draw's instances expanded."""

    pos_w: torch.Tensor  # (V, 3)
    normal_w: torch.Tensor  # (V, 3)
    tangent_w: torch.Tensor  # (V, 3)
    bitangent_w: torch.Tensor  # (V, 3)
    uv: torch.Tensor  # (V, 2)
    tris: torch.Tensor  # (T, 3) int64
    face_material: torch.Tensor  # (T,) int64


def flatten_scene(scene: Scene) -> FlatGeometry:
    """Instance-expand every draw into world space, vertex by vertex (the VS
    world stage, Default.hlsl:27-35): positions through the full 4x4,
    normals, tangents and bitangents through the 3x3, each instance's
    ``tris`` offset by the vertices before it, ``face_material`` per face or
    per draw. The same sums as :func:`flatten_scene_corners`, so
    ``pos_w[tris]`` is its corner positions bit for bit."""
    blocks, uvs, tris, mats = [], [], [], []
    v_offset = 0
    for draw in scene.draws:
        m = draw.mesh
        num_i, nv = draw.num_instances, m.num_vertices
        local = torch.stack([m.positions, m.normals, m.tangents, m.bitangents], dim=-2)  # (V, 4, 3)
        blocks.append(_world_blocks(local, draw.worlds).reshape(num_i * nv, 4, 3))
        uvs.append(m.uvs[None].expand(num_i, nv, 2).reshape(-1, 2))
        inst_off = v_offset + torch.arange(num_i, device=m.tris.device) * nv
        tris.append((m.tris[None] + inst_off[:, None, None]).reshape(-1, 3))
        mats.append(_face_materials(draw))
        v_offset += num_i * nv
    world = torch.cat(blocks)
    return FlatGeometry(pos_w=world[:, 0], normal_w=world[:, 1], tangent_w=world[:, 2], bitangent_w=world[:, 3],
                        uv=torch.cat(uvs), tris=torch.cat(tris), face_material=torch.cat(mats))


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
        wb = _world_blocks(local.reshape(*local.shape[:-1], nblk, 3), w)  # (I, Tb, 3, nb, 3)
        world = wb.reshape(num_i, *local.shape[:-1], nblk * 3)
        if textured:
            uv_c = m.uvs[idx]
            world = torch.cat([world, uv_c[None].expand(num_i, *uv_c.shape)], dim=-1)
        attr_parts.append(world.reshape(-1, 3, world.shape[-1]))
        mat_parts.append(_face_materials(draw))

    return CornerGeometry(attrs=torch.cat(attr_parts), face_material=torch.cat(mat_parts))


def translation_world(x, y, z) -> np.ndarray:
    """Row-vector translation matrix (host-side convenience)."""
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = (x, y, z)
    return m
