"""Hierarchical scene graph that lowers to the flat render representation —
the counterpart of ``physically_based_renderer_tpu/models/scene_graph.py``.

The reference carries a vestigial scene graph — ``Node`` with a toWorld
transform, children and components (``Node.h:12-69``, ``Component.h:5-25``)
and Direct/Point/Spot light nodes (``Light.h:11-64``) — which PBRApp never
instantiates. Author hierarchies of transforms (NumPy, row-vector), meshes,
materials and lights, then :func:`lower` composes the world matrices (child
@ parent) and emits the batched :class:`~.scene.Scene` the renderer takes,
on the material bank's device. Instances of one mesh object without
per-face materials batch into one ``InstancedDraw``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable

import numpy as np
import torch

from ..ops.brdf import Lights
from .material import MaterialBank
from .mesh import Mesh
from .scene import InstancedDraw, Scene, default_clear_color

_ids = itertools.count()


@dataclasses.dataclass
class Component:
    """Base component (Component.h:5-25)."""

    name: str = ""


@dataclasses.dataclass
class MeshComponent(Component):
    mesh: Mesh | None = None
    material: int = 0  # material-bank index
    face_materials: np.ndarray | None = None  # (T,) bank ids, one a triangle


@dataclasses.dataclass
class LightComponent(Component):
    """Direct/Point/Spot light property bag (Light.h:11-64). Position and
    direction come from the owning node's world transform: the position is
    its translation, the direction its local +z row."""

    kind: str = "directional"  # directional | point | spot
    strength: tuple = (1.0, 1.0, 1.0)
    spot_power: float = 16.0


@dataclasses.dataclass
class Node:
    """Transform-tree node (Node.h:12-69): unique id, local transform,
    children, components, active flag."""

    name: str = ""
    transform: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))  # local
    children: list["Node"] = dataclasses.field(default_factory=list)
    components: list[Component] = dataclasses.field(default_factory=list)
    active: bool = True
    unique_id: int = dataclasses.field(default_factory=lambda: next(_ids))

    def add(self, child: "Node") -> "Node":
        self.children.append(child)
        return child

    def walk(self, parent_world: np.ndarray | None = None) -> Iterable[tuple["Node", np.ndarray]]:
        """(node, world) of every active node, depth first; an inactive
        node hides its subtree. Row-vector compose: world = local @ parent."""
        if not self.active:
            return
        world = self.transform if parent_world is None else self.transform @ parent_world
        yield self, world
        for ch in self.children:
            yield from ch.walk(world)


def lower(
    root: Node,
    materials: MaterialBank,
    *,
    atlas=None,
    ambient=(0.03, 0.03, 0.03),
    env_map: torch.Tensor | None = None,
    extra_lights: Lights | None = None,
) -> Scene:
    """Flatten the graph into a renderable Scene on ``materials``' device.

    Meshes sharing one mesh object batch into one InstancedDraw, instances
    in walk order (a mesh with per-face materials is a draw of its own).
    Lights collect into the packed light set, directional first, then point,
    then spot (the ComputeLighting order); ``extra_lights`` replaces them."""
    device = materials.diffuse.device
    batches: dict[int, list[tuple[np.ndarray, int]]] = {}
    mesh_of: dict[int, Mesh] = {}
    face_mats: dict[int, np.ndarray | None] = {}
    directional, point, spot = [], [], []

    for node, world in root.walk():
        for comp in node.components:
            if isinstance(comp, MeshComponent) and comp.mesh is not None:
                key = id(comp.mesh) if comp.face_materials is None else -node.unique_id
                mesh_of[key] = comp.mesh
                face_mats[key] = comp.face_materials
                batches.setdefault(key, []).append((world, comp.material))
            elif isinstance(comp, LightComponent):
                pos = tuple(np.asarray(world[3, :3], np.float64))
                direction = np.asarray(world[2, :3], np.float64)  # local +z through the rotation
                direction = tuple(direction / max(np.linalg.norm(direction), 1e-12))
                if comp.kind == "directional":
                    directional.append((direction, comp.strength))
                elif comp.kind == "point":
                    point.append((pos, comp.strength))
                else:
                    spot.append((pos, direction, comp.strength, comp.spot_power))

    draws = tuple(
        InstancedDraw.create(mesh_of[key], np.stack([w for w, _ in inst]).astype(np.float32),
                             [m for _, m in inst], face_materials=face_mats[key])
        for key, inst in batches.items()
    )
    lights = extra_lights if extra_lights is not None else Lights.build(
        directional=directional, point=point, spot=spot, device=device)
    return Scene(
        draws=draws,
        materials=materials,
        atlas=atlas,
        lights=lights,
        ambient=torch.as_tensor(ambient, dtype=torch.float32, device=device),
        clear_color=default_clear_color(device),
        env_map=env_map,
    )
