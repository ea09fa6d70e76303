"""Scenes and cameras carried across from plain NumPy trees.

``scene_from_numpy`` and ``camera_from_numpy`` take nested dicts of NumPy
arrays and Python scalars, keyed by the JAX package's dataclass field names,
and return the port's ``Scene`` and ``Camera`` on ``device``:

  scene:  {"draws": [{"mesh": {positions, normals, tangents, bitangents, uvs,
                               tris},
                      "worlds", "material_ids", "face_materials"}, ...],
           "materials": {every MaterialBank field, any_displacement,
                         any_alpha_test},
           "lights": {strength, direction, position, spot_power, num_dir,
                      num_point, num_spot},
           "ambient", "clear_color",
           "atlas", "env_map", "ibl", "sky_map", "combined_atlas"}
  camera: {position, yaw, pitch, fov_y, aspect, near, far}

The later-slice scene fields must be absent or None.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..camera import Camera
from ..models.material import MaterialBank
from ..models.mesh import Mesh
from ..models.scene import LATER_SLICE_FIELDS, InstancedDraw, Scene
from ..ops.brdf import Lights


def _f32(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)


def _i64(x, device):
    return torch.as_tensor(np.array(x, np.int64), device=device)


def scene_from_numpy(tree: dict, *, device="cpu") -> Scene:
    for name, slice_name in LATER_SLICE_FIELDS.items():
        if tree.get(name) is not None:
            raise NotImplementedError(f"Scene.{name} comes with {slice_name}")
    draws = []
    for d in tree["draws"]:
        m = d["mesh"]
        mesh = Mesh(
            positions=_f32(m["positions"], device),
            normals=_f32(m["normals"], device),
            tangents=_f32(m["tangents"], device),
            bitangents=_f32(m["bitangents"], device),
            uvs=_f32(m["uvs"], device),
            tris=_i64(m["tris"], device),
        )
        fm = d.get("face_materials")
        draws.append(
            InstancedDraw(
                mesh=mesh,
                worlds=_f32(d["worlds"], device),
                material_ids=_i64(d["material_ids"], device),
                face_materials=None if fm is None else _i64(fm, device),
            )
        )
    mt = tree["materials"]
    fields = {}
    for f in dataclasses.fields(MaterialBank):
        if f.name in ("any_displacement", "any_alpha_test"):
            fields[f.name] = bool(mt[f.name])
        elif f.name == "tex_index":
            fields[f.name] = torch.as_tensor(np.array(mt[f.name], np.int32), device=device)
        else:
            fields[f.name] = _f32(mt[f.name], device)
    lt = tree["lights"]
    lights = Lights(
        strength=_f32(lt["strength"], device),
        direction=_f32(lt["direction"], device),
        position=_f32(lt["position"], device),
        spot_power=_f32(lt["spot_power"], device),
        num_dir=int(lt["num_dir"]),
        num_point=int(lt["num_point"]),
        num_spot=int(lt["num_spot"]),
    )
    return Scene(
        draws=tuple(draws),
        materials=MaterialBank(**fields),
        lights=lights,
        ambient=_f32(tree["ambient"], device),
        clear_color=_f32(tree["clear_color"], device),
    )


def camera_from_numpy(tree: dict, *, device="cpu") -> Camera:
    return Camera(
        position=_f32(tree["position"], device),
        yaw=_f32(tree["yaw"], device),
        pitch=_f32(tree["pitch"], device),
        fov_y=float(tree["fov_y"]),
        aspect=float(tree["aspect"]),
        near=float(tree["near"]),
        far=float(tree["far"]),
    )
