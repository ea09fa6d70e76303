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
           "env_map": (He, We, 3) f32 or None,
           "sky_map": None, (Hk, Wk, 3) f32, or the LDR background as uint8
                      texels or the JAX package's (Hk, Wk, 4) uint32 quad
                      words (both become uint8 texels, ``ops/texture.sky_u8``),
           "ibl": None or {every IBLMaps field; the f16 fields as float16
                  texels or the JAX package's uint32 quad words},
           "atlas", "combined_atlas"}
  camera: {position, yaw, pitch, fov_y, aspect, near, far}

The later-slice scene fields (textures) must be absent or None.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..camera import Camera
from ..models.material import MaterialBank
from ..models.mesh import Mesh
from ..models.scene import LATER_SLICE_FIELDS, InstancedDraw, Scene
from ..ops.brdf import Lights
from ..ops.ibl import IBLMaps
from ..ops.texture import f16_from_quad_words, sky_u8


def _f32(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)


def _i64(x, device):
    return torch.as_tensor(np.array(x, np.int64), device=device)


def _f16(x, base, device):
    """An f16 IBL field: float16 texels, or quad words unpacked to the
    channels of their f32 original ``base``."""
    if x is None:
        return None
    x = np.asarray(x)
    t = f16_from_quad_words(x, base.shape[-1]) if x.dtype == np.uint32 else torch.as_tensor(x.astype(np.float16))
    return t.to(device)


def ibl_from_numpy(tree: dict, *, device=DEFAULT_DEVICE) -> IBLMaps:
    opt = lambda k: None if tree.get(k) is None else _f32(tree[k], device)
    stack, irr = opt("specular_stack"), _f32(tree["irradiance"], device)
    return IBLMaps(
        irradiance=irr,
        specular_levels=tuple(_f32(t, device) for t in tree["specular_levels"]),
        lut=_f32(tree["lut"], device),
        specular_stack=stack,
        specular_stack_f16=None if stack is None else _f16(tree.get("specular_stack_f16"), stack, device),
        irradiance_f16=_f16(tree.get("irradiance_f16"), irr, device),
        irradiance_sh9=opt("irradiance_sh9"),
    )


def _sky(x, device):
    x = np.asarray(x)
    if x.dtype in (np.uint32, np.uint8):
        return (torch.as_tensor(x) if x.dtype == np.uint8 else sky_u8(x)).to(device)
    return _f32(x, device)


def scene_from_numpy(tree: dict, *, device=DEFAULT_DEVICE) -> Scene:
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
        env_map=None if tree.get("env_map") is None else _f32(tree["env_map"], device),
        ibl=None if tree.get("ibl") is None else ibl_from_numpy(tree["ibl"], device=device),
        sky_map=None if tree.get("sky_map") is None else _sky(tree["sky_map"], device),
    )


def camera_from_numpy(tree: dict, *, device=DEFAULT_DEVICE) -> Camera:
    return Camera(
        position=_f32(tree["position"], device),
        yaw=_f32(tree["yaw"], device),
        pitch=_f32(tree["pitch"], device),
        fov_y=float(tree["fov_y"]),
        aspect=float(tree["aspect"]),
        near=float(tree["near"]),
        far=float(tree["far"]),
    )
