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
           "atlas": None or {"mips": [(N, S>>l, S>>l, 4) f32, ...]},
           "combined_atlas": None or {"kind": "f32" | "quad" | "half" | "packed", and the
                  fields of that mode's atlas: pages, material_page and mips
                  (f32); taps, pages, material_page, mips_taps, mips_stack,
                  num_levels and the JAX package's ``tile`` (quad: tile-major
                  rows become row-major); words, pages, material_page,
                  mips_words, mips_stack, num_levels (half: uint32 words
                  become their int32 bits); words, material_page,
                  mips_words, num_levels (packed: the same)}}
  camera: {position, yaw, pitch, fov_y, aspect, near, far}
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..camera import Camera
from ..models.material import MaterialBank
from ..models.mesh import Mesh
from ..models.scene import InstancedDraw, Scene
from ..ops.brdf import Lights
from ..ops.ibl import IBLMaps
from ..ops.texture import TextureAtlas, f16_from_quad_words, sky_u8
from ..ops.texture_combined import CombinedAtlas, HalfCombinedAtlas, PackedCombinedAtlas, QuadCombinedAtlas


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


def atlas_from_numpy(tree: dict, *, device=DEFAULT_DEVICE) -> TextureAtlas:
    return TextureAtlas(mips=tuple(_f32(m, device) for m in tree["mips"]))


def _words(x, device):
    """uint32 words → the int32 tensor of the same bits."""
    return None if x is None else torch.as_tensor(np.array(x, np.uint32).view(np.int32),
                                                  device=device)


def combined_atlas_from_numpy(tree: dict, *, device=DEFAULT_DEVICE):
    opt = lambda k: None if tree.get(k) is None else _f32(tree[k], device)  # noqa: E731
    material_page = _i64(tree["material_page"], device)
    if tree["kind"] == "packed":
        return PackedCombinedAtlas(words=_words(tree["words"], device), material_page=material_page,
                                   mips_words=_words(tree.get("mips_words"), device),
                                   num_levels=int(tree["num_levels"]))
    pages = _f32(tree["pages"], device)
    if tree["kind"] == "f32":
        mips = tree.get("mips")
        return CombinedAtlas(pages=pages, material_page=material_page,
                             mips=None if mips is None else tuple(_f32(m, device) for m in mips))
    if tree["kind"] == "quad":
        taps = np.asarray(tree["taps"], np.float32)
        t = int(tree.get("tile", 1))
        if t > 1:  # tile-major rows back to row-major
            p, s = taps.shape[0], taps.shape[1]
            taps = taps.reshape(p, s // t, s // t, t, t, 48).transpose(0, 1, 3, 2, 4, 5).reshape(taps.shape)
        return QuadCombinedAtlas(taps=_f32(taps, device), pages=pages, material_page=material_page,
                                 mips_taps=opt("mips_taps"), mips_stack=opt("mips_stack"),
                                 num_levels=int(tree["num_levels"]))
    if tree["kind"] == "half":
        return HalfCombinedAtlas(words=_words(tree["words"], device), pages=pages, material_page=material_page,
                                 mips_words=_words(tree.get("mips_words"), device), mips_stack=opt("mips_stack"),
                                 num_levels=int(tree["num_levels"]))
    raise NotImplementedError(f"combined atlas kind {tree['kind']!r} is not ported")


def scene_from_numpy(tree: dict, *, device=DEFAULT_DEVICE) -> Scene:
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
        atlas=None if tree.get("atlas") is None else atlas_from_numpy(tree["atlas"], device=device),
        combined_atlas=(None if tree.get("combined_atlas") is None
                        else combined_atlas_from_numpy(tree["combined_atlas"], device=device)),
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
