"""A configuration's scene, built twice from its file and the seed: once
through the program's own entry points, once for the reference.

A configuration names one of the program's scene constructors (``scene``)
and describes the same scene as data: the spheres, their materials and the
texture slot each binds, the lights, the environment. The texture pages
(and the environment and sky, where there is one) are made from the seed
on the device; the program receives them as decoded pages through its
asset cache, as a user's decoded files would arrive."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import seeded
from .reference import render as ref

SRGB_SLOTS = ("diffuse", "specular")


def page_keys(cfg: dict) -> list[str]:
    """The "set/slot" keys of every page the materials bind, in the order the
    materials and their slots name them (the asset cache's page order)."""
    keys: list[str] = []
    for mat in cfg["materials"]:
        for key in mat.get("textures", {}).values():
            if key not in keys:
                keys.append(key)
    return keys


@dataclasses.dataclass(frozen=True)
class Inputs:
    """What the seed makes for one configuration, on the device."""

    keys: list
    pages: torch.Tensor  # (N, S, S, 3) uint8
    env: torch.Tensor | None
    sky: torch.Tensor | None


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    keys = page_keys(cfg)
    pages = seeded.texture_pages(seed, [k.split("/")[1] for k in keys], cfg["texture_size"], device)
    env = sky = None
    if cfg.get("environment"):
        env = seeded.environment(seed, *cfg["environment"]["env"], device)
        sky = seeded.sky_u8(seed, *cfg["environment"]["sky"], device)
    return Inputs(keys=keys, pages=pages, env=env, sky=sky)


def program_scene(port, cfg: dict, inputs: Inputs, device):
    """The program's scene: its asset cache filled with the seeded pages, its
    scene constructor, the environment and its IBL maps, the combined
    pages. Raises if the program's mip rule disagrees with the configuration."""
    cache = port.scenes.AssetCache(texture_size=cfg["texture_size"])
    host_pages = inputs.pages.cpu().numpy()
    for i, key in enumerate(inputs.keys):
        cache._page_index[key] = len(cache.pages)
        cache.pages.append(host_pages[i])
        cache.srgb.append(key.split("/")[1] in SRGB_SLOTS)
    build = getattr(port.scenes, cfg["scene"])
    scene = build(cache, texture_size=cfg["texture_size"], device=device)
    if inputs.env is not None:
        scene = dataclasses.replace(scene, env_map=inputs.env, sky_map=inputs.sky).with_ibl()
    scene = scene.with_combined_textures(mode=cfg["combined_textures"])
    if port.renderer.default_mip_lod(scene) != cfg["mip_lod"]:
        raise ValueError(f"{cfg['name']}: the program's mip_lod rule gives {not cfg['mip_lod']}, "
                         f"the configuration states {cfg['mip_lod']}")
    return scene


def reference_scene(cfg: dict, inputs: Inputs, device, tf32: bool = False) -> ref.RefScene:
    """The reference's scene from the same description and inputs."""
    sph = cfg["sphere"]
    if sph["radius"] != 1.0:
        raise ValueError("the reference builds unit spheres")
    spheres = np.asarray(cfg["spheres"], np.float64)
    corners, face_mat = ref.corner_attrs(sph["slices"], sph["stacks"], spheres[:, :3],
                                         spheres[:, 3].astype(np.int64), device, tf32=tf32)
    mats = cfg["materials"]
    m = len(mats)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    tex_index = np.zeros((m, len(ref.SLOTS)), np.int64)
    has = np.zeros((m, len(ref.SLOTS)), np.float32)
    for i, mat in enumerate(mats):
        for slot, key in mat.get("textures", {}).items():
            tex_index[i, ref.SLOT[slot]] = inputs.keys.index(key)
            has[i, ref.SLOT[slot]] = 1.0
    bank = dict(
        diffuse=f32([mt["diffuse"] for mt in mats]),
        metallic=f32([mt["metallic"] for mt in mats]),
        fresnel_r0=f32([mt.get("fresnel_r0", [0.04, 0.04, 0.04]) for mt in mats]),
        roughness=f32([mt["roughness"] for mt in mats]),
        opacity=f32([mt.get("opacity", 1.0) for mt in mats]),
        height_scale=f32([mt.get("height_scale", 1.0) for mt in mats]),
        uv_transform=f32([mt.get("uv_transform", [[1, 0], [0, 1], [0, 0]]) for mt in mats]),
        has_tex=f32(has),
    )
    # The combined pages hold one page a textured material, each slot's
    # texels times its binding; a material that binds no slot reads the
    # first textured material's page (its value is masked by has_tex = 0,
    # but the gradient of has_tex sees it).
    textured = [i for i in range(m) if has[i].any()]
    page_of = np.asarray([i if has[i].any() else (textured[0] if textured else i) for i in range(m)])
    tex_index, built = tex_index[page_of], has[page_of]
    lights = cfg["lights"]["directional"]
    ibl = ref.IBL.build(inputs.env, tf32=tf32) if inputs.env is not None else None
    return ref.RefScene(
        corners=corners, face_material=face_mat, bank=bank,
        tex_index=torch.as_tensor(tex_index, device=device), has_built=f32(built),
        pages=ref.Pages.build(inputs.pages, [k.split("/")[1] in SRGB_SLOTS for k in inputs.keys]),
        lights=dict(strength=f32([lt["strength"] for lt in lights]), direction=f32([lt["direction"] for lt in lights])),
        ambient=f32(cfg["ambient"]), clear_color=f32(cfg["clear_color"]), mip_lod=cfg["mip_lod"],
        sky_u8=inputs.sky, ibl=ibl,
    )
