"""Built-in scenes — the counterpart of
``physically_based_renderer_tpu/scenes.py`` (``PBRApp.cpp:504-1094``): the
analytic sphere, the 7×7 red sweep, the 58-sphere PBR.png scene (9 textured
spheres in a row above the sweep), the single rustediron sphere of
``Samples/rusted_iron_pbr.png``, and OBJ models with their MTL materials and
texture maps (``obj_scene``, ``mori_knob_scene``: ``PBRApp::LoadOBJModel``).

Textures come through an :class:`AssetCache`: atlas pages by (texture set,
slot) or by OBJ texture file, decoded once on the host
(``utils/image_io.load_image``: PNG, JPEG, BMP, DDS, GIF, TIFF, TGA and
WebP, no imaging package) and packed into one :class:`~ops.texture.TextureAtlas`. A
cache may also be filled with decoded pages by its caller (``pages``,
``srgb``, ``_page_index``). With no page for a slot the slot stays unbound,
and a scene without any page renders untextured, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .device import DEFAULT_DEVICE
from .models.material import MaterialBuilder
from .models.mesh import sphere_mesh
from .models.scene import InstancedDraw, Scene, default_clear_color, translation_world
from .ops.brdf import Lights
from .ops.texture import build_atlas
from .utils.image_io import find_asset_root, load_hdr, load_image

AMBIENT = (0.03, 0.03, 0.03)  # PBRApp.cpp:478

# Texture-set directories and file stems (PBRApp::LoadTextures,
# PBRApp.cpp:1196-1467): set name → (dir, stem, size tag).
TEXTURE_SETS = {
    "rusted_iron": ("rustediron", "rustediron2_{}", None),
    "rock_copper": ("rockcopper", "copper-rock1-{}", None),
    "brick_modern": ("Brick_Modern_1K", "semlcibb_8K_{}", None),
    "concrete_dirty": ("Concrete_Dirty_1K", "rm4kshp_4K_{}", None),
    "concrete_rough": ("Concrete_Rough_1K", "sdbhdd3b_8K_{}", None),
    "grass_wild": ("Grass_Wild_1K", "sfknaeoa_8K_{}", None),
    "metal_bare": ("Metal_Bare_1K", "se2abbvc_8K_{}", None),
    "soil_mud": ("Soil_Mud_1K", "sghjcnyo_8K_{}", None),
    "stone_wall": ("Stone_Wall_1K", "sdambcec_8K_{}", None),
}

# slot name → filename tokens to try
SLOT_FILE_TOKENS = {
    "diffuse": ("Albedo", "basecolor", "albedo"),
    "specular": ("Specular", "specular"),
    "metallic": ("Metalness", "metallic", "Metallic"),
    "roughness": ("Roughness", "roughness"),
    "normal": ("Normal", "normal"),
    "displacement": ("Displacement",),
}

SRGB_SLOTS = {"diffuse", "specular"}

ENVIRONMENTS = {
    "chelsea_stairs": ("Chelsea_Stairs", "Chelsea_Stairs_Env.hdr"),
    "papermill": ("PaperMill_Ruins_E", "PaperMill_E_Env.hdr"),
    "subway_lights": ("Subway_Lights", "20_Subway_Lights_Env.hdr"),
}


def _find_texture_file(root: str, set_name: str, slot: str) -> str | None:
    dirname, _stem, _ = TEXTURE_SETS[set_name]
    d = os.path.join(root, dirname)
    if not os.path.isdir(d):
        return None
    files = os.listdir(d)
    for token in SLOT_FILE_TOKENS.get(slot, ()):
        for f in files:
            if token.lower() in f.lower() and f.lower().endswith((".jpg", ".png", ".jpeg")):
                return os.path.join(d, f)
    return None


class AssetCache:
    """Atlas pages by (texture set, slot) or OBJ texture file, and the
    environments, once per process. ``pages`` are decoded images (H, W, C)
    uint8 or float, ``srgb`` their decode flags, ``_page_index`` maps
    "set/slot" or "obj:<path>" to a page."""

    def __init__(self, asset_root: str | None = None, texture_size: int = 512):
        self.root = asset_root or find_asset_root()
        self.texture_size = texture_size
        self.pages: list[np.ndarray] = []
        self.srgb: list[bool] = []
        self._page_index: dict[str, int] = {}

    def page(self, set_name: str, slot: str) -> int | None:
        """The atlas page of (texture set, slot), decoded at first use; None
        when the set has no file for the slot (the slot stays unbound)."""
        key = f"{set_name}/{slot}"
        if key in self._page_index:
            return self._page_index[key]
        if self.root is None:
            return None
        path = _find_texture_file(self.root, set_name, slot)
        if path is None:
            return None
        return self._add_page(key, path, slot in SRGB_SLOTS)

    def file_page(self, path: str, srgb: bool) -> int:
        """The atlas page of a texture file (an OBJ's maps), keyed
        ``obj:<path>``, decoded at first use."""
        key = f"obj:{path}"
        if key in self._page_index:
            return self._page_index[key]
        return self._add_page(key, path, srgb)

    def _add_page(self, key: str, path: str, srgb: bool) -> int:
        self._page_index[key] = len(self.pages)
        self.pages.append(load_image(path))
        self.srgb.append(srgb)
        return self._page_index[key]

    def build_atlas(self, *, device=DEFAULT_DEVICE):
        if not self.pages:
            return None
        return build_atlas(self.pages, self.srgb, size=self.texture_size, device=device)

    def load_environment(self, name: str, *, device=DEFAULT_DEVICE) -> torch.Tensor:
        dirname, filename = ENVIRONMENTS[name]
        return torch.as_tensor(load_hdr(os.path.join(self.root, dirname, filename)), device=device)

    def load_sky_background(self, name: str, *, device=DEFAULT_DEVICE) -> torch.Tensor | None:
        """The visible-sky map: the sIBL set's LDR background (what the
        reference samples for g_SkyArray[0], PBRApp.cpp:1199-1208) as (H, W,
        3) uint8 texels (``ops/texture.sky_u8``, the port's form of the JAX
        package's u8 quad words: bit-exact against an 8-bit file). None when
        the set has no descriptor or no LDR background."""
        from .models.sibl import find_ibl, parse_ibl
        from .ops.texture import sky_u8

        dirname, _ = ENVIRONMENTS[name]
        path = find_ibl(os.path.join(self.root, dirname))
        if path is None:
            return None
        bg = parse_ibl(path).load_background()
        return None if bg is None else sky_u8(bg).to(device)

    def load_sibl(self, name: str):
        """The environment's parsed sIBL descriptor (``models/sibl``)."""
        from .models.sibl import find_ibl, parse_ibl

        dirname, _ = ENVIRONMENTS[name]
        path = find_ibl(os.path.join(self.root, dirname))
        if path is None:
            raise FileNotFoundError(f"no .ibl descriptor in {dirname}")
        return parse_ibl(path)

    def sibl_lights(self, name: str, *, device=DEFAULT_DEVICE):
        """Directional lights from the descriptor's [Sun]/[LightN] hotspots."""
        from .models.sibl import sibl_scene_lights

        return sibl_scene_lights(self.load_sibl(name), device=device)


def analytic_sphere_scene(
    albedo=(1.0, 0.0, 0.0),
    roughness=0.5,
    metallic=0.5,
    slices: int = 64,
    stacks: int = 32,
    lights: Lights | None = None,
    *,
    device=DEFAULT_DEVICE,
) -> Scene:
    """One constant-material sphere under the default 4 directional lights."""
    mb = MaterialBuilder()
    mb.add("sphere", diffuse=albedo, roughness=roughness, metallic=metallic)
    return Scene(
        draws=(
            InstancedDraw.create(
                sphere_mesh(1.0, slices, stacks, device=device), np.eye(4, dtype=np.float32), [0]
            ),
        ),
        materials=mb.build(device=device),
        lights=lights if lights is not None else Lights.default_scene_lights(device=device),
        ambient=torch.tensor(AMBIENT, dtype=torch.float32, device=device),
        clear_color=default_clear_color(device),
    )


def _add_red_sweep(mb: MaterialBuilder, worlds: list, mids: list) -> None:
    """The 7×7 red sweep: roughness (i%7)/6, metallic 1−(i//7)/6, F0 0.04,
    positions from the 'hacky translation' at PBRApp.cpp:1016-1024."""
    for i in range(49):
        mids.append(mb.add(f"sphere_red_{i}", diffuse=(1.0, 0.0, 0.0), roughness=(i % 7) / 6.0,
                           metallic=1.0 - (i // 7) / 6.0))
        worlds.append(translation_world((i % 7) * 2.5 - 3 * 2.5, (i // 7) * -2.5 - 2.5, 0.0))


def red_sphere_grid_scene(slices: int = 64, stacks: int = 32, *, device=DEFAULT_DEVICE) -> Scene:
    """The 7×7 analytic red-sphere sweep."""
    mb = MaterialBuilder()
    worlds, mids = [], []
    _add_red_sweep(mb, worlds, mids)
    mesh = sphere_mesh(1.0, slices, stacks, device=device)
    return Scene(
        draws=(InstancedDraw.create(mesh, np.stack(worlds), mids),),
        materials=mb.build(device=device),
        lights=Lights.default_scene_lights(device=device),
        ambient=torch.tensor(AMBIENT, dtype=torch.float32, device=device),
        clear_color=default_clear_color(device),
    )


# The textured row of the PBR scene: material name → (texture set, bound
# slots, x position) — PBRApp.cpp:892-974, 1026-1068.
TEXTURED_SPHERES = {
    "sphere_rust": ("rusted_iron", ("diffuse", "metallic", "roughness", "normal"), 0.0),
    "sphere_rock_copper": ("rock_copper", ("diffuse", "metallic", "roughness", "normal"), -2.5),
    "sphere_brick_modern": ("brick_modern", ("diffuse", "specular", "roughness", "normal"), -5.0),
    "sphere_concrete_dirty": ("concrete_dirty", ("diffuse", "specular", "roughness", "normal"), -7.5),
    "sphere_concrete_rough": ("concrete_rough", ("diffuse", "specular", "roughness", "normal"), -10.0),
    "sphere_grass_wild": ("grass_wild", ("diffuse", "specular", "roughness", "normal"), 2.5),
    "sphere_metal_bare": ("metal_bare", ("diffuse", "specular", "metallic", "roughness", "normal"), 5.0),
    "sphere_soil_mud": ("soil_mud", ("diffuse", "specular", "roughness", "normal"), 7.5),
    "sphere_stone_wall": ("stone_wall", ("diffuse", "specular", "roughness", "normal"), 10.0),
}
RUSTEDIRON_SLOTS = ("diffuse", "metallic", "roughness", "normal")


def pbr_scene(
    assets: AssetCache | None = None,
    texture_size: int = 512,
    slices: int = 64,
    stacks: int = 32,
    environment: str | None = None,
    *,
    device=DEFAULT_DEVICE,
) -> Scene:
    """The 58-sphere PBR.png scene: 9 textured spheres in a row at y = 0 and
    the 7×7 red sweep below (PBRApp.cpp:892-1094). Slots without a page stay
    unbound (a row without pages renders analytic)."""
    assets = assets or AssetCache(texture_size=texture_size)
    mb = MaterialBuilder()
    worlds, mids = [], []
    for name, (set_name, slots, x) in TEXTURED_SPHERES.items():
        textures = {}
        for slot in slots:
            page = assets.page(set_name, slot)
            if page is not None:
                textures[slot] = page
        mids.append(mb.add(name, diffuse=(1.0, 1.0, 1.0), roughness=0.5, metallic=0.0, textures=textures))
        worlds.append(translation_world(x, 0.0, 0.0))
    _add_red_sweep(mb, worlds, mids)
    mesh = sphere_mesh(1.0, slices, stacks, device=device)
    return Scene(
        draws=(InstancedDraw.create(mesh, np.stack(worlds), mids),),
        materials=mb.build(device=device),
        atlas=assets.build_atlas(device=device),
        lights=Lights.default_scene_lights(device=device),
        ambient=torch.tensor(AMBIENT, dtype=torch.float32, device=device),
        clear_color=default_clear_color(device),
        env_map=assets.load_environment(environment, device=device) if environment else None,
        sky_map=assets.load_sky_background(environment, device=device) if environment else None,
    )


def rustediron_sphere_scene(
    assets: AssetCache | None = None,
    texture_size: int = 512,
    environment: str | None = None,
    *,
    device=DEFAULT_DEVICE,
) -> Scene:
    """One textured sphere with the rustediron metallic-roughness and normal
    maps (``Samples/rusted_iron_pbr.png``)."""
    assets = assets or AssetCache(texture_size=texture_size)
    mb = MaterialBuilder()
    textures = {}
    for slot in RUSTEDIRON_SLOTS:
        page = assets.page("rusted_iron", slot)
        if page is not None:
            textures[slot] = page
    mb.add("sphere_rust", textures=textures)
    return Scene(
        draws=(InstancedDraw.create(sphere_mesh(1.0, 64, 32, device=device), np.eye(4, dtype=np.float32), [0]),),
        materials=mb.build(device=device),
        atlas=assets.build_atlas(device=device),
        lights=Lights.default_scene_lights(device=device),
        ambient=torch.tensor(AMBIENT, dtype=torch.float32, device=device),
        clear_color=default_clear_color(device),
        env_map=assets.load_environment(environment, device=device) if environment else None,
        sky_map=assets.load_sky_background(environment, device=device) if environment else None,
    )


def obj_scene(
    path: str,
    assets: AssetCache | None = None,
    texture_size: int = 512,
    world=None,
    environment: str | None = None,
    lights: Lights | None = None,
    prefer_native: bool = True,
    *,
    device=DEFAULT_DEVICE,
) -> Scene:
    """An OBJ model with its MTL materials and texture maps as a scene (the
    reference's LoadOBJModel path, PBRApp.cpp:1471-1639): one draw with
    per-face materials; each map the MTL names and the disk holds becomes an
    atlas page keyed ``obj:<path>`` (sRGB for the diffuse and specular
    slots)."""
    from .models.obj_loader import load_obj

    loaded = load_obj(path, prefer_native=prefer_native, device=device)
    assets = assets or AssetCache(texture_size=texture_size)
    mb = MaterialBuilder()
    local_to_global = []
    if not loaded.material_names:
        local_to_global.append(mb.add("obj::default"))
    for name, kwargs, textures in zip(loaded.material_names, loaded.material_kwargs, loaded.material_textures):
        pages = {slot: assets.file_page(tex_path, slot in SRGB_SLOTS)
                 for slot, tex_path in textures.items() if os.path.exists(tex_path)}
        local_to_global.append(mb.add(name, textures=pages, **kwargs))
    face_mat = np.asarray(local_to_global, np.int32)[loaded.face_material]
    if world is None:
        world = np.eye(4, dtype=np.float32)
    return Scene(
        draws=(InstancedDraw.create(loaded.mesh, world, [local_to_global[0]], face_materials=face_mat),),
        materials=mb.build(device=device),
        atlas=assets.build_atlas(device=device),
        lights=lights if lights is not None else Lights.default_scene_lights(device=device),
        ambient=torch.tensor(AMBIENT, dtype=torch.float32, device=device),
        clear_color=default_clear_color(device),
        env_map=assets.load_environment(environment, device=device) if environment else None,
        sky_map=assets.load_sky_background(environment, device=device) if environment else None,
    )


def mori_knob_scene(
    assets: AssetCache | None = None,
    texture_size: int = 512,
    environment: str | None = None,
    world=None,
    *,
    device=DEFAULT_DEVICE,
) -> Scene:
    """BASELINE config 4: the mori_knob test model (6,091 vertices, 11,970
    triangles, 5 materials — ``Assets/mori_knob/testObj.obj``)."""
    assets = assets or AssetCache(texture_size=texture_size)
    if assets.root is None:
        raise FileNotFoundError("mori_knob_scene needs the reference asset tree (find_asset_root found none)")
    path = os.path.join(assets.root, "mori_knob", "testObj.obj")
    return obj_scene(path, assets=assets, texture_size=texture_size, world=world, environment=environment,
                     device=device)
