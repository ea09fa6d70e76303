"""Wavefront OBJ/MTL loading — the counterpart of
``physically_based_renderer_tpu/models/obj_loader.py`` (``PBRApp::
LoadOBJModel``, ``PBRApp.cpp:1471-1639``, and tinyobjloader).

Geometry is parsed by the native C++ parser (``native/objparse.cpp``, built
by ``utils/native``) or, when the caller asks, by ``parse_obj_python``, which
gives the same arrays. MTL parsing, the material mapping and the generated
normals and tangents are NumPy, line for line as in the JAX package, so the
arrays are bit-equal to its; ``load_obj`` returns the port's ``Mesh`` on the
requested device.

Semantics, as the reference's:
  * vertex dedup on the (v, vt, vn) index triple (PBRApp.cpp:1572-1580);
  * negative (relative) indices; polygons fan-triangulated;
  * uv v-flip to the DirectX convention;
  * MTL → material: Kd diffuse, Ks FresnelR0, d opacity, Ke emissive, Tf
    transmission, roughness ``Pr`` or else ``1 − min(Ns/256, 1)``
    (PBRApp.cpp:1524), Pm metallic;
  * materials named ``<objname>::<mtlname>`` (PBRApp.cpp:1510-1512).
Missing normals are generated (area-weighted) and tangent frames computed
from the uvs, which the reference leaves out for OBJ models.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np

from ..device import DEFAULT_DEVICE
from ..utils.native import load_objparse
from .mesh import Mesh


@dataclasses.dataclass
class ObjData:
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32 (zeros where absent)
    uvs: np.ndarray  # (V, 2) f32
    tris: np.ndarray  # (T, 3) i32
    face_material: np.ndarray  # (T,) i32 (-1 = none)
    material_names: list[str]
    mtllibs: list[str]
    has_normals: bool
    has_uvs: bool


def parse_obj_native(path: str) -> ObjData:
    """Parse with the native library (built at first use; a failed build
    raises)."""
    lib = load_objparse()
    h = lib.obj_parse_file(os.fsencode(path))
    try:
        err = lib.obj_error(h).decode()
        if err:
            raise IOError(f"{path}: {err}")
        nv, nt = lib.obj_vertex_count(h), lib.obj_tri_count(h)
        pos = np.empty((nv, 3), np.float32)
        nrm = np.empty((nv, 3), np.float32)
        uv = np.empty((nv, 2), np.float32)
        tris = np.empty((nt, 3), np.int32)
        fmat = np.empty((nt,), np.int32)
        f32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa: E731
        i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
        if nv:
            lib.obj_copy_positions(h, f32(pos))
            lib.obj_copy_normals(h, f32(nrm))
            lib.obj_copy_uvs(h, f32(uv))
        if nt:
            lib.obj_copy_tris(h, i32(tris))
            lib.obj_copy_face_material(h, i32(fmat))
        mats = [lib.obj_material_name(h, i).decode() for i in range(lib.obj_material_count(h))]
        libs = [lib.obj_mtllib_name(h, i).decode() for i in range(lib.obj_mtllib_count(h))]
        return ObjData(pos, nrm, uv, tris, fmat, mats, libs, bool(lib.obj_has_normals(h)), bool(lib.obj_has_uvs(h)))
    finally:
        lib.obj_free(h)


def parse_obj_python(path: str) -> ObjData:
    """The parser in Python; output-identical to the native one."""
    vs: list[tuple] = []
    vts: list[tuple] = []
    vns: list[tuple] = []
    dedup: dict[tuple, int] = {}
    pos, nrm, uv = [], [], []
    tris, fmat = [], []
    mats: list[str] = []
    mat_idx: dict[str, int] = {}
    libs: list[str] = []
    cur = -1
    has_n = has_t = False

    def corner(tok: str) -> int:
        nonlocal has_n, has_t
        parts = tok.split("/")
        vi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        v = vi - 1 if vi > 0 else len(vs) + vi
        t = ti - 1 if ti > 0 else (len(vts) + ti if ti < 0 else -1)
        n = ni - 1 if ni > 0 else (len(vns) + ni if ni < 0 else -1)
        key = (v, t, n)
        if key in dedup:
            return dedup[key]
        idx = len(pos)
        dedup[key] = idx
        pos.append(vs[v])
        if 0 <= n < len(vns):
            nrm.append(vns[n])
            has_n = True
        else:
            nrm.append((0.0, 0.0, 0.0))
        if 0 <= t < len(vts):
            uv.append((vts[t][0], 1.0 - vts[t][1]))  # v-flip (DirectX)
            has_t = True
        else:
            uv.append((0.0, 0.0))
        return idx

    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            tok = s.split()
            if tok[0] == "v" and len(tok) >= 4:
                vs.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif tok[0] == "vt" and len(tok) >= 3:
                vts.append((float(tok[1]), float(tok[2])))
            elif tok[0] == "vn" and len(tok) >= 4:
                vns.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif tok[0] == "f" and len(tok) >= 4:
                ids = [corner(t) for t in tok[1:]]
                for i in range(2, len(ids)):
                    tris.append((ids[0], ids[i - 1], ids[i]))
                    fmat.append(cur)
            elif tok[0] == "usemtl":
                name = s[6:].strip()
                if name not in mat_idx:
                    mat_idx[name] = len(mats)
                    mats.append(name)
                cur = mat_idx[name]
            elif tok[0] == "mtllib":
                libs.append(s[6:].strip())

    return ObjData(
        np.asarray(pos, np.float32).reshape(-1, 3),
        np.asarray(nrm, np.float32).reshape(-1, 3),
        np.asarray(uv, np.float32).reshape(-1, 2),
        np.asarray(tris, np.int32).reshape(-1, 3),
        np.asarray(fmat, np.int32),
        mats,
        libs,
        has_n,
        has_t,
    )


def parse_obj(path: str, prefer_native: bool = True) -> ObjData:
    """The native parser, or the Python one when ``prefer_native`` is False."""
    return parse_obj_native(path) if prefer_native else parse_obj_python(path)


def parse_mtl(path: str) -> dict[str, dict]:
    """MTL file → {material name: property dict} (Kd/Ks/Ns/d/Ke/Tf/map_*);
    a missing file has no materials."""
    mats: dict[str, dict] = {}
    cur: dict | None = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            tok = s.split()
            key = tok[0]
            if key == "newmtl":
                cur = {}
                mats[s[6:].strip()] = cur
            elif cur is None:
                continue
            elif key in ("Kd", "Ks", "Ka", "Ke", "Tf") and len(tok) >= 4:
                cur[key] = (float(tok[1]), float(tok[2]), float(tok[3]))
            elif key in ("Ns", "d", "Ni", "Pm", "Pr", "Ps", "Pc", "Pcr", "aniso", "anisor"):
                cur[key] = float(tok[1])
            elif key == "illum":
                cur[key] = int(tok[1])
            elif key.startswith("map_") or key in ("bump", "disp", "norm"):
                cur[key] = tok[-1]
    return mats


def material_kwargs_from_mtl(props: dict) -> dict:
    """MTL properties → ``MaterialBuilder.add`` kwargs (PBRApp.cpp:1515-1530,
    plus the PBR extension keys Pm/Pr that tinyobjloader also reads)."""
    kw: dict = {}
    if "Kd" in props:
        kw["diffuse"] = props["Kd"]
    if "Ks" in props:
        kw["fresnel_r0"] = props["Ks"]
    if "Ke" in props:
        kw["emissive"] = props["Ke"]
    if "Tf" in props:
        kw["transmission"] = props["Tf"]
    if "d" in props:
        kw["opacity"] = props["d"]
    if "Pr" in props:  # the PBR extension's roughness wins over shininess
        kw["roughness"] = props["Pr"]
    elif "Ns" in props:
        kw["roughness"] = 1.0 - min(props["Ns"] / 256.0, 1.0)  # PBRApp.cpp:1524
    if "Pm" in props:
        kw["metallic"] = props["Pm"]
    if "Ps" in props:
        kw["sheen"] = props["Ps"]
    if "Pc" in props:
        kw["clearcoat_thickness"] = props["Pc"]
    if "Pcr" in props:
        kw["clearcoat_roughness"] = props["Pcr"]
    if "aniso" in props:
        kw["anisotropy"] = props["aniso"]
    if "anisor" in props:
        kw["anisotropy_rotation"] = props["anisor"]
    return kw


def compute_vertex_normals(positions: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (for OBJs without vn)."""
    p = positions
    fn = np.cross(p[tris[:, 1]] - p[tris[:, 0]], p[tris[:, 2]] - p[tris[:, 0]])
    out = np.zeros_like(p)
    for c in range(3):
        np.add.at(out, tris[:, c], fn)
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norms, 1e-20)).astype(np.float32)


def compute_tangents(positions: np.ndarray, normals: np.ndarray, uvs: np.ndarray, tris: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Per-vertex tangent and bitangent from the uv derivatives (Lengyel),
    Gram-Schmidt against the normal."""
    p, t = positions, tris
    e1 = p[t[:, 1]] - p[t[:, 0]]
    e2 = p[t[:, 2]] - p[t[:, 0]]
    du1 = uvs[t[:, 1]] - uvs[t[:, 0]]
    du2 = uvs[t[:, 2]] - uvs[t[:, 0]]
    det = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)[:, None]
    ftan = (e1 * du2[:, 1:2] - e2 * du1[:, 1:2]) * r
    acc = np.zeros_like(p)
    for c in range(3):
        np.add.at(acc, t[:, c], ftan)
    ndott = np.sum(acc * normals, axis=1, keepdims=True)
    tan = acc - normals * ndott
    ln = np.linalg.norm(tan, axis=1, keepdims=True)
    fallback = np.cross(normals, np.asarray([0.0, 0.0, 1.0], np.float32))
    fb_ln = np.linalg.norm(fallback, axis=1, keepdims=True)
    fallback = np.where(fb_ln > 1e-6, fallback / np.maximum(fb_ln, 1e-20), np.asarray([1.0, 0.0, 0.0], np.float32))
    tan = np.where(ln > 1e-8, tan / np.maximum(ln, 1e-20), fallback)
    bit = np.cross(normals, tan)
    return tan.astype(np.float32), bit.astype(np.float32)


# MTL map keys → material texture slots (the JAX package's mapping)
MTL_SLOTS = {
    "map_Kd": "diffuse",
    "map_Ks": "specular",
    "map_Pm": "metallic",
    "map_Pr": "roughness",
    "map_bump": "normal",
    "norm": "normal",
    "bump": "bump",
    "map_d": "opacity",
    "map_Ke": "emissive",
    "disp": "displacement",
}


@dataclasses.dataclass
class LoadedObj:
    mesh: Mesh
    face_material: np.ndarray  # (T,) i32, local material index (faces without usemtl: 0)
    material_names: list[str]  # "<obj>::<mtl>"
    material_kwargs: list[dict]  # MaterialBuilder.add kwargs per local material
    material_textures: list[dict]  # slot → absolute texture path


def load_obj(path: str, prefer_native: bool = True, *, device=DEFAULT_DEVICE) -> LoadedObj:
    """An OBJ and its MTLs → the port's ``Mesh`` on ``device`` and the
    material specs."""
    data = parse_obj(path, prefer_native=prefer_native)
    base = os.path.dirname(os.path.abspath(path))
    obj_name = os.path.splitext(os.path.basename(path))[0]

    mtl_props: dict[str, dict] = {}
    for libname in data.mtllibs:
        mtl_props.update(parse_mtl(os.path.join(base, libname)))

    normals = data.normals
    if not data.has_normals or np.linalg.norm(normals, axis=1).min() < 1e-8:
        normals = compute_vertex_normals(data.positions, data.tris)
    else:
        ln = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = np.where(ln > 1e-8, normals / np.maximum(ln, 1e-20), normals)
    uvs = data.uvs if data.has_uvs else data.uvs * 0
    tangents, bitangents = compute_tangents(data.positions, normals, uvs, data.tris)
    mesh = Mesh.from_numpy(data.positions, normals, tangents, bitangents, data.uvs, data.tris, device=device)

    names, kwargs_list, tex_list = [], [], []
    for name in data.material_names:
        props = mtl_props.get(name, {})
        names.append(f"{obj_name}::{name}")
        kwargs_list.append(material_kwargs_from_mtl(props))
        tex_list.append({slot: os.path.join(base, props[key]) for key, slot in MTL_SLOTS.items() if key in props})
    fmat = np.maximum(data.face_material, 0)  # faces without usemtl → material 0
    return LoadedObj(mesh, fmat, names, kwargs_list, tex_list)
