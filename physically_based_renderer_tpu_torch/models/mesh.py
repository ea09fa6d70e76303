"""Triangle meshes and their procedural generators — the counterpart of
``physically_based_renderer_tpu/models/mesh.py``.

Every generator builds in NumPy, as the JAX package does, then moves the
arrays to ``device``: the UV sphere with the reference's exact vertex
order, winding and UV parametrisation (``Mesh.h:473-591``), the quad, grid
and box of the reference's commented generators (``Mesh.h:155-471``), and
the geosphere, cylinder and capsule its stubs name (``Mesh.h:594-610``).
``subdivide`` and ``merge_meshes`` work on the arrays of the meshes they
are given and keep their device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Triangle mesh, structure of arrays. Per-vertex arrays share dim 0."""

    positions: torch.Tensor  # (V, 3) f32
    normals: torch.Tensor  # (V, 3) f32
    tangents: torch.Tensor  # (V, 3) f32, not normalised (Mesh.h:518-523)
    bitangents: torch.Tensor  # (V, 3) f32
    uvs: torch.Tensor  # (V, 2) f32
    tris: torch.Tensor  # (T, 3) int64

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tris.shape[0]

    @staticmethod
    def from_numpy(positions, normals, tangents, bitangents, uvs, tris, *, device=DEFAULT_DEVICE) -> "Mesh":
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
        return Mesh(
            positions=f(positions),
            normals=f(normals),
            tangents=f(tangents),
            bitangents=f(bitangents),
            uvs=f(uvs),
            tris=torch.as_tensor(np.asarray(tris, np.int64), device=device),
        )

    def to(self, device) -> "Mesh":
        return Mesh(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def _numpy(mesh: Mesh) -> tuple:
    """(positions, normals, tangents, bitangents, uvs, tris) as NumPy."""
    return tuple(getattr(mesh, f.name).detach().cpu().numpy() for f in dataclasses.fields(mesh))


def sphere_mesh(
    radius: float = 1.0, slices: int = 64, stacks: int = 32, *, device=DEFAULT_DEVICE
) -> Mesh:
    """UV sphere with the reference's exact topology: north pole, rings
    i=1..stacks-1 of slices+1 columns (seam duplicated), south pole.
    Position (r sinφ cosθ, r cosφ, r sinφ sinθ); normal = pos/r; tangent =
    ∂P/∂θ; bitangent = normal × tangent; UV = (θ/2π, φ/π)."""
    return Mesh.from_numpy(*_sphere_arrays(radius, slices, stacks), device=device)


def _sphere_arrays(radius: float, slices: int, stacks: int) -> tuple:
    if slices > 250 or stacks > 250:  # Mesh.h:489 parity
        raise ValueError("sphere_mesh: slices and stacks must be <= 250")

    ring_count = stacks - 1
    ring_verts = slices + 1
    nv = 2 + ring_count * ring_verts

    phi = (np.arange(1, stacks)[:, None]) * (math.pi / stacks)
    theta = (np.arange(ring_verts)[None, :]) * (2.0 * math.pi / slices)
    sp, cp = np.sin(phi), np.cos(phi)
    st, ct = np.sin(theta), np.cos(theta)

    pos = np.zeros((nv, 3), np.float32)
    nrm = np.zeros((nv, 3), np.float32)
    tan = np.zeros((nv, 3), np.float32)
    bit = np.zeros((nv, 3), np.float32)
    uv = np.zeros((nv, 2), np.float32)

    pos[0] = (0.0, radius, 0.0)
    nrm[0] = (0.0, 1.0, 0.0)
    tan[0] = (1.0, 0.0, 0.0)
    bit[0] = (0.0, 0.0, -1.0)
    pos[-1] = (0.0, -radius, 0.0)
    nrm[-1] = (0.0, -1.0, 0.0)
    tan[-1] = (1.0, 0.0, 0.0)
    bit[-1] = (0.0, 0.0, 1.0)
    uv[-1] = (0.0, 1.0)

    ring_pos = np.stack(
        [
            radius * sp * ct,
            np.broadcast_to(radius * cp, (ring_count, ring_verts)),
            radius * sp * st,
        ],
        axis=-1,
    ).reshape(-1, 3)
    ring_nrm = ring_pos / np.linalg.norm(ring_pos, axis=-1, keepdims=True)
    ring_tan = np.stack(
        [-radius * sp * st, np.zeros((ring_count, ring_verts)), radius * sp * ct], axis=-1
    ).reshape(-1, 3)
    ring_bit = np.cross(ring_nrm, ring_tan)
    ring_uv = np.stack(
        [
            np.broadcast_to(theta / (2.0 * math.pi), (ring_count, ring_verts)),
            np.broadcast_to(phi / math.pi, (ring_count, ring_verts)),
        ],
        axis=-1,
    ).reshape(-1, 2)

    pos[1:-1] = ring_pos
    nrm[1:-1] = ring_nrm
    tan[1:-1] = ring_tan
    bit[1:-1] = ring_bit
    uv[1:-1] = ring_uv

    # Indices: the order and winding of Mesh.h:534-565.
    tris = [(0, i + 1, i) for i in range(1, slices + 1)]  # top cap
    base = 1
    for i in range(stacks - 2):  # inner quads
        for j in range(slices):
            a = base + i * ring_verts + j
            b = a + 1
            c = base + (i + 1) * ring_verts + j
            d = c + 1
            tris.append((a, b, c))
            tris.append((c, b, d))
    south = nv - 1
    base = south - ring_verts
    tris += [(south, base + i, base + i + 1) for i in range(slices)]  # bottom cap

    return pos, nrm, tan, bit, uv, np.asarray(tris, np.int64)


def subdivide(mesh: Mesh) -> Mesh:
    """Midpoint 1→4 subdivision (``Mesh.h:80-152``: naive midpoints,
    attributes averaged, no vertex shared across split edges): six vertices
    a triangle, (v0, m01, v1, m12, v2, m20)."""
    p, n, t, b, u, tris = _numpy(mesh)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]

    def six(a):
        return np.stack([a[v0], 0.5 * (a[v0] + a[v1]), a[v1], 0.5 * (a[v1] + a[v2]), a[v2],
                         0.5 * (a[v2] + a[v0])], axis=1).reshape(-1, a.shape[-1])

    offs = (np.arange(tris.shape[0]) * 6)[:, None, None]
    local = np.asarray([[0, 1, 5], [1, 2, 3], [5, 3, 4], [1, 3, 5]], np.int64)  # indices into the six
    return Mesh.from_numpy(six(p), six(n), six(t), six(b), six(u), (offs + local[None]).reshape(-1, 3),
                           device=mesh.positions.device)


def quad_mesh(width: float = 1.0, depth: float = 1.0, *, device=DEFAULT_DEVICE) -> Mesh:
    """XZ-plane quad facing +y (the commented Quad generator, Mesh.h:155-200)."""
    hw, hd = width / 2.0, depth / 2.0
    pos = np.asarray([[-hw, 0, -hd], [hw, 0, -hd], [hw, 0, hd], [-hw, 0, hd]], np.float32)
    nrm = np.tile([0.0, 1.0, 0.0], (4, 1))
    tan = np.tile([1.0, 0.0, 0.0], (4, 1))
    bit = np.tile([0.0, 0.0, 1.0], (4, 1))
    uv = np.asarray([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    return Mesh.from_numpy(pos, nrm, tan, bit, uv, np.asarray([[0, 3, 1], [1, 3, 2]]), device=device)


def grid_mesh(width: float, depth: float, m: int, n: int, *, device=DEFAULT_DEVICE) -> Mesh:
    """m×n vertex grid in the XZ plane (the commented Grid generator,
    Mesh.h:203-320)."""
    xs = np.linspace(-width / 2, width / 2, n)
    zs = np.linspace(depth / 2, -depth / 2, m)
    zz, xx = np.meshgrid(zs, xs, indexing="ij")
    pos = np.stack([xx, np.zeros_like(xx), zz], axis=-1).reshape(-1, 3)
    nrm = np.tile([0.0, 1.0, 0.0], (m * n, 1))
    tan = np.tile([1.0, 0.0, 0.0], (m * n, 1))
    bit = np.tile([0.0, 0.0, 1.0], (m * n, 1))
    vv, uu = np.meshgrid(np.linspace(0, 1, m), np.linspace(0, 1, n), indexing="ij")
    uv = np.stack([uu, vv], axis=-1).reshape(-1, 2)
    a = (np.arange(m - 1)[:, None] * n + np.arange(n - 1)[None, :]).reshape(-1, 1)
    tris = np.concatenate([a, a + 1, a + n, a + n, a + 1, a + n + 1], axis=1).reshape(-1, 3)
    return Mesh.from_numpy(pos, nrm, tan, bit, uv, tris, device=device)


def box_mesh(width: float = 1.0, height: float = 1.0, depth: float = 1.0, *, device=DEFAULT_DEVICE) -> Mesh:
    """Axis-aligned box, 24 vertices and 12 triangles (the commented Box
    generator, Mesh.h:323-471): per-face normals and tangents, clockwise
    front faces seen from outside, uv (0, 0) at a face's top left."""
    ext = np.asarray([width / 2, height / 2, depth / 2], np.float32)
    faces = [  # (normal, tangent)
        ((0, 0, -1), (1, 0, 0)),  # front (−z)
        ((0, 0, 1), (-1, 0, 0)),  # back (+z)
        ((0, 1, 0), (1, 0, 0)),  # top
        ((0, -1, 0), (-1, 0, 0)),  # bottom
        ((-1, 0, 0), (0, 0, -1)),  # left
        ((1, 0, 0), (0, 0, 1)),  # right
    ]
    pos, nrm, tan, bit, tris = [], [], [], [], []
    for fi, (n, t) in enumerate(faces):
        n, t = np.asarray(n, np.float32), np.asarray(t, np.float32)
        b = np.cross(n, t)
        c, tt, bb = n * ext, t * ext, b * ext
        pos += [c - tt + bb, c + tt + bb, c + tt - bb, c - tt - bb]
        nrm += [n] * 4
        tan += [t] * 4
        bit += [b] * 4
        base = fi * 4
        tris += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    uv = [(0, 0), (1, 0), (1, 1), (0, 1)] * len(faces)
    return Mesh.from_numpy(np.asarray(pos), np.asarray(nrm), np.asarray(tan), np.asarray(bit), np.asarray(uv),
                           np.asarray(tris), device=device)


def geosphere_mesh(radius: float = 1.0, subdivisions: int = 3, *, device=DEFAULT_DEVICE) -> Mesh:
    """Icosahedron-subdivision sphere — the reference's ``GeosphereMesh``
    stub (Mesh.h:594-598) implemented as the JAX package does: even triangle
    areas (no pole slivers), midpoints shared along each edge, UV the
    equirect of the normal, faces wound as the UV sphere's."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
        np.float32,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
         [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5],
         [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        np.int64,
    )
    for _ in range(subdivisions):
        edge_mid: dict[tuple, int] = {}
        vlist = list(verts)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                edge_mid[key] = len(vlist)
                vlist.append(m / np.linalg.norm(m))
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        verts = np.asarray(vlist, np.float32)
        faces = np.asarray(new_faces, np.int64)

    nrm = verts.copy()
    theta = np.arctan2(nrm[:, 2], nrm[:, 0]) % (2 * math.pi)
    phi = np.arccos(np.clip(nrm[:, 1], -1, 1))
    uv = np.stack([theta / (2 * math.pi), phi / math.pi], axis=-1)
    tan = np.stack([-np.sin(theta), np.zeros_like(theta), np.cos(theta)], axis=-1)
    bit = np.cross(nrm, tan)
    # outward faces clockwise from outside, as the UV sphere's
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    outward = np.einsum("ij,ij->i", np.cross(b - a, c - a), a + b + c) < 0
    faces = np.where(outward[:, None], faces, faces[:, [0, 2, 1]])
    return Mesh.from_numpy(verts * radius, nrm, tan, bit, uv, faces, device=device)


def cylinder_mesh(bottom_radius: float = 0.5, top_radius: float = 0.5, height: float = 1.0, slices: int = 32,
                  stacks: int = 4, *, device=DEFAULT_DEVICE) -> Mesh:
    """Capped cylinder or cone — the ``CylinderMesh`` stub (Mesh.h:600-604)
    implemented with Frank Luna's parametrisation, as the JAX package: rings
    of slices+1 vertices bottom to top, then the top cap's ring and centre,
    then the bottom cap's."""
    verts, tris = [], []
    dh = height / stacks
    dr = (top_radius - bottom_radius) / stacks
    ring_verts = slices + 1
    for i in range(stacks + 1):
        y = -height / 2 + i * dh
        r = bottom_radius + i * dr
        for j in range(ring_verts):
            th = j * 2 * math.pi / slices
            c, s = math.cos(th), math.sin(th)
            tan = (-s, 0.0, c)
            bit = np.asarray((dr * c, -height, dr * s))
            n = np.cross(tan, bit)
            verts.append(((r * c, y, r * s), tuple(n / np.linalg.norm(n)), tan, tuple(bit / np.linalg.norm(bit)),
                          (j / slices, 1 - i / stacks)))
    for i in range(stacks):
        for j in range(slices):
            a = i * ring_verts + j
            b = (i + 1) * ring_verts + j
            tris += [(a, b, a + 1), (a + 1, b, b + 1)]
    for top in (True, False):  # the caps
        y = height / 2 if top else -height / 2
        r = top_radius if top else bottom_radius
        n = (0.0, 1.0 if top else -1.0, 0.0)
        bit = (0, 0, 1 if top else -1)
        base = len(verts)
        center = base + ring_verts
        for j in range(ring_verts):
            th = j * 2 * math.pi / slices
            c, s = math.cos(th), math.sin(th)
            verts.append(((r * c, y, r * s), n, (1, 0, 0), bit, (c / 2 + 0.5, s / 2 + 0.5)))
        verts.append(((0.0, y, 0.0), n, (1, 0, 0), bit, (0.5, 0.5)))
        tris += [(center, base + j, base + j + 1) if top else (center, base + j + 1, base + j)
                 for j in range(slices)]
    cols = [np.asarray([v[k] for v in verts], np.float32) for k in range(5)]
    return Mesh.from_numpy(*cols, np.asarray(tris), device=device)


def capsule_mesh(radius: float = 0.5, height: float = 1.0, slices: int = 24, stacks: int = 12, *,
                 device=DEFAULT_DEVICE) -> Mesh:
    """Capsule — the ``CapsuleMesh`` stub (Mesh.h:606-610) implemented as
    the JAX package does: a UV sphere whose two hemispheres move apart by
    ``height`` along y (attributes and topology the sphere's)."""
    pos, nrm, tan, bit, uv, tris = _sphere_arrays(radius, slices, max(2, stacks))
    off = height / 2.0
    pos[:, 1] = np.where(pos[:, 1] >= 0, pos[:, 1] + off, pos[:, 1] - off)
    return Mesh.from_numpy(pos, nrm, tan, bit, uv, tris, device=device)


def merge_meshes(meshes: list[Mesh]) -> tuple[Mesh, np.ndarray]:
    """Concatenate meshes into one on the first mesh's device → (merged
    mesh, (T,) int32 NumPy submesh id of each triangle), the DrawArgs /
    Submesh analog (``Mesh.h:12-20``)."""
    parts = [_numpy(m) for m in meshes]
    offsets = np.cumsum([0] + [m.num_vertices for m in meshes[:-1]])
    cols = [np.concatenate([p[k] for p in parts]) for k in range(5)]
    tris = np.concatenate([p[5] + off for p, off in zip(parts, offsets)])
    sub_ids = np.concatenate([np.full((m.num_triangles,), i, np.int32) for i, m in enumerate(meshes)])
    return Mesh.from_numpy(*cols, tris, device=meshes[0].positions.device), sub_ids
