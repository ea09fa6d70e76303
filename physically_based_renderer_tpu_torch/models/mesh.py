"""Triangle meshes and the UV-sphere generator — the counterpart of
``physically_based_renderer_tpu/models/mesh.py``.

The sphere is built in NumPy with the reference's exact vertex order,
winding and UV parametrisation (``Mesh.h:473-591``), then moved to tensors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


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
    def from_numpy(positions, normals, tangents, bitangents, uvs, tris, *, device="cpu") -> "Mesh":
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


def sphere_mesh(
    radius: float = 1.0, slices: int = 64, stacks: int = 32, *, device="cpu"
) -> Mesh:
    """UV sphere with the reference's exact topology: north pole, rings
    i=1..stacks-1 of slices+1 columns (seam duplicated), south pole.
    Position (r sinφ cosθ, r cosφ, r sinφ sinθ); normal = pos/r; tangent =
    ∂P/∂θ; bitangent = normal × tangent; UV = (θ/2π, φ/π)."""
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

    return Mesh.from_numpy(pos, nrm, tan, bit, uv, np.asarray(tris, np.int64), device=device)
