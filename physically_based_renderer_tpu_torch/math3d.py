"""3D math on torch tensors with the reference's left-handed, row-vector
conventions — the counterpart of ``physically_based_renderer_tpu/math3d.py``.

Matrices follow the HLSL row-vector convention (``mul(float4(pos,1), M)``):
points transform as ``v @ M`` and compose left to right,
``v @ (world @ view_proj)``. Left-handed, z-forward; NDC depth in [0, 1].

Small contractions (3-term dot products, the 4x4 point transform) are written
as explicit elementwise sums in a fixed order instead of ``matmul``: the
result is then the same bits on the CPU and the card (no BLAS blocking, no
TF32), which keeps triangle coverage at pixel centres identical.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis (size 3)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize along the last axis (returns ~0 for the zero vector)."""
    n2 = dot(v, v)[..., None]
    return v * torch.rsqrt(torch.clamp(n2, min=eps))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def yaw_pitch_to_cartesian(yaw: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
    """Forward direction from yaw/pitch (``MathUtil.h:349-364``): yaw=0,
    pitch=0 → +z; yaw rotates toward +x."""
    cp = torch.cos(pitch)
    return torch.stack([cp * torch.sin(yaw), torch.sin(pitch), cp * torch.cos(yaw)], dim=-1)


def perspective_fov_lh(
    fov_y: float, aspect: float, near: float, far: float, *, device=None
) -> torch.Tensor:
    """Row-vector LH perspective, NDC z in [0,1] (``XMMatrixPerspectiveFovLH``).
    The entries are rounded to float32 as the JAX package rounds them:
    ``1/tan`` is taken in float32, the depth terms in double."""
    h = 1.0 / torch.tan(torch.tensor(fov_y * 0.5, dtype=torch.float32))
    w = h / aspect
    zr = far / (far - near)
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = zr
    m[2, 3] = 1.0
    m[3, 2] = -near * zr
    return m.to(device)


def look_to_lh(eye: torch.Tensor, forward: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Row-vector LH view matrix (``XMMatrixLookToLH``)."""
    f = normalize(forward)
    s = normalize(cross(up, f))  # side = up × forward (LH)
    u = cross(f, s)
    rot = torch.stack([s, u, f], dim=-1)  # columns are s, u, f
    top = torch.cat([rot, torch.zeros((3, 1), dtype=rot.dtype, device=rot.device)], dim=1)
    last = torch.cat(
        [
            torch.stack([-dot(s, eye), -dot(u, eye), -dot(f, eye)]),
            torch.ones((1,), dtype=rot.dtype, device=rot.device),
        ]
    )
    return torch.cat([top, last[None, :]], dim=0)


def matmul4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(4,4) @ (4,4) as explicit sums (no BLAS, no TF32)."""
    return (
        a[:, 0:1] * b[0:1, :]
        + a[:, 1:2] * b[1:2, :]
        + a[:, 2:3] * b[2:3, :]
        + a[:, 3:4] * b[3:4, :]
    )


def inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a 4x4 matrix (LU; no error check, so no host sync)."""
    return torch.linalg.inv_ex(m).inverse


def transform_points_h(points: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[..., 3] points → homogeneous [..., 4] through a 4x4 row-vector matrix."""
    x, y, z = points[..., 0:1], points[..., 1:2], points[..., 2:3]
    return x * m[0] + y * m[1] + z * m[2] + m[3]
