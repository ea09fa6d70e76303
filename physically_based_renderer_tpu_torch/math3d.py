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

from .device import DEFAULT_DEVICE
from .utils import profiling


def dot(a: torch.Tensor, b: torch.Tensor, axis: int = -1, keepdims: bool = False) -> torch.Tensor:
    """Dot product along ``axis``. Over a last axis of size 3 it is the
    explicit sum a0·b0 + a1·b1 + a2·b2 (the same bits on the CPU and the
    card); otherwise ``sum(a * b)``."""
    if axis in (-1, a.ndim - 1) and a.shape[-1] == 3 and b.shape[-1] == 3:
        out = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
        return out[..., None] if keepdims else out
    return (a * b).sum(dim=axis, keepdim=keepdims)


def normalize(v: torch.Tensor, axis: int = -1, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize along ``axis`` (returns ~0 for the zero vector)."""
    n2 = dot(v, v, axis=axis, keepdims=True)
    return v * torch.rsqrt(torch.clamp(n2, min=eps))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def length(v: torch.Tensor, axis: int = -1, keepdims: bool = False) -> torch.Tensor:
    """Length along ``axis``, floored at √1e-20."""
    return torch.sqrt(torch.clamp(dot(v, v, axis=axis, keepdims=keepdims), min=1e-20))


def lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return a + (b - a) * t


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``: a tie splits its gradient 0.5/0.5 (``torch.
    clamp`` gives it all to x). The constant is a fill, not a copy from the
    host (which would synchronise the stream)."""
    return torch.maximum(x, x.new_full((), c))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: min(max()), ties split as JAX splits them."""
    return torch.minimum(maximum(x, lo), x.new_full((), hi))


def saturate(x: torch.Tensor) -> torch.Tensor:
    return clip(x, 0.0, 1.0)


def yaw_pitch_to_cartesian(yaw: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
    """Forward direction from yaw/pitch (``MathUtil.h:349-364``): yaw=0,
    pitch=0 → +z; yaw rotates toward +x."""
    cp = torch.cos(pitch)
    return torch.stack([cp * torch.sin(yaw), torch.sin(pitch), cp * torch.cos(yaw)], dim=-1)


def spherical_to_cartesian(radius, theta, phi) -> torch.Tensor:
    """``MathUtil.h:375-383``, the sphere mesh's parametrisation:
    x = r sinφ cosθ, y = r cosφ, z = r sinφ sinθ (tensors, broadcast)."""
    sp = torch.sin(phi)
    return torch.stack([radius * sp * torch.cos(theta), radius * torch.cos(phi), radius * sp * torch.sin(theta)],
                       dim=-1)


# ---------------------------------------------------------------------------
# 4x4 matrices (row-vector convention: v_row @ M). The constructors take a
# number or a tensor: a tensor keeps its device and its gradient, a number
# lands on ``device``.
# ---------------------------------------------------------------------------


def _scalar(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32, device=device)


def _matrix(rows, device) -> torch.Tensor:
    """A 4x4 of numbers and 0-d tensors, differentiable through the tensors."""
    dev = next((v.device for r in rows for v in r if isinstance(v, torch.Tensor)), torch.device(device))
    return torch.stack([torch.stack([_scalar(v, dev) for v in r]) for r in rows])


def identity4(*, device=DEFAULT_DEVICE) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def translation(x, y, z, *, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Row-vector translation: the last row carries the offset."""
    return _matrix([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [x, y, z, 1]], device)


def scaling(x, y, z, *, device=DEFAULT_DEVICE) -> torch.Tensor:
    return _matrix([[x, 0, 0, 0], [0, y, 0, 0], [0, 0, z, 0], [0, 0, 0, 1]], device)


def _cos_sin(angle, device):
    a = _scalar(angle, device)
    return torch.cos(a), torch.sin(a)


def rotation_x(angle, *, device=DEFAULT_DEVICE) -> torch.Tensor:
    c, s = _cos_sin(angle, device)
    return _matrix([[1, 0, 0, 0], [0, c, s, 0], [0, -s, c, 0], [0, 0, 0, 1]], device)


def rotation_y(angle, *, device=DEFAULT_DEVICE) -> torch.Tensor:
    c, s = _cos_sin(angle, device)
    return _matrix([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], device)


def rotation_z(angle, *, device=DEFAULT_DEVICE) -> torch.Tensor:
    c, s = _cos_sin(angle, device)
    return _matrix([[c, s, 0, 0], [-s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], device)


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
    with profiling.sync("projection"):  # a copy from the host: on the card it waits for the stream
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


def look_at_lh(eye: torch.Tensor, target: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return look_to_lh(eye, target - eye, up)


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


def transform_points(points: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[..., 3] points through a 4x4 row-vector matrix (w = 1), no divide."""
    x, y, z = points[..., 0:1], points[..., 1:2], points[..., 2:3]
    return x * m[0, :3] + y * m[1, :3] + z * m[2, :3] + m[3, :3]


def transform_vectors(vectors: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Directions through the upper-left 3x3 (``mul(n, (float3x3)g_World)``,
    ``Default.hlsl:31``): no inverse-transpose, as the reference — right only
    under uniform scale and rotation."""
    x, y, z = vectors[..., 0:1], vectors[..., 1:2], vectors[..., 2:3]
    return x * m[0, :3] + y * m[1, :3] + z * m[2, :3]
