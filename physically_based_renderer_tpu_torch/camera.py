"""FPS-style camera, left-handed / z-forward — the counterpart of
``physically_based_renderer_tpu/camera.py`` (reference ``Camera.{h,cpp}``:
fovY π/4, near 0.1, far 100, start (0,0,-5); mouse look at 0.25°/px with the
pitch clamped to ±(π/2 − 0.1), ``Camera.cpp:89``; WASD at 5 units/s,
``PBRApp.cpp:376-402``).

Position, yaw and pitch are tensors on one device; fov, aspect, near and far
are Python floats. ``.to(device)`` moves the camera; the input methods
return a new camera, so the pose stays a differentiable input.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .device import DEFAULT_DEVICE
from . import math3d

PITCH_LIMIT = math.pi / 2.0 - 0.1  # Camera.cpp:89
MOVE_SPEED = 5.0  # units/s, PBRApp.cpp:394
MOUSE_RADIANS_PER_PIXEL = math.radians(0.25)  # PBRApp.cpp:377-378


@dataclasses.dataclass(frozen=True)
class Camera:
    position: torch.Tensor  # (3,)
    yaw: torch.Tensor  # () radians; 0 → +z
    pitch: torch.Tensor  # () radians
    fov_y: float = math.pi / 4.0
    aspect: float = 1200.0 / 800.0
    near: float = 0.1
    far: float = 100.0

    @staticmethod
    def create(
        position=(0.0, 0.0, -5.0),
        yaw=0.0,
        pitch=0.0,
        fov_y=math.pi / 4.0,
        aspect=1200.0 / 800.0,
        near=0.1,
        far=100.0,
        *,
        device: torch.device | str = DEFAULT_DEVICE,
    ) -> "Camera":
        f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
        return Camera(
            position=f(position),
            yaw=f(yaw),
            pitch=f(pitch),
            fov_y=fov_y,
            aspect=aspect,
            near=near,
            far=far,
        )

    @property
    def device(self) -> torch.device:
        return self.position.device

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self,
            position=self.position.to(device),
            yaw=self.yaw.to(device),
            pitch=self.pitch.to(device),
        )

    @property
    def forward(self) -> torch.Tensor:
        return math3d.yaw_pitch_to_cartesian(self.yaw, self.pitch)

    @property
    def side(self) -> torch.Tensor:
        """The horizontal strafe direction (pitch ignored), LH: up × forward."""
        flat_fwd = math3d.yaw_pitch_to_cartesian(self.yaw, torch.zeros_like(self.pitch))
        return math3d.normalize(math3d.cross(self.world_up, flat_fwd))

    @property
    def world_up(self) -> torch.Tensor:
        return torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=self.device)

    def view_matrix(self) -> torch.Tensor:
        return math3d.look_to_lh(self.position, self.forward, self.world_up)

    def projection_matrix(self) -> torch.Tensor:
        return math3d.perspective_fov_lh(
            self.fov_y, self.aspect, self.near, self.far, device=self.device
        )

    def view_proj(self) -> torch.Tensor:
        return math3d.matmul4(self.view_matrix(), self.projection_matrix())

    def rotate(self, dyaw, dpitch) -> "Camera":
        """Yaw and pitch advanced by the given radians, the pitch clamped."""
        pitch = math3d.clip(self.pitch + dpitch, -PITCH_LIMIT, PITCH_LIMIT)
        return dataclasses.replace(self, yaw=self.yaw + dyaw, pitch=pitch)

    def on_mouse_move(self, dx_pixels, dy_pixels) -> "Camera":
        return self.rotate(dx_pixels * MOUSE_RADIANS_PER_PIXEL, dy_pixels * MOUSE_RADIANS_PER_PIXEL)

    def move(self, forward_amt=0.0, side_amt=0.0, dt=1.0 / 60.0) -> "Camera":
        """Walk along the view direction and strafe, at MOVE_SPEED for ``dt`` s."""
        delta = (self.forward * forward_amt + self.side * side_amt) * (MOVE_SPEED * dt)
        return dataclasses.replace(self, position=self.position + delta)

    def with_aspect(self, width: int, height: int) -> "Camera":
        return dataclasses.replace(self, aspect=float(width) / float(height))
