"""FPS-style camera, left-handed / z-forward — the counterpart of
``physically_based_renderer_tpu/camera.py`` (reference ``Camera.{h,cpp}``:
fovY π/4, near 0.1, far 100, start (0,0,-5)).

Position, yaw and pitch are tensors on one device; fov, aspect, near and far
are Python floats. ``.to(device)`` moves the camera.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import math3d


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
        device: torch.device | str = "cpu",
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
