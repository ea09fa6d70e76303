"""Frame loop — the counterpart of ``physically_based_renderer_tpu/app.py``,
the headless analog of ``D3DApp::Run``'s message pump and swap chain
(``d3dApp.cpp:72-124``): per-frame camera input with the WASD and mouse
semantics of ``PBRApp::OnKeyboardInput`` / ``OnMouseMove``
(``PBRApp.cpp:376-402``), a render, fps and ms-per-frame statistics
(``CalculateFrameStats``, ``d3dApp.cpp:598-628``) and PNG "present".

On its first frame :class:`RenderLoop` checks the binning's capacity
(``renderer.check_raster_capacity``) and, where the configured pair cap
overflows, raises it to the suggested cap before it renders: the port's
``render`` raises on overflow (the JAX package's drops triangles).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Iterable

import numpy as np

from .camera import Camera
from .models.scene import Scene
from .renderer import check_raster_capacity, render
from .utils.config import RenderConfig, check_frame
from .utils.image_io import save_png

log = logging.getLogger("pbr_tpu_torch")


@dataclasses.dataclass
class FrameInput:
    """One frame's input events (the message pump's payload)."""

    forward: float = 0.0  # W/S axis in [-1, 1]
    side: float = 0.0  # A/D axis in [-1, 1]
    mouse_dx: float = 0.0  # pixels
    mouse_dy: float = 0.0


@dataclasses.dataclass
class FrameStats:
    """Rolling fps and ms per frame, recomputed once a second (the
    ``CalculateFrameStats`` semantics; host clock, frames presented)."""

    frames: int = 0
    window_start: float = dataclasses.field(default_factory=time.perf_counter)
    fps: float = 0.0
    mspf: float = 0.0

    def tick(self) -> bool:
        self.frames += 1
        now = time.perf_counter()
        elapsed = now - self.window_start
        if elapsed >= 1.0:
            self.fps = self.frames / elapsed
            self.mspf = 1000.0 * elapsed / self.frames
            self.frames = 0
            self.window_start = now
            return True
        return False


class RenderLoop:
    """Headless run loop: feed inputs, get frames as NumPy (H, W, 4) arrays.
    ``fps_lock`` is the reference's F3 toggle (60, 120 or None for uncapped,
    ``d3dApp.cpp:104-114``). The scene and camera stay on their device."""

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig | None = None,
                 fps_lock: float | None = None, check_capacity: bool = True):
        self.scene = scene
        self.camera = camera
        self.config = config or RenderConfig()
        self.fps_lock = fps_lock
        self.stats = FrameStats()
        self._last_time = time.perf_counter()
        self._capacity_checked = not check_capacity

    def step(self, inp: FrameInput | None = None, dt: float | None = None) -> np.ndarray:
        """Advance one frame: apply the input to the camera, render, and
        return the frame (its ``.cpu().numpy()``, which waits for it)."""
        now = time.perf_counter()
        if dt is None:
            dt = now - self._last_time
        self._last_time = now

        if inp is not None:
            cam = self.camera
            if inp.mouse_dx or inp.mouse_dy:
                cam = cam.on_mouse_move(inp.mouse_dx, inp.mouse_dy)
            if inp.forward or inp.side:
                cam = cam.move(inp.forward, inp.side, dt=dt)
            self.camera = cam

        if not self._capacity_checked:
            cfg = self.config
            stats = check_raster_capacity(self.scene, self.camera, width=cfg.width, height=cfg.height,
                                          tile_h=cfg.tile_h, tile_w=cfg.tile_w, pairs_cap=cfg.raster_pairs_cap)
            if stats["overflowed"]:
                log.warning("raster binning overflow: %d pairs > cap %d; raising raster_pairs_cap to %d",
                            stats["num_pairs"], stats["pairs_cap"], stats["suggested_pairs_cap"])
                self.config = dataclasses.replace(cfg, raster_pairs_cap=stats["suggested_pairs_cap"])
            self._capacity_checked = True

        img = render(self.scene, self.camera, **self.config.render_kwargs())
        check_frame(img)
        frame = img.detach().cpu().numpy()
        self.stats.tick()

        if self.fps_lock:
            budget = 1.0 / self.fps_lock
            spent = time.perf_counter() - now
            if spent < budget:
                time.sleep(budget - spent)
        return frame

    def run_sequence(self, inputs: Iterable[FrameInput], out_dir: str | None = None,
                     on_frame: Callable[[int, np.ndarray], None] | None = None,
                     dt: float = 1.0 / 60.0) -> list[np.ndarray]:
        """Render a scripted input sequence; optionally write frame PNGs."""
        frames = []
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        for i, inp in enumerate(inputs):
            frame = self.step(inp, dt=dt)
            frames.append(frame)
            if out_dir:
                save_png(os.path.join(out_dir, f"frame_{i:04d}.png"), frame)
            if on_frame:
                on_frame(i, frame)
        return frames


def turntable_inputs(num_frames: int, degrees_per_frame: float = 2.0) -> list[FrameInput]:
    """A mouse-drag sequence that orbits the camera's yaw (0.25°/px,
    ``PBRApp.cpp:377-378``)."""
    px_per_frame = degrees_per_frame / 0.25
    return [FrameInput(mouse_dx=px_per_frame) for _ in range(num_frames)]
