"""Render configuration and the debug mode — the counterpart of
``physically_based_renderer_tpu/utils/config.py``.

``RenderConfig`` carries the reference's window size (``d3dApp.h:126-127``,
1200×800), the tonemap and culling toggles, ``render``'s raster route
(``raster_backend``), the tile width and height and the binning's pair cap. ``debug_mode`` is the
D3D12-debug-layer analog: autograd's anomaly detection, and a finite check
of every frame ``app.RenderLoop`` presents.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging

import torch

log = logging.getLogger("pbr_tpu_torch")

_FRAME_CHECKS = False  # set inside debug_mode: check_frame raises on a non-finite frame


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable)."""

    width: int = 1200
    height: int = 800
    apply_tonemap: bool = True
    cull_backface: bool = True
    # renderer.render's route ("auto": the scene picks; renderer.raster_route)
    raster_backend: str = "auto"
    tile_h: int | None = None
    tile_w: int = 128
    # The binning's pair cap (None: render's resolution-scaled default).
    # RenderLoop sizes it on its first frame with
    # renderer.check_raster_capacity where the given cap overflows.
    raster_pairs_cap: int | None = None
    # Screen-space mip selection for textured materials; off, mip-0
    # bilinear, as the reference's 1-mip loads.
    mip_lod: bool = False

    def render_kwargs(self) -> dict:
        """The keyword arguments of ``renderer.render``."""
        return dict(
            width=self.width,
            height=self.height,
            apply_tonemap=self.apply_tonemap,
            cull_backface=self.cull_backface,
            raster_backend=self.raster_backend,
            tile_h=self.tile_h,
            tile_w=self.tile_w,
            raster_pairs_cap=self.raster_pairs_cap,
            mip_lod=self.mip_lod,
        )


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True):
    """For the scope: ``torch.autograd.set_detect_anomaly`` (a backward that
    makes NaN raises, naming the forward op), and :func:`check_frame` raises
    on a frame with a NaN or an infinity. Slows everything; for repro hunts."""
    global _FRAME_CHECKS
    old = _FRAME_CHECKS
    _FRAME_CHECKS = nan_checks
    try:
        with torch.autograd.set_detect_anomaly(nan_checks):
            yield
    finally:
        _FRAME_CHECKS = old


def check_frame(img: torch.Tensor) -> None:
    """Inside :func:`debug_mode`: raise ``FloatingPointError`` unless every
    value of the frame is finite (a host sync); outside it, nothing."""
    if _FRAME_CHECKS and not bool(torch.isfinite(img).all()):
        raise FloatingPointError(f"non-finite values in a frame of shape {tuple(img.shape)}")


def log_startup_info() -> None:
    """Log the devices at start (the ``LogAdapters`` analog)."""
    from .profiling import device_summary

    log.info("physically_based_renderer_tpu_torch startup\n%s", device_summary())
