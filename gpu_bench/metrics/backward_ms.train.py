"""Device time a step of the work launched inside the trainer's
``torch.autograd.grad`` call (the backward through the PS stage, the
fetches, the IBL tail and the raster's interpolation recompute)."""

SOURCE = "device_trace"


def read(trace, ctx):
    us = trace.device_us_under("backward")
    return us / trace.units * 1e-3 if us > 0 else None
