"""Device time a frame of the work launched inside the PS stage's span
(``renderer.shade_pixels``: the material fetch, the samplers, the BRDF)."""

SOURCE = "device_trace"


def read(trace, ctx):
    us = trace.device_us_under("ps_stage")
    return us / trace.units * 1e-3 if us > 0 else None
