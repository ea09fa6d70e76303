"""Device time a frame of the work launched inside ``renderer.ibl_compose``
(the env gather of the prefiltered specular, tonemap, compose over the sky)."""

SOURCE = "device_trace"


def read(trace, ctx):
    us = trace.device_us_under("ibl_tail")
    return us / trace.units * 1e-3 if us > 0 else None
