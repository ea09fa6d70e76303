"""Host-clock time a frame inside the raster layer: the span around
``renderer.raster_gbuffer`` (setup, binning with its host sync, kernel 4's
launch)."""

SOURCE = "program_span"


def read(trace, ctx):
    us = trace.span_us("raster")
    return us / trace.units * 1e-3 if us > 0 else None
