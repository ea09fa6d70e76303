"""Device time a frame of the work launched inside the program's
``raster/bin`` span (``ops/raster_row.bin_for_shade``: triangle setup, the
corner channels and the binning's sort, on every raster route)."""

from gpu_bench import program

SOURCE = "device_trace"


def read(trace, ctx):
    prog = program.load(trace, ctx)
    if prog is None or not trace.device:
        return None
    return program.per_unit_ms(trace, prog.device_us_in("raster/bin"))
