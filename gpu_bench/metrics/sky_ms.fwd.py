"""Device time a frame of the work launched inside the program's ``sky``
span (``renderer.background``: the view rays, the sky gather, its tonemap)."""

from gpu_bench import program

SOURCE = "device_trace"


def read(trace, ctx):
    prog = program.load(trace, ctx)
    if prog is None or not trace.device:
        return None
    return program.per_unit_ms(trace, prog.device_us_in("sky"))
