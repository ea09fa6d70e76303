"""Device time a frame of the work launched inside the program's
``ps_stage/sample`` span: the parallax tap, the mip LOD and every sampler
tap of the PS stage."""

from gpu_bench import program

SOURCE = "device_trace"


def read(trace, ctx):
    prog = program.load(trace, ctx)
    if prog is None or not trace.device:
        return None
    return program.per_unit_ms(trace, prog.device_us_in("ps_stage/sample"))
