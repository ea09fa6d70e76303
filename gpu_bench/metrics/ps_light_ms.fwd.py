"""Device time a frame of the work launched inside the program's
``ps_stage/light`` span: the punctual lights, and the IBL split's SH9 and
environment BRDF or the ambient term."""

from gpu_bench import program

SOURCE = "device_trace"


def read(trace, ctx):
    prog = program.load(trace, ctx)
    if prog is None or not trace.device:
        return None
    return program.per_unit_ms(trace, prog.device_us_in("ps_stage/light"))
