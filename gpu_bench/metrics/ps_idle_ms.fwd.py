"""Idle time of the card a frame that opens while the host is inside the
PS stage (the program's ``ps_stage`` span) and in none of its ``sync/*``
spans: the card waiting for the host to enqueue the eager PS stage."""

from gpu_bench import program

SOURCE = "device_trace"


def read(trace, ctx):
    prog = program.load(trace, ctx)
    if prog is None or not trace.device:
        return None
    return program.per_unit_ms(trace, prog.idle_us_opening_in("ps_stage", not_prefix="sync/"))
