"""Idle time of the card a step that opens while the host is inside the
trainer's backward (the program's ``step/backward`` span around
``torch.autograd.grad``): the card waiting for autograd to enqueue work."""

from gpu_bench import program

SOURCE = "device_trace"


def read(trace, ctx):
    prog = program.load(trace, ctx)
    if prog is None or not trace.device:
        return None
    return program.per_unit_ms(trace, prog.idle_us_opening_in("step/backward"))
