"""Host time a frame spent waiting for the card: the union of the program's
``sync/*`` spans (each span is one wait)."""

from gpu_bench import program

SOURCE = "program_span"


def read(trace, ctx):
    prog = program.load(trace, ctx)
    return None if prog is None else program.per_unit_ms(trace, prog.host_us("sync/"))
