"""Calls in the program that wait for the card, a frame: the program's
``sync/*`` counters over the traced window (``utils/profiling.sync``)."""

from gpu_bench import program

SOURCE = "program_counter"


def read(trace, ctx):
    prog = program.load(trace, ctx)
    return None if prog is None else prog.count("sync/") / trace.units
