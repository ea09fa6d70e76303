"""Device time a step of the work launched inside the program's
``step/backward/ibl_tail`` span: the IBL tail's share of the backward (the
specular-level lerp, the env taps' bilinear weights along the reflect
direction, the sky mapping's derivative, tonemap and compose). Autograd
launches it from its own thread; a program without the span reads
nothing."""

from gpu_bench import program

SOURCE = "device_trace"
SPAN = "step/backward/ibl_tail"


def read(trace, ctx):
    prog = program.load(trace, ctx)
    if prog is None or not trace.device or not any(s.name == SPAN for s in prog.spans):
        return None
    return program.per_unit_ms(trace, prog.device_us_in(SPAN))
