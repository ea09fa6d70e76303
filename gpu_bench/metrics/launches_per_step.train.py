"""Kernel, copy and fill launches the card ran per training step of the traced window."""

SOURCE = "device_trace"


def read(trace, ctx):
    if not trace.device:
        return None
    return trace.launches() / trace.units
