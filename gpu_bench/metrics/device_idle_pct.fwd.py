"""Share of the traced window in which no kernel, copy or fill ran on the
card: 1 minus the union of their intervals over the window's length."""

SOURCE = "device_trace"


def read(trace, ctx):
    if not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
