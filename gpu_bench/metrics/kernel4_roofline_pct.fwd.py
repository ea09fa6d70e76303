"""Kernel 4's share of its roofline: the least time the card could take for
the frames' G-buffer work (``roofline.frame_work``: each triangle in view
read once, each pixel's code and each hit pixel's attributes and depth
written once) over the device time of ``raster_gbuffer_row_kernel<8, 15>``."""

from gpu_bench.roofline import least_seconds

SOURCE = "device_trace"
KERNEL = "raster_gbuffer_row_kernel<8,15>"


def read(trace, ctx):
    measured = trace.device_us_named(KERNEL) * 1e-6
    if measured <= 0.0:
        return None
    least = sum(least_seconds(*w["kernel4"]) for w in ctx.work())
    return 100.0 * least / measured
