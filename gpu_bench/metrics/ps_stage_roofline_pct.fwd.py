"""The PS stage's share of its roofline: the least time the card could take
for the frames' shading work (``roofline.frame_work``: each hit pixel's
G-buffer read once, each texel the samples touch read once, the material
rows, each hit pixel's output written once; the shader's and the filters'
float32 operations) over the device time launched inside its span."""

from gpu_bench.roofline import least_seconds

SOURCE = "device_trace"


def read(trace, ctx):
    measured = trace.device_us_under("ps_stage") * 1e-6
    if measured <= 0.0:
        return None
    least = sum(least_seconds(*w["ps_stage"]) for w in ctx.work())
    return 100.0 * least / measured
