"""``shade_ms``: device ms per frame of the shading kernels.

The port's hand-written shading kernels, matched by the start of their
kernel names: ``shade_pre``, ``shade_post`` and ``shade_bounce``.
Summed torch.profiler device time over the traced window, divided by
its frames.
"""

from rtbench.trace import matches

PREFIXES = ("shade_pre", "shade_post", "shade_bounce")


def read(trace):
    if trace.frames == 0 or not trace.device:
        return None
    return trace.device_s(lambda n: matches(n, PREFIXES)) * 1e3 / trace.frames
