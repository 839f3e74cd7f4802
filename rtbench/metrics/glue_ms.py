"""``glue_ms``: device ms per frame of everything but the port's
intersection and shading kernels: torch's elementwise, gather, index,
sort and reduction kernels and the copies and sets between them (the
bounce loop's glue and the gather branch).  Summed torch.profiler
device time over the traced window, divided by its frames; the two
name lists are those of ``intersect_ms`` and ``shade_ms``.
"""

from rtbench import spec
from rtbench.trace import matches

HAND_WRITTEN = spec.metric_reader("intersect_ms").PREFIXES + spec.metric_reader("shade_ms").PREFIXES


def read(trace):
    if trace.frames == 0 or not trace.device:
        return None
    return trace.device_s(lambda n: not matches(n, HAND_WRITTEN)) * 1e3 / trace.frames
