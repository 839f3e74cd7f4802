"""``intersect_ms``: device ms per frame of the intersection kernels.

The port's hand-written intersection kernels, matched by the start of
their kernel names: the packet kernels (``mt_trace``, ``refine_cull``,
``mt_stream``, the probes' ``mt_tpose`` / ``mt_mxu`` with its TF32
words' ``tf32_table``) and kernel G, the threaded walk (``bvh_walk``).
Summed torch.profiler device time over the traced window, divided by
its frames.
"""

from rtbench.trace import matches

PREFIXES = ("mt_trace", "refine_cull", "bvh_walk", "mt_stream", "mt_tpose", "mt_mxu", "tf32_table")


def read(trace):
    if trace.frames == 0 or not trace.device:
        return None
    return trace.device_s(lambda n: matches(n, PREFIXES)) * 1e3 / trace.frames
