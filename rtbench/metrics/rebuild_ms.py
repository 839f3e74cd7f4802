"""``rebuild_ms``: device ms per frame of the kernels whose base name
starts ``wide_build``: ``DynamicRenderer``'s per-frame build of kernel
G's packed wide tree from each frame's corners (``csrc/wide_build.cu``:
the Morton codes, the sort, Karras' emit, the bounds, the collapse and
the packing).  Summed torch.profiler device time over the traced window,
divided by its frames.  Where no such kernel ran (the static cells, the
refit cells, the chunk table's rebuild, a program without the kernels)
it reads as nothing."""

from rtbench.trace import matches

PREFIXES = ("wide_build",)


def read(trace):
    if trace.frames <= 0 or not trace.device:
        return None
    build_s = trace.device_s(lambda n: matches(n, PREFIXES))
    if build_s <= 0:
        return None
    return build_s * 1e3 / trace.frames
