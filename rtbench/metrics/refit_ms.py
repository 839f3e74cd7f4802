"""``refit_ms``: device ms per frame of the kernels whose base name
starts ``wide_refit``: ``DynamicRenderer``'s per-frame refit of kernel
G's packed wide tree (``csrc/wide_refit.cu``), which rewrites the tree's
boxes and prims from each frame's corners.  Summed torch.profiler device
time over the traced window, divided by its frames.  Where no such
kernel ran (the static cells, the chunk table's refit, a program
without the kernel) it reads as nothing."""

from rtbench.trace import matches

PREFIXES = ("wide_refit",)


def read(trace):
    if trace.frames <= 0 or not trace.device:
        return None
    refit_s = trace.device_s(lambda n: matches(n, PREFIXES))
    if refit_s <= 0:
        return None
    return refit_s * 1e3 / trace.frames
