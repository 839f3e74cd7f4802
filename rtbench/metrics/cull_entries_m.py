"""``cull_entries_m``: millions of chunk-list entries a frame that the
packet culls keep and kernel B (``mt_trace``) tests, every mode and cull
together, from the port's counters (``rt_rs_tpu_torch.tracing``: the sum
of ``counts`` its prologue reads) over the traced window's frames."""

from rtbench import counters


def read(trace):
    snap = counters.counted(trace)
    if snap is None:
        return None
    return sum(snap["cull_entries"].values()) / trace.frames / 1e6
