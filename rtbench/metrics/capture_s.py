"""``capture_s``: seconds the process spent capturing its CUDA graphs
(``rt.capture``: the warm-up frame and the capture of a chain), from the
port's set-up totals (``rt_rs_tpu_torch.tracing``); part of
``setup_s``.  None where nothing was captured."""

from rtbench import counters


def read(trace):
    snap = counters.snapshot(trace)
    if snap is None or not snap["captures"]:
        return None
    return snap["capture_s"]
