"""``build_s``: seconds the process spent building its renderers' scene
tensors and acceleration structures (``rt.build``: ``Renderer``'s pack
and the handler's build), from the port's set-up totals
(``rt_rs_tpu_torch.tracing``); part of ``setup_s``."""

from rtbench import counters


def read(trace):
    snap = counters.snapshot(trace)
    if snap is None or not snap["build_s"]:
        return None
    return snap["build_s"]
