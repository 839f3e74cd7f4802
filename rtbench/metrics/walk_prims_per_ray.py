"""``walk_prims_per_ray``: kernel G's prim tests per valid ray it walks
(the ray's excluded prim not tested), from the port's counters
(``rt_rs_tpu_torch.tracing``)."""

from rtbench import counters


def read(trace):
    snap = counters.counted(trace)
    if snap is None or not snap["walk_rays"]:
        return None
    return snap["walk_prims"] / snap["walk_rays"]
