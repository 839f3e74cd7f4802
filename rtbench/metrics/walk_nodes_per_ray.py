"""``walk_nodes_per_ray``: kernel G's wide-node visits per valid ray it
walks, every primary, shadow and bounce ray of the traced window, from
the port's counters (``rt_rs_tpu_torch.tracing``)."""

from rtbench import counters


def read(trace):
    snap = counters.counted(trace)
    if snap is None or not snap["walk_rays"]:
        return None
    return snap["walk_nodes"] / snap["walk_rays"]
