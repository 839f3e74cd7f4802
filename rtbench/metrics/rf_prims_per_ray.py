"""``rf_prims_per_ray``: the leaf slots the RF records walk tests (empty
and excluded slots skipped) per valid ray it walks, every primary,
shadow and bounce ray of the traced window, from the port's counters
(``rt_rs_tpu_torch.tracing``: ``rf_prims`` over ``rf_rays``).  A
program that walks no ray through the records, or counts no such
thing, reads as nothing."""

from rtbench import counters


def read(trace):
    snap = counters.counted(trace)
    if snap is None or not snap.get("rf_rays"):
        return None
    return snap["rf_prims"] / snap["rf_rays"]
