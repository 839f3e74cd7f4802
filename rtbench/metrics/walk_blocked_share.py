"""``walk_blocked_share``: the share of the shadow rays kernel G walks in
its any-hit mode that stop at a blocker, from the port's counters
(``rt_rs_tpu_torch.tracing``: ``walk_blocked`` over ``walk_anyhit``).
A blocked ray ends its walk at the first prim below its cap; the rest
walk every node that the cap leaves in.  A program that walks no ray in
that mode, or counts no such thing, reads as nothing."""

from rtbench import counters


def read(trace):
    snap = counters.counted(trace)
    if snap is None or not snap.get("walk_anyhit"):
        return None
    return snap["walk_blocked"] / snap["walk_anyhit"]
