"""``rebuild_nodes``: the wide nodes ``DynamicRenderer``'s per-frame
build of kernel G's tree writes, per frame, from the port's counter
``rebuild_nodes`` (``rt_rs_tpu_torch.tracing``), which the build's
last kernel adds to inside every graph replay.  Fewer nodes for the same
prims is a shallower, wider tree.  A program without the counter, or a
window that built no tree, reads as nothing."""

from rtbench import counters


def read(trace):
    snap = counters.counted(trace)
    if snap is None or not snap.get("rebuild_nodes"):
        return None
    return snap["rebuild_nodes"] / snap["frames"]
