"""``live_share``: the share of the ray slots that bounces 1 and later
shade, from the port's counters (``rt_rs_tpu_torch.tracing``): the rays
kernel D (or F) finds with ``active_f`` set over the T x r slots it is
launched on, summed over the traced window's frames.  The gather branch
gathers a shade row for every slot; this says how many are alive."""

from rtbench import counters


def read(trace):
    snap = counters.counted(trace)
    if snap is None:
        return None
    slots = sum(snap["slots"][1:])
    return sum(snap["live_rays"][1:]) / slots if slots else None
