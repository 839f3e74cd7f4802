"""``device_idle.frame``: the device's idle share of the traced window
of an orbit cell: 1 - (the union of the device operations' intervals) /
(the window's wall time)."""


def read(trace):
    if trace.window_s <= 0.0 or not trace.device:
        return None
    return 1.0 - trace.busy_s() / trace.window_s
