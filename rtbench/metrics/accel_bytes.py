"""``accel_bytes``: the device bytes of every tensor reachable from
``Renderer.accel``, each storage counted once (``rtbench/accel.py``)."""


def read(window):
    return float(window.accel_bytes)
