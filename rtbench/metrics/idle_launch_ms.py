"""``idle_launch_ms``: device idle ms a frame while the renderer replays
a chain's graph: the idle gaps whose middle lies in the port's host span
``rt.replay`` (the innermost ``rt.`` span there; ``rtbench/spans.py``).
The next graph reaching the device late shows here."""

from rtbench import spans


def read(trace):
    return spans.idle_ms(trace, replay=True)
