"""``idle_host_ms``: device idle ms a frame while the renderer is in any
of its other steps (``rt.prepare``, ``rt.copy_out``, ``rt.orbit``,
``rt.sync``, ``rt.deliver``, ``rt.dispatch`` between them): the idle
gaps whose middle lies in an ``rt.`` span other than ``rt.replay``
(``rtbench/spans.py``)."""

from rtbench import spans


def read(trace):
    return spans.idle_ms(trace, replay=False)
