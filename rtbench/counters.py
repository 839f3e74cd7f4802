"""The port's own counters and set-up totals, read for the per-layer
metrics that count work inside the program.

``rt_rs_tpu_torch.tracing`` counts, while a torch.profiler session
records, the rays each bounce shades, the chunk-list entries each cull
keeps and kernel G's visits, in the port's kernels (so inside every
graph replay too), and times the program's set-up steps always.  Its
``snapshot()`` is the one read path; the readers here are, with
``drive.py`` and the traffic kinds, the benchmark's only files that
import the program.  A program without that module reads as nothing.
"""

from __future__ import annotations


def snapshot(trace) -> dict | None:
    """The program's tracing snapshot, read after the traced window, or
    None where the trace holds no device operation or the program has no
    tracing module."""
    if not trace.device:
        return None
    try:
        from rt_rs_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def counted(trace) -> dict | None:
    """:func:`snapshot` where its counters count the traced window's
    frames (``frames`` equal to the trace's), else None."""
    snap = snapshot(trace)
    if snap is None or trace.frames <= 0 or snap.get("frames") != trace.frames:
        return None
    return snap
