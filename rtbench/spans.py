"""The traced window's device idle time by the program's own host spans.

The port marks its renderer's steps as host spans named ``rt.*`` on the
profiler's clock (``rt_rs_tpu_torch.tracing``): ``rt.dispatch`` with
``rt.prepare``, ``rt.capture`` and ``rt.replay`` inside it, and
``rt.copy_out``, ``rt.orbit``, ``rt.sync``, ``rt.deliver`` (and the
eager loop's ``rt.frame``).  Each idle gap of the device goes to the
innermost such span under way at its middle.
"""

from __future__ import annotations

import collections

PREFIX = "rt."
REPLAY = "rt.replay"


def idle_by_span(trace) -> dict[str, float] | None:
    """Device idle seconds of the window by the innermost ``rt.`` span at
    each gap's middle (gaps outside every such span are left out), or
    None where the trace holds no device operation or no ``rt.`` span."""
    spans = sorted((h for h in trace.host if h[0].startswith(PREFIX)), key=lambda e: (e[1], -e[2]))
    if not trace.device or not spans:
        return None
    idle = collections.Counter()
    stack: list[tuple[str, float, float]] = []
    j = 0
    for a, b in sorted(trace.idle_gaps(), key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while j < len(spans) and spans[j][1] <= mid:
            while stack and stack[-1][2] < spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        if stack:
            idle[stack[-1][0]] += b - a
    return dict(idle)


def idle_ms(trace, replay: bool) -> float | None:
    """Idle ms a frame under ``rt.replay`` (``replay``) or under every
    other ``rt.`` span."""
    idle = idle_by_span(trace)
    if idle is None or trace.frames <= 0:
        return None
    s = sum(v for n, v in idle.items() if (n == REPLAY) == replay)
    return s * 1e3 / trace.frames
