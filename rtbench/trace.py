"""From a torch.profiler trace to the numbers the per-layer metrics read.

:func:`collect` reduces a profile of the traced window to a
:class:`Trace`: the device operations (kernels, copies, sets) inside the
window, the host operations of the thread that drove it, the window's
bounds and the frames it rendered.
A metric's reader (``rtbench/metrics/<name>.py``) takes a :class:`Trace`
and returns its number, or None where the trace holds nothing for it.
"""

from __future__ import annotations

import collections
import dataclasses
import re

# The host span that marks the traced window in the profile.
WINDOW_MARK = "rtbench.window"
# Entries in each list of the line's breakdown.
BREAKDOWN_ENTRIES = 10
# The host label of an idle gap in which no profiled host operation ran.
NO_HOST_OP = "python (no profiled op)"


def base_name(name: str) -> str:
    """A device operation's kernel name without its return type,
    namespaces, template arguments and parameters:
    ``void (anonymous namespace)::mt_trace_items_kernel<2, false>(...)``
    -> ``mt_trace_items_kernel``; ``Memcpy DtoD (Device -> Device)`` ->
    ``Memcpy DtoD``."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void ", "", s)
    s = re.split(r"[<(]", s, maxsplit=1)[0].strip()
    return s.rsplit("::", 1)[-1]


def matches(name: str, prefixes) -> bool:
    """Whether kernel ``name``'s base name starts with one of ``prefixes``."""
    return base_name(name).startswith(tuple(prefixes))


@dataclasses.dataclass
class Trace:
    """The traced window.  Times in seconds on the profile's clock.

    ``device``: (name, start, end) of each device operation inside the
    window; ``host``: (name, start, end) of each host operation of the
    driving thread inside it; ``frames``: frames rendered in it."""

    start: float
    end: float
    frames: int
    device: list[tuple[str, float, float]]
    host: list[tuple[str, float, float]] = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, merged."""
        merged: list[list[float]] = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_s(self, keep) -> float:
        """Seconds of the device operations whose name ``keep`` accepts
        (summed: overlapping operations both count)."""
        return sum(b - a for n, a, b in self.device if keep(n))

    def idle_gaps(self) -> list[tuple[float, float]]:
        """The window's stretches with no device operation."""
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def breakdown(self) -> dict[str, list]:
        """The device operations that took most time (by base name), and
        the idle time by what the host was doing then (the innermost
        host operation under way at each gap's middle), each the
        :data:`BREAKDOWN_ENTRIES` largest, in seconds."""
        ops = collections.Counter()
        for n, a, b in self.device:
            ops[base_name(n)] += b - a
        idle = collections.Counter()
        gaps = sorted(self.idle_gaps(), key=lambda g: (g[0] + g[1]) / 2)
        host = sorted(self.host, key=lambda e: (e[1], -e[2]))
        stack: list[tuple[str, float, float]] = []
        j = 0
        for a, b in gaps:
            mid = (a + b) / 2
            while j < len(host) and host[j][1] <= mid:
                while stack and stack[-1][2] < host[j][1]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            idle[stack[-1][0] if stack else NO_HOST_OP] += b - a
        return {
            "device_ops": [[n, s] for n, s in ops.most_common(BREAKDOWN_ENTRIES)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(BREAKDOWN_ENTRIES)],
        }


def collect(prof, frames: int) -> Trace:
    """A :class:`Trace` of the window marked :data:`WINDOW_MARK` in
    ``prof`` (a finished ``torch.profiler.profile``)."""
    from torch.autograd import DeviceType

    events = prof.events()
    marks = [e for e in events if e.name == WINDOW_MARK and e.device_type == DeviceType.CPU]
    if len(marks) != 1:
        raise RuntimeError(f"the profile holds {len(marks)} window marks, not 1")
    mark = marks[0]
    start, end = mark.time_range.start / 1e6, mark.time_range.end / 1e6
    device, host = [], []
    for e in events:
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if b <= start or a >= end or e.name == WINDOW_MARK:
            continue
        if e.device_type == DeviceType.CPU:
            if e.thread == mark.thread:
                host.append((e.name, a, b))
        else:
            device.append((e.name, max(a, start), min(b, end)))
    return Trace(start, end, frames, device, host)
