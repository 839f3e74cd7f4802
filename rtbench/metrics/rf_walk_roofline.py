"""``rf_walk_roofline``: the RF records walk's share of its bytes
roofline, in percent: a frame's bytes floor time over the device
seconds a frame of the kernels whose base name starts ``bvh_walk_rf``.

The floor counts what any walk of the frame must move, whatever the
tree: every primary ray of the cell's traffic is valid, so its 32
bytes of payload are read and its hit, ``t`` and ``pid`` (8 bytes), is
written, at the H100's 3.35 TB/s of HBM bandwidth.  The pixels come from
``rtbench/traffic/orbit_1080.json``, the traffic of the cells this
metric is declared for, and never from the program's counters, so no
later cull or layout can raise the floor.  Where no such kernel ran
(the packet kernels' frames) it reads as nothing."""

import json
import pathlib

from rtbench.trace import matches

TRAFFIC = pathlib.Path(__file__).resolve().parent.parent / "traffic" / "orbit_1080.json"
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes a second (chip_smoke.PEAK_BYTES)
RAY_BYTES = 32 + 8  # a primary ray's payload read, then its t and pid written
PREFIXES = ("bvh_walk_rf",)


def floor_s() -> float:
    """A frame's bytes floor time, in seconds."""
    with open(TRAFFIC) as f:
        mix = json.load(f)
    return int(mix["width"]) * int(mix["height"]) * RAY_BYTES / PEAK_BYTES


def read(trace):
    if trace.frames <= 0 or not trace.device:
        return None
    walk_s = trace.device_s(lambda n: matches(n, PREFIXES))
    if walk_s <= 0:
        return None
    return 100.0 * floor_s() / (walk_s / trace.frames)
