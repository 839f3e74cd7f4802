"""``rebuild_roofline``: the wide build's share of its bytes roofline, in
percent: a frame's bytes floor time over the device seconds a frame of
the kernels whose base name starts ``wide_build`` (``rebuild_ms``).

The floor counts what any build of the frame's structure must move,
whatever the tree, with ``refit_roofline``'s arithmetic: every
triangle's three corners are read (36 bytes) and its 48-byte prim record
is written, at the H100's 3.35 TB/s of HBM bandwidth.  The triangles come
from ``rtbench/configs/teapots3_rebuild.json``, the configuration of the
cell this metric is declared for, and never from the program's
counters, so no later layout can raise the floor.  Where no such kernel
ran it reads as nothing."""

import json
import pathlib

from rtbench import spec

CONFIG = pathlib.Path(__file__).resolve().parent.parent / "configs" / "teapots3_rebuild.json"
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes a second (chip_smoke.PEAK_BYTES)
TRIANGLE_BYTES = 36 + 48  # three corners read, one prim record written


def floor_s() -> float:
    """A frame's bytes floor time, in seconds."""
    with open(CONFIG) as f:
        config = json.load(f)
    return int(config["triangles"]) * TRIANGLE_BYTES / PEAK_BYTES


def read(trace):
    ms = spec.metric_reader("rebuild_ms").read(trace)
    if ms is None:
        return None
    return 100.0 * floor_s() / (ms * 1e-3)
