"""The comparison that decides ``correct``.

The frames a window produced are judged at pixels drawn from the seed
(:class:`rtbench.sampling.Sampler`) against the plain reference
(:mod:`rtbench.reference`), which works each frame's camera out again
from the configuration, the seed's starting angle and the orbit steps.
A pixel is off where any channel differs from the reference by more
than :data:`PIXEL_TOLERANCE` (two 8-bit levels: what a viewer can
see).  The numbers compared:

* ``bad_px``: the share of all compared pixels that are off;
* ``worst_frame``: the largest share of one compared frame's pixels
  that are off.

Each has the limit of the cell's ``rtbench/limits/<cell>.json``, set
from readings of sound runs of the program and of the control (the
reference computed in bfloat16, put in the program's place).
"""

from __future__ import annotations

import numpy as np

# A pixel is off where a channel differs by more than this, in [0, 1].
PIXEL_TOLERANCE = 2.0 / 255.0
NUMBERS = ("bad_px", "worst_frame")


def off_pixels(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Per pixel [N], whether ``got`` [N, 3] is off ``want`` [N, 3]
    (linear colours; a NaN is off)."""
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    diff = np.where(np.isnan(diff), np.inf, diff)
    return (diff > PIXEL_TOLERANCE + 1e-12).any(axis=-1)


def numbers(frames: list[tuple[np.ndarray, np.ndarray]]) -> tuple[dict[str, float], list[float]]:
    """(``bad_px``, ``worst_frame``) over the compared frames, each a
    pair (got [N, 3], want [N, 3]), and each frame's share off."""
    if not frames:
        return {"bad_px": 1.0, "worst_frame": 1.0}, []
    off = [off_pixels(g, w) for g, w in frames]
    per_frame = [float(o.mean()) for o in off]
    share = sum(int(o.sum()) for o in off) / sum(o.size for o in off)
    return {"bad_px": share, "worst_frame": max(per_frame)}, per_frame


def verdict(values: dict[str, float], limits: dict) -> tuple[bool, dict[str, dict]]:
    """Whether every number is within its limit -> (correct, the
    numbers each beside its limit)."""
    checks = {n: {"value": values[n], "limit": float(limits[n]["limit"])} for n in NUMBERS}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
