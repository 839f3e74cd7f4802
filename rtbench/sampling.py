"""What a run draws from its seed: the starting orbit angle, and the
frames and pixels the comparison keeps.

A traffic mix is a data file, ``rtbench/traffic/<mix>.json``; its
``kind`` names the loop that drives the program, the module
``rtbench/traffic/<kind>.py``, and the other keys are that loop's
parameters.  Every mix takes ``width``, ``height`` and ``check``:
``frames`` frames kept for the comparison (spread over the kind's
strata) and ``pixels`` pixels of each.  Everything here draws from the
seed alone; nothing reads the program.
"""

from __future__ import annotations

import math

import numpy as np

# Radians per unit of orbit step (the study's camera.rs:177-189: an
# orbit step of ``mult`` turns the camera 0.0314 * mult radians).
ORBIT_RATE = 0.0314
# Independent random streams drawn from one seed (``STREAM_KIND``: for
# a traffic kind's own draws).
STREAM_START, STREAM_KIND, STREAM_SAMPLE, STREAM_PIXELS = range(4)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of ``stream`` for ``seed`` (any whole number)."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), stream]))


def start_angle(seed: int) -> float:
    """The orbit angle, in radians from the configuration's camera, at
    which a run starts."""
    return float(rng(seed, STREAM_START).uniform(0.0, 2.0 * math.pi))


class Sampler:
    """Which frames of a window are compared, and at which pixels.

    ``strata`` reservoirs (one per position in a chained dispatch; 1 for
    eager frames) keep ``per_stratum`` frames each, a uniform sample of
    the frames offered, drawn from the seed; frame ``i`` belongs to
    stratum ``i % strata``.  Slot ``k`` of a reservoir reads the pixels
    ``pixel_sets[k]``, drawn from the seed before the window, so a kept
    frame costs one small gather."""

    def __init__(self, seed: int, strata: int, per_stratum: int, n_pixels: int, width: int, height: int):
        self.strata, self.per_stratum = strata, per_stratum
        g = rng(seed, STREAM_PIXELS)
        n = min(n_pixels, width * height)
        self.pixel_sets = [
            np.sort(g.choice(width * height, size=n, replace=False)) for _ in range(strata * per_stratum)
        ]
        self._g = rng(seed, STREAM_SAMPLE)
        self._seen = [0] * strata
        self.kept: dict[int, tuple[int, object]] = {}  # slot -> (frame index, pixels)

    def slot(self, i: int) -> int | None:
        """The slot frame ``i`` takes, or None if it is not kept
        (reservoir sampling within its stratum)."""
        s = i % self.strata
        seen = self._seen[s]
        self._seen[s] += 1
        if seen < self.per_stratum:
            k = seen
        else:
            k = int(self._g.integers(0, seen + 1))
            if k >= self.per_stratum:
                return None
        return s * self.per_stratum + k

    def offer(self, i: int, take) -> None:
        """Offer frame ``i``; if it is kept, ``take(k)`` reads its pixels
        ``pixel_sets[k]`` (the caller's, as the frame lives on the device
        or on the host)."""
        k = self.slot(i)
        if k is not None:
            self.kept[k] = (i, take(k))

    def samples(self) -> list[tuple[int, np.ndarray, object]]:
        """(frame index, pixel indices, pixels) of every kept frame, in
        frame order."""
        out = [(i, self.pixel_sets[k], px) for k, (i, px) in self.kept.items()]
        return sorted(out, key=lambda x: x[0])
